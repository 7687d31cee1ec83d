#!/usr/bin/env python3
"""End-to-end check of pygpa_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   TF32 switched off for matmuls and cuDNN;
2. the build of the CUDA kernels (csrc/*.cu, nvcc, timed);
3. each kernel against its plain PyTorch twin on the card, on the
   inputs the 4096^2 bench extractor hands it (captured from one
   extractor run), with the error bound stated beside the check and
   both times from CUDA events after warm-up;
4. the bench extractor itself: make_displacement_extractor((4096,
   4096), ks, chunk=4, unwrap_coarse=4, device="cuda") on the bench
   fixture (r_k 0.02, theta 5 deg, kappa 1.005, psi 10 deg, order 2)
   and on the Gaussian-envelope deformed fixture, held to the bench's
   three accuracy gates (interior < 0.002 px, dc-free < 0.0012 px,
   deformed < 0.075 px after gaussian_deconvolve); launch counters
   reset just before and read just after show that every kernel ran;
   seconds per image and Mpix/s over 5 runs after warm-up, per-stage
   CUDA-event times and peak device memory.

Any failed check raises and the script exits non-zero. Without a CUDA
card it fails at once. Its last two lines are the kernels JSON object
followed by {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE = 4096
R_K, THETA, KAPPA, PSI = 0.02, 5.0, 1.005, 10.0
GATE_INTERIOR, GATE_DCFREE, GATE_DEFORMED = 0.002, 0.0012, 0.075
REPS = 5
# kernel -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "sweep_uv": ("pygpa_tpu_torch/csrc/sweep.cu",
                 "pygpa_tpu/ops/pallas_sweep.py:370"),
    "presmooth": ("pygpa_tpu_torch/csrc/vcycle.cu",
                  "pygpa_tpu/ops/pallas_vcycle.py:138"),
    "applyq": ("pygpa_tpu_torch/csrc/vcycle.cu",
               "pygpa_tpu/ops/pallas_vcycle.py:217"),
    "cg_poisson": ("pygpa_tpu_torch/csrc/cg.cu",
                   "pygpa_tpu/ops/pallas_cg.py:109"),
}


def say(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn() from CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


class Capture:
    """Swap a module-level kernel wrapper for a recorder that keeps the
    arguments of every call and forwards it to the wrapper."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def rec(*args):
            self.calls.append(args)
            return self.orig(*args)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def fixtures(torch):
    from pygpa_tpu_torch.lattices import generate_ks, hexlattice_gen
    ks = generate_ks(R_K, THETA, kappa=KAPPA, psi=PSI)[:3]
    img = hexlattice_gen(R_K, THETA, order=2, size=SIZE, kappa=KAPPA,
                         psi=PSI, dtype=torch.float32, device="cuda")
    S = SIZE // 2
    xp, yp = np.meshgrid(np.arange(-S, S), np.arange(-S, S), indexing="ij")
    xshift = 0.1 * xp * np.exp(-0.5 * ((xp / (2 * S / 8)) ** 2
                                       + 1.2 * (yp / (2 * S / 6)) ** 2))
    u_true = np.stack((xshift, np.zeros_like(xshift))).astype(np.float32)
    img_d = hexlattice_gen(R_K, THETA, order=2, size=SIZE, kappa=KAPPA,
                           psi=PSI, shift=u_true, dtype=torch.float32,
                           device="cuda")
    return ks, img, img_d, torch.from_numpy(u_true).cuda()


def rel_err(got, want):
    """max |got - want| / max |want| (normwise relative)."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def check_sweep(sw, args):
    import torch
    ux, uy, wn = sw.sweep_uv(*args)
    px, py, pn = sw.sweep_uv_plain(*args)
    torch.cuda.synchronize()
    for name, t in (("dudx_s", ux), ("dudy_s", uy), ("wnorm", wn)):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"sweep kernel: non-finite {name}")
    dx = (ux - px)[:, :, 1:].abs()
    dy = (uy - py)[:, 1:, :].abs()
    dwn = ((wn - pn).abs() / (pn.abs() + 1e-9))
    # flip-tolerant bounds (tests/test_lockin_wfr.py banded-vs-unbanded):
    # near-tie winners may differ between two f32 summation orders, so
    # the p99s are bounded tightly and the maxima loosely
    q = torch.tensor([0.99], device=dx.device)
    stats = {
        "dudx_p99": float(torch.quantile(dx.flatten()[::7], q)),
        "dudy_p99": float(torch.quantile(dy.flatten()[::7], q)),
        "wnorm_rel_max": float(dwn.max()),
        "wnorm_rel_p99": float(torch.quantile(dwn.flatten()[::7], q)),
    }
    max_abs = max(float(dx.max()), float(dy.max()),
                  float((wn - pn).abs().max()))
    say(f"  sweep_uv vs twin: {json.dumps(stats)} max_abs_err={max_abs!r}")
    ok = (stats["dudx_p99"] < 1e-3 and stats["dudy_p99"] < 1e-3
          and stats["wnorm_rel_max"] < 5e-3
          and stats["wnorm_rel_p99"] < 5e-5)
    if not ok:
        raise RuntimeError("sweep kernel disagrees with its twin beyond "
                           "p99 < 1e-3 (dudx, dudy), wnorm rel max < 5e-3, "
                           "p99 < 5e-5")
    return max_abs


def check_vcycle(vc, ps_args, aq_args):
    import torch
    got = vc.presmooth(*ps_args)
    want = vc.presmooth_plain(*ps_args)
    torch.cuda.synchronize()
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    mabs_ps = max(float((g - w).abs().max()) for g, w in zip(got, want))
    say(f"  presmooth vs twin: rel err (r, d, Dinv, rrow) = {errs} "
        f"max_abs_err={mabs_ps!r} (bound 1e-5)")
    if not all(np.isfinite(errs)) or max(errs) > 1e-5:
        raise RuntimeError("presmooth kernel disagrees with its twin")
    q = vc.applyq(*aq_args)
    qp = vc.applyq_plain(*aq_args)
    torch.cuda.synchronize()
    e = rel_err(q, qp)
    mabs_aq = float((q - qp).abs().max())
    say(f"  applyq vs twin: rel err {e!r} max_abs_err={mabs_aq!r} "
        "(bound 1e-5)")
    if not np.isfinite(e) or e > 1e-5:
        raise RuntimeError("applyq kernel disagrees with its twin")
    return mabs_ps, mabs_aq


CG_BOUND = 1e-4


def check_cg(cg, calls):
    import torch
    mabs = 0.0
    for args in calls:
        got = cg.cg_poisson(*args)
        want = cg.cg_poisson_plain(*args)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        mabs = max(mabs, float((got - want).abs().max()))
        say(f"  cg_poisson {tuple(args[0].shape)} kmax {args[3]} vs twin: "
            f"rel err {e!r} (bound {CG_BOUND}: dense-matrix DCT vs FFT DCT "
            "preconditioner, f32)")
        if not np.isfinite(e) or e > CG_BOUND:
            raise RuntimeError("cg_poisson kernel disagrees with its twin")
    return mabs


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pygpa_tpu_torch.gpa import pipeline
    from pygpa_tpu_torch.ops import _build
    from pygpa_tpu_torch.ops import cg as cg_mod
    from pygpa_tpu_torch.ops import sweep as sw_mod
    from pygpa_tpu_torch.ops import vcycle as vc_mod
    from pygpa_tpu_torch.ops import wfr as wfr_mod
    from pygpa_tpu_torch.solvers import unwrap as unwrap_mod

    # ---- 1. the card
    card = card_line()
    say(f"[1] card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"    torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")

    # ---- 2. build
    t0 = time.perf_counter()
    lib = _build.load()
    say(f"[2] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds!r} s) -> {os.path.basename(lib._name)}")

    # ---- 3. kernels vs twins on the main path's own inputs
    ks, img, img_d, u_true = fixtures(torch)
    fn = pipeline.make_displacement_extractor(
        (SIZE, SIZE), ks, chunk=4, unwrap_coarse=4, device="cuda")
    plan = fn.plan
    say(f"[3] plan: sigma={plan.sigma} dr={plan.dr} G,P={plan.wl.shape[:2]} "
        f"W0={plan.idx0s.shape[1]} W1={plan.idx1s.shape[1]} "
        f"col_groups={plan.col_groups}")
    with Capture(wfr_mod._sweep, "sweep_uv") as c_sw, \
            Capture(unwrap_mod._vcycle, "presmooth") as c_ps, \
            Capture(unwrap_mod._vcycle, "applyq") as c_aq, \
            Capture(unwrap_mod._cg, "cg_poisson") as c_cg:
        fn(img)
        torch.cuda.synchronize()
    cg_calls = [tuple(a[0].shape) + (a[3],) for a in c_cg.calls]
    say(f"    captured calls: sweep {len(c_sw.calls)}, presmooth "
        f"{len(c_ps.calls)}, applyq {len(c_aq.calls)}, cg {cg_calls}")
    sw_args, ps_args, aq_args = c_sw.calls[0], c_ps.calls[0], c_aq.calls[0]
    rows = {}
    rows["sweep_uv"] = dict(
        max_abs_err=check_sweep(sw_mod, sw_args),
        ms=cuda_ms(lambda: sw_mod.sweep_uv(*sw_args), 3),
        plain_ms=cuda_ms(lambda: sw_mod.sweep_uv_plain(*sw_args), 3))
    e_ps, e_aq = check_vcycle(vc_mod, ps_args, aq_args)
    rows["presmooth"] = dict(
        max_abs_err=e_ps, ms=cuda_ms(lambda: vc_mod.presmooth(*ps_args), 20),
        plain_ms=cuda_ms(lambda: vc_mod.presmooth_plain(*ps_args), 20))
    rows["applyq"] = dict(
        max_abs_err=e_aq, ms=cuda_ms(lambda: vc_mod.applyq(*aq_args), 20),
        plain_ms=cuda_ms(lambda: vc_mod.applyq_plain(*aq_args), 20))
    e_cg = check_cg(cg_mod, c_cg.calls)
    cg_ms = [(cuda_ms(lambda a=a: cg_mod.cg_poisson(*a), 10),
              cuda_ms(lambda a=a: cg_mod.cg_poisson_plain(*a), 10))
             for a in c_cg.calls]
    say(f"    cg_poisson ms (kernel, twin) per call: {cg_ms}")
    rows["cg_poisson"] = dict(max_abs_err=e_cg, ms=cg_ms[0][0],
                              plain_ms=cg_ms[0][1])
    for name, r in rows.items():
        say(f"    {name}: kernel {r['ms']!r} ms, twin {r['plain_ms']!r} ms")

    # ---- 4. the main path, counters reset just before
    u = fn(img)                                   # warm-up
    torch.cuda.synchronize()
    _build.launches.clear()
    t0 = time.perf_counter()
    for _ in range(REPS):
        u = fn(img)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / REPS
    # per-stage CUDA-event times and peak memory: the bench's deformed
    # run, i.e. the extractor followed by gaussian_deconvolve(u, sigma,
    # 2 sigma), which is the same factory with deconvolve=True
    fn_d = pipeline.make_displacement_extractor(
        (SIZE, SIZE), ks, chunk=4, unwrap_coarse=4, deconvolve=True,
        device="cuda")
    ud = fn_d(img_d)
    events = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    ud = fn_d(img_d, events=events)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stages, prev = {}, start
    for name, ev in events:
        stages[name] = prev.elapsed_time(ev)
        prev = ev
    launches = {k: _build.launches[k] for k in KERNELS}
    say(f"[4] launches in the main-path runs: {launches}")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"a kernel of the main path never ran: {launches}")

    if tuple(u.shape) != (2, SIZE, SIZE) or not torch.isfinite(u).all():
        raise RuntimeError(f"extractor output bad: shape {tuple(u.shape)}")
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    ui = u[:, b:-b, b:-b]
    u_err = float(ui.abs().max())
    um = ui - ui.mean(dim=(1, 2), keepdim=True)
    u_err_dc = float(um.abs().max())
    resid = (-ud - u_true)[:, b:-b, b:-b]
    resid = resid - resid.mean(dim=(1, 2), keepdim=True)
    u_err_def = float(resid.abs().max())
    gates = {"u_err_interior_px": u_err, "u_err_interior_dcfree_px": u_err_dc,
             "u_err_deformed_px": u_err_def,
             "gated": f"interior<{GATE_INTERIOR}, dcfree<{GATE_DCFREE}, "
                      f"deformed<{GATE_DEFORMED}"}
    say(f"    gates: {json.dumps(gates)}")
    if not (u_err < GATE_INTERIOR and u_err_dc < GATE_DCFREE
            and u_err_def < GATE_DEFORMED):
        raise RuntimeError("ACCURACY GATE FAILED")
    say(f"    seconds_per_image {dt!r}, Mpix/s {SIZE * SIZE / 1e6 / dt!r} "
        f"({REPS} runs after warm-up, host clock, synchronized)")
    say(f"    stage ms (CUDA events): {json.dumps(stages)}")
    say(f"    peak device memory {peak / 2**30!r} GiB")

    kernels = []
    for name, (src, rep) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        **rows[name]})
    say(card_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
