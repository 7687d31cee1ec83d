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
   CUDA-event times and peak device memory;
5. the README's eager path, extract_displacement_field(img, ks) on the
   same fixture (one zoom sweep per Bragg peak, the exact CG on the DCT
   kernels), and
6. the README's factory at its defaults,
   make_displacement_extractor((4096, 4096), ks, device="cuda") (the
   grouped sweep, then the exact CG on the DCT kernels);
   each with its launch counts, the whole path against the same path
   on the plain twins (interior p99 |du| < 1e-4 px, max < 1e-2 px), the
   bench's three gates, seconds per image over 3 runs after warm-up,
   per-stage CUDA-event times and peak device memory.

Phase 3 also holds the zoom-sweep kernel (all three peaks of the eager
path) and the four DCT directions (on the exact CG's own residual)
against their twins.

Any failed check raises and the script exits non-zero. Without a CUDA
card it fails at once. Its last two lines are the kernels JSON object
followed by {"ok": true, "device": {...}}.
"""
import contextlib
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
# the bench's k-vectors as bench.py's generate_ks returns them (float32,
# JAX's default precision): in extract_displacement_field their candidate
# banks (np.arange endpoints) hold P = 42, 49 and 36, so one peak runs
# past the reference's 48-candidate chunk; phases 3, 5 and 6 use them
KS_BENCH_F32 = np.array([[0.019829239696264267, 0.0017598043195903301],
                         [0.008427001535892487, 0.018130626529455185],
                         [-0.011402237229049206, 0.01637081988155842]],
                        np.float32)
REPS = 5
REPS_EXACT = 3      # timed runs of phases 5 and 6
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
    "zoom_sweep": ("pygpa_tpu_torch/csrc/zoom_sweep.cu",
                   "pygpa_tpu/ops/pallas_sweep.py:96"),
    "dct_lane": ("pygpa_tpu_torch/csrc/dct.cu",
                 "pygpa_tpu/ops/pallas_dct2.py:132"),
    "dct_sub": ("pygpa_tpu_torch/csrc/dct.cu",
                "pygpa_tpu/ops/pallas_dct2.py:220"),
}
# the path whose counted run a kernel's "launches" reports
PATH_OF = {"sweep_uv": 4, "presmooth": 4, "applyq": 4, "cg_poisson": 4,
           "zoom_sweep": 5, "dct_lane": 5, "dct_sub": 5}
# kernels each driven path must launch
PATH_KERNELS = {4: ("sweep_uv", "presmooth", "applyq", "cg_poisson"),
                5: ("zoom_sweep", "dct_lane", "dct_sub"),
                6: ("sweep_uv", "dct_lane", "dct_sub")}


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
    arguments of its first `keep` calls (all when None) and forwards
    every call to the wrapper."""

    def __init__(self, module, name, keep=None):
        self.module, self.name, self.keep = module, name, keep
        self.orig = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def rec(*args):
            if self.keep is None or len(self.calls) < self.keep:
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


ZOOM_AGREE = 0.99      # winner agreement, kernel vs twin


def check_zoom(zs, calls, dr):
    """The zoom-sweep kernel against its twin on each peak's inputs,
    flip-tolerant (tests/test_lockin_wfr.py's kernel bounds): winners
    agree on > 99% of pixels; where they agree, |M|^2 within rtol 1e-4
    (atol 1e-7 of its maximum: float32 sums carry that much absolute
    noise), Re/Im within 1e-3 of the largest |M|, the weight within
    rtol 1e-5 (atol 1e-6), and the phase within 1e-5 rad modulo 2 pi
    where |M| is at least 1e-3 of its maximum (below that atan2
    amplifies the same absolute noise)."""
    import torch
    mabs = 0.0
    for args in calls:
        got = zs.zoom_sweep(*args, dr=dr)
        want = zs.zoom_sweep_plain(*args, dr=dr)
        torch.cuda.synchronize()
        same = got[3] == want[3]
        agree = float(same.float().mean())
        amax = float(want[0].max())
        top = amax ** 0.5
        d = [(g - w).abs() for g, w in zip(got, want)]
        ex_a = float((d[0] - 1e-4 * want[0].abs())[same].max())
        ex_w = float((d[5] - 1e-5 * want[5].abs())[same].max())
        live = same & (want[0] >= 1e-6 * amax)
        ph = float(torch.remainder(got[4] - want[4] + np.pi, 2 * np.pi)
                   .sub(np.pi).abs()[live].max())
        dre, dim = float(d[1][same].max()), float(d[2][same].max())
        mabs = max(mabs, dre, dim)
        say(f"  zoom_sweep P={args[2].shape[0]} W0={args[0].shape[0]} "
            f"W1={args[0].shape[1]} vs twin: winners agree {agree!r}; "
            f"absq excess over rtol {ex_a / amax!r} of max, re "
            f"{dre / top!r}, im {dim / top!r} of max |M|, phase {ph!r} "
            f"rad, weight excess over rtol {ex_w!r}")
        ok = (agree > ZOOM_AGREE and ex_a <= 1e-7 * amax
              and dre <= 1e-3 * top and dim <= 1e-3 * top and ph <= 1e-5
              and ex_w <= 1e-6)
        if not (ok and all(bool(torch.isfinite(g).all()) for g in got[:3])):
            raise RuntimeError("zoom_sweep kernel disagrees with its twin")
    return mabs


DCT_BOUND = 1e-5


def check_dct(dm, inputs):
    """Each DCT kernel direction against its FFT twin on the exact CG's
    own inputs: normwise relative error <= 1e-5 (float32 sums of 4096
    terms in another order; measured ~1e-6)."""
    import torch
    mabs = {}
    for name, x in inputs.items():
        got = getattr(dm, name)(x)
        want = getattr(dm, name + "_plain")(x)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        kern = "dct_lane" if name.endswith("lane") else "dct_sub"
        mabs[kern] = max(mabs.get(kern, 0.0),
                         float((got - want).abs().max()))
        say(f"  {name} {tuple(x.shape)} vs twin: rel err {e!r} "
            f"(bound {DCT_BOUND})")
        if not np.isfinite(e) or e > DCT_BOUND:
            raise RuntimeError(f"{name} kernel disagrees with its twin")
    return mabs


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper swapped for its plain twin (the DCT route
    predicate off), to drive a path on the card without its kernels."""
    from pygpa_tpu_torch.core import fourier
    from pygpa_tpu_torch.ops import cg, sweep, vcycle, zoom_sweep
    swaps = [(sweep, "sweep_uv", sweep.sweep_uv_plain),
             (zoom_sweep, "zoom_sweep", zoom_sweep.zoom_sweep_plain),
             (vcycle, "presmooth", vcycle.presmooth_plain),
             (vcycle, "applyq", vcycle.applyq_plain),
             (cg, "cg_poisson", cg.cg_poisson_plain),
             (fourier, "dct_kernel_ok", lambda n, dtype: False)]
    saved = [(m, k, getattr(m, k)) for m, k, _ in swaps]
    for m, k, v in swaps:
        setattr(m, k, v)
    try:
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def gate_values(u, ud, u_true, ks):
    """The bench's three accuracy numbers: interior max |u| and its
    dc-free form on the zero-displacement fixture, and the deformed
    fixture's dc-free interior error."""
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    ui = u[:, b:-b, b:-b]
    um = ui - ui.mean(dim=(1, 2), keepdim=True)
    resid = (-ud - u_true)[:, b:-b, b:-b]
    resid = resid - resid.mean(dim=(1, 2), keepdim=True)
    return float(ui.abs().max()), float(um.abs().max()), \
        float(resid.abs().max())


def drive_path(num, label, call, call_deconv, img, img_d, u_true, ks):
    """Phases 5 and 6: one counted run, timed runs, the path against its
    plain versions, the bench gates, stage times and peak memory.
    Returns the counted run's launches."""
    import torch
    from pygpa_tpu_torch.ops import _build
    call(img)                                      # warm-up
    torch.cuda.synchronize()
    _build.launches.clear()
    u = call(img)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    say(f"[{num}] {label}: launches in one run: {launches}")
    missing = [k for k in PATH_KERNELS[num] if not launches.get(k)]
    if missing:
        raise RuntimeError(f"kernels of the path never ran: {missing}")
    if tuple(u.shape) != (2, SIZE, SIZE) or not torch.isfinite(u).all():
        raise RuntimeError(f"{label}: output bad, shape {tuple(u.shape)}")
    t0 = time.perf_counter()
    for _ in range(REPS_EXACT):
        call(img)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / REPS_EXACT
    with plain_versions():
        up = call(img)
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    d = (u - up)[:, b:-b, b:-b].abs().flatten()
    p99 = float(torch.quantile(d[::7], torch.tensor([0.99],
                                                    device=d.device)))
    dmax = float(d.max())
    say(f"    with kernels vs plain versions: interior p99 |du| {p99!r} "
        f"max {dmax!r} px (bounds 1e-4, 1e-2)")
    if not (p99 < 1e-4 and dmax < 1e-2):
        raise RuntimeError(f"{label}: kernels change the result")
    call_deconv(img_d)
    events = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    ud = call_deconv(img_d, events=events)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stages, prev = {}, start
    for name, ev in events:
        stages[name] = prev.elapsed_time(ev)
        prev = ev
    g = gate_values(u, ud, u_true, ks)
    gates = {"u_err_interior_px": g[0], "u_err_interior_dcfree_px": g[1],
             "u_err_deformed_px": g[2],
             "gated": f"interior<{GATE_INTERIOR}, dcfree<{GATE_DCFREE}, "
                      f"deformed<{GATE_DEFORMED}"}
    say(f"    gates: {json.dumps(gates)}")
    if not (g[0] < GATE_INTERIOR and g[1] < GATE_DCFREE
            and g[2] < GATE_DEFORMED):
        raise RuntimeError(f"{label}: ACCURACY GATE FAILED")
    say(f"    seconds_per_image {dt!r}, Mpix/s {SIZE * SIZE / 1e6 / dt!r} "
        f"({REPS_EXACT} runs after warm-up, host clock, synchronized)")
    say(f"    stage ms (CUDA events, deconvolving run): "
        f"{json.dumps(stages)}")
    say(f"    peak device memory {peak / 2**30!r} GiB")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pygpa_tpu_torch.core import fourier as fourier_mod
    from pygpa_tpu_torch.gpa import pipeline
    from pygpa_tpu_torch.ops import _build
    from pygpa_tpu_torch.ops import cg as cg_mod
    from pygpa_tpu_torch.ops import dct as dct_mod
    from pygpa_tpu_torch.ops import zoom_sweep as zs_mod
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
    # the eager path's inputs: one zoom sweep per Bragg peak, and the
    # first transform of each direction in its exact CG
    ks32 = KS_BENCH_F32
    if np.abs(ks32 - ks).max() > 1e-8:
        raise RuntimeError("KS_BENCH_F32 is not the bench fixture's ks")
    with Capture(wfr_mod._zoom, "zoom_sweep") as c_zs, \
            Capture(fourier_mod._dct, "dct_lane", keep=1) as c_dl, \
            Capture(fourier_mod._dct, "idct_lane", keep=1) as c_il, \
            Capture(fourier_mod._dct, "dct_sub", keep=1) as c_ds, \
            Capture(fourier_mod._dct, "idct_sub", keep=1) as c_is:
        pipeline.extract_displacement_field(img, ks32)
        torch.cuda.synchronize()
    say(f"    captured eager-path calls: zoom_sweep P = "
        f"{[a[2].shape[0] for a in c_zs.calls]}, windows "
        f"{[tuple(a[0].shape) for a in c_zs.calls]}")
    dr = 2 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    e_zs = check_zoom(zs_mod, c_zs.calls, dr)
    zs_ms = [(cuda_ms(lambda a=a: zs_mod.zoom_sweep(*a), 3),
              cuda_ms(lambda a=a: zs_mod.zoom_sweep_plain(*a), 2))
             for a in c_zs.calls]
    say(f"    zoom_sweep ms (kernel, twin) per peak: {zs_ms}")
    rows["zoom_sweep"] = dict(max_abs_err=e_zs,
                              ms=sum(k for k, _ in zs_ms),
                              plain_ms=sum(p for _, p in zs_ms))
    dct_in = {"dct_lane": c_dl.calls[0][0], "idct_lane": c_il.calls[0][0],
              "dct_sub": c_ds.calls[0][0], "idct_sub": c_is.calls[0][0]}
    e_dct = check_dct(dct_mod, dct_in)
    dct_ms = {name: (cuda_ms(lambda f=getattr(dct_mod, name), x=x: f(x), 10),
                     cuda_ms(lambda f=getattr(dct_mod, name + "_plain"),
                             x=x: f(x), 10))
              for name, x in dct_in.items()}
    say(f"    DCT ms (kernel, twin) per call: {dct_ms}")
    for kern, inv in (("dct_lane", "idct_lane"), ("dct_sub", "idct_sub")):
        rows[kern] = dict(max_abs_err=e_dct[kern],
                          ms=(dct_ms[kern][0] + dct_ms[inv][0]) / 2,
                          plain_ms=(dct_ms[kern][1] + dct_ms[inv][1]) / 2)
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
    launches = {k: _build.launches[k] for k in PATH_KERNELS[4]}
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

    # ---- 5. the README's eager path
    path_launches = {4: launches}
    path_launches[5] = drive_path(
        5, "extract_displacement_field(img, ks)",
        lambda im, events=None: pipeline.extract_displacement_field(
            im, ks32, events=events),
        lambda im, events=None: pipeline.extract_displacement_field(
            im, ks32, deconvolve=True, events=events),
        img, img_d, u_true, ks32)
    if path_launches[5].get("zoom_sweep") != 3:
        raise RuntimeError("the eager path should run one zoom sweep per "
                           f"Bragg peak: {path_launches[5]}")

    # ---- 6. the README's factory at its defaults (exact CG)
    path_launches[6] = drive_path(
        6, "make_displacement_extractor((4096, 4096), ks) defaults",
        pipeline.make_displacement_extractor((SIZE, SIZE), ks32,
                                             device="cuda"),
        pipeline.make_displacement_extractor((SIZE, SIZE), ks32,
                                             deconvolve=True, device="cuda"),
        img, img_d, u_true, ks32)

    kernels = []
    for name, (src, rep) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep,
                        "launches": path_launches[PATH_OF[name]][name],
                        **rows[name]})
    say(card_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
