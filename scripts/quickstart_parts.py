#!/usr/bin/env python3
"""Where refine_ks's and iterate_GPA's time goes on one CUDA card:

    python3 scripts/quickstart_parts.py [--root DIR] [--reps N]

--root names the checkout whose pygpa_tpu_torch and chip_smoke.py are
measured (default: the one holding this script), for instance an
unpacked `git archive` of another commit, so that two commits run on one
card, one process each, in turns (parent, change, change, parent).

On the 4096^2 bench fixture of chip_smoke.py (the true ks offset by
(0.002, -0.001), sigma = ceil(1 / min |k|)) it runs iterate_GPA's loop
step by step, as gpa/reconstruct.py does: each round's lock-ins (three
gpa_lockin calls, the 5-px trim, angle, magnitude and the weight), the
exact unwrap (kmax 25, the last round's kmax 25 as refine_ks runs it or
200 as iterate_GPA does) and the batched plane fit, with CUDA events
between the steps. The corrections must equal iterate_GPA's bit for bit.
Each form runs twice (the first run includes cuFFT's planning); the
second run's milliseconds are printed per step and round. Then one
plane fit of the first round's unwrapped (3, 4086^2) phases is traced
(torch.profiler): its device ms, its kernels, and the device ms a step
(the fit's device time over its 61 steps), with its launches counted by
ops._build.launches. Then refine_ks and iterate_GPA whole: seconds a
call (host clock over --reps synchronized calls after a warm-up). Last,
the exact unwrap alone, 25 iterations on three planes, at the trimmed
4086^2 and untrimmed at 4096^2, with their DCT kernel launches.
"""
import argparse
import math
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFSET = np.array([0.002, -0.001])
EDGE, ITERS, KMAX_ITER = 5, 3, 25
FIT_ITERS = 60      # core.mathtools.fit_plane's IRLS steps after the first


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def loop_parts(img, kv, sigma, kmax_final):
    """iterate_GPA's loop with CUDA events between its steps: (corr,
    {step: [ms per round]})."""
    import torch
    from pygpa_tpu_torch.gpa import reconstruct
    from pygpa_tpu_torch.ops import lockin
    from pygpa_tpu_torch.solvers import unwrap
    corr = torch.zeros_like(kv)
    ms = {"lockin": [], "unwrap": [], "fit": []}
    for i in range(ITERS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        rs = lockin.gpa_lockin_batch(img, kv + corr, sigma,
                                     device=img.device)
        rs = rs[:, EDGE:-EDGE, EDGE:-EDGE]
        prs, w = torch.angle(rs), torch.abs(rs)
        wn = torch.sqrt(w / w.amax(dim=(-2, -1), keepdim=True))
        ev[1].record()
        kmax = KMAX_ITER if i < ITERS else kmax_final
        unwrapped = unwrap.phase_unwrap(prs, wn, kmax=kmax)
        ev[2].record()
        if i < ITERS:
            corr = corr - reconstruct.fit_delta_k(unwrapped)
        ev[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(ms, zip(ev, ev[1:])):
            ms[k].append(a.elapsed_time(b))
    ms["fit"] = ms["fit"][:ITERS]
    return corr, ms


def fit_trace(cs, phases):
    """(device ms of one fit_delta_k call on phases, device ms a step,
    {kernel: device ms}, fit_plane launches counted) from torch.profiler
    (chip_smoke.device_kernels, after a warm-up call)."""
    import torch
    from pygpa_tpu_torch.gpa import reconstruct
    from pygpa_tpu_torch.ops import _build
    by_name, _ = cs.device_kernels(lambda: reconstruct.fit_delta_k(phases))
    torch.cuda.synchronize()
    _build.launches.clear()
    reconstruct.fit_delta_k(phases)
    torch.cuda.synchronize()
    counted = _build.launches.get("fit_plane", 0)
    total = None if by_name is None else sum(by_name.values())
    step = None if total is None else total / (FIT_ITERS + 1)
    return total, step, by_name, counted


def call_seconds(fn, reps):
    """Seconds a call of fn() over `reps` synchronized calls (host clock)
    after a warm-up."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def unwrap_ms(psi, w, reps=2):
    """(ms per call, DCT kernel launches a call) of the exact unwrap,
    KMAX_ITER iterations, after a warm-up."""
    import torch
    from pygpa_tpu_torch.ops import _build
    from pygpa_tpu_torch.solvers import unwrap
    unwrap.phase_unwrap(psi, w, kmax=KMAX_ITER)
    torch.cuda.synchronize()
    _build.launches.clear()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        unwrap.phase_unwrap(psi, w, kmax=KMAX_ITER)
    b.record()
    torch.cuda.synchronize()
    dct = sum(_build.launches.get(k, 0) for k in ("dct_lane", "dct_sub"))
    return a.elapsed_time(b) / reps, dct // reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("quickstart_parts: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pygpa_tpu_torch.gpa import reconstruct
    from pygpa_tpu_torch.ops import _build
    from pygpa_tpu_torch.solvers import unwrap
    print(f"root {root}; card {card()}", flush=True)
    _build.load()
    ks, img, _, _ = chip_smoke.fixtures(torch)
    true = np.asarray(ks, np.float64)
    sigma = int(math.ceil(1 / np.linalg.norm(true, axis=1).min()))
    kv = torch.as_tensor(true + OFFSET, device=img.device).to(img.dtype)
    _, _, want = reconstruct.iterate_GPA(img, true + OFFSET, sigma,
                                         kmax=KMAX_ITER)
    for label, kmax_final in (("refine_ks", KMAX_ITER),
                              ("iterate_GPA", 200)):
        for run in (1, 2):
            corr, ms = loop_parts(img, kv, sigma, kmax_final)
        if not torch.equal(corr, want):
            raise RuntimeError("the step-by-step loop is not iterate_GPA's")
        total = sum(sum(v) for v in ms.values())
        print(f"{label} (final kmax {kmax_final}), second run, ms per round: "
              f"{ms}; sums lockin {sum(ms['lockin'])!r}, unwrap "
              f"{sum(ms['unwrap'])!r}, fit {sum(ms['fit'])!r}; all "
              f"{total!r} ms (CUDA events)")
    rs = reconstruct.gpa_lockin_batch(img, kv, sigma, device=img.device)
    rs = rs[:, EDGE:-EDGE, EDGE:-EDGE]
    w0 = torch.abs(rs)
    phases = unwrap.phase_unwrap(
        torch.angle(rs), torch.sqrt(w0 / w0.amax(dim=(-2, -1), keepdim=True)),
        kmax=KMAX_ITER)
    del rs, w0
    total, step, by_name, counted = fit_trace(chip_smoke, phases)
    print(f"plane fit of the first round's unwrapped phases "
          f"{tuple(phases.shape)}: device {total!r} ms a fit, {step!r} ms a "
          f"step ({FIT_ITERS + 1} steps), fit_plane launches counted "
          f"{counted}; device ms by kernel {by_name} (torch.profiler)")
    del phases
    pks = np.asarray(true + OFFSET)
    for label, fn in (("refine_ks", lambda: reconstruct.refine_ks(img, pks)),
                      ("iterate_GPA", lambda: reconstruct.iterate_GPA(
                          img, pks, sigma))):
        print(f"{label}(img, ks + {OFFSET.tolist()}): "
              f"{call_seconds(fn, args.reps)!r} s a call ({args.reps} "
              "synchronized calls after a warm-up, host clock)", flush=True)
    n = img.shape[-1]
    x = torch.arange(n, device=img.device, dtype=img.dtype)
    ramp = (0.021 * x[:, None] + 0.013 * x[None, :]) * (2 * math.pi)
    psi = torch.remainder(ramp + math.pi, 2 * math.pi).expand(3, n, n) \
        - math.pi
    w = torch.ones_like(psi)
    cut = (psi[:, EDGE:-EDGE, EDGE:-EDGE].contiguous(),
           w[:, EDGE:-EDGE, EDGE:-EDGE].contiguous())
    for label, operands in ((f"{n - 2 * EDGE}^2 (trimmed)", cut),
                            (f"{n}^2 (untrimmed)", (psi, w))):
        t, dct = unwrap_ms(*operands)
        print(f"exact unwrap, 3 planes, kmax {KMAX_ITER}, {label}: {t!r} ms "
              f"a call, {dct} DCT kernel launches a call (CUDA events, 2 "
              "calls after a warm-up)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
