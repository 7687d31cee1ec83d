#!/usr/bin/env python3
"""The exact unwrap's CG on one CUDA card, for comparing two commits:

    python3 scripts/cg_unwrap_parts.py bits [--root DIR]
    python3 scripts/cg_unwrap_parts.py paths [--root DIR] [--reps N]
    python3 scripts/cg_unwrap_parts.py quickstart [--root DIR] [--reps N]

--root names the checkout whose pygpa_tpu_torch and chip_smoke.py are
measured (default: the one holding this script), for instance an
unpacked `git archive` of another commit, so that two commits run on one
card, one process each, in turns.

bits: sha256 digests of the kernels the early-stopping CG must leave as
they were: the four DCT directions (ops.dct) on a seeded (2, 4096, 4096)
plane pair; cg_poisson on seeded aligned problems at (2, 1024, 1024)
kmax 6 (FFT route) and (2, 384, 640) kmax 4 (dense route) and on the
first call of the bench extractor (phase 4's coarse solve, made before
any early-stopping solve); the bench extractor's u with the
early-stopping kernel's gate off (solvers.unwrap.cg_unwrap_kernel_ok,
where the checkout has it), which is then the parent's path; and the
early-stopping kernel on its power-of-two (Stockham) passes: phi and k
of a seeded aligned (2, 4096, 4096) kmax 10 solve, and phase 5's u
(extract_displacement_field on the bench fixture).

paths: seconds per image (host clock over --reps synchronized runs after
a warm-up) and the stages of one more run (CUDA events, the "unwrap"
stages among them) of chip_smoke.py's phase 4 (the bench extractor),
phase 5 (extract_displacement_field), phase 6 (the factory at its
defaults), 9b (config 1's lattice at 500^2, unwrap_coarse=4) and 13d
(config 6, 8192^2), the CG kernel launches of one run, and each
early-stopping solve of that run alone (shape, kmax, whether the
checkout's unwrap_fft_route takes it, ms a call by CUDA events over
--reps calls, its k per plane and its bound, as chip_smoke.py's phase 3
computes it). One JSON line each, after the card's name and power
limit.

quickstart: chip_smoke.py's phase 12b (refine_ks from the sub-bin peaks
of the bench fixture) and 12d (iterate_GPA from the true ks + its
offset): seconds per call (host clock over --reps synchronized calls
after a warm-up) and the kernel launches of one call; then 12b's first
early-stopping solve, (3, 4086, 4086) kmax 25, alone: ms a call (CUDA
events over --reps calls), its k per plane, its bound and its device ms
per kernel (torch.profiler).
"""
import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sha(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def seeded(torch, shape, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.normal(size=shape).astype(np.float32)).cuda()


def aligned_problem(torch, B, n, m, seed):
    """The aligned residual and weights of random gradients and a weight
    with a 1e-6 rim (chip_smoke.dense_cg_call's recipe)."""
    from pygpa_tpu_torch.solvers.unwrap import _residual_aligned
    dxp, dyp = seeded(torch, (B, n, m), seed), seeded(torch, (B, n, m),
                                                     seed + 1)
    dxp[..., -1] = 0
    dyp[..., -1, :] = 0
    w = np.random.default_rng(seed + 2).uniform(0.05, 1.0, size=(n, m))
    w[:8] = w[-8:] = w[:, :8] = w[:, -8:] = 1e-6
    rk, WWx, WWy = _residual_aligned(dxp, dyp, torch.from_numpy(
        w.astype(np.float32)).cuda())
    return rk, WWx, WWy


def bits(torch, cs):
    from pygpa_tpu_torch.gpa import pipeline
    from pygpa_tpu_torch.ops import cg, dct
    from pygpa_tpu_torch.solvers import unwrap
    out = {}
    x = seeded(torch, (2, 4096, 4096), 1)
    for name in ("dct_lane", "idct_lane", "dct_sub", "idct_sub"):
        out[name] = sha(getattr(dct, name)(x))
    for B, n, m, kmax, seed in ((2, 1024, 1024, 6, 3), (2, 384, 640, 4, 5)):
        a = aligned_problem(torch, B, n, m, seed)
        out[f"cg_poisson {(B, n, m)} kmax {kmax}"] = sha(
            cg.cg_poisson(*a, kmax))
    ks, img, _, _ = cs.fixtures(torch)
    fn = pipeline.make_displacement_extractor(
        (cs.SIZE, cs.SIZE), ks, chunk=4, unwrap_coarse=4, device="cuda")
    calls = []
    real = unwrap._cg.cg_poisson

    def rec(*a):
        calls.append(a)
        return real(*a)
    unwrap._cg.cg_poisson = rec
    try:
        fn(img)
    finally:
        unwrap._cg.cg_poisson = real
    out["cg_poisson phase 4 coarse solve"] = sha(cg.cg_poisson(*calls[0]))
    gate = getattr(unwrap, "cg_unwrap_kernel_ok", None)
    if gate is not None:
        unwrap.cg_unwrap_kernel_ok = lambda *a: False
    try:
        out["phase 4 u, early-stopping kernel off"] = sha(fn(img))
    finally:
        if gate is not None:
            unwrap.cg_unwrap_kernel_ok = gate
    a = aligned_problem(torch, 2, 4096, 4096, 7)
    phi, k = cg.cg_unwrap(*a, 10, True)
    out["cg_unwrap (2, 4096, 4096) kmax 10 phi"] = sha(phi)
    out["cg_unwrap (2, 4096, 4096) kmax 10 k"] = sha(k)
    out["phase 5 u"] = sha(pipeline.extract_displacement_field(
        img, cs.KS_BENCH_F32))
    torch.cuda.synchronize()
    for k, v in out.items():
        print(json.dumps({"bits": k, "sha256": v}), flush=True)


def solve_bound(cs, args, phi, k):
    """[ms, what sets it]: chip_smoke.py's bound of an early-stopping
    solve from its inputs (rk0, WWx, WWy read once, phi written once) and
    the work its data needed (each plane's own iterations of an FFT-form
    2D DCT pair and the stencil, 5 log2(nm) + 12 operations an element)."""
    n, m = args[0].shape[-2:]
    work = float(k.sum()) * n * m * (5 * np.log2(n * m) + 12)
    return list(cs.bound(cs.tensor_bytes(*args[:3], phi), work))


def stages_of(torch, call):
    events = []
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    call(events)
    torch.cuda.synchronize()
    st, prev = {}, start
    for name, ev in events:
        st[name] = prev.elapsed_time(ev)
        prev = ev
    return st


def paths(torch, cs, reps):
    from pygpa_tpu_torch.gpa import pipeline
    from pygpa_tpu_torch.lattices import generate_ks, hexlattice_gen
    from pygpa_tpu_torch.ops import _build, cg
    from pygpa_tpu_torch.solvers import unwrap
    ks, img, _, _ = cs.fixtures(torch)
    ks32 = cs.KS_BENCH_F32
    size6 = 2 * cs.SIZE
    ks6 = generate_ks(cs.R_K, cs.THETA, kappa=cs.KAPPA, psi=cs.PSI)[:3]
    img6 = hexlattice_gen(cs.R_K, cs.THETA, order=2, size=size6,
                          kappa=cs.KAPPA, psi=cs.PSI, dtype=torch.float32,
                          device="cuda")
    runs = {
        "4": (pipeline.make_displacement_extractor(
            (cs.SIZE, cs.SIZE), ks, chunk=4, unwrap_coarse=4,
            device="cuda"), img),
        "5": (lambda im, events=None: pipeline.extract_displacement_field(
            im, ks32, events=events), img),
        "6": (pipeline.make_displacement_extractor(
            (cs.SIZE, cs.SIZE), ks32, device="cuda"), img),
        "9b": (pipeline.make_displacement_extractor(
            (500, 500), generate_ks(0.1, 7.0)[:3], unwrap_coarse=4,
            device="cuda"), hexlattice_gen(0.1, 7.0, order=2, size=500,
                                           dtype=torch.float32,
                                           device="cuda")),
        "13d": (pipeline.make_displacement_extractor(
            (size6, size6), ks6, chunk=4, unwrap_coarse=4, device="cuda"),
            img6),
    }
    for label, (fn, im) in runs.items():
        fn(im)
        torch.cuda.synchronize()
        _build.launches.clear()
        with cs.Capture(unwrap._cg, "cg_unwrap") as c:
            fn(im)
            torch.cuda.synchronize()
        launches = {k: v for k, v in _build.launches.items()
                    if k.startswith(("cg_", "dct_"))}
        solves = []
        for a in c.calls:
            phi, k = cg.cg_unwrap(*a[:5])
            solves.append({
                "shape": list(a[0].shape), "kmax": int(a[3]),
                "fft_route": cg.unwrap_fft_route(*a[0].shape[-2:]),
                "ms": cs.cuda_ms(lambda a=a: cg.cg_unwrap(*a[:5]), reps),
                "k": k.flatten().tolist(),
                "bound_ms": solve_bound(cs, a, phi, k)})
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(im)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        st = stages_of(torch, lambda ev, fn=fn, im=im: fn(im, events=ev))
        print(json.dumps({"path": label, "seconds_per_image": dt,
                          "reps": reps, "stages_ms": st,
                          "cg_and_dct_launches": launches,
                          "early_stopping_solves": solves}), flush=True)


def quickstart(torch, cs, reps):
    import pygpa_tpu_torch as gt
    from pygpa_tpu_torch.ops import _build, cg
    from pygpa_tpu_torch.solvers import unwrap
    ks, img, _, _ = cs.fixtures(torch)
    true = np.asarray(ks, np.float64)
    pks_s, _ = gt.gpa.extract_primary_ks(img, DoG=False, subpixel=True)
    _, pks3 = cs.to_true(gt.gpa.select_closest_to_triangle(pks_s)
                         if len(pks_s) > 3 else pks_s, true)
    sig = int(np.ceil(1 / np.linalg.norm(true, axis=1).min()))
    runs = {"12b refine_ks": lambda: gt.gpa.refine_ks(img, pks3),
            "12d iterate_GPA": lambda: gt.gpa.iterate_GPA(
                img, true + cs.ITERATE_OFFSET, sig)}
    for label, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        _build.launches.clear()
        fn()
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        print(json.dumps({"path": label, "seconds_per_call": dt,
                          "reps": reps, "launches": launches}), flush=True)
    with cs.Capture(unwrap._cg, "cg_unwrap", keep=1) as c:
        gt.gpa.refine_ks(img, pks3)
        torch.cuda.synchronize()
    args = c.calls[0][:5]
    ms = cs.cuda_ms(lambda: cg.cg_unwrap(*args), reps)
    phi, k = cg.cg_unwrap(*args)
    by_kernel, count = cs.device_kernels(lambda: cg.cg_unwrap(*args))
    print(json.dumps({"solve": list(args[0].shape), "kmax": int(args[3]),
                      "aligned": bool(args[4]), "ms": ms, "reps": reps,
                      "k": k.flatten().tolist(),
                      "bound_ms": solve_bound(cs, args, phi, k),
                      "kernels_a_call": count,
                      "device_ms_per_kernel": by_kernel}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("bits", "paths", "quickstart"))
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("cg_unwrap_parts: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pygpa_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"root {root}; card {cs.card_line()}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds!r} s)", flush=True)
    if args.mode == "bits":
        bits(torch, cs)
    elif args.mode == "paths":
        paths(torch, cs, args.reps)
    else:
        quickstart(torch, cs, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
