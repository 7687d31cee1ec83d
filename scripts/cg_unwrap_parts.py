#!/usr/bin/env python3
"""The exact unwrap's CG on one CUDA card, for comparing two commits:

    python3 scripts/cg_unwrap_parts.py bits [--root DIR]
    python3 scripts/cg_unwrap_parts.py paths [--root DIR] [--reps N]

--root names the checkout whose pygpa_tpu_torch and chip_smoke.py are
measured (default: the one holding this script), for instance an
unpacked `git archive` of another commit, so that two commits run on one
card, one process each, in turns.

bits: sha256 digests of the kernels the early-stopping CG must leave as
they were: the four DCT directions (ops.dct) on a seeded (2, 4096, 4096)
plane pair; cg_poisson on seeded aligned problems at (2, 1024, 1024)
kmax 6 (FFT route) and (2, 384, 640) kmax 4 (dense route) and on the
first call of the bench extractor (phase 4's coarse solve, made before
any early-stopping solve); and the bench extractor's u with the
early-stopping kernel's gate off (solvers.unwrap.cg_unwrap_kernel_ok,
where the checkout has it), which is then the parent's path.

paths: seconds per image (host clock over --reps synchronized runs after
a warm-up) and the stages of one more run (CUDA events, the "unwrap"
stages among them) of chip_smoke.py's phase 4 (the bench extractor),
phase 5 (extract_displacement_field), phase 6 (the factory at its
defaults) and 13d (config 6, 8192^2), and the CG kernel launches of one
run. One JSON line each, after the card's name and power limit.
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
    torch.cuda.synchronize()
    for k, v in out.items():
        print(json.dumps({"bits": k, "sha256": v}), flush=True)


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
    from pygpa_tpu_torch.ops import _build
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
        "13d": (pipeline.make_displacement_extractor(
            (size6, size6), ks6, chunk=4, unwrap_coarse=4, device="cuda"),
            img6),
    }
    for label, (fn, im) in runs.items():
        fn(im)
        torch.cuda.synchronize()
        _build.launches.clear()
        fn(im)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.launches.items()
                    if k.startswith(("cg_", "dct_"))}
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(im)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        st = stages_of(torch, lambda ev, fn=fn, im=im: fn(im, events=ev))
        print(json.dumps({"path": label, "seconds_per_image": dt,
                          "reps": reps, "stages_ms": st,
                          "cg_and_dct_launches": launches}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("bits", "paths"))
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
    else:
        paths(torch, cs, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
