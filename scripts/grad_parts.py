#!/usr/bin/env python3
"""The parts of both sweeps' gradient emissions, timed apart on one CUDA
card, on the inputs config 2g's paths hand them (chip_smoke.py phase 10:
10a, one zoom sweep per Bragg peak with float32 k-vectors; 10b, one
grouped sweep with float64 ones):

    python3 scripts/grad_parts.py [--root DIR] [--reps N]

--root names the checkout whose pygpa_tpu_torch and chip_smoke.py are
measured (default: the one holding this script), for instance an
unpacked `git archive` of another commit, so that two commits are
compared on one card, one process each.

Each part is timed with CUDA events after a warm-up call (ms): the
whole emission call; stage 1 of T; stage 1 of Tx on every candidate;
the tournament alone (the plain launch: the zoom sweep's, the grouped
sweep's phase/weight emission) and, for the grouped sweep, the
tournament that stores the winners; the band flags, stage 1 of Tx on
the flagged (band, candidate) pairs and the winner products. Counts:
the distinct winning candidates of each 64-row band and of each 64 x 64
tile, from the tournament's index plane. Also the peak device memory of
one emission call and of one config 2g step of each path, and the
sha256 of the emission's outputs (tournament or phase/weight planes;
gradients), so that two commits' bits can be compared. One JSON line
per path, after the card's name and power limit and ptxas's registers
and spills of the sweeps' kernels.
"""
import argparse
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def band_counts(idx, P):
    """Distinct winners of each 64-row band of the (G, n, m) index
    plane: the flagged (band, candidate) pairs, their mean and maximum
    per band, and the number of bands."""
    import torch
    G, n, m = idx.shape
    seen = torch.zeros((G, n // 64, P), dtype=torch.bool, device=idx.device)
    seen.scatter_(2, idx.long().reshape(G, n // 64, 64 * m), True)
    per = seen.sum(-1).double()
    return {"flagged_pairs": int(seen.sum()), "bands": G * (n // 64),
            "band_winners_mean": float(per.mean()),
            "band_winners_max": int(per.max())}


def sha(planes):
    """sha256 of the planes' bytes, in order."""
    h = hashlib.sha256()
    for p in planes:
        h.update(p.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def peak_gib(torch, fn):
    """Peak device GiB allocated during one call of fn()."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("grad_parts: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pygpa_tpu_torch.ops import sweep as sw
    from pygpa_tpu_torch.ops import wfr
    from pygpa_tpu_torch.ops import zoom_sweep as zs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    from pygpa_tpu_torch.ops import _build
    _build.load()
    for key in ("stage2_kernel", "stage1_kernel", "winner_products_kernel"):
        print(f"ptxas {key}: {cs.ptxas_lines(_build.build_log, key)}",
              flush=True)
    print(f"root {root}", flush=True)

    def ms(fn):
        return cs.cuda_ms(fn, args.reps)

    ks, img, _, _ = cs.fixtures(torch)
    step32, _ = cs.config2g_step(cs.KS_BENCH_F32)
    step64, _ = cs.config2g_step(np.asarray(ks, np.float64))
    with cs.Capture(wfr._zoom, "zoom_sweep") as cz:
        step32(img)
        torch.cuda.synchronize()
    with cs.Capture(wfr._sweep, "sweep_grad") as cg:
        step64(img)
        torch.cuda.synchronize()
    paths = {"10a": peak_gib(torch, lambda: step32(img)),
             "10b": peak_gib(torch, lambda: step64(img))}
    print(f"peak GiB of one config 2g step above its inputs: "
          f"{json.dumps(paths)}", flush=True)
    del step32, step64

    # 10a: per peak
    for a, kw in zip(cz.calls, cz.kws):
        S2r, S2i, A1yc, A1ys = gops = kw["grad_ops"]
        Sr, Si, gx, gy, A0c, A0s, A1c, A1s = a
        (W0, W1), P = Sr.shape, gx.shape[0]
        n, m = A0c.shape[0], A1c.shape[0]
        T = zs.stage1(*a[:6])
        t = {"call": ms(lambda: zs.zoom_sweep(*a, grad_ops=gops)),
             "stage1_T": ms(lambda: zs.stage1(*a[:6])),
             "stage1_Tx_full": ms(lambda: zs.stage1(S2r, S2i, gx, gy, A0c,
                                                    A0s)),
             "tournament": ms(lambda: zs.stage2(T, A1c, A1s, None))}
        _, mr, mi, idx = zs.stage2(T, A1c, A1s, None)
        one = [x[None] for x in (S2r, S2i, gx, gy, A0c, A0s)]
        run = torch.zeros((1, P), dtype=torch.int32, device=Sr.device)
        flags = sw.band_winners(idx[None], P)
        t["band_flags"] = ms(lambda: sw.band_winners(idx[None], P))
        t["stage1_Tx_flagged"] = ms(lambda: sw.stage1(
            one[0][:, None], one[1][:, None], *one[2:], run, flags))
        Tx = sw.stage1(one[0][:, None], one[1][:, None], *one[2:], run,
                       flags)
        basis = [x[None] for x in (A1c, A1s, A1yc, A1ys)]
        t["products"] = ms(lambda: sw.winner_products(
            T[None], Tx, *basis, mr[None], mi[None], idx[None], flags,
            None, False, False))
        del Tx, T
        out = zs.zoom_sweep(*a, grad_ops=gops)
        rec = {"path": "10a", "P": P, "W0": W0, "W1": W1, "ms": t,
               "sha256_tournament": sha(out[:4]),
               "sha256_grads": sha(out[4:6]),
               **band_counts(idx[None], P),
               "tile_winners": cs.tile_winners(idx, P),
               "tiles": n * m // 4096,
               "peak_gib": peak_gib(torch, lambda: zs.zoom_sweep(
                   *a, grad_ops=gops))}
        print(json.dumps(rec), flush=True)
        del mr, mi, idx

    # 10b: the grouped sweep
    (Sr, Si, S2r, S2i, gx, gy, A0c, A0s, A1c, A1s, A1yc, A1ys, run, off,
     dr, banded) = g = cg.calls[0]
    G, P, W0 = gx.shape
    n, m, Wb = A0c.shape[1], A1c.shape[1], A1c.shape[2]
    T = sw.stage1(Sr, Si, gx, gy, A0c, A0s, run)
    t = {"call": ms(lambda: sw.sweep_grad(*g)),
         "stage1_T": ms(lambda: sw.stage1(Sr, Si, gx, gy, A0c, A0s, run)),
         "stage1_Tx_full": ms(lambda: sw.stage1(S2r, S2i, gx, gy, A0c, A0s,
                                                run)),
         "tournament": ms(lambda: sw.stage2(T, A1c, A1s, off, dr, banded))}
    out = sw.stage2(T, A1c, A1s, off, dr, banded, winners=True)
    mr, mi, idx = out[2:]
    t["tournament_winners"] = ms(lambda: sw.stage2(
        T, A1c, A1s, off, dr, banded, winners=True))
    flags = sw.band_winners(idx, P)
    t["band_flags"] = ms(lambda: sw.band_winners(idx, P))
    t["stage1_Tx_flagged"] = ms(lambda: sw.stage1(
        S2r, S2i, gx, gy, A0c, A0s, run, flags))
    Tx = sw.stage1(S2r, S2i, gx, gy, A0c, A0s, run, flags)
    t["products"] = ms(lambda: sw.winner_products(
        T, Tx, A1c, A1s, A1yc, A1ys, mr, mi, idx, flags, off, banded, True))
    del Tx, out, mr, mi, T
    out = sw.sweep_grad(*g)
    rec = {"path": "10b", "G": G, "P": P, "W0": W0, "Wb": Wb,
           "banded": bool(banded), "ms": t,
           "sha256_phase_weight": sha(out[:2]), "sha256_grads": sha(out[2:]),
           **band_counts(idx, P),
           "tile_winners": sum(cs.tile_winners(idx[k], P) for k in range(G)),
           "tiles": G * n * m // 4096,
           "peak_gib": peak_gib(torch, lambda: sw.sweep_grad(*g))}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
