#!/usr/bin/env python3
"""Stage 2 of both WFR sweeps (the tensor-core products and the |M|^2
tournament), timed apart on one CUDA card on the inputs the paths hand
it:

    python3 scripts/stage2_parts.py [--root DIR] [--reps N]

--root names the checkout whose pygpa_tpu_torch and chip_smoke.py are
measured (default: the one holding this script), for instance an
unpacked `git archive` of another commit, so that two commits are
compared on one card, one process each, in turns.

Rows (chip_smoke.py's fixtures):
  1   the bench extractor's grouped sweep (phase 3's sweep_uv inputs),
      the phase/weight tournament ``ops.sweep.stage2``;
  5   the eager path's zoom sweeps (phase 3's three peaks), the plain
      tournament ``ops.zoom_sweep.stage2``;
  5b  the zoom tournament of config 2g's per-peak gradient path (10a);
  1b  config 2g's grouped gradient path (10b): the phase/weight
      tournament (a) and the one that stores the winners (b).
Each is timed with CUDA events after a warm-up call (ms per call, all
its launches), the stage-2 kernel's device time from torch.profiler
beside it, its TF32 tensor-core rate (three TF32 products a float32
one: 3 * 8 P n m K FLOP) and its share of the 3xTF32 bound at 495
TFLOP/s; the sha256 of its outputs lets two commits' bits be compared.
One JSON line per row, after the card's name and power limit and
ptxas's registers and spills of the stage-2 kernels.
"""
import argparse
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TF32_FLOP_S = 495e12


def sha(planes):
    """sha256 of the planes' bytes, in order."""
    h = hashlib.sha256()
    for p in planes:
        h.update(p.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("stage2_parts: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pygpa_tpu_torch.gpa import pipeline
    from pygpa_tpu_torch.ops import _build
    from pygpa_tpu_torch.ops import sweep as sw
    from pygpa_tpu_torch.ops import wfr
    from pygpa_tpu_torch.ops import zoom_sweep as zs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    _build.load()
    for key in ("zoom_stage2_kernel", "grouped_stage2_kernel"):
        print(f"ptxas {key}: {cs.ptxas_lines(_build.build_log, key)}",
              flush=True)
    print(f"root {root}", flush=True)

    def row(label, fn, kernel, flops2, **info):
        fn()
        ms = cs.cuda_ms(fn, args.reps)
        by, _ = cs.device_kernels(fn, args.reps)
        k_ms = cs.kernel_ms(by, kernel)
        bound = 3 * flops2 / TF32_FLOP_S * 1e3
        t = k_ms or ms
        rec = {"row": label, **info, "ms": ms, "kernel_ms": k_ms,
               "device_ms": by, "tf32_tflop_s": 3 * flops2 / t / 1e9,
               "bound_ms": bound, "share_of_bound": bound / t,
               "sha256": sha(fn())}
        print(json.dumps(rec), flush=True)

    ks, img, _, _ = cs.fixtures(torch)
    fn = pipeline.make_displacement_extractor(
        (cs.SIZE, cs.SIZE), ks, chunk=4, unwrap_coarse=4, device="cuda")
    with cs.Capture(wfr._sweep, "sweep_uv", keep=1) as c_sw:
        fn(img)
        torch.cuda.synchronize()
    del fn
    a = c_sw.calls[0]
    G, P, W0 = a[2].shape
    n, m, Wb = a[4].shape[1], a[6].shape[1], a[6].shape[2]
    T = sw.stage1(*a[:6], a[8])
    row("1", lambda: sw.stage2(T, a[6], a[7], a[9], a[11], a[12]),
        "grouped_stage2_kernel", 8 * G * P * n * m * Wb, G=G, P=P, Wb=Wb)
    del T, c_sw, a

    with cs.Capture(wfr._zoom, "zoom_sweep") as c_zs:
        pipeline.extract_displacement_field(img, cs.KS_BENCH_F32)
        torch.cuda.synchronize()
    for a in c_zs.calls:
        P, W1, n, m = a[2].shape[0], a[0].shape[1], a[4].shape[0], \
            a[6].shape[0]
        T = zs.stage1(*a[:6])
        row("5", lambda: zs.stage2(T, a[6], a[7], None),
            "zoom_stage2_kernel", 8 * P * n * m * W1, P=P, W1=W1)
        del T
    del c_zs

    step32, _ = cs.config2g_step(cs.KS_BENCH_F32)
    step64, _ = cs.config2g_step(np.asarray(ks, np.float64))
    with cs.Capture(wfr._zoom, "zoom_sweep") as c_zg:
        step32(img)
        torch.cuda.synchronize()
    with cs.Capture(wfr._sweep, "sweep_grad") as c_sg:
        step64(img)
        torch.cuda.synchronize()
    del step32, step64
    for a in c_zg.calls:
        P, W1, n, m = a[2].shape[0], a[0].shape[1], a[4].shape[0], \
            a[6].shape[0]
        T = zs.stage1(*a[:6])
        row("5b", lambda: zs.stage2(T, a[6], a[7], None),
            "zoom_stage2_kernel", 8 * P * n * m * W1, P=P, W1=W1)
        del T
    (Sr, Si, _, _, gx, gy, A0c, A0s, A1c, A1s, _, _, run, off, dr,
     banded) = c_sg.calls[0]
    G, P, _ = gx.shape
    n, m, Wb = A0c.shape[1], A1c.shape[1], A1c.shape[2]
    T = sw.stage1(Sr, Si, gx, gy, A0c, A0s, run)
    f2 = 8 * G * P * n * m * Wb
    row("1b (a)", lambda: sw.stage2(T, A1c, A1s, off, dr, banded),
        "grouped_stage2_kernel", f2, G=G, P=P, Wb=Wb, banded=bool(banded))
    row("1b (b)", lambda: sw.stage2(T, A1c, A1s, off, dr, banded,
                                    winners=True),
        "grouped_stage2_kernel", f2, G=G, P=P, Wb=Wb, banded=bool(banded))
    return 0


if __name__ == "__main__":
    sys.exit(main())
