#!/usr/bin/env python3
"""Which stage of the grouped sweep's rounding moves the bench extractor's
path, on one CUDA card:

    python3 scripts/sweep_stage_paths.py

Runs make_displacement_extractor((4096, 4096), ks, chunk=4,
unwrap_coarse=4) on chip_smoke.py's bench fixture with the grouped
sweep composed from its CUDA stages or its plain float32 twin's (stage 1
in float32 FMA or cuBLAS, stage 2 on the tensor cores or cuBLAS; the uv
epilogue is the kernel's in all four), every other kernel as built, and
prints each path's interior p99 and max distance (px, chip_smoke.py's
border) to the path with the sweep computed in float64.
"""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from pygpa_tpu_torch.gpa import pipeline  # noqa: E402
from pygpa_tpu_torch.ops import sweep as sw  # noqa: E402


def composed(kernel_stage1, kernel_stage2):
    """A sweep_uv of the chosen stages (kernel or float32 twin)."""
    def sweep(*a):
        if kernel_stage1:
            T = sw.stage1(*a[:6], a[8])
        else:
            T = sw._stage1_plain(*a[:6], a[8]).contiguous()
        if kernel_stage2:
            ph, wt = sw.stage2(T, a[6], a[7], a[9], a[11], a[12])
        else:
            ph, wt = sw._stage2_plain(T, a[6], a[7], a[9], int(a[11]),
                                      bool(a[12]))
        return sw.epilogue(ph.contiguous(), wt.contiguous(), a[10])
    return sweep


def main():
    if not torch.cuda.is_available():
        print("sweep_stage_paths: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    ks, img, _, _ = cs.fixtures(torch)
    fn = pipeline.make_displacement_extractor(
        (cs.SIZE, cs.SIZE), ks, chunk=4, unwrap_coarse=4, device="cuda")
    with cs.float64_sweep():
        u64 = fn(img)
    real = sw.sweep_uv
    try:
        for k1 in (True, False):
            for k2 in (True, False):
                sw.sweep_uv = composed(k1, k2)
                p99, dmax = cs.interior_dist(fn(img), u64, ks)
                print(f"stage 1 {'kernel' if k1 else 'twin'}, stage 2 "
                      f"{'kernel' if k2 else 'twin'}: interior p99 {p99!r} "
                      f"max {dmax!r} px from the float64-sweep path")
    finally:
        sw.sweep_uv = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
