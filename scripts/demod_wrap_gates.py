#!/usr/bin/env python3
"""The bench's three gates for the demodulated reconstruction with each
of the two wraps of its phase differences, on one CUDA card:

    python3 scripts/demod_wrap_gates.py

Builds make_displacement_extractor((4096, 4096), ks) on chip_smoke.py's
bench fixture (its float32 k-vectors) with pipeline_fused_uv=False (the
grouped sweep's phase/weight emission, then
gpa.reconstruct.reconstruct_u_inv_from_demod), at the defaults (exact
CG) and with unwrap_coarse=4, once with the reference's (x + pi) mod
2 pi - pi wrap and once with ops.sweep.wrap_diff, the form the port
uses; the uv route (pipeline_fused_uv=True) is printed beside them.
Each line: interior max |u|, its dc-free form, and the deformed
fixture's dc-free error after deconvolution (px).
"""
import dataclasses
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from pygpa_tpu_torch.core.mathtools import wrap_to_pi  # noqa: E402
from pygpa_tpu_torch.gpa import pipeline, reconstruct  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("demod_wrap_gates: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    _, img, img_d, u_true = cs.fixtures(torch)
    ks = cs.KS_BENCH_F32
    real_defaults, real_wrap = pipeline.DEFAULTS, reconstruct.wrap_diff
    runs = [(True, "uv epilogue")] + [(False, w) for w in ("wrap_to_pi",
                                                           "wrap_diff")]
    try:
        for fused, wrap in runs:
            pipeline.DEFAULTS = dataclasses.replace(
                real_defaults, pipeline_fused_uv=fused)
            reconstruct.wrap_diff = wrap_to_pi if wrap == "wrap_to_pi" \
                else real_wrap
            for kw in ({}, {"unwrap_coarse": 4}):
                fn, fn_d = (pipeline.make_displacement_extractor(
                    (cs.SIZE, cs.SIZE), ks, device="cuda", deconvolve=d,
                    **kw) for d in (False, True))
                g = cs.gate_values(fn(img), fn_d(img_d), u_true, ks)
                print(f"pipeline_fused_uv={fused} wrap={wrap} {kw}: "
                      f"interior {g[0]!r} dc-free {g[1]!r} deformed "
                      f"{g[2]!r} px (gates {cs.GATE_INTERIOR}, "
                      f"{cs.GATE_DCFREE}, {cs.GATE_DEFORMED})", flush=True)
    finally:
        pipeline.DEFAULTS, reconstruct.wrap_diff = real_defaults, real_wrap
    return 0


if __name__ == "__main__":
    sys.exit(main())
