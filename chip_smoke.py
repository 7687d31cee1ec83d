#!/usr/bin/env python3
"""End-to-end check of pygpa_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   TF32 switched off for matmuls and cuDNN;
2. the build of the CUDA kernels (csrc/*.cu, nvcc, timed), ptxas's
   registers and spills of the sweeps' kernels (both stage 2s, stage
   1, the gradient emissions' band flags and winner products; the
   phase fails if one spills), the bilinear and displacement-form cubic
   warps, the CG's fused DCT passes and stencil kernel and the
   drizzle's shared-memory kernel, the proof that both stage 2s run on
   Hopper's warpgroup wgmma (HGMMA instructions in their SASS and no
   HMMA, cuobjdump -sass) and the winner products on mma.sync (HMMA),
   and that the drizzle's shared-memory
   adds are native ATOMS.ADD, not a compare-and-swap loop, or the phase
   fails;
3. each kernel against its plain PyTorch twin on the card, on the
   inputs the 4096^2 paths hand it (captured from one run of each),
   with the error bound stated beside the check and both times from
   CUDA events after warm-up;
4. the bench extractor itself: make_displacement_extractor((4096,
   4096), ks, chunk=4, unwrap_coarse=4, device="cuda") on the bench
   fixture (r_k 0.02, theta 5 deg, kappa 1.005, psi 10 deg, order 2)
   and on the Gaussian-envelope deformed fixture, held to the bench's
   three accuracy gates (interior < 0.002 px, dc-free < 0.0012 px,
   deformed < 0.075 px after gaussian_deconvolve, its margin printed)
   and to the path with a float64 grouped sweep (interior p99 < 5e-4
   px, max < 1e-2 px; the path with the sweep's float32 twin, the other
   kernels as built, printed beside it); launch
   counters reset just before and read just after show that every
   kernel ran; seconds per image and Mpix/s over 5 runs after warm-up,
   per-stage CUDA-event times and peak device memory;
5. the README's eager path, extract_displacement_field(img, ks) on the
   same fixture (one zoom sweep per Bragg peak, the exact CG on the
   early-stopping CG kernel), and
6. the README's factory at its defaults,
   make_displacement_extractor((4096, 4096), ks, device="cuda") (the
   grouped sweep, then the exact CG on the early-stopping kernel);
   each with its launch counts, the whole path against the same path
   on the plain twins (max < 1e-2 px: near-tie winner flips) and, since
   the sweep kernels sum more accurately than their float32 twins,
   against the path with that sweep computed in float64 (interior p99
   < 5e-4 px and no further than the twins' own path, max < 1e-2 px;
   the float64 path's own interior maxima printed), the bench's three
   gates, seconds per image over 3 runs after warm-up, per-stage
   CUDA-event times and peak device memory.

7. the README's undistortion, two runs: (a) config 3 of
   benchmarks/run_all.py as it builds it (2048^2,
   phase_unwrap_mg(psi, |img|) and undistort_image(img, u, coarse=4)),
   held to its three gates (unwrap p99 < 0.02 rad, max < 0.3 rad,
   undistort rel rms < 0.05) and to 20 bilinear launches, and (b) the
   default undistort_image(img_d, u_true) (coarse 1, order 3) on the 4096^2
   deformed fixture against the clean lattice, rel rms < 0.05 on the
   128-px interior, and to 37 cubic launches (36 Picard steps, one
   final warp);
8. the README's unit cell, two runs: (a) config 4 (unit_cell_average
   with only_generate_func at z = 2, then expand_unitcell at 4096^2),
   and (b) the same calls on the deformed fixture with u = u_true, each
   held to ucell_roundtrip_rel_rms < 0.05 on the 128-px interior;
   each run with its launch counts, the whole path against the same path
   on the plain twins (max |delta| / max |ref| < 1e-4), seconds per call
   after a warm-up and peak device memory;
9. two short extractor runs on config 1's lattice (r_k 0.1, theta 7
   deg): at 2048^2 with the defaults (the grouped sweep at Wb = 448)
   and at 500^2 with unwrap_coarse=4 (the multigrid's V-branch on its
   twins), each held to finite output, config 1's gate (interior max
   |u| < 0.02 px) and its plain versions' path;
10. config 2g of benchmarks/run_all.py (adaptive-GPA property maps from
   the winner phase gradients, 4096^2) as it builds it, twice: (a) with
   the k-vectors in float32 (KS_BENCH_F32: banks of 42, 49 and 36
   candidates, so the grouped gate fails and each peak runs the zoom
   sweep's gradient emission: 3 "zoom_grad" launches, no grouped one)
   and (b) in float64 (42 candidates each: one grouped launch with the
   gradient emission, "sweep_grad", banded at Wb = 192); each held to
   config 2g's gates on the 4 sigma interior (max |theta - theta_0| <
   0.01 deg, max |kappa - 1.005| < 0.001), to the same path on the plain
   twins (a tenth of each gate: 1e-3 deg, 1e-4), seconds per call over 3
   runs after warm-up and peak device memory;
11. (a) extract_displacement_field(img, ks, with_grad=True,
   return_gs=True): 3 "zoom_grad" launches, finite gradients, u the
   same bits as without with_grad, the bench's three gates; (b) the
   factory at its defaults with pipeline_fused_uv=False: the grouped
   phase/weight emission ("sweep_pw", one launch) and the demodulated
   reconstruction, held to the bench's three gates, with its distance
   from the uv route's u printed;
12. the README quick start from the raw 4096^2 bench image: (a)
   gt.gpa.extract_primary_ks(img) at its defaults (three primary ks,
   each a true k up to sign within 1.5/size, the same canonical sets as
   the call with device="cpu", atol 1e-9; the bytes each attempt
   fetches to the host; seconds per call over 3 runs); (b)
   extract_primary_ks(img, DoG=False, subpixel=True) within 0.5/size,
   then refine_ks on those ks (sign-aligned and ordered to the true
   ones) within 0.15/size, with no DCT kernel launch (iterate_GPA trims
   5 px, so its unwraps run at 4086^2, on cg_unwrap's chirp-z passes,
   and its plane fits on fit_plane, both launched in the counted run);
   its seconds per call (the first and the second) and how far the
   refined ks lie from refine_ks on the fit's twin; (c)
   extract_displacement_field from the refined ks against phase 5's u
   from the true ks: each component's least-squares plane removed on
   the 8 sigma interior (a k error is a uniform strain), max < 0.02 px;
   (d) vecGPA against three optGPA calls and GPA against optGPA, bit
   for bit, and iterate_GPA from ks + (0.002, -0.001) cancelling at
   least 65% of the offset (cg_unwrap and fit_plane launched); (e) the bench extractor with the "vv"
   finest level (unwrap_mg_final replaced in the unwrap module's
   DEFAULTS): presmooth once and applyq three times a call (once with
   "v"), the bench's interior and dc-free gates, the same path on the
   plain twins within 1e-2 px; each with its launch counts and seconds
   per call;
13. benchmarks/run_all.py configs 1, 2, 5 and 6 as it builds them,
   through the bench extractor (unwrap_coarse=4): (a) config 1 at 512^2
   (interior max |u| < 0.02 px, 8 sigma border), (b) config 2 at 1024^2
   (r_k 0.015, theta 3 deg; < 0.6 px, 2 sigma border), (c) config 5,
   four 4096^2 tiles (the lattice and its flips, chunk=4) each followed
   by props_from_u (tile 0's interior: max |theta| < 0.01 deg, max
   |kappa - 1| < 0.001), (d) config 6 at 8192^2 (chunk=4; raw interior
   < 0.004 px, dc-free < 0.003 px); each with its launch counts and the
   routes they show, seconds, peak memory, and the same path on the
   plain twins (u: interior p99 < 1e-3 px, max < 1e-2 px; config 5's
   props: a tenth of each gate); (a), (b) and (d) also hold each kernel
   of the path against its twin, with phase 3's bounds, on the inputs
   one run of the same extractor hands it on the lattice displaced by
   the bench's field (config 5's shapes are phase 3's);
14. (a) config 5f: iterate_J_leastsq on the 128^2 float32 JacA0 field
   from Kerelsky_Jac's refest (max |theta - theta_ref| < 0.5 deg, kfits/s,
   its distance from the float64 fit on the card, one traced fit's
   kernel count and device time); (b) Kerelsky_plus and
   Kerelsky_Jac on three moire k-vector sets, each through
   tests/test_kerelsky.py's round-trip gates; (c) gt.gpa.wfr4 on the
   4096^2 bench fixture for each Bragg peak with config 2g's bank and
   dk one bank step (route, seconds), and on a 1024^2 crop against the
   same call on the CPU (winners agree on >= 99.9% of the 5 sigma
   interior, the lock-in's phase within 1e-4 rad there); (d) gt.gpa.wff
   on a noisy 1024^2 crop (correlation with the clean crop > 0.97 and
   above the noisy input's). No hand kernel runs in phase 14.
15. the batch axis: (a) run_all.py config 1b: 16 x 512^2 config 1
   lattices (image i shifted by 0.31 i px) through one call of
   make_displacement_extractor((512, 512), ks, unwrap_coarse=4), its
   launches per stack against one image's (equal), each image's u less
   its mean within 0.02 px on the 8 sigma interior, the stack against the
   loop of run(images[i]) (interior p99 < 1e-3, max < 1e-2 px; bits and
   their cause printed), seconds per stack, Mpix/s, the loop's seconds
   and peak memory; then check_path_kernels on a stack of 4 (the lattice
   displaced by bench_field and three shifts of it) and each batched
   kernel against its own single-image launch on each image's slice;
   the batched kernels' rows of the kernels line (sweep_uv_1b,
   presmooth_1b, applyq_1b, cg_poisson_1b) are timed on config 1b's own
   stack; (b) config 5 as one call: 13c's four 4096^2 tiles stacked
   through one call of its extractor, then props_from_u per tile, tile
   0's gates and each tile's u against 13c's loop, seconds per step and
   peak memory; (c) a 16384^2 mosaic from disk: config 5's lattice
   rendered in float64 on the card, scaled to uint16 and written with
   gt.data.write_mosaic into a temporary directory, then
   MosaicTiles.batches(4096, batch_size=4) (the loader built with g++)
   through 15b's extractor, every tile held to config 5's gates, one
   stack's u through gt.io's checkpoint and back with equal bits, the
   pass's seconds, per stack the host read and device ms, and the
   device's idle share over a pass (torch.profiler).
16. one launch per stage for a stack on the eager path and on both
   gradient emissions, and the utilities: (a) config 5's four 4096^2
   tiles through one call of gt.parallel.extract_displacement_field_batch
   (one fft2, one zoom sweep launch pair a peak for the stack, the exact
   CG on every tile at once): launches per stack against one image's
   (zoom_sweep 3 and the DCTs' count, equal or fail), config 5's gates
   (tile 0's, as run_all.py's; every tile printed), the stack against the loop of four eager calls (interior
   p99 < 1e-3, max < 1e-2 px), seconds and peak memory of both, four
   displaced tiles held against their loop (hold_displaced), each batched
   zoom launch against its single-image launches bit for bit (any
   difference fails) and against its twin (check_zoom, on the displaced
   tiles but for the last one's hole of noise, and on config 5's);
   then 15c's sixteen mosaic tiles through the same call, which splits
   them into calls that fit the card's free memory: the calls' sizes,
   seconds, the peak against the estimate the split rests on, and
   config 5's gates on every tile; (b) config 1b's
   16 x 512^2 through the same call, its gate, the stack against its
   loop and seconds of both, a displaced stack of 16 held alike; (c)
   config 2g's step on a stack of two 4096^2 images (the bench fixture
   and the same lattice displaced by the bench's field) through the zoom
   gradient emission (float32 ks, 3 "zoom_grad") and the grouped one
   (float64 ks, 1 "sweep_grad"): launches per stack against one image's,
   the gates on the first image, the stack's maps against the plain
   twins' (each image's max within a tenth of each gate, as phase 10,
   but at the pixels where a winner flips between kernel and twin at a
   near tie: both winners' float64 |M|^2 within check_zoom's |M|^2
   bounds of the top candidate's, each flip's gaps printed), seconds of
   stack and loop, each batched
   emission's bits against its single-image launches and the emission
   against its twin; (d) prep_image on the bench fixture with a zero
   border, generate_mask on 15c's 16 tiles, tpugpa's tpuGPA,
   wfr2_grad_opt and wfr2_only_lockin on the bench fixture (the zoom
   kernel's launches counted), each timed and held to the same call on
   the CPU (the sweeps on a 1024^2 crop). The kernels line adds
   zoom_sweep_stack (16a), zoom_grad_stack and sweep_grad_stack (16c).
17. the multi-device API (gt.parallel) on a world of one: an NCCL
   process group through a file store in a temporary directory and
   make_mesh(1) on the card (NCCL takes one rank a card; several ranks
   are held on the CPU through gloo, tests/test_torch_parallel.py):
   (a) extract_displacement_field_sharded(img, ks, mesh,
   unwrap_coarse=4) on the bench fixture against the bench's three
   gates and the single-card factory at unwrap_coarse=4 (interior p99 <
   1e-3 px, max < 1e-2), its launches (3 "zoom_sweep": the row-block
   sweeps, the multigrid on the sharded preconditioner's twins at
   1024^2); (b) the same with the exact CG (unwrap_coarse=None: the
   pencil DCT's local passes on the DCT kernels at 4096) against the
   gates and the eager extract_displacement_field alike; (c) the zoom
   kernel on 17a's row-block calls against zoom_sweep_plain on the same
   operands (check_zoom, phase 3's bounds; the winner flips that are
   not near ties, near_ties, at most 1 - 0.99 of the pixels), timed
   beside the twin; (d) wfr_sweep_sharded against ops.wfr.wfr_sweep on
   the same full-FFT route; (e) fft2_sharded / ifft2_sharded against
   torch.fft; (f) dct2n_sharded / idct2n_sharded against core.fourier
   (the DCT kernels' counters rising), the local passes of 17b timed
   against their twins; (g) extract_displacement_field_batch(mesh=...)
   on two images against the same call without a mesh (the same bits);
   (h) ops.kernel_smoke.run_kernel_smoke(device="cuda") (every entry's
   launch counter rising). Each call's seconds and peak device memory
   are printed; the group is destroyed at the end. The kernels line
   adds zoom_sweep_sharded (17a's launches) and dct_lane_sharded,
   dct_sub_sharded (17b's).

Phase 3 also holds the grouped sweep (kernel and float32 twin against
the float64 twin; stages 1, 2 and the uv epilogue timed apart, with
stage 2's float32-FMA and 3xTF32 bounds), the zoom-sweep kernel (all
three peaks of the eager path; stage 1 and stage 2 timed apart, with
stage 2's float32-FMA and 3xTF32 bounds), the four DCT directions (on
the first transform of each direction of the exact CG's
preconditioner on phase 5's residual), the warp kernels (the displacement-form
cubic warp on the first Picard step of phase 7b, both planes in place,
and on its final 'constant' warp, with the coordinate form on the same
positions; the first bilinear warp of 7a's coarse inversion: both
planes of u in one launch, timed per call and as device time from
torch.profiler beside F.grid_sample on the same planes), and the
drizzle and expand kernels (phase 8a's inputs) against their twins;
the drizzle and expand kernels also run twice and on their other route
(global-atomic; L1) and must repeat bit for bit, the drizzle's max|v|
pass is timed alone, and the expand kernel's device time
(torch.profiler, both routes) is printed apart from its call's
CUDA-event time and launches (the cell's prefilter is torch). The
presmooth kernel must repeat bit for bit; its device time and the
bytes it moves (its halo reads counted) are printed beside its bound.
The applyq kernel must give its twin's bits and repeat them, on the
inputs phase 4 hands it (2, 4096^2) and on those of 7a's unwrap (one
2048^2 plane); its device time and the bytes it moves are printed the
same way.
The CG kernel runs both calls phase 4 captures (kmax 6 and 4, the FFT
route) and a dense-route call at (2, 384, 640), each against its twin
and bit for bit against itself, with its kernel launches per iteration
(exactly 6 on the FFT route, read from the call's captured CUDA
graph), the L2 traffic of its
launch chain and, on the FFT route, the dense route's error and time on
the same inputs. The early-stopping CG kernel (cg_unwrap) runs phase
5's exact solve (2, 4096^2, kmax 10, the row), config 6's 2048^2
levels (kmax 6 and 4) and 4096^2 refinement (13d's inputs, from one run
of its extractor on the displaced 8192^2 lattice), a (4, 2) stack of
displaced 512^2 images with their own weights (16b's path), 12b's
(3, 4086^2) unwrap (refine_ks: the chirp-z passes on both axes) and
seeded aligned solves whose sides cover every chirp-z length L = 256 ...
4096 with N odd and even on both axes (CZT_COVER), each
against its twin (phi within 1e-4, k per plane equal, bit for bit over
two calls), with the route it took, each plane's stop margin, ms a call,
launches an iteration, the HBM traffic of its launch chain and, on the
chirp-z passes, each pass kind's device ms a plane-pass. Every
call, here and in phases 13 and 15a, is held to the route its shape
gives (stated_route, worked out by powers of two and even sides apart
from ops.cg's gate): exactly its launches an iteration of each DCT pass
kind (chirp-z, Stockham), of eigen_rz and in all (6 on the FFT route,
with no cuFFT kernel; 3 besides core.fourier's DCT pair at other
sides), read from the call's captured CUDA graph (ops._build's
graph_kernels, which cannot lose a launch as a torch.profiler trace
can); phase 3 also states
each label's chirp-z passes (4 for 12b's 4086^2 and the cover, 0
elsewhere) and fails
where a label captured no call. The plane fit's kernel (fit_plane)
runs 12b's three fits of the (3, 4086^2) unwrapped phases, from the
true ks and from ks + (0.002, -0.001) (slopes ~1e-2 rad/px), each against
the twin's fit of a float64 copy (slopes within 1e-5 of the larger
|slope|, the offset within 1e-5 of |offset|; the float32 twin's
distances beside), bit for bit over two calls, with exactly iters + 1
launches and no other kernel, ms a fit, device ms a step and the bound
of iters + 1 reads of the stack. For each kernel it computes the bound from those inputs (the larger of
their bytes, each input read once and each output written once, over
3.35 TB/s and their float32 operations over 67 TFLOP/s: the sweeps'
8 G P n Wb (W0 + m) from their shapes with stage 2 three times over at
495 TFLOP/s dense TF32, 2.5 n log2 n per DCT line, the CG's FFT-form
DCT pairs and stencil, a per-element count for the stencils, gathers
and scatters) and, where one PyTorch call computes the same function,
times it and holds it to the kernel: F.grid_sample for the bilinear
warp, scatter_ for the band flags (the drizzle has none: index_add
scatters taps that other calls compute first). The DCT rows print each direction's time beside its
twin's and its bound.

Phase 3 also holds the three gradient-path emissions to their float32
and float64 twins on the inputs paths 10a and 10b hand them: the zoom
sweep's gradient emission on all three peaks of 10a (winners agree on
> 1 - 2e-4 of the pixels, and there the gradients within rtol 2e-3,
atol 2e-5 rad/px; its tournament the plain launch's bits), and the
grouped sweep's phase/weight (a) and gradient (b) emissions on 10b's
(a: the uv route's phase/weight bounds; b: its planes (a)'s bits, the
gradients within the same rtol/atol wherever the phases agree within
1e-3 rad, all but 2e-4 of the pixels). Each gradient emission's steps
after its tournament are held to their twins on the same inputs: the
band flags ("grad_flags") equal, stage 1 of the row-derivative window
on the flagged (band, candidate) pairs ("grad_stage1") the full
launch's rows bit for bit and within 1e-5 of the twin's (relative), the
winner products ("grad_products") within the rtol/atol above at every
pixel. Each call is split into its parts (stage 1 of T, the
tournament, the three steps; CUDA events), the band and tile winners
of the kernel's and of the float32 twin's tournament are counted (the
bounds count the twin's), and each row prints two bounds: the work the function
needs (stage 1 once and on the band winners in float32 FMA, stage 2
and 2 x 8 x 64^2 x W FLOP per tile winner three times over at the dense
TF32 rate; the row's bound) and the old design's (stage 1 twice in
full). The three steps' rows are 10a's, summed over its peaks.

Any failed check raises and the script exits non-zero. Without a CUDA
card it fails at once. Its last two lines are the kernels JSON object
followed by {"ok": true, "device": {...}}.
"""
import contextlib
import gc
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
    # the early-stopping CG: the reference's lax.while_loop, which XLA
    # fuses on the TPU (its Pallas CG takes only VMEM-sized levels)
    "cg_unwrap": ("pygpa_tpu_torch/csrc/cg_unwrap.cu",
                  "pygpa_tpu/solvers/unwrap.py:215"),
    "zoom_sweep": ("pygpa_tpu_torch/csrc/zoom_sweep.cu",
                   "pygpa_tpu/ops/pallas_sweep.py:96"),
    # the robust plane fit: the reference's lax.fori_loop of IRLS steps,
    # which XLA fuses on the TPU (no Pallas kernel)
    "fit_plane": ("pygpa_tpu_torch/csrc/fit_plane.cu",
                  "pygpa_tpu/core/mathtools.py:49"),
    "dct_lane": ("pygpa_tpu_torch/csrc/dct.cu",
                 "pygpa_tpu/ops/pallas_dct2.py:132"),
    "dct_sub": ("pygpa_tpu_torch/csrc/dct.cu",
                "pygpa_tpu/ops/pallas_dct2.py:220"),
    "warp_bilinear": ("pygpa_tpu_torch/csrc/warp.cu",
                      "pygpa_tpu/ops/pallas_warp.py:71"),
    "warp_cubic": ("pygpa_tpu_torch/csrc/warp.cu",
                   "pygpa_tpu/ops/pallas_warp.py:172"),
    "expand": ("pygpa_tpu_torch/csrc/expand.cu",
               "pygpa_tpu/ops/pallas_expand.py:78"),
    "drizzle": ("pygpa_tpu_torch/csrc/drizzle.cu",
                "pygpa_tpu/ops/pallas_drizzle.py:56"),
    # the emissions of the gradient path, counted apart
    "sweep_pw": ("pygpa_tpu_torch/csrc/sweep.cu",
                 "pygpa_tpu/ops/pallas_sweep.py:370"),
    "sweep_grad": ("pygpa_tpu_torch/csrc/sweep.cu",
                   "pygpa_tpu/ops/pallas_sweep.py:370"),
    "zoom_grad": ("pygpa_tpu_torch/csrc/zoom_sweep.cu",
                  "pygpa_tpu/ops/pallas_sweep.py:96"),
    # the gradient emissions' steps after the tournament (both sweeps;
    # timed on 10a's inputs)
    "grad_flags": ("pygpa_tpu_torch/csrc/sweep.cu",
                   "pygpa_tpu/ops/pallas_sweep.py:96"),
    "grad_stage1": ("pygpa_tpu_torch/csrc/sweep.cu",
                    "pygpa_tpu/ops/pallas_sweep.py:96"),
    "grad_products": ("pygpa_tpu_torch/csrc/sweep.cu",
                      "pygpa_tpu/ops/pallas_sweep.py:96"),
    # the column basis split for both stage 2s' tensor cores (the TPU
    # kernels split theirs inside, _split_bf16; timed on the bench
    # extractor's basis)
    "split_basis": ("pygpa_tpu_torch/csrc/sweep.cu",
                    "pygpa_tpu/ops/pallas_sweep.py:370"),
}
# the path whose counted run a kernel's "launches" reports
PATH_OF = {"sweep_uv": 4, "presmooth": 4, "applyq": 4, "cg_poisson": 4,
           "zoom_sweep": 5, "cg_unwrap": 5, "fit_plane": "12b", "dct_lane": "17b",
           "dct_sub": "17b",
           "warp_bilinear": "7a", "warp_cubic": "7b", "expand": "8a",
           "drizzle": "8a", "zoom_grad": "10a", "sweep_grad": "10b",
           "sweep_pw": "11b", "grad_flags": "10a", "grad_stage1": "10a",
           "grad_products": "10a", "split_basis": 4}
# the gradient emissions' launches after the tournament, one each per
# emission call
GRAD_STEPS = ("grad_flags", "grad_stage1", "grad_products")
# kernels each driven path must launch
PATH_KERNELS = {4: ("sweep_uv", "presmooth", "applyq", "cg_poisson"),
                5: ("zoom_sweep", "cg_unwrap"),
                6: ("sweep_uv", "cg_unwrap"),
                "7a": ("presmooth", "applyq", "cg_poisson", "warp_bilinear",
                       "warp_cubic"),
                "7b": ("warp_cubic",),
                "8a": ("drizzle", "expand"),
                "8b": ("drizzle", "expand"),
                "9a": ("sweep_uv",),
                # 500^2: the 125^2 coarse solve on the early-stopping
                # kernel's other sides, the V-branch on its twins
                "9b": ("cg_unwrap",),
                "10a": ("zoom_grad",) + GRAD_STEPS,
                "10b": ("sweep_grad",) + GRAD_STEPS,
                "11a": ("zoom_grad", "cg_unwrap") + GRAD_STEPS,
                "11b": ("sweep_pw", "cg_unwrap"),
                # the quick start's exact unwraps at 4086^2 (the 5-px
                # trim): the early-stopping kernel's chirp-z passes; its
                # plane fits of the unwrapped phases
                "12b": ("cg_unwrap", "fit_plane"),
                "12d": ("cg_unwrap", "fit_plane"),
                "12e": ("sweep_uv", "presmooth", "applyq", "cg_poisson"),
                "13a": ("sweep_uv", "presmooth", "applyq", "cg_poisson"),
                "13b": ("sweep_uv", "presmooth", "applyq", "cg_poisson"),
                "13c": ("sweep_uv", "presmooth", "applyq", "cg_poisson"),
                # 8192^2: the 2048^2 coarse and correction solves (above
                # ops.cg.MAX_SIDE) take the early-stopping kernel
                "13d": ("sweep_uv", "presmooth", "applyq", "cg_unwrap"),
                # phase 15: the stacks run the path's four kernels
                "15a": ("sweep_uv", "presmooth", "applyq", "cg_poisson"),
                "15b": ("sweep_uv", "presmooth", "applyq", "cg_poisson"),
                # the fits, wfr4 and WFF run no hand kernel
                "14a": (), "14b": (), "14c": (), "14d": (),
                # phase 16: the eager path and both gradient emissions on
                # stacks (the exact CG on the early-stopping kernel)
                "16a": ("zoom_sweep", "cg_unwrap"),
                "16b": ("zoom_sweep", "cg_unwrap"),
                "16ca": ("zoom_grad",) + GRAD_STEPS,
                "16cb": ("sweep_grad",) + GRAD_STEPS,
                # phase 17: the row-sharded pipeline (multigrid on the
                # sharded preconditioner: no CG or V-branch kernel, the
                # 1024^2 levels' DCTs on the twins) and with the exact CG
                # (the torch loop through the seam: the pencil DCT's
                # passes at 4096 on the DCT kernels); the batch over the
                # mesh (each rank's eager call: the early-stopping kernel)
                "17a": ("zoom_sweep",),
                "17b": ("zoom_sweep", "dct_lane", "dct_sub"),
                "17g": ("zoom_sweep", "cg_unwrap")}
# each gradient path's launches of the sweeps: exactly these counts
PATH_SWEEPS = {"10a": {"zoom_grad": 3}, "10b": {"sweep_grad": 1},
               "11a": {"zoom_grad": 3}, "11b": {"sweep_pw": 1},
               "16a": {"zoom_sweep": 3}, "16b": {"zoom_sweep": 3},
               "16ca": {"zoom_grad": 3}, "16cb": {"sweep_grad": 1},
               "17a": {"zoom_sweep": 3}, "17b": {"zoom_sweep": 3}}
SWEEP_NAMES = ("sweep_uv", "sweep_pw", "sweep_grad", "zoom_sweep",
               "zoom_grad")
# stage 2 of either sweep splits its column basis first, in its own launch
for _k, _v in PATH_KERNELS.items():
    if set(_v) & set(SWEEP_NAMES):
        PATH_KERNELS[_k] = _v + ("split_basis",)
# the sweeps' kernels (mangled-name keys): phase 2 fails if one spills
SWEEP_KERNELS = ("zoom_stage2_kernel", "grouped_stage2_kernel",
                 "stage1_kernel", "band_flags_kernel",
                 "winner_products_kernel", "split_basis_kernel")
# the tournaments' stage 2 (wgmma: HGMMA in their SASS and no HMMA) and
# the winner products (mma.sync: HMMA)
WGMMA_KERNELS = ("zoom_stage2_kernel", "grouped_stage2_kernel")
MMA_SYNC_KERNELS = ("winner_products_kernel",)
GATE_2G_THETA, GATE_2G_KAPPA = 0.01, 0.001   # run_all.py config 2g
DEVICE = "cuda"     # where phases 9-11, 13 and 14 put their work
GRAD_RTOL, GRAD_ATOL, GRAD_AGREE = 2e-3, 2e-5, 1 - 2e-4
# where the grouped phases agree, a near-tie flip to a neighbouring
# candidate moves a gradient by up to ~1e-3 rad/px (measured 1.0e-3 on
# path 10b); a sign, axis or band-ramp slip moves all of them by 1e-2
# and more
GRAD_SLIP = 1e-2
REPS_NEW = 3        # timed runs of phases 7 and 8
PATH_AGREE = 1e-4   # phases 7, 8: max |kernels - twins| / max |twins|
GATE_UNWRAP_P99, GATE_UNWRAP_MAX, GATE_UNDISTORT = 0.02, 0.3, 0.05
GATE_UCELL = 0.05
# phase 12: the quick start from the raw image (tests/test_peaks.py's
# gates, in units of 1 / size; the eager path's u from refined ks within
# config 1's gate of phase 5's u once a plane is removed;
# tests/test_pipeline.py's iterate_GPA offset and its 65% cancellation)
GATE_PEAKS, GATE_SUBPIXEL, GATE_REFINE = 1.5, 0.5, 0.15
GATE_REFINED_U = 0.02
ITERATE_OFFSET, ITERATE_LEFT = np.array([0.002, -0.001]), 0.35
VV_TWINS = 1e-2     # 12e: max |kernels - twins| px on the interior
PEAK_REPS = 3


def say(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_state():
    """The card's SM clock, temperature and power draw now, as
    nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
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
    positional arguments of its first `keep` calls (all when None) in
    `calls` and their keyword arguments in `kws`, the latest call's in
    `last`, and forwards every call to the wrapper."""

    def __init__(self, module, name, keep=None):
        self.module, self.name, self.keep = module, name, keep
        self.orig = getattr(module, name)
        self.calls = []
        self.kws = []          # the keyword arguments of each kept call
        self.last = None

    def __enter__(self):
        def rec(*args, **kw):
            if self.keep is None or len(self.calls) < self.keep:
                self.calls.append(args)
                self.kws.append(kw)
            self.last = args
            return self.orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def bench_field(size):
    """The bench's displacement field at `size` (float32, (2, size,
    size)): u_x = 0.1 x exp(-(x / (size / 4))^2 / 2 - 1.2 (y / (size /
    3))^2 / 2), u_y = 0."""
    S = size // 2
    xp, yp = np.meshgrid(np.arange(-S, S), np.arange(-S, S), indexing="ij")
    xshift = 0.1 * xp * np.exp(-0.5 * ((xp / (2 * S / 8)) ** 2
                                       + 1.2 * (yp / (2 * S / 6)) ** 2))
    return np.stack((xshift, np.zeros_like(xshift))).astype(np.float32)


def fixtures(torch):
    from pygpa_tpu_torch.lattices import generate_ks, hexlattice_gen
    ks = generate_ks(R_K, THETA, kappa=KAPPA, psi=PSI)[:3]
    img = hexlattice_gen(R_K, THETA, order=2, size=SIZE, kappa=KAPPA,
                         psi=PSI, dtype=torch.float32, device="cuda")
    u_true = bench_field(SIZE)
    img_d = hexlattice_gen(R_K, THETA, order=2, size=SIZE, kappa=KAPPA,
                           psi=PSI, shift=u_true, dtype=torch.float32,
                           device="cuda")
    return ks, img, img_d, torch.from_numpy(u_true).cuda()


def rel_err(got, want):
    """max |got - want| / max |want| (normwise relative)."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# published H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s,
# float32 FLOP/s outside the tensor cores and dense TF32 FLOP/s on them
HBM_BYTES_S, FP32_FLOP_S, TF32_FLOP_S = 3.35e12, 67e12, 495e12


def tensor_bytes(*objs):
    """Bytes of every tensor in objs (tuples and lists searched)."""
    import torch
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += tensor_bytes(*o)
    return total


def bound(nbytes, ops):
    """(least ms, what sets it): the larger of nbytes over the HBM rate
    and ops float32 operations over the float32 peak."""
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, float(ops) / FP32_FLOP_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def zoom_bounds(nbytes, flops1, flops2):
    """(FP32-FMA bound ms, 3xTF32 bound ms) of the zoom sweep: stage 1's
    flops1 in float32 FMA either way; stage 2's flops2 in float32 FMA, or
    three times over at the dense TF32 rate; each no less than nbytes
    over the HBM rate."""
    t_b = nbytes / HBM_BYTES_S * 1e3
    fp32 = (flops1 + flops2) / FP32_FLOP_S * 1e3
    tc = (flops1 / FP32_FLOP_S + 3 * flops2 / TF32_FLOP_S) * 1e3
    return max(t_b, fp32), max(t_b, tc)


def device_ms(fn, reps):
    """Mean device milliseconds per call of fn(): the summed durations of
    the kernels the calls launched, from torch.profiler's device records
    (host time and launch gaps excluded), after one warm-up call; None
    when the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps if us > 0 else None


def ptxas_lines(log, key):
    """ptxas's registers/spills lines (nvcc -Xptxas -v) of every kernel
    whose mangled name holds `key`."""
    out, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = key in line
        elif on and ("spill" in line or "Used" in line):
            out.append(line.strip())
    return out


def spill_bytes(lines):
    """Spill stores and loads, in bytes, summed over ptxas lines (0 for
    the message that the log holds none)."""
    import re
    return sum(int(a) + int(b) for ln in lines for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln))


def sass_functions(lib_path, key):
    """The SASS text (cuobjdump -sass) of each kernel of the built
    library whose mangled name holds `key`."""
    from pygpa_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return [f for f in sass.split("Function : ")[1:]
            if key in f.split("\n", 1)[0]]


def sass_count(lib_path, key, op):
    """Occurrences of the SASS opcode `op` (HGMMA: warpgroup wgmma; HMMA:
    mma.sync) in the kernels of the built library whose mangled name
    holds `key`."""
    return sum(f.count(op) for f in sass_functions(lib_path, key))


def stage2_rate(label, ms, flops2, kernel_ms=None):
    """Print stage 2's time apart (the split and the tournament launch;
    the tournament kernel's device time beside it when the profiler
    gave one), its achieved rate of TF32 tensor-core products (three a
    float32 product) and its share of the 3xTF32 bound, against the aim
    of half the bound."""
    b = 3 * flops2 / TF32_FLOP_S * 1e3
    t = ms if kernel_ms is None else kernel_ms
    say(f"    {label} stage 2: {ms!r} ms (split and tournament launches), "
        f"tournament kernel {kernel_ms!r} ms device; "
        f"{3 * flops2 / t / 1e9!r} TFLOP/s of TF32 products, {b / t!r} of "
        f"its 3xTF32 bound {b!r} ms (aim: at least 0.5)")


def sass_ops(lib_path, key, prefixes):
    """The distinct SASS opcodes starting with one of `prefixes` in the
    kernels of the built library whose mangled name holds `key`."""
    return sorted({tok for f in sass_functions(lib_path, key)
                   for ln in f.splitlines()
                   for tok in ln.replace(";", " ").split()
                   if tok.startswith(prefixes)})


def device_kernels(fn, reps=1):
    """The CUDA kernels one call of fn() launches: {name: device ms per
    call} from torch.profiler's device records over `reps` calls
    (copies and fills left out), after one warm-up call, and their count
    per call; (None, None) when the profiler records no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)   # a trace can lack its first milliseconds
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    recs = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]
    if not recs:
        return None, None
    by_name, count = {}, 0
    for name, us in recs:
        if name.lower().startswith(("memcpy", "memset")):
            continue
        count += 1
        short = name.replace("(anonymous namespace)::", "").split("(")[0]
        by_name[short] = by_name.get(short, 0.0) + us / 1e3 / reps
    return by_name, count // reps


def matmul_flops(fn, *args, **kw):
    """FLOPs of the matrix products fn(*args) runs (torch's flop
    counter; elementwise work is not counted, so a bound built on it
    stays a lower bound). Returns (flops, outputs)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        out = fn(*args, **kw)
    return fc.get_total_flops(), out


def dct_ops(x, axis):
    """Operations of a DCT through a half-length complex FFT: 2.5 n
    log2 n per line of n (half of a complex n-point FFT's 5 n log2 n)."""
    n = x.shape[axis]
    return 2.5 * n * np.log2(n) * (x.numel() // n)


def bound_row(nbytes, ops):
    """The kernels-line fields of a bound (library_ms None until a
    library call is timed)."""
    ms, by = bound(nbytes, ops)
    return dict(bound_ms=ms, bound_by=by, library_ms=None)


# F.grid_sample against the bilinear warp kernel: it normalises the
# positions to [-1, 1] and back, so taps may move by float32 rounding
LIBRARY_BOUND = 1e-5


def bilinear_library(args):
    """F.grid_sample (bilinear, align_corners=True) on a bilinear warp's
    image or stack of C planes, as one (1, C, n, m) input, and positions,
    as a zero-argument call whose output reshapes to the warp's: the same
    function in 'nearest' mode (padding 'border') and in 'constant' mode
    with cval 0 (padding 'zeros'); None for another cval."""
    import torch
    import torch.nn.functional as F
    image, cy, cx = args[:3]
    mode = args[3] if len(args) > 3 else "nearest"
    cval = args[4] if len(args) > 4 else 0.0
    pad = {"nearest": "border"}.get(mode)
    if mode == "constant" and float(cval) == 0.0:
        pad = "zeros"
    if pad is None:
        return None
    n, m = image.shape[-2:]
    grid = torch.stack([2 * cx / (m - 1) - 1, 2 * cy / (n - 1) - 1], -1)
    grid = grid.reshape(1, -1, 1, 2)
    inp = image.reshape(1, -1, n, m)
    return lambda: F.grid_sample(inp, grid, mode="bilinear",
                                 padding_mode=pad, align_corners=True)


SWEEP_BOUNDS = {"dudx_p99": 1e-3, "dudy_p99": 1e-3, "wnorm_rel_max": 5e-3,
                "wnorm_rel_p99": 5e-5}


def p99(t):
    """The 99th percentile of t's values, from every 7th (sparser where
    torch.quantile's limit of 2^24 values needs it)."""
    import torch
    f = t.flatten()
    step = max(7, -(-f.numel() // (1 << 24)))
    return float(torch.quantile(f[::step], torch.tensor(
        [0.99], device=f.device, dtype=f.dtype)))


def sweep_stats(got, want):
    """check_sweep's numbers of one sweep's outputs against another's (one
    image's, or a stack's with a leading image axis)."""
    ux, uy, wn = got
    vx, vy, vn = want
    dx = (ux - vx)[..., 1:].abs()
    dy = (uy - vy)[..., 1:, :].abs()
    dwn = (wn - vn).abs() / (vn.abs() + 1e-9)
    return {"dudx_p99": p99(dx), "dudy_p99": p99(dy),
            "wnorm_rel_max": float(dwn.max()), "wnorm_rel_p99": p99(dwn)}


def check_sweep(sw, args):
    """The grouped sweep kernel against its float32 twin and, with the
    twin, against the twin computed in float64, with the flip-tolerant
    bounds of tests/test_lockin_wfr.py's banded-vs-unbanded test (near-tie
    winners may differ between two summation orders, so the p99s are
    bounded tightly and the maxima loosely). Returns the largest absolute
    difference from the float32 twin."""
    import torch
    got = sw.sweep_uv(*args)
    f32 = sw.sweep_uv_plain(*args)
    f64 = [t.float() for t in sw.sweep_uv_plain(*(
        a.double() if torch.is_tensor(a) and a.is_floating_point() else a
        for a in args))]
    torch.cuda.synchronize()
    for name, t in zip(("dudx_s", "dudy_s", "wnorm"), got):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"sweep kernel: non-finite {name}")
    ok = True
    for what, a, b in (("kernel vs float32 twin", got, f32),
                       ("kernel vs float64 twin", got, f64),
                       ("float32 twin vs float64 twin", f32, f64)):
        st = sweep_stats(a, b)
        say(f"  sweep_uv {what}: {json.dumps(st)} (bounds "
            f"{json.dumps(SWEEP_BOUNDS)})")
        ok &= all(st[k] < v for k, v in SWEEP_BOUNDS.items())
    max_abs = max(float((ux - px)[..., 1:].abs().max()) for ux, px in
                  zip(got[:2], f32[:2]))
    max_abs = max(max_abs, float((got[2] - f32[2]).abs().max()))
    say(f"  sweep_uv max_abs_err (kernel vs float32 twin) {max_abs!r}")
    if not ok:
        raise RuntimeError("sweep kernel or twin beyond the flip-tolerant "
                           f"bounds {SWEEP_BOUNDS}")
    return max_abs


def check_vcycle(vc, ps_args, aq_calls):
    import torch
    got = vc.presmooth(*ps_args)
    again = vc.presmooth(*ps_args)
    want = vc.presmooth_plain(*ps_args)
    torch.cuda.synchronize()
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    mabs_ps = max(float((g - w).abs().max()) for g, w in zip(got, want))
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    say(f"  presmooth vs twin: rel err (r, d, Dinv, rrow) = {errs} "
        f"max_abs_err={mabs_ps!r} (bound 1e-5); two launches "
        f"bit-identical: {same}")
    if not all(np.isfinite(errs)) or max(errs) > 1e-5 or not same:
        raise RuntimeError("presmooth kernel disagrees with its twin or "
                           "does not repeat")
    mabs_aq = 0.0
    for a in aq_calls:
        q = vc.applyq(*a)
        again = vc.applyq(*a)
        qp = vc.applyq_plain(*a)
        torch.cuda.synchronize()
        mabs = float((q - qp).abs().max())
        bits, same = torch.equal(q, qp), torch.equal(q, again)
        say(f"  applyq {tuple(a[0].shape)} vs twin: max_abs_err={mabs!r}, "
            f"twin's bits: {bits}; two launches bit-identical: {same}")
        if not (bits and same):
            raise RuntimeError("applyq kernel does not give its twin's "
                               "bits or does not repeat")
        mabs_aq = max(mabs_aq, mabs)
    return mabs_ps, mabs_aq


CG_BOUND = 1e-4


@contextlib.contextmanager
def cg_dense_route():
    """The CG wrapper's route predicate set to the dense DCT-matrix
    route for every side (the sides it then takes are still kernels)."""
    from pygpa_tpu_torch.ops import cg
    real = cg.fft_route
    cg.fft_route = lambda n, m: False
    try:
        yield
    finally:
        cg.fft_route = real


def check_cg(cg, calls):
    """The CG kernel against its FFT-form twin on each call, normwise
    relative <= 1e-4 (float32 sums in another order), and a second run
    bit for bit (fixed-order reductions); on the FFT route also the
    dense route's error on the same inputs, printed beside it."""
    import torch
    mabs = 0.0
    for args in calls:
        got = cg.cg_poisson(*args)
        again = cg.cg_poisson(*args)
        want = cg.cg_poisson_plain(*args)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        same = bool(torch.equal(got, again))
        mabs = max(mabs, float((got - want).abs().max()))
        n, m = args[0].shape[-2:]
        route = "FFT-form DCT passes" if cg.fft_route(n, m) else \
            "dense DCT matrices"
        line = (f"  cg_poisson {tuple(args[0].shape)} kmax {args[3]} "
                f"({route}) vs twin: rel err {e!r} (bound {CG_BOUND}: "
                f"float32 sums in another order); two runs bit-identical: "
                f"{same}")
        if cg.fft_route(n, m):
            with cg_dense_route():
                dense = cg.cg_poisson(*args)
            line += (f"; the dense route on the same inputs: rel err "
                     f"{rel_err(dense, want)!r}")
        say(line)
        if not (np.isfinite(e) and e <= CG_BOUND and same
                and torch.isfinite(got).all()):
            raise RuntimeError("cg_poisson kernel disagrees with its twin "
                               "or does not repeat")
    return mabs


def dense_cg_call(torch, B, n, m, kmax):
    """A CG call at sides no Stockham plan covers (the dense route): the
    aligned residual and weights of random gradients and a weight with
    the pipeline's 1e-6 rim, from numpy seeds."""
    from pygpa_tpu_torch.solvers.unwrap import _residual_aligned
    g = np.random.default_rng(7)
    dxp, dyp = (torch.from_numpy(g.normal(size=(B, n, m)).astype(
        np.float32)).cuda() for _ in range(2))
    dxp[..., -1] = 0
    dyp[..., -1, :] = 0
    w = g.uniform(0.05, 1.0, size=(n, m))
    w[:8] = w[-8:] = w[:, :8] = w[:, -8:] = 1e-6
    rk, WWx, WWy = _residual_aligned(dxp, dyp, torch.from_numpy(
        w.astype(np.float32)).cuda())
    return rk, WWx, WWy, kmax


def chain_bytes(B, n, m, I=1):
    """Bytes one FFT-route iteration of either CG kernel moves, each
    launch's planes read and written once: the four passes (2, 2, 2 and 3
    planes of (B, n, m)), the p/stencil kernel (z, p_old, p, Qp and the I
    weight pairs) and the phi/r kernel (phi, r, p, Qp read; phi, r
    written). cg_poisson's stay in L2 (at 1024^2); at the exact path's
    4096^2 they are HBM bytes."""
    plane, ww = 4 * B * n * m, 4 * I * n * m
    return (2 + 2 + 2 + 3) * plane + 4 * plane + 2 * ww + 6 * plane


# the early-stopping kernel's launches inside an iteration (the DCT
# passes, Stockham or chirp-z, step_p, step_x; eigen_rz on the other
# sides)
UNWRAP_ITER_KERNELS = ("dct_kernel", "czt_kernel", "step_p_kernel",
                       "step_x_kernel", "eigen_rz_kernel")


def unwrap_route(cg, n, m):
    """The early-stopping kernel's route at n x m, in words: its own DCT
    passes (each axis Stockham at a power of two, chirp-z at another even
    side) or core.fourier's DCT pair between its launches."""
    if not cg.unwrap_fft_route(n, m):
        return "other sides: core.fourier's DCT pair between 3 launches"
    kind = ["Stockham" if s in cg.UNWRAP_FFT_SIDES else "chirp-z"
            for s in (n, m)]
    return f"FFT route: {kind[0]} sub pass, {kind[1]} lane pass"


def stated_route(n, m):
    """The early-stopping kernel's launches an iteration at n x m, worked
    out from the sides alone (apart from ops.cg's gate): where each side
    is a power of two from 128 to 8192 or even from 130 to 4094, the FFT
    route, whose four DCT passes (two a side) are chirp-z off the powers
    of two and Stockham on them, then step_p and step_x: six; at other
    sides (odd, under 128, past 4094 and not a power of two), eigen_rz,
    step_p and step_x besides core.fourier's DCT pair, whose forward and
    inverse pass are the Stockham kernel on a power-of-two side from 4096
    and torch's FFTs elsewhere. Returns (fft, {kernel: launches an
    iteration}, UNWRAP_ITER_KERNELS launches an iteration)."""
    def pow2(s):
        return s & (s - 1) == 0

    sides = (n, m)
    if all((pow2(s) and 128 <= s <= 8192) or (s % 2 == 0 and 130 <= s <= 4094)
           for s in sides):
        czt = sum(2 for s in sides if not pow2(s))
        return True, {"czt_kernel": czt, "dct_kernel": 4 - czt,
                      "eigen_rz_kernel": 0}, 6
    dct = sum(2 for s in sides if pow2(s) and 4096 <= s <= 8192)
    return False, {"czt_kernel": 0, "dct_kernel": dct,
                   "eigen_rz_kernel": 1}, 3 + dct


def check_cg_unwrap(cg, calls, label, czt=None):
    """The early-stopping CG kernel against its twin on each captured
    call (rk0, WWx, WWy, kmax, aligned): phi within PATH_AGREE (1e-4,
    normwise relative: float32 sums in another order), k per plane equal
    to the twin's, a second call bit for bit, finite; printed: each
    plane's stop margin (||r|| after its last iteration over its
    threshold 1e-6 ||r0||: below 1 it stopped by the norm), ms a call,
    the twin's ms, launches an iteration, the route, the bound and, on
    the FFT route, the HBM traffic of its launch chain. Every call is
    held to the route stated_route works out from its shape: ops.cg's
    gate must take it, and the launches of the call's captured graph
    (_build.graph_kernels: exact, where a torch.profiler trace can read
    low) must be exactly the route's, of each DCT pass kind, of eigen_rz
    and in all an iteration, with no cuFFT kernel on the FFT route.
    `czt`, where given, is the chirp-z passes an iteration the caller
    states for every call, which the shapes must give, and no captured
    call fails. Returns (largest |delta|, a row per call)."""
    import torch
    from pygpa_tpu_torch.ops import _build
    if czt is not None and not calls:
        raise RuntimeError(f"[{label}] no early-stopping CG call captured")
    mabs, rows = 0.0, []
    for args in calls:
        rk0, WWx, WWy, kmax, aligned = args[:5]
        lead = rk0.shape[:-2]
        nk = torch.empty(lead + (2,), device=rk0.device)
        nt = torch.empty_like(nk)
        got, k = cg.cg_unwrap(*args[:5], norms=nk)
        again, k2 = cg.cg_unwrap(*args[:5])
        want, kw = cg.cg_unwrap_plain(*args[:5], norms=nt)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        same = bool(torch.equal(got, again)) and bool(torch.equal(k, k2))
        mabs = max(mabs, float((got - want).abs().max()))
        n, m = rk0.shape[-2:]
        B = int(np.prod(lead))
        fft, route, route_it = stated_route(n, m)
        if czt is not None and not (fft and route["czt_kernel"] == czt):
            raise RuntimeError(f"[{label}] {n} x {m} does not give the "
                               f"route stated ({czt} chirp-z passes an "
                               f"iteration): {route}")
        its = max(int(kmax), 1)
        want_count = {x: c * its for x, c in route.items()}

        k_ms = cuda_ms(lambda a=args: cg.cg_unwrap(*a[:5]), 5)
        t_ms = cuda_ms(lambda a=args: cg.cg_unwrap_plain(*a[:5]), 3)
        graph = _build.graph_kernels(lambda a=args: cg.cg_unwrap(*a[:5]))
        g_count = {x: sum(x in nm for nm in graph) for x in route}
        g_per_it = sum(any(x in nm for x in UNWRAP_ITER_KERNELS)
                       for nm in graph) / its
        cufft = sorted({nm for nm in graph if "fft" in nm.lower()})
        # the work this run's data needs: each plane's own iterations of
        # an FFT-form 2D DCT pair and the stencil
        work = float(k.sum()) * n * m * (5 * np.log2(n * m) + 12)
        b_ms, b_by = bound(tensor_bytes(rk0, WWx, WWy, got), work)
        line = (f"  [{label}] cg_unwrap {tuple(rk0.shape)} "
                f"{'aligned' if aligned else 'unaligned'} kmax {kmax} "
                f"({unwrap_route(cg, n, m)}) vs twin: phi rel "
                f"err {e!r} (bound {PATH_AGREE}); k {k.flatten().tolist()}, "
                f"twin {kw.flatten().tolist()}; stop margin ||r|| / thr "
                f"{(nk[..., 0] / nk[..., 1]).flatten().tolist()}, twin "
                f"{(nt[..., 0] / nt[..., 1]).flatten().tolist()}; two runs "
                f"bit-identical: {same}; kernel {k_ms!r} ms, twin {t_ms!r} "
                f"ms, bound {b_ms!r} ms ({b_by}); launches an iteration "
                f"{g_per_it!r} in the captured graph (route: {route_it}), "
                f"cuFFT kernels in the call {cufft}")
        if fft:
            tr = chain_bytes(B, n, m, int(np.prod(WWx.shape[:-2])))
            line += (f"; HBM traffic of the launch chain {tr!r} bytes an "
                     f"iteration ({tr / HBM_BYTES_S * 1e3!r} ms an iteration "
                     f"at the HBM rate, {tr * float(k.max()) / HBM_BYTES_S * 1e3!r}"
                     f" ms for the call's longest plane)")
        say(line)
        by_kernel, _ = device_kernels(lambda a=args: cg.cg_unwrap(*a[:5]))
        say(f"      device ms per kernel over the call: "
            f"{json.dumps(by_kernel)}")
        if route["czt_kernel"] and by_kernel is not None:
            # a chirp-z pass kind runs once a plane-iteration (a done
            # plane's blocks return at their start)
            pi = float(k.sum())
            say(f"      chirp-z device ms a plane-pass over {pi:.0f} "
                f"plane-iterations: " + json.dumps(
                    {x: v / pi for x, v in by_kernel.items()
                     if "czt_kernel" in x}))
        say(f"      route stated from the shape: {route} an iteration, "
            f"{route_it} launches an iteration in all; launches in the "
            f"call {g_count} (graph), expected {want_count}")
        ok = (np.isfinite(e) and e <= PATH_AGREE and same
              and bool(torch.equal(k, kw)) and bool(torch.isfinite(got).all()))
        if fft != cg.unwrap_fft_route(n, m) or g_per_it != route_it or \
                g_count != want_count or (fft and cufft):
            raise RuntimeError(
                f"[{label}] the early-stopping CG did not take the route "
                f"stated for {n} x {m} ({route}, {route_it} launches an "
                f"iteration): gate's FFT route {cg.unwrap_fft_route(n, m)}, "
                f"launches an iteration {g_per_it}, {g_count}, cuFFT "
                f"kernels {cufft}")
        if not ok:
            raise RuntimeError(f"[{label}] cg_unwrap kernel disagrees with "
                               "its twin or does not repeat")
        rows.append(dict(ms=k_ms, plain_ms=t_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None))
    return mabs, rows


# sides of phase 3's chirp-z cover: each L = 256 ... 4096 with N odd and
# even, on the sub (first) and the lane (second) axis
CZT_COVER = ((130, 252), (252, 130), (374, 500), (1000, 1022),
             (1500, 2046), (3000, 4092), (4094, 3000))


FIT_AGREE = 1e-5   # the plane fit: slopes within this of the larger
#                    |slope|, the offset within this of |offset|, of the
#                    twin's fit of a float64 copy


def check_fit(fit, calls, label):
    """The plane fit's kernel against its twin on each captured call
    (image, mask, f_scale, iters): the kernel's coefficients against the
    twin's fit of a float64 copy, the slopes (p0, p1) within FIT_AGREE of
    the larger |slope| of each plane and the offset p2 within FIT_AGREE
    of |p2| (tests/test_torch_lockin.py's float32 bound, applied to the
    slopes and the offset apart: at 4086^2 the offset is many radians and
    a slope ~1e-2 rad/px); the float32 twin's distances printed beside
    them; finite; a second call bit for bit; exactly iters + 1 launches,
    counted by the wrapper and in the call's captured graph
    (_build.graph_kernels), and no other kernel in the fit (no solver
    library). Printed: ms a fit, the twin's ms, device ms a step, the
    bound of iters + 1 reads of the stack. Returns (largest |delta|, the
    first call's row)."""
    import torch
    from pygpa_tpu_torch.ops import _build
    if not calls:
        raise RuntimeError(f"[{label}] no plane fit captured")
    mabs, rows = 0.0, []
    for args in calls:
        img, mask, f_scale, iters = args[:4]
        its = int(iters) + 1

        def call(a=args):
            return fit.fit_plane_irls(*a[:4])

        before = _build.launches["fit_plane"]
        got = call()
        counted = _build.launches["fit_plane"] - before
        again = call()
        want = fit.fit_plane_irls_plain(img.double(), mask, f_scale, iters)
        twin = fit.fit_plane_irls_plain(img, mask, f_scale, iters)
        torch.cuda.synchronize()
        w = want.reshape(-1, 3)
        slope = w[:, :2].abs().amax(-1)

        def dist(x):
            d = (x.double().reshape(-1, 3) - w).abs()
            return ((d[:, :2].amax(-1) / slope).tolist(),
                    (d[:, 2] / w[:, 2].abs()).tolist())

        (k_sl, k_off), (t_sl, t_off) = dist(got), dist(twin)
        mabs = max(mabs, float((got.double() - want).abs().max()))
        same = bool(torch.equal(got, again))
        graph = _build.graph_kernels(call)
        g_steps = sum("irls_step_kernel" in nm for nm in graph)
        other = sorted({nm for nm in graph if "irls_step_kernel" not in nm})
        k_ms = cuda_ms(call, 5)
        t_ms = cuda_ms(lambda: fit.fit_plane_irls_plain(img, mask, f_scale,
                                                        iters), 2)
        by_kernel, _ = device_kernels(call)
        dev_ms = kernel_ms(by_kernel, "irls_step_kernel")
        step_ms = None if dev_ms is None else dev_ms / its
        # each step reads the stack (and the mask) once: ~20 float32
        # operations a pixel
        nbytes = tensor_bytes(img) + (0 if mask is None else mask.numel())
        b_ms, b_by = bound(its * nbytes, its * 20 * img.numel())
        say(f"  [{label}] fit_plane {tuple(img.shape)} "
            f"{'no mask' if mask is None else tuple(mask.shape)} iters "
            f"{iters}: kernel {got.reshape(-1, 3).tolist()}, float64 twin "
            f"{w.tolist()}; kernel from the float64 twin: slopes "
            f"{k_sl} of the larger |slope|, offset {k_off} of |offset| "
            f"(bound {FIT_AGREE}); float32 twin from it: slopes {t_sl}, "
            f"offset {t_off}; two runs bit-identical: {same}; launches "
            f"{counted} counted, {g_steps} irls_step_kernel in the captured "
            f"graph, other kernels {other} (expected {its}, none); kernel "
            f"{k_ms!r} ms a "
            f"fit, twin {t_ms!r} ms; device {dev_ms!r} ms a fit, {step_ms!r} "
            f"ms a step; bound {b_ms!r} ms a fit ({b_by}: {its} reads of "
            f"{nbytes} bytes), {b_ms / its!r} ms a step")
        if not (bool(torch.isfinite(got).all()) and same and counted == its
                and max(k_sl) <= FIT_AGREE and max(k_off) <= FIT_AGREE
                and g_steps == its and not other):
            raise RuntimeError(f"[{label}] fit_plane kernel disagrees with "
                               "its twin, does not repeat or does not "
                               f"launch {its} steps and nothing else")
        rows.append(dict(ms=k_ms, plain_ms=t_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None))
    return mabs, rows[0]


ZOOM_AGREE = 0.99      # winner agreement, kernel vs twin


ABSQ_RTOL, ABSQ_ATOL = 1e-4, 1e-7   # check_zoom's |M|^2 bounds


def check_split(sw, A1c, A1s):
    """The basis split against its twin on stage 2's own basis, bit for
    bit (both round to TF32 by the same rule); its row: the bytes it
    must move bound it (the basis read once, its four planes written
    once)."""
    import torch
    got, want = sw.split_basis(A1c, A1s), sw.split_basis_plain(A1c, A1s)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    say(f"  split_basis {tuple(A1c.shape)} -> {tuple(got.shape)} vs twin: "
        f"bit for bit {torch.equal(got, want)}, max |delta| {err!r}")
    if not torch.equal(got, want):
        raise RuntimeError("split_basis kernel disagrees with its twin")
    return dict(max_abs_err=err,
                ms=cuda_ms(lambda: sw.split_basis(A1c, A1s), 20),
                plain_ms=cuda_ms(lambda: sw.split_basis_plain(A1c, A1s), 20),
                **bound_row(tensor_bytes(A1c, A1s, got), 0))


def check_zoom(zs, calls, dr, keep=None):
    """The zoom-sweep kernel against its twin on each peak's inputs,
    flip-tolerant (tests/test_lockin_wfr.py's kernel bounds): winners
    agree on > 99% of pixels; where they agree, |M|^2 within rtol
    ABSQ_RTOL (atol ABSQ_ATOL of its maximum: float32 sums carry that
    much absolute noise), Re/Im within 1e-3 of the largest |M|, the
    weight within rtol 1e-5 (atol 1e-6), and the phase within 1e-5 rad
    modulo 2 pi where |M| is at least 1e-3 of its maximum (below that
    atan2 amplifies the same absolute noise). `keep`, a boolean mask
    broadcast to the planes: the bounds hold there (where the lattice
    is), the largest phase difference elsewhere is printed."""
    import torch
    mabs = 0.0
    for args in calls:
        got = zs.zoom_sweep(*args, dr=dr)
        want = zs.zoom_sweep_plain(*args, dr=dr)
        torch.cuda.synchronize()
        same = got[3] == want[3]
        agree = float(same.float().mean())
        dph = torch.remainder(got[4] - want[4] + np.pi, 2 * np.pi).sub(
            np.pi).abs()
        left = ""
        if keep is not None:
            out = same & ~keep & (want[0] >= 1e-6 * want[0].max())
            left = (f" (outside the held pixels {float(dph[out].max())!r} "
                    f"rad)" if bool(out.any()) else "")
            same = same & keep
        amax = float(want[0].max())
        top = amax ** 0.5
        d = [(g - w).abs() for g, w in zip(got, want)]
        ex_a = float((d[0] - ABSQ_RTOL * want[0].abs())[same].max())
        ex_w = float((d[5] - 1e-5 * want[5].abs())[same].max())
        live = same & (want[0] >= 1e-6 * amax)
        ph = float(dph[live].max())
        dre, dim = float(d[1][same].max()), float(d[2][same].max())
        mabs = max(mabs, dre, dim)
        say(f"  zoom_sweep P={args[2].shape[0]} windows "
            f"{tuple(args[0].shape)} vs twin: winners agree {agree!r}; "
            f"absq excess over rtol {ex_a / amax!r} of max, re "
            f"{dre / top!r}, im {dim / top!r} of max |M|, phase {ph!r} "
            f"rad{left}, weight excess over rtol {ex_w!r}")
        ok = (agree > ZOOM_AGREE and ex_a <= ABSQ_ATOL * amax
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
            f"(error bound {DCT_BOUND})")
        if not np.isfinite(e) or e > DCT_BOUND:
            raise RuntimeError(f"{name} kernel disagrees with its twin")
    return mabs


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper swapped for its plain twin (the DCT route
    predicate off), to drive a path on the card without its kernels."""
    from pygpa_tpu_torch.core import fourier
    from pygpa_tpu_torch.ops import (cg, drizzle, expand, fit, sweep, vcycle,
                                     warp, zoom_sweep)
    swaps = [(warp, "warp_bilinear", warp.warp_bilinear_plain),
             (warp, "warp_cubic", warp.warp_cubic_plain),
             (warp, "warp_cubic_disp", warp.warp_cubic_disp_plain),
             (drizzle, "drizzle", drizzle.drizzle_plain),
             (expand, "expand_cell", expand.expand_cell_plain),
             (sweep, "sweep_uv", sweep.sweep_uv_plain),
             (sweep, "sweep_pw", sweep.sweep_pw_plain),
             (sweep, "sweep_grad", sweep.sweep_grad_plain),
             (zoom_sweep, "zoom_sweep", zoom_sweep.zoom_sweep_plain),
             (vcycle, "presmooth", vcycle.presmooth_plain),
             (vcycle, "applyq", vcycle.applyq_plain),
             (cg, "cg_poisson", cg.cg_poisson_plain),
             (cg, "cg_unwrap", cg.cg_unwrap_plain),
             (fourier, "dct_kernel_ok", lambda n, dtype: False),
             (fit, "fit_kernel_ok", lambda *a: False)]
    saved = [(m, k, getattr(m, k)) for m, k, _ in swaps]
    for m, k, v in swaps:
        setattr(m, k, v)
    try:
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


@contextlib.contextmanager
def fit_twins():
    """The plane fit's route gate off (ops.fit.fit_kernel_ok), so the
    fits run the twin on the card, every other kernel as built."""
    from pygpa_tpu_torch.ops import fit
    real = fit.fit_kernel_ok
    fit.fit_kernel_ok = lambda *a: False
    try:
        yield
    finally:
        fit.fit_kernel_ok = real


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


ZOOM_PATH_F64 = 5e-4   # phase 5: interior p99 |du| px from the float64
#                        zoom sweep's path (the float32 twins' own path
#                        lies 4.45e-4 px from it on the bench fixture)


@contextlib.contextmanager
def float64_zoom():
    """The zoom-sweep wrapper swapped for its twin computed in float64
    (outputs cast back to float32), every other kernel as built: the
    path phase 5 holds the zoom kernel's path to."""
    from pygpa_tpu_torch.ops import zoom_sweep as zs

    def zoom64(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, dr=None, grad_ops=None):
        out = zs.zoom_sweep_plain(*(a.double() for a in (
            Sr, Si, gx, gy, A0c, A0s, A1c, A1s)), dr=dr,
            grad_ops=None if grad_ops is None else as_double(grad_ops))
        return tuple(o.float() if o.is_floating_point() else o for o in out)

    real = zs.zoom_sweep
    zs.zoom_sweep = zoom64
    try:
        yield
    finally:
        zs.zoom_sweep = real


SWEEP_PATH_F64 = 5e-4  # phase 6: interior p99 |du| px from the float64
#                        grouped sweep's path


@contextlib.contextmanager
def float64_sweep():
    """The grouped-sweep wrapper swapped for its twin computed in float64
    (outputs cast back to float32), every other kernel as built: the
    path phases 4 and 6 hold the grouped kernel's path to."""
    import torch
    from pygpa_tpu_torch.ops import sweep as sw

    def sweep64(*args):
        out = sw.sweep_uv_plain(*(a.double() if torch.is_tensor(a)
                                  and a.is_floating_point() else a
                                  for a in args))
        return tuple(o.float() for o in out)

    real = sw.sweep_uv
    sw.sweep_uv = sweep64
    try:
        yield
    finally:
        sw.sweep_uv = real


@contextlib.contextmanager
def float32_sweep():
    """The grouped-sweep wrapper swapped for its float32 twin alone."""
    from pygpa_tpu_torch.ops import sweep as sw
    real = sw.sweep_uv
    sw.sweep_uv = sw.sweep_uv_plain
    try:
        yield
    finally:
        sw.sweep_uv = real


def interior_dist(u, ref, ks, b=None):
    """Interior p99 and max |u - ref| (px), cutting b px (default the
    bench's 8 sigma border)."""
    if b is None:
        b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    d = (u - ref)[:, b:-b, b:-b].abs()
    return p99(d), float(d.max())


def drive_path(num, label, call, call_deconv, img, img_d, u_true, ks,
               ref64, bound64):
    """Phases 5 and 6: one counted run, timed runs, the path against its
    plain versions and against the path with a float64 sweep, the bench
    gates, stage times and peak memory. Returns the counted run's
    launches.

    The sweep kernels compute their products more accurately than their
    float32 twins, so a check against the twins' path measures rounding:
    the path with kernels is held to the path on the plain twins only by
    max < 1e-2 px (near-tie winner flips), and its interior p99 to the
    path with the sweep computed in float64 (`ref64`, a context): under
    `bound64` px and no further than the twins' own path; max < 1e-2
    px. The float64 path's own interior maxima are printed beside the
    gates'."""
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
    p99, dmax = interior_dist(u, up, ks)
    with ref64():
        u64 = call(img)
    k99, kmax = interior_dist(u, u64, ks)
    t99, tmax = interior_dist(up, u64, ks)
    say(f"    with kernels vs plain versions: interior p99 |du| {p99!r} "
        f"max {dmax!r} px (bound on max 1e-2)")
    say(f"    vs the path with a float64 sweep: with kernels p99 {k99!r} "
        f"max {kmax!r} px, plain versions p99 {t99!r} max {tmax!r} px "
        f"(bounds: p99 < {bound64} and <= the plain versions', max < 1e-2)")
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    ui = u64[:, b:-b, b:-b]
    say(f"    the float64-sweep path's own interior max |u| "
        f"{float(ui.abs().max())!r} px, dc-free "
        f"{float((ui - ui.mean(dim=(1, 2), keepdim=True)).abs().max())!r} "
        "px (the zero-displacement fixture)")
    ok = dmax < 1e-2 and k99 < bound64 and k99 <= t99 and kmax < 1e-2
    del u64, up
    if not ok:
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
    say(f"    unwrap stage (the exact CG on the early-stopping kernel) "
        f"{stages.get('unwrap')!r} ms; card {card_line()}")
    say(f"    peak device memory {peak / 2**30!r} GiB")
    return launches


def config3_fixture(torch):
    """benchmarks/run_all.py config 3 (2048^2): the lattice rendered with
    a Gaussian x-shift u, the clean lattice, u, the phase plane psi and
    the weight |img|."""
    from pygpa_tpu_torch.lattices import hexlattice_gen
    size = 2048
    S = size // 2
    xp, yp = np.meshgrid(np.arange(-S, S), np.arange(-S, S), indexing="ij")
    u = np.stack([3.0 * np.exp(-((xp / 400.) ** 2 + (yp / 500.) ** 2)),
                  np.zeros((size, size))]).astype(np.float32)
    img = hexlattice_gen(0.08, 5.0, order=2, size=size, shift=u,
                         dtype=torch.float32, device="cuda")
    clean = hexlattice_gen(0.08, 5.0, order=2, size=size,
                           dtype=torch.float32, device="cuda")
    psi = torch.from_numpy((0.05 * (xp + yp)).astype(np.float32)).cuda()
    return img, clean, torch.from_numpy(u).cuda(), psi, img.abs()


def config4_fixture(torch):
    """benchmarks/run_all.py config 4 (4096^2): the perfect lattice and
    the first two k-vectors in float32 (JAX's default precision there)."""
    from pygpa_tpu_torch.lattices import generate_ks, hexlattice_gen
    img = hexlattice_gen(0.02, 5.0, order=2, size=SIZE, dtype=torch.float32,
                         device="cuda")
    return img, generate_ks(0.02, 5.0)[:2].astype(np.float32)


def rel_rms(got, want, b):
    """rms(got - want) / rms(want) on the interior that crops b px."""
    d = (got - want)[b:-b, b:-b]
    w = want[b:-b, b:-b]
    return float((d * d).mean().sqrt() / (w * w).mean().sqrt())


WARP_BOUND = 1e-6


def check_warp(wm, name, args):
    """A warp kernel against its twin on one captured call: normwise
    relative error <= 1e-6 (the kernel repeats the twin's float32
    operations in the same order)."""
    import torch
    got = getattr(wm, name)(*args)
    want = getattr(wm, name + "_plain")(*args)
    torch.cuda.synchronize()
    e = rel_err(got, want)
    say(f"  {name} image {tuple(args[0].shape)} mode {args[3]!r} "
        f"{args[5] if len(args) > 5 else ''} vs twin: rel err {e!r} "
        f"(bound {WARP_BOUND})")
    if not torch.isfinite(got).all() or not e <= WARP_BOUND:
        raise RuntimeError(f"{name} kernel disagrees with its twin")
    return float((got - want).abs().max())


def check_cubic_disp(wm, args):
    """The displacement-form cubic kernel against its twin on one
    captured call, out of place and, for a two-plane call, in place on a
    copy of u: normwise relative error <= WARP_BOUND (the twin's float32
    operations in the same order)."""
    import torch
    got = wm.warp_cubic_disp(*args)
    want = wm.warp_cubic_disp_plain(*args)
    errs = [rel_err(got, want)]
    if args[0].shape[-1] == 2:
        u2 = args[1].clone()
        wm.warp_cubic_disp(args[0], u2, *args[2:6], u2)
        errs.append(rel_err(u2, want))
    torch.cuda.synchronize()
    say(f"  warp_cubic_disp {tuple(args[0].shape)} at {tuple(args[1].shape)}"
        f" mode {args[4]!r} margin {args[3]} vs twin: rel err (out of "
        f"place, in place) {errs} (bound {WARP_BOUND})")
    if not torch.isfinite(got).all() or not max(errs) <= WARP_BOUND:
        raise RuntimeError("warp_cubic_disp kernel disagrees with its twin")
    return float((got - want).abs().max())


def cubic_coords(args):
    """The coordinate-form cubic warp's arguments for the first plane of
    a displacement-form call: the positions its twin builds."""
    import torch
    from pygpa_tpu_torch.core import interp
    coef, u, origin, margin, mode, cval = args
    h, w = u.shape[-2:]
    xx = torch.arange(origin[0], origin[0] + h, device=u.device).float()
    yy = torch.arange(origin[1], origin[1] + w, device=u.device).float()
    c = interp.margin_coords(torch.stack([xx[:, None] + u[0],
                                          yy[None, :] + u[1]]),
                             coef.shape[:2], margin)
    return (coef[..., 0].contiguous(), c[0].contiguous(), c[1].contiguous(),
            mode, cval, "bspline")


DRIZZLE_BOUND = 1e-5


@contextlib.contextmanager
def drizzle_global_route():
    """The drizzle wrapper's route predicate set to the global-atomic
    route for every cell."""
    from pygpa_tpu_torch.ops import drizzle
    real = drizzle.shared_route
    drizzle.shared_route = lambda rsize: False
    try:
        yield
    finally:
        drizzle.shared_route = real


def check_drizzle(dm, args):
    """The drizzle kernel against its twin (float32 index_add_, sums in
    another order): normwise relative error <= 1e-5 for sum and weights;
    two launches, and the other route, agree bit for bit."""
    import torch
    s1, w1 = dm.drizzle(*args)
    s2, w2 = dm.drizzle(*args)
    with drizzle_global_route():
        sg, wg = dm.drizzle(*args)
    ps, pw = dm.drizzle_plain(*args)
    torch.cuda.synchronize()
    same = bool(torch.equal(s1, s2) and torch.equal(w1, w2))
    same_g = bool(torch.equal(s1, sg) and torch.equal(w1, wg))
    es, ew = rel_err(s1, ps), rel_err(w1, pw)
    route = "shared-memory" if dm.shared_route(s1.shape) else "global"
    say(f"  drizzle {tuple(args[0].shape)} -> {tuple(s1.shape)} ({route} "
        f"route) vs twin: rel err sum {es!r} weights {ew!r} (bound "
        f"{DRIZZLE_BOUND}); two launches bit-identical: {same}; "
        f"bit-identical to the global-atomic route: {same_g}")
    if not (same and same_g and es <= DRIZZLE_BOUND and ew <= DRIZZLE_BOUND):
        raise RuntimeError("drizzle kernel disagrees with its twin or its "
                           "other route, or does not repeat")
    return max(float((s1 - ps).abs().max()), float((w1 - pw).abs().max()))


def absmax_ms(img):
    """CUDA-event ms of the drizzle's max|v| pass alone (its C entry)."""
    import torch
    from pygpa_tpu_torch.ops import _build
    out = torch.zeros(1, dtype=torch.int32, device=img.device)
    fn = _build.bind("drizzle_absmax", "pipp")
    stream = torch.cuda.current_stream().cuda_stream
    return cuda_ms(lambda: _build.check(fn(img.data_ptr(), img.numel(),
                                           out.data_ptr(), stream),
                                        "drizzle_absmax"), 20)


@contextlib.contextmanager
def expand_l1_route():
    """The expand wrapper's route predicate set to the L1 route (no
    staging) for every cell."""
    from pygpa_tpu_torch.ops import expand
    real = expand.shared_route
    expand.shared_route = lambda shape: False
    try:
        yield
    finally:
        expand.shared_route = real


def check_expand(em, args):
    """The expand kernel against its twin: within WARP_BOUND of the
    cell's maximum (same float32 operations in the same order); a second
    launch and the L1 route give the same bits."""
    import torch
    got = em.expand_cell(*args)
    again = em.expand_cell(*args)
    with expand_l1_route():
        l1 = em.expand_cell(*args)
    want = em.expand_cell_plain(*args)
    torch.cuda.synchronize()
    e = float((got - want).abs().max()) / float(args[0].abs().max())
    same, same_l1 = bool(torch.equal(got, again)), bool(torch.equal(got, l1))
    say(f"  expand_cell cell {tuple(args[0].shape)} -> {tuple(got.shape)} "
        f"order {args[7]} vs twin: max |delta| / max |cell| {e!r} (bound "
        f"{WARP_BOUND}), rel err {rel_err(got, want)!r}; two launches "
        f"bit-identical: {same}; bit-identical to the L1 route: {same_l1}")
    if not (torch.isfinite(got).all() and e <= WARP_BOUND and same
            and same_l1):
        raise RuntimeError("expand kernel disagrees with its twin or its "
                           "other route, or does not repeat")
    return float((got - want).abs().max())


def kernel_ms(by_name, key):
    """Device ms of the kernels in a device_kernels breakdown whose name
    holds `key` (None without device records)."""
    if by_name is None:
        return None
    return sum(v for k, v in by_name.items() if key in k)


def run_path(label, title, call, gates):
    """Phases 7 and 8: a warm-up, one counted run (launch counts reset
    just before, read just after), the gates on its outputs, timed runs,
    peak memory, and the same path on the plain twins. Returns the
    counted run's launches."""
    import torch
    from pygpa_tpu_torch.ops import _build
    call()
    torch.cuda.synchronize()
    _build.launches.clear()
    outs = call()
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    say(f"[{label}] {title}: launches in one run: {launches}")
    missing = [k for k in PATH_KERNELS[label] if not launches.get(k)]
    if missing:
        raise RuntimeError(f"kernels of the path never ran: {missing}")
    for o in outs:
        if not torch.isfinite(o).any():
            raise RuntimeError(f"{title}: output has no finite value")
    vals, ok = gates(outs)
    say(f"    gates: {json.dumps(vals)}")
    if not ok:
        raise RuntimeError(f"{title}: ACCURACY GATE FAILED")
    t0 = time.perf_counter()
    for _ in range(REPS_NEW):
        call()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / REPS_NEW
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with plain_versions():
        refs = call()
    for o, r in zip(outs, refs):
        if not torch.equal(torch.isnan(o), torch.isnan(r)):
            raise RuntimeError(f"{title}: NaN bins differ from the twins'")
        e = rel_err(torch.nan_to_num(o), torch.nan_to_num(r))
        say(f"    with kernels vs plain versions: {tuple(o.shape)} max "
            f"|delta| / max |ref| {e!r} (bound {PATH_AGREE})")
        if not e < PATH_AGREE:
            raise RuntimeError(f"{title}: kernels change the result")
    say(f"    seconds per call {dt!r} ({REPS_NEW} runs after warm-up, host "
        f"clock, synchronized); peak device memory {peak / 2**30!r} GiB")
    return launches


def plan_line(fn):
    """The grouped sweep's plan of an extractor (G, P, W0, Wb), or that it
    has none (the per-peak sweeps)."""
    plan = fn.plan
    if plan is None:
        return "no grouped plan (per-peak sweeps)"
    wb = plan.idx1s.shape[1] if plan.col_groups is None \
        else plan.col_groups[0]
    return (f"grouped plan G, P = {tuple(plan.wl.shape[:2])}, W0 = "
            f"{plan.idx0s.shape[1]}, Wb = {wb}")


def launch_routes(launches):
    """The route each stage of an extractor's counted run took, read from
    the kernels it launched."""
    def runs(*keys):
        n = {k: launches[k] for k in keys if launches.get(k)}
        return f"kernels {n}" if n else None
    dct = [k for k in launches if k.startswith("dct")]
    return {"sweep": runs("sweep_uv") or "no grouped sweep kernel",
            "CG solves": runs("cg_poisson", "cg_unwrap")
            or "torch CG loop (no CG kernel launch)",
            "DCT": runs(*dct) or "twins (no DCT kernel launch)",
            "V-branch": runs("presmooth", "applyq") or "twins"}


SWEEP_SCALE = 10 * SWEEP_BOUNDS["dudx_p99"]


def check_path_kernels(label, fn, img_d):
    """Phase 13: each hand kernel an extractor's path launches, against
    its twin on the inputs one run of the same extractor hands it (phase
    3's checks and bounds), at the config's own shapes. That run is on
    the config's lattice displaced by bench_field, so the twin's
    gradient planes are far from 0 (their p99 must exceed SWEEP_SCALE, 10
    times the sweep's bound): a kernel that writes zeros fails. img_d may
    be a stack (phase 15a's displaced_stack). Returns the captured calls (sweep_uv,
    presmooth, applyq, cg_poisson) and each kernel's largest absolute
    difference from its twin; the early-stopping CG's calls (config 6's
    levels past ops.cg.MAX_SIDE) are held to its twin too."""
    import torch
    from pygpa_tpu_torch.ops import cg, sweep, vcycle, wfr
    from pygpa_tpu_torch.solvers import unwrap
    with Capture(wfr._sweep, "sweep_uv") as c_sw, \
            Capture(unwrap._vcycle, "presmooth") as c_ps, \
            Capture(unwrap._vcycle, "applyq") as c_aq, \
            Capture(unwrap._cg, "cg_poisson") as c_cg, \
            Capture(unwrap._cg, "cg_unwrap") as c_cu:
        fn(img_d)
        torch.cuda.synchronize()
    say(f"[{label}] kernels vs twins on one run's inputs (the lattice "
        f"displaced by bench_field, scaled per image in a stack): sweep_uv {len(c_sw.calls)}, presmooth "
        f"{[tuple(a[0].shape) for a in c_ps.calls]}, applyq "
        f"{[tuple(a[0].shape) for a in c_aq.calls]}, cg "
        f"{[tuple(a[0].shape) + (a[3],) for a in c_cg.calls]}")
    if not (c_sw.calls and c_ps.calls and c_aq.calls):
        raise RuntimeError(f"[{label}] a kernel of the path was not called")
    errs = {"sweep_uv": 0.0, "presmooth": 0.0, "applyq": 0.0,
            "cg_poisson": 0.0}
    for args in c_sw.calls:
        ux, uy, _ = sweep.sweep_uv_plain(*args)
        scale = min(p99(ux[..., 1:].abs()), p99(uy[..., 1:, :].abs()))
        say(f"  sweep_uv {tuple(args[0].shape)}: the twin's p99 |gradient| "
            f"{scale!r} (must exceed {SWEEP_SCALE})")
        if not scale > SWEEP_SCALE:
            raise RuntimeError(f"[{label}] the sweep's gradients are too "
                               "small to hold the kernel")
        del ux, uy
        errs["sweep_uv"] = max(errs["sweep_uv"], check_sweep(sweep, args))
    for ps in c_ps.calls:
        e_ps, e_aq = check_vcycle(vcycle, ps, c_aq.calls)
        errs["presmooth"] = max(errs["presmooth"], e_ps)
        errs["applyq"] = max(errs["applyq"], e_aq)
    if c_cg.calls:
        errs["cg_poisson"] = check_cg(cg, c_cg.calls)
    if c_cu.calls:
        errs["cg_unwrap"], _ = check_cg_unwrap(cg, c_cu.calls, label)
    return (c_sw.calls, c_ps.calls, c_aq.calls, c_cg.calls), errs


def drive_short(label, size, kw, r_k=0.1, theta=7.0, gate=0.02, mult=8,
                title="config 1", kernels=False):
    """Phases 9 and 13: make_displacement_extractor((size, size), the
    lattice's k-vectors, **kw) on the zero-displacement lattice (r_k,
    theta; order 2, float32): launch counts and the routes they show,
    finite output, the gate interior max |u| < gate px on the mult sigma
    interior, seconds per image, peak memory, and the path against the
    same path on the plain twins (interior p99 < 1e-3 px, max < 1e-2 px:
    near-tie winner flips between the grouped kernel and its twin); with
    `kernels`, check_path_kernels on the same extractor. Returns the
    counted run's launches."""
    import torch
    from pygpa_tpu_torch.gpa import pipeline
    from pygpa_tpu_torch.lattices import generate_ks, hexlattice_gen
    from pygpa_tpu_torch.ops import _build
    ks = generate_ks(r_k, theta)[:3]
    img = hexlattice_gen(r_k, theta, order=2, size=size, dtype=torch.float32,
                         device=DEVICE)
    fn = pipeline.make_displacement_extractor((size, size), ks,
                                              device=DEVICE, **kw)
    fn(img)
    torch.cuda.synchronize()
    _build.launches.clear()
    u = fn(img)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    say(f"[{label}] make_displacement_extractor(({size}, {size}), {title} "
        f"ks, {kw}): launches in one run: {launches}")
    say(f"    {plan_line(fn)}; routes: {json.dumps(launch_routes(launches))}")
    missing = [k for k in PATH_KERNELS[label] if not launches.get(k)]
    if missing:
        raise RuntimeError(f"kernels of the path never ran: {missing}")
    if tuple(u.shape) != (2, size, size) or not torch.isfinite(u).all():
        raise RuntimeError(f"[{label}] output bad, shape {tuple(u.shape)}")
    dt, peak = timed(lambda: fn(img), REPS_NEW)
    with plain_versions():
        up = fn(img)
    b = mult * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    p99, dmax = interior_dist(u, up, ks, b)
    err = float(u[:, b:-b, b:-b].abs().max())
    say(f"    gates: {json.dumps({'u_err_interior_px': err, 'gated': f'<{gate}, {mult} sigma border'})}")
    say(f"    with kernels vs plain versions: interior p99 |du| {p99!r} max "
        f"{dmax!r} px (bounds 1e-3, 1e-2); seconds per image {dt!r}, Mpix/s "
        f"{size * size / 1e6 / dt!r} ({REPS_NEW} runs after warm-up, host "
        f"clock, synchronized); peak device memory {peak!r} GiB")
    if not (err < gate and p99 < 1e-3 and dmax < 1e-2):
        raise RuntimeError(f"[{label}] gate or path check failed")
    if kernels:
        del u, up
        img_d = hexlattice_gen(r_k, theta, order=2, size=size,
                               shift=bench_field(size), dtype=torch.float32,
                               device=DEVICE)
        check_path_kernels(label, fn, img_d)
    return launches


def config2g_banks(ks):
    """benchmarks/run_all.py config 2g's candidate banks and sigma from
    the k-vectors in their own dtype (np.arange endpoints in it):
    sigma = ceil(1 / min |k|), kw = mean |k| / 2.5, steps of kw / 3."""
    knorms = np.linalg.norm(ks, axis=1)
    kw = knorms.mean() / 2.5
    wlists = []
    for pk in ks:
        wx, wy = np.meshgrid(np.arange(pk[0] - kw, pk[0] + kw, kw / 3),
                             np.arange(pk[1] - kw, pk[1] + kw, kw / 3),
                             indexing="ij")
        wlists.append(np.stack([wx.ravel(), wy.ravel()], -1))
    return wlists, int(np.ceil(1 / knorms.min()))


def config2g_step(ks):
    """Config 2g's step as run_all.py builds it: mean subtraction,
    wfr_sweep_phase_weight_multi(with_grad=True, krefs=ks) and
    calc_props_from_phasegradient on float32 k-vectors. A stack (B, n,
    m) goes through the sweep in one call (each image less its own
    mean) and gives (B, 4, n, m)."""
    import torch
    from pygpa_tpu_torch.ops.wfr import wfr_sweep_phase_weight_multi
    from pygpa_tpu_torch.props import calc_props_from_phasegradient
    wlists, sigma = config2g_banks(ks)
    kv = np.asarray(ks, np.float32)

    def step(image):
        img0 = image - image.mean(dim=(-2, -1), keepdim=True)
        _, weights, grads = wfr_sweep_phase_weight_multi(
            img0, wlists, sigma, 2 * sigma, with_grad=True, krefs=ks)
        if image.dim() == 3:
            return torch.stack([calc_props_from_phasegradient(kv, g, w, 1.0)
                                for g, w in zip(grads, weights)])
        return calc_props_from_phasegradient(kv, grads, weights, 1.0)
    return step, sigma


def tile_winners(idx, P):
    """Distinct winning candidates of each 64 x 64 tile of a (n, m) index
    plane, summed over the tiles."""
    import torch
    n, m = idx.shape
    t = idx.long().reshape(n // 64, 64, m // 64, 64).permute(0, 2, 1, 3)
    t = t.reshape(-1, 64 * 64)
    seen = torch.zeros((t.shape[0], P), dtype=torch.bool, device=idx.device)
    seen.scatter_(1, t, True)
    return int(seen.sum())


def grad_excess(got, want, where):
    """Largest |got - want| beyond GRAD_ATOL + GRAD_RTOL |want| on the
    pixels `where` (<= 0 passes), and the largest |got - want| there."""
    d = (got - want).abs()[where]
    return (float((d - GRAD_ATOL - GRAD_RTOL * want.abs()[where]).max()),
            float(d.max()))


def as_double(args):
    import torch
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


STAGE1_BOUND = 1e-5    # flagged Tx rows: max |kernel - twin| / max |twin|


def check_grad_steps(sw, T, ops, win, split):
    """The gradient steps after a tournament, each against its plain twin
    on the same inputs on the card: the band flags equal; Tx on the
    flagged pairs the full stage 1's rows bit for bit and within
    STAGE1_BOUND (relative) of the masked twin's; the winner products
    within GRAD_RTOL, GRAD_ATOL of the twin's at every pixel (both read
    the same winners). ops = (S2r, S2i, gx, gy, A0c, A0s, run, A1c, A1s,
    A1yc, A1ys, off, banded) in the grouped layout, win = (mr, mi, idx)
    the tournament's store. Returns ({step: (kernel ms, twin ms, max
    |kernel - twin|, library ms or None)}, flagged pairs)."""
    import torch
    S2r, S2i, gx, gy, A0c, A0s, run, A1c, A1s, A1yc, A1ys, off, banded = ops
    mr, mi, idx = win
    P = T.shape[1]
    flags = sw.band_winners(idx, P)
    if not torch.equal(flags, sw.band_winners_plain(idx, P)):
        raise RuntimeError("grad_flags disagrees with its twin")
    s1 = (S2r, S2i, gx, gy, A0c, A0s, run)
    Tx = sw.stage1(*s1, flags)
    rows = flags.permute(0, 2, 1).repeat_interleave(64, dim=2).bool()
    if not torch.equal(Tx[rows], sw.stage1(*s1)[rows]):
        raise RuntimeError("grad_stage1's rows are not the full launch's")
    want = sw._stage1_plain(*s1, flags)[rows]
    e1 = float((Tx[rows] - want).abs().max())
    say(f"    grad_stage1: {int(flags.sum())} of {flags.numel()} (band, "
        f"candidate) pairs; max |kernel - twin| {e1!r}, "
        f"{e1 / float(want.abs().max())!r} of the rows' max (bound "
        f"{STAGE1_BOUND})")
    if not e1 <= STAGE1_BOUND * float(want.abs().max()):
        raise RuntimeError("grad_stage1 disagrees with its twin")
    del want
    args = (T, Tx, A1c, A1s, A1yc, A1ys, mr, mi, idx, flags, off, banded)
    got = sw.winner_products(*args, split)
    want = sw.winner_products_plain(*args)
    every = torch.ones_like(idx, dtype=torch.bool)
    e2 = 0.0
    for k, nm in ((0, "gx"), (1, "gy")):
        if not torch.isfinite(got[k]).all():
            raise RuntimeError(f"grad_products: non-finite {nm}")
        ex, dmax = grad_excess(got[k], want[k], every)
        if ex > 0:
            raise RuntimeError(f"grad_products' {nm} disagrees with its twin "
                               f"(excess {ex!r})")
        e2 = max(e2, dmax)
    del got, want
    # the library call: one scatter_ of the index plane (widened to int64
    # once, as scatter_ takes it) into zeroed flags; it is idempotent, so
    # repeats compute the same flags
    G, n, m = idx.shape
    lib_idx = idx.long().reshape(G, n // 64, 64 * m)
    lib_flags = torch.zeros_like(flags)
    lib_flags.scatter_(2, lib_idx, 1)
    if not torch.equal(lib_flags, flags):
        raise RuntimeError("scatter_ computes other flags than grad_flags")
    parts = {
        "grad_flags": (cuda_ms(lambda: sw.band_winners(idx, P), 5),
                       cuda_ms(lambda: sw.band_winners_plain(idx, P), 5),
                       0.0, cuda_ms(lambda: lib_flags.scatter_(2, lib_idx, 1),
                                    5)),
        "grad_stage1": (cuda_ms(lambda: sw.stage1(*s1, flags), 5),
                        cuda_ms(lambda: sw._stage1_plain(*s1, flags), 1),
                        e1, None),
        "grad_products": (
            cuda_ms(lambda: sw.winner_products(*args, split), 3),
            cuda_ms(lambda: sw.winner_products_plain(*args), 1), e2, None)}
    del lib_idx, lib_flags
    return parts, int(flags.sum())


def step_bounds(P, n, m, W0, W, pairs, wins, win_bytes):
    """Bounds (ms) of the gradient steps from this run's winners: the
    band flags read the index plane and write the flags; stage 1 on the
    pairs flagged of P * n/64 does 8 * 64 W0 W FLOP a pair in float32
    FMA; the products read those pairs' rows of T and Tx, the bases, the
    winners' planes and flags and write gx, gy, with 2 * 8 * 64^2 * W
    FLOP per tile winner three times over at the dense TF32 rate.
    win_bytes: the bytes of the inputs each step reads besides those."""
    nb = n // 64
    flag_b = 4 * nb * P
    rows_b = pairs * 64 * 2 * W * 4
    fg = 2 * 8 * wins * 64 * 64 * W
    return {"grad_flags": bound(4 * n * m + flag_b, n * m),
            "grad_stage1": bound(win_bytes["stage1"] + flag_b + rows_b,
                                 8 * pairs * 64 * W0 * W),
            "grad_products": (zoom_bounds(
                win_bytes["products"] + flag_b + 2 * rows_b
                + 5 * n * m * 4, 0, fg)[1], "operations")}


def winner_counts(sw, idx, P):
    """(flagged (band, candidate) pairs, tile winners) of a (G, n, m)
    index plane, from the band flags' plain twin and tile_winners."""
    return (int(sw.band_winners_plain(idx, P).sum()),
            sum(tile_winners(x, P) for x in idx))


def say_parts(label, t, got, twin, P, bands, tiles):
    """The parts' times, and the band and tile winners of the kernel's
    tournament (`got`) and of the float32 twin's (`twin`, which the
    bounds count)."""
    say(f"  {label} parts (ms, CUDA events): " + ", ".join(
        f"{k} {v!r}" for k, v in t.items()) + "; band winners (kernel, "
        f"twin) {got[0]}, {twin[0]} of {P * bands} (band, candidate) pairs "
        f"({got[0] / bands!r}, {twin[0] / bands!r} a band); tile winners "
        f"{got[1]}, {twin[1]} ({got[1] / tiles!r}, {twin[1] / tiles!r} a "
        "tile)")


def check_zoom_grad(zs, sw, calls, kws):
    """Emission (c) on each peak's captured inputs: the gradients against
    the float32 twin on the pixels whose winners agree (> GRAD_AGREE of
    them; rtol GRAD_RTOL, atol GRAD_ATOL rad/px), and both against the
    float64 twin's (distances printed); the tournament is the plain
    launch's, bit for bit; each gradient step against its twin
    (check_grad_steps); the call's parts timed apart, the band and tile
    winners counted. Returns the rows of "zoom_grad" and the three
    steps (summed over the peaks) and the old design's bound."""
    import torch
    mabs = k_ms = t_ms = 0.0
    nbytes = f1 = f1x = f2 = fg = 0
    steps = {k: [0.0, 0.0, 0.0, None] for k in ("grad_flags", "grad_stage1",
                                                 "grad_products")}
    sb = {k: [0.0, None] for k in steps}
    for a, kw in zip(calls, kws):
        gops = kw["grad_ops"]
        got = zs.zoom_sweep(*a, grad_ops=gops)
        plain = zs.zoom_sweep(*a)
        want = zs.zoom_sweep_plain(*a, grad_ops=gops)
        w64 = zs.zoom_sweep_plain(*as_double(a), grad_ops=as_double(gops))
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got[:4], plain)):
            raise RuntimeError("zoom_grad: the tournament's bits differ "
                               "from the plain launch's")
        same = got[3] == want[3]
        agree = float(same.float().mean())
        line = []
        ok = agree > GRAD_AGREE
        for k, nm in ((4, "gx"), (5, "gy")):
            if not torch.isfinite(got[k]).all():
                raise RuntimeError(f"zoom_grad: non-finite {nm}")
            ex, dmax = grad_excess(got[k], want[k], same)
            s64 = got[3] == w64[3]
            d64 = float((got[k].double() - w64[k]).abs()[s64].max())
            t64 = float((want[k].double() - w64[k]).abs()[s64].max())
            line.append(f"{nm} max |kernel - twin| {dmax!r} (excess over "
                        f"the bound {ex!r}); vs the float64 twin: kernel "
                        f"{d64!r}, float32 twin {t64!r}")
            ok &= ex <= 0
            mabs = max(mabs, dmax)
        (W0, W1), P = a[0].shape, a[2].shape[0]
        n, m = a[4].shape[0], a[6].shape[0]
        # the bounds count the float32 twin's winners, not the kernel's
        twin = winner_counts(sw, want[3][None], P)
        say(f"  zoom_grad P={P} W0={W0} W1={W1}: winners agree {agree!r}; "
            + "; ".join(line))
        if not ok:
            raise RuntimeError("zoom_grad kernel disagrees with its twin")
        del got, plain, want, w64
        # the steps after the tournament, as one group with one band run
        T = zs.stage1(*a[:6])
        out = zs.stage2(T, a[6], a[7], None)
        run = torch.zeros((1, P), dtype=torch.int32, device=T.device)
        S2r, S2i, A1yc, A1ys = gops
        ops = (S2r[None, None], S2i[None, None], a[2][None], a[3][None],
               a[4][None], a[5][None], run, a[6][None], a[7][None],
               A1yc[None], A1ys[None], None, False)
        parts, pairs = check_grad_steps(
            sw, T[None], ops, tuple(x[None] for x in out[1:4]), False)
        wins = tile_winners(out[3], P)
        t = {"call": cuda_ms(lambda a=a: zs.zoom_sweep(*a, grad_ops=gops),
                             3),
             "stage1_T": cuda_ms(lambda a=a: zs.stage1(*a[:6]), 3),
             "tournament": cuda_ms(lambda T=T, a=a: zs.stage2(
                 T, a[6], a[7], None), 3)}
        t.update({k: v[0] for k, v in parts.items()})
        say_parts(f"zoom_grad P={P}", t, (pairs, wins), twin, P, n // 64,
                  n * m // 4096)
        stage2_rate(f"zoom_grad P={P} W1={W1} tournament", t["tournament"],
                    8 * P * n * m * W1)
        del T, out
        k_ms += t["call"]
        t_ms += cuda_ms(lambda a=a: zs.zoom_sweep_plain(*a, grad_ops=gops),
                        1)
        call_bytes = tensor_bytes(a, gops) + 6 * n * m * 4
        nbytes += call_bytes
        f1 += 8 * P * n * W0 * W1
        f1x += 8 * twin[0] * 64 * W0 * W1
        f2 += 8 * P * n * m * W1
        fg += 2 * 8 * twin[1] * 64 * 64 * W1
        b = step_bounds(P, n, m, W0, W1, *twin, {
            "stage1": tensor_bytes(gops[:2], a[2:6]),
            "products": tensor_bytes(a[6:8], gops[2:])})
        for k, v in parts.items():
            for q in range(2):
                steps[k][q] += v[q]
            steps[k][2] = max(steps[k][2], v[2])
            if v[3] is not None:
                steps[k][3] = (steps[k][3] or 0.0) + v[3]
            sb[k][0] += b[k][0]
            sb[k][1] = b[k][1]
    rows = {"zoom_grad": dict(
        max_abs_err=mabs, ms=k_ms, plain_ms=t_ms,
        bound_ms=zoom_bounds(nbytes, f1 + f1x, f2 + fg)[1],
        bound_by="operations", library_ms=None)}
    for k, (ms, pm, err, lib) in steps.items():
        rows[k] = dict(max_abs_err=err, ms=ms, plain_ms=pm,
                       bound_ms=sb[k][0], bound_by=sb[k][1], library_ms=lib)
    old = zoom_bounds(nbytes, 2 * f1, f2 + fg)[1]
    need = rows["zoom_grad"]["bound_ms"]
    say(f"    zoom_grad, three peaks: kernel {k_ms!r} ms, twin {t_ms!r} ms; "
        f"bound of the work the function needs {need!r} ms (stage 1 {f1!r} "
        f"and on the band winners {f1x!r} FLOP in float32 FMA, stage 2 {f2!r} and the winner products {fg!r} in "
        f"3xTF32); the old design's work (stage 1 twice in full) "
        f"{old!r} ms")
    return rows


PW_BOUNDS = {"phase_flips": 1e-2, "phase_p99": 5e-5, "weight_rel_p99": 5e-5,
             "weight_rel_max": 2e-2}


def pw_stats(ph, wt, ph_w, wt_w):
    """The uv route's phase/weight numbers (tests/test_torch_cuda.py's
    grouped stage-2 test): the share of phases more than 1e-4 rad off,
    their p99, and the weights' relative p99 and maximum."""
    import torch
    dt = ph_w.dtype
    dph = (torch.remainder(ph.to(dt) - ph_w + np.pi, 2 * np.pi)
           - np.pi).abs().flatten()
    rel = ((wt.to(dt) - wt_w).abs() / (wt_w.abs() + 1e-9)).flatten()
    q = torch.tensor([0.99], device=dph.device, dtype=dt)
    return {"phase_flips": float((dph > 1e-4).double().mean()),
            "phase_p99": float(torch.quantile(dph[::7], q)),
            "weight_rel_p99": float(torch.quantile(rel[::7], q)),
            "weight_rel_max": float(rel.max())}


def check_grouped_emissions(sw, args):
    """Emissions (a) and (b) of the grouped sweep on path 10b's inputs
    (sweep_grad's arguments; (a) takes them without the gradient
    operands): (a) against the float32 and float64 twins within
    PW_BOUNDS; (b) returns (a)'s planes bit for bit, and its gradients
    lie within rtol GRAD_RTOL, atol GRAD_ATOL of each twin's wherever the
    phases agree within 1e-3 rad, at all but 1 - GRAD_AGREE of the
    pixels (near-tie winner flips), and within GRAD_SLIP at every pixel
    where the phases agree. Returns the rows of both."""
    import torch
    pw_args = args[:2] + args[4:10] + args[12:]
    pw = sw.sweep_pw(*pw_args)
    gr = sw.sweep_grad(*args)
    torch.cuda.synchronize()
    if not (torch.equal(gr[0], pw[0]) and torch.equal(gr[1], pw[1])):
        raise RuntimeError("sweep_grad's phase/weight planes are not "
                           "sweep_pw's")
    pw_abs, gr_abs = 0.0, 0.0
    for tag, dt in (("float32", None), ("float64", torch.float64)):
        a = args if dt is None else as_double(args)
        want = sw.sweep_grad_plain(*a, winners=dt is None)
        st = pw_stats(pw[0], pw[1], want[0], want[1])
        say(f"  sweep_pw vs the {tag} twin: {json.dumps(st)} (bounds "
            f"{json.dumps(PW_BOUNDS)})")
        if not all(st[k] < v for k, v in PW_BOUNDS.items()):
            raise RuntimeError(f"sweep_pw disagrees with its {tag} twin")
        dph = (torch.remainder(gr[0].to(want[0].dtype) - want[0] + np.pi,
                               2 * np.pi) - np.pi).abs()
        ok_ph = dph < 1e-3
        bad = ~ok_ph
        line = []
        for k, nm in ((2, "gx"), (3, "gy")):
            if not torch.isfinite(gr[k]).all():
                raise RuntimeError(f"sweep_grad: non-finite {nm}")
            g64, w = gr[k].to(want[k].dtype), want[k]
            d = (g64 - w).abs()
            bad |= d > GRAD_ATOL + GRAD_RTOL * w.abs()
            dmax = float(d[ok_ph].max())
            line.append(f"{nm} max |kernel - twin| {dmax!r} where the "
                        f"phases agree")
            if dt is None:
                gr_abs = max(gr_abs, dmax)
        share = float(bad.double().mean())
        say(f"  sweep_grad vs the {tag} twin: " + "; ".join(line)
            + f"; pixels off the bounds {share!r} (bound {1 - GRAD_AGREE!r})")
        if not (share < 1 - GRAD_AGREE
                and all(float((gr[k].to(want[k].dtype) - want[k]).abs()
                              [ok_ph].max()) < GRAD_SLIP for k in (2, 3))):
            raise RuntimeError(f"sweep_grad disagrees with its {tag} twin")
        if dt is None:
            pw_abs = float((pw[1] - want[1]).abs().max())
            # the bounds count the float32 twin's winners
            twin = winner_counts(sw, want[6], args[4].shape[1])
        del want
    # the steps after the tournament, its parts timed apart, winners
    # counted and the bounds
    (Sr, Si, S2r, S2i, gx, gy, A0c, A0s, A1c, A1s, A1yc, A1ys, run, off,
     dr, banded) = args
    G, P, W0 = gx.shape
    n, m, Wb = A0c.shape[1], A1c.shape[1], A1c.shape[2]
    T = sw.stage1(Sr, Si, gx, gy, A0c, A0s, run)
    win = sw.stage2(T, A1c, A1s, off, dr, banded, winners=True)
    if not (torch.equal(win[0], pw[0]) and torch.equal(win[1], pw[1])):
        raise RuntimeError("the tournament that stores the winners changes "
                           "(a)'s planes")
    parts, pairs = check_grad_steps(
        sw, T, (S2r, S2i, gx, gy, A0c, A0s, run, A1c, A1s, A1yc, A1ys, off,
                banded), win[2:], True)
    wins = sum(tile_winners(win[4][g], P) for g in range(G))
    t = {"call": cuda_ms(lambda: sw.sweep_grad(*args), 3),
         "stage1_T": cuda_ms(lambda: sw.stage1(Sr, Si, gx, gy, A0c, A0s,
                                               run), 3),
         "tournament": cuda_ms(lambda: sw.stage2(T, A1c, A1s, off, dr, banded,
                                                 winners=True), 3),
         "tournament_pw": cuda_ms(lambda: sw.stage2(T, A1c, A1s, off, dr,
                                                    banded), 3)}
    t.update({k: v[0] for k, v in parts.items()})
    del T, win
    say_parts(f"sweep_grad G={G} P={P} Wb={Wb}", t, (pairs, wins), twin, P,
              G * n // 64, G * n * m // 4096)
    f1, f2 = 8 * G * P * n * W0 * Wb, 8 * G * P * n * m * Wb
    stage2_rate(f"sweep_grad G={G} P={P} Wb={Wb} tournament (winners "
                "stored)", t["tournament"], f2)
    stage2_rate(f"sweep_pw G={G} P={P} Wb={Wb} tournament", t["tournament_pw"],
                f2)
    f1x = 8 * twin[0] * 64 * W0 * Wb
    fg = 2 * 8 * twin[1] * 64 * 64 * Wb
    pw_b = zoom_bounds(tensor_bytes(pw_args, pw), f1, f2)[1]
    gr_bytes = tensor_bytes(args, gr)
    gr_b = zoom_bounds(gr_bytes, f1 + f1x, f2 + fg)[1]
    gr_old = zoom_bounds(gr_bytes, 2 * f1, f2 + fg)[1]
    rows = {"sweep_pw": dict(
                max_abs_err=pw_abs, ms=cuda_ms(lambda: sw.sweep_pw(*pw_args),
                                               3),
                plain_ms=cuda_ms(lambda: sw.sweep_pw_plain(*pw_args), 1),
                bound_ms=pw_b, bound_by="operations", library_ms=None),
            "sweep_grad": dict(
                max_abs_err=gr_abs, ms=t["call"],
                plain_ms=cuda_ms(lambda: sw.sweep_grad_plain(*args), 1),
                bound_ms=gr_b, bound_by="operations", library_ms=None)}
    say(f"  grouped emissions G={G} P={P} W0={W0} Wb={Wb} banded={banded}: "
        f"FLOP stage 1 {f1!r}, on the band winners {f1x!r}, stage 2 "
        f"{f2!r}, winner products {fg!r}; sweep_grad: the old design's "
        f"work (stage 1 twice in full) bounds at {gr_old!r} ms")
    for k, r in rows.items():
        say(f"  {k}: kernel {r['ms']!r} ms, twin {r['plain_ms']!r} ms, bound "
            f"{r['bound_ms']!r} ms (the work the function needs, stage 2 and "
            "the winner products in 3xTF32)")
    return rows


def sweep_launches(launches, label):
    """Fail unless the counted run launched exactly PATH_SWEEPS[label]'s
    sweeps and no other sweep, and each gradient step once per gradient
    emission."""
    want = PATH_SWEEPS[label]
    got = {k: launches.get(k, 0) for k in SWEEP_NAMES}
    if any(got[k] != want.get(k, 0) for k in SWEEP_NAMES):
        raise RuntimeError(f"[{label}] sweep launches {got}, expected "
                           f"{want}")
    steps = {k: launches.get(k, 0) for k in GRAD_STEPS}
    if any(v != got["zoom_grad"] + got["sweep_grad"] for v in steps.values()):
        raise RuntimeError(f"[{label}] gradient steps {steps} for "
                           f"{got['zoom_grad'] + got['sweep_grad']} gradient "
                           "emissions")


def counted_run(label, call):
    """A warm-up call, then one call with the launch counts reset just
    before and read just after; fails unless every kernel of
    PATH_KERNELS[label] ran and, where PATH_SWEEPS has the label, the
    sweeps are its."""
    import torch
    from pygpa_tpu_torch.ops import _build
    call()
    torch.cuda.synchronize()
    _build.launches.clear()
    out = call()
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    missing = [k for k in PATH_KERNELS[label] if not launches.get(k)]
    if missing:
        raise RuntimeError(f"kernels of the path never ran: {missing}")
    if label in PATH_SWEEPS:
        sweep_launches(launches, label)
    return out, launches


def timed(call, reps):
    """(seconds per call over `reps` synchronized runs on the host clock,
    peak device GiB of one more run)."""
    import torch
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    return dt, torch.cuda.max_memory_allocated() / 2**30


def drive_2g(label, title, ks, img):
    """Phase 10: config 2g's step on the bench fixture: launch counts,
    the gates on the 4 sigma interior, the same step on the plain twins
    (a tenth of each gate), seconds per call and peak memory. Returns
    the counted run's launches."""
    import torch
    from pygpa_tpu_torch.props import get_initial_props
    step, sigma = config2g_step(ks)
    props, launches = counted_run(label, lambda: step(img))
    say(f"[{label}] {title}: launches in one run: {launches}")
    if tuple(props.shape) != (4, SIZE, SIZE) or not torch.isfinite(
            props).all():
        raise RuntimeError(f"[{label}] props bad: {tuple(props.shape)}")
    b = 4 * sigma
    theta0 = float(np.float32(float(get_initial_props(ks)[1])))
    th, ka = props[0][b:-b, b:-b], props[3][b:-b, b:-b]
    gates = {"theta_err_interior_deg": float((th - theta0).abs().max()),
             "kappa_err_interior": float((ka - 1.005).abs().max()),
             "gated": f"theta<{GATE_2G_THETA}, kappa<{GATE_2G_KAPPA}"}
    say(f"    gates: {json.dumps(gates)}")
    if not (gates["theta_err_interior_deg"] < GATE_2G_THETA
            and gates["kappa_err_interior"] < GATE_2G_KAPPA):
        raise RuntimeError(f"[{label}] ACCURACY GATE FAILED")
    dt, peak = timed(lambda: step(img), REPS_EXACT)
    with plain_versions():
        pp = step(img)
    dth = float((props[0] - pp[0])[b:-b, b:-b].abs().max())
    dka = float((props[3] - pp[3])[b:-b, b:-b].abs().max())
    say(f"    with kernels vs plain versions, 4 sigma interior: max |dtheta| "
        f"{dth!r} deg, max |dkappa| {dka!r} (bounds "
        f"{GATE_2G_THETA / 10}, {GATE_2G_KAPPA / 10})")
    say(f"    seconds per call {dt!r} ({REPS_EXACT} runs after warm-up, host "
        f"clock, synchronized); peak device memory {peak!r} GiB")
    if not (dth < GATE_2G_THETA / 10 and dka < GATE_2G_KAPPA / 10):
        raise RuntimeError(f"[{label}] kernels change the result")
    return launches


def gates_ok(g):
    return g[0] < GATE_INTERIOR and g[1] < GATE_DCFREE and g[2] < GATE_DEFORMED


def say_gates(g):
    say("    gates: " + json.dumps({
        "u_err_interior_px": g[0], "u_err_interior_dcfree_px": g[1],
        "u_err_deformed_px": g[2],
        "gated": f"interior<{GATE_INTERIOR}, dcfree<{GATE_DCFREE}, "
                 f"deformed<{GATE_DEFORMED}"}))


def drive_eager_grad(img, img_d, u_true, ks):
    """Phase 11a: the eager path with with_grad=True: 3 zoom_grad
    launches, finite gradients, u the plain eager path's bits, the
    bench's three gates, seconds per call and peak memory."""
    import torch
    from pygpa_tpu_torch.gpa import pipeline

    def call():
        return pipeline.extract_displacement_field(img, ks, with_grad=True,
                                                   return_gs=True,
                                                   device=DEVICE)
    (u, gs), launches = counted_run("11a", call)
    say(f"[11a] extract_displacement_field(img, ks, with_grad=True, "
        f"return_gs=True): launches in one run: {launches}")
    for g in gs:
        if tuple(g["grad"].shape) != (SIZE, SIZE, 2) or not torch.isfinite(
                g["grad"]).all():
            raise RuntimeError("[11a] gradients bad")
    u0 = pipeline.extract_displacement_field(img, ks, device=DEVICE)
    if not torch.equal(u, u0):
        raise RuntimeError("[11a] u differs from the path without with_grad")
    ud = pipeline.extract_displacement_field(img_d, ks, deconvolve=True,
                                             with_grad=True, device=DEVICE)
    g = gate_values(u, ud, u_true, ks)
    say_gates(g)
    dt, peak = timed(call, 2)
    say(f"    u is the path without with_grad's, bit for bit; seconds per "
        f"call {dt!r} (2 runs after warm-up, host clock, synchronized); "
        f"peak device memory {peak!r} GiB")
    if not gates_ok(g):
        raise RuntimeError("[11a] ACCURACY GATE FAILED")
    return launches


def drive_demod(img, img_d, u_true, ks):
    """Phase 11b: the factory at its defaults with pipeline_fused_uv=False:
    one sweep_pw launch, the bench's three gates, the distance from the
    uv route's u, seconds per image and peak memory."""
    import dataclasses
    from pygpa_tpu_torch.gpa import pipeline
    real = pipeline.DEFAULTS
    pipeline.DEFAULTS = dataclasses.replace(real, pipeline_fused_uv=False)
    try:
        fn = pipeline.make_displacement_extractor((SIZE, SIZE), ks,
                                                  device=DEVICE)
        fn_d = pipeline.make_displacement_extractor(
            (SIZE, SIZE), ks, deconvolve=True, device=DEVICE)
    finally:
        pipeline.DEFAULTS = real
    u, launches = counted_run("11b", lambda: fn(img))
    say(f"[11b] make_displacement_extractor((4096, 4096), ks) defaults, "
        f"pipeline_fused_uv=False: launches in one run: {launches}")
    g = gate_values(u, fn_d(img_d), u_true, ks)
    say_gates(g)
    p99, dmax = interior_dist(u, pipeline.make_displacement_extractor(
        (SIZE, SIZE), ks, device=DEVICE)(img), ks)
    dt, peak = timed(lambda: fn(img), REPS_EXACT)
    say(f"    vs the uv route (phase 6's call): interior p99 |du| {p99!r} max "
        f"{dmax!r} px; seconds per image {dt!r} ({REPS_EXACT} runs after "
        f"warm-up, host clock, synchronized); peak device memory {peak!r} "
        "GiB")
    if not gates_ok(g):
        raise RuntimeError("[11b] ACCURACY GATE FAILED")
    return launches


def canon(ks):
    """k-vectors with a non-negative x (y where x is 0), rows sorted: a
    set of ks up to the sign of each."""
    ks = np.asarray(ks, np.float64)
    c = np.where(np.sign(ks[:, [0]]) != 0, np.sign(ks[:, [0]]) * ks,
                 np.sign(ks[:, [1]]) * ks)
    return c[np.lexsort(c.T[::-1])]


def to_true(found, true):
    """For each true k, its distance (up to sign) to the nearest of
    `found`, and the found ks reordered and sign-aligned to the true
    ones (tests/test_peaks.py's alignment, with the order matched)."""
    found = np.asarray(found, np.float64)
    both = np.concatenate([found, -found])
    d = np.linalg.norm(both[None] - true[:, None], axis=-1)
    return d.min(axis=1), both[d.argmin(axis=1)]


@contextlib.contextmanager
def record_fetches(peaks_mod, sizes):
    """Append each detection attempt's candidate record size (bytes, the
    one copy to the host an attempt makes) to `sizes`."""
    orig = peaks_mod._peak_candidates

    def spy(*a, **kw):
        rec = orig(*a, **kw)
        sizes.append(rec.numel() * rec.element_size())
        return rec

    peaks_mod._peak_candidates = spy
    try:
        yield
    finally:
        peaks_mod._peak_candidates = orig


def counted(call):
    """(out, launches, seconds) of one synchronized call with the launch
    counts reset just before and read just after."""
    import torch
    from pygpa_tpu_torch.ops import _build
    torch.cuda.synchronize()
    _build.launches.clear()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return out, dict(_build.launches), time.perf_counter() - t0


def drive_peaks(img, ks):
    """Phases 12a and 12b: Bragg peaks from the raw 4096^2 image, then
    refine_ks (and how far its result lies from refine_ks on the plane
    fit's twin). Returns the refined ks (host numpy, in the true ks'
    order) and the counted refine_ks run's launches."""
    import pygpa_tpu_torch as gt
    from pygpa_tpu_torch.gpa import peaks as peaks_mod
    true = np.asarray(ks, np.float64)
    size = img.shape[0]
    gt.gpa.extract_primary_ks(img)                 # warm-up
    sizes = []
    with record_fetches(peaks_mod, sizes):
        (pks, all_ks), launches, _ = counted(
            lambda: gt.gpa.extract_primary_ks(img))
    t0 = time.perf_counter()
    for _ in range(PEAK_REPS):
        gt.gpa.extract_primary_ks(img)
    dt = (time.perf_counter() - t0) / PEAK_REPS
    t0 = time.perf_counter()
    pks_cpu, all_cpu = gt.gpa.extract_primary_ks(img.cpu(), device="cpu")
    dt_cpu = time.perf_counter() - t0
    d, _ = to_true(pks, true)
    same = len(pks) == len(pks_cpu) and len(all_ks) == len(all_cpu) and \
        np.abs(canon(pks) - canon(pks_cpu)).max() <= 1e-9 and \
        np.abs(canon(all_ks) - canon(all_cpu)).max() <= 1e-9
    say(f"[12a] extract_primary_ks(img) at the README's defaults, {size}^2: "
        f"launches {launches}; {len(sizes)} attempt(s), {sizes} bytes "
        f"fetched to the host (one record each); primary ks {pks.tolist()} "
        f"({len(all_ks)} candidates); distance to the true ks (up to sign) "
        f"{(d * size).tolist()} / size (gate {GATE_PEAKS}); the same "
        f"canonical sets as device='cpu': {same} (atol 1e-9); seconds per "
        f"call {dt!r} ({PEAK_REPS} runs after warm-up, host clock, "
        f"synchronized), the CPU call {dt_cpu!r} s")
    if not (len(pks) == 3 and np.all(d < GATE_PEAKS / size) and same):
        raise RuntimeError("[12a] Bragg peaks: GATE FAILED")

    pks_s, _ = gt.gpa.extract_primary_ks(img, DoG=False, subpixel=True)
    d_sub, _ = to_true(pks_s, true)
    _, pks3 = to_true(gt.gpa.select_closest_to_triangle(pks_s)
                      if len(pks_s) > 3 else pks_s, true)
    refined, launches, dt = counted(lambda: gt.gpa.refine_ks(img, pks3))
    _, _, dt2 = counted(lambda: gt.gpa.refine_ks(img, pks3))
    with fit_twins():
        refined_twin = gt.gpa.refine_ks(img, pks3)
    d_twin = np.abs(refined - refined_twin).max()
    d_ref = np.linalg.norm(refined - true, axis=-1)
    n_dct = sum(launches.get(k, 0) for k in ("dct_lane", "dct_sub"))
    say(f"[12b] extract_primary_ks(img, DoG=False, subpixel=True): distance "
        f"to the true ks {(d_sub * size).tolist()} / size (gate "
        f"{GATE_SUBPIXEL}); refine_ks(img, pks3): launches {launches} "
        f"({n_dct} DCT kernel launches: iterate_GPA trims 5 px, so its "
        f"exact unwraps run at {size - 10}^2, each one cg_unwrap launch "
        f"with its chirp-z passes inside); refined "
        f"{refined.tolist()}, distance {(d_ref * size).tolist()} / size "
        f"(gate {GATE_REFINE}); seconds per call {dt!r} (first), {dt2!r} "
        f"(second; host clock, synchronized); max |refined - refined on "
        f"the fit's twin| {d_twin!r} (1 / px)")
    missing = [k for k in PATH_KERNELS["12b"] if not launches.get(k)]
    if missing:
        raise RuntimeError(f"[12b] kernels of the path not launched: "
                           f"{missing} (launches {launches})")
    if not (np.all(d_sub < GATE_SUBPIXEL / size) and n_dct == 0
            and np.all(d_ref < GATE_REFINE / size)):
        raise RuntimeError("[12b] sub-bin peaks or refine_ks: GATE FAILED")
    return refined, launches


def drive_refined_u(img, ks32, refined):
    """Phase 12c: extract_displacement_field from the refined ks against
    phase 5's u from the true ks, each component's least-squares plane
    removed on the 8 sigma interior (a k error is a uniform strain)."""
    import torch
    import pygpa_tpu_torch as gt
    u5 = gt.gpa.extract_displacement_field(img, ks32)
    u12, launches, dt = counted(
        lambda: gt.gpa.extract_displacement_field(img, refined))
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks32, axis=1).min()))
    d = (u12 - u5)[:, b:-b, b:-b].double()
    h, w = d.shape[-2:]
    # on a full grid with centred coordinates the plane's normal
    # equations are diagonal
    x = torch.arange(h, dtype=torch.float64, device=d.device) - (h - 1) / 2
    y = torch.arange(w, dtype=torch.float64, device=d.device) - (w - 1) / 2
    sx = (d * x[:, None]).sum((-2, -1)) / (w * (x * x).sum())
    sy = (d * y[None, :]).sum((-2, -1)) / (h * (y * y).sum())
    c0 = d.mean((-2, -1))
    resid = (d - sx[:, None, None] * x[:, None] - sy[:, None, None]
             * y[None, :] - c0[:, None, None]).abs().flatten()
    p99 = float(torch.quantile(resid[::7].float(), torch.tensor(
        0.99, device=d.device)))
    dmax = float(resid.max())
    raw = float(d.abs().max())
    say(f"[12c] extract_displacement_field(img, refined ks) vs phase 5's u "
        f"(true ks): launches {launches}; interior max |du| {raw!r} px "
        f"raw; with each component's plane removed: max {dmax!r} px (gate "
        f"{GATE_REFINED_U}), p99 {p99!r} px; plane slopes (px/px) x "
        f"{sx.tolist()} y {sy.tolist()}; seconds per call {dt!r} (one run, "
        "host clock, synchronized)")
    if not dmax < GATE_REFINED_U:
        raise RuntimeError("[12c] u from refined ks: GATE FAILED")


def drive_lockin(img, ks):
    """Phase 12d: vecGPA against three optGPA calls and GPA against
    optGPA (bit for bit), then iterate_GPA from offset ks against the
    reference's gate."""
    import torch
    import pygpa_tpu_torch as gt
    true = np.asarray(ks, np.float64)
    sig = int(np.ceil(1 / np.linalg.norm(true, axis=1).min()))
    v, launches, _ = counted(lambda: gt.gpa.vecGPA(img, true, sig))
    bits = all(torch.equal(v[i], gt.gpa.optGPA(img, true[i], sig))
               for i in range(len(true)))
    bits_gpa = torch.equal(gt.gpa.GPA(img, true[0, 0], true[0, 1], sig),
                           gt.gpa.optGPA(img, true[0], sig))
    t0 = time.perf_counter()
    for _ in range(PEAK_REPS):
        gt.gpa.vecGPA(img, true, sig)
    torch.cuda.synchronize()
    dt_v = (time.perf_counter() - t0) / PEAK_REPS
    del v
    (_, _, corr), launches_i, dt_i = counted(
        lambda: gt.gpa.iterate_GPA(img, true + ITERATE_OFFSET, sig))
    corr = corr.cpu().numpy()
    left = np.linalg.norm(corr + ITERATE_OFFSET, axis=1) \
        / np.linalg.norm(ITERATE_OFFSET)
    say(f"[12d] vecGPA(img, ks, {sig}): launches {launches}; equals three "
        f"optGPA calls bit for bit: {bits}; GPA equals optGPA: {bits_gpa}; "
        f"seconds per call {dt_v!r} ({PEAK_REPS} runs, host clock, "
        f"synchronized). iterate_GPA(img, ks + {ITERATE_OFFSET.tolist()}, "
        f"{sig}): launches {launches_i}; correction {corr.tolist()}, offset "
        f"left {left.tolist()} (gate < {ITERATE_LEFT}); seconds per call "
        f"{dt_i!r} (one run, host clock, synchronized)")
    missing = [k for k in PATH_KERNELS["12d"] if not launches_i.get(k)]
    if missing:
        raise RuntimeError(f"[12d] kernels of the path not launched: "
                           f"{missing} (launches {launches_i})")
    if not (bits and bits_gpa and np.all(left < ITERATE_LEFT)):
        raise RuntimeError("[12d] lock-in: GATE FAILED")


@contextlib.contextmanager
def mg_final(final):
    """The multigrid's finest level set to `final` (a dataclasses.replace
    of the unwrap module's DEFAULTS, restored on exit)."""
    import dataclasses
    from pygpa_tpu_torch.solvers import unwrap
    real = unwrap.DEFAULTS
    unwrap.DEFAULTS = dataclasses.replace(real, unwrap_mg_final=final)
    try:
        yield
    finally:
        unwrap.DEFAULTS = real


def drive_vv(img, ks):
    """Phase 12e: the bench extractor with the "vv" finest level: the
    bench's interior and dc-free gates, presmooth once and applyq three
    times a call (once with "v"), the same path on the twins."""
    import torch
    from pygpa_tpu_torch.gpa import pipeline
    fn = pipeline.make_displacement_extractor(
        (SIZE, SIZE), ks, chunk=4, unwrap_coarse=4, device="cuda")
    fn(img)
    _, launches_v, _ = counted(lambda: fn(img))
    with mg_final("vv"):
        fn(img)
        u, launches, _ = counted(lambda: fn(img))
        missing = [k for k in PATH_KERNELS["12e"] if not launches.get(k)]
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn(img)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / REPS
        with plain_versions():
            up = fn(img)
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    ui = u[:, b:-b, b:-b]
    err = float(ui.abs().max())
    err_dc = float((ui - ui.mean(dim=(1, 2), keepdim=True)).abs().max())
    p99, dmax = interior_dist(u, up, ks)
    say(f"[12e] the bench extractor with unwrap_mg_final='vv': launches in "
        f"one run {launches} (with 'v': {launches_v}); interior max |u| "
        f"{err!r} px (gate {GATE_INTERIOR}), dc-free {err_dc!r} px (gate "
        f"{GATE_DCFREE}); with kernels vs plain versions: interior p99 "
        f"{p99!r} max {dmax!r} px (bound {VV_TWINS}); seconds per image "
        f"{dt!r} ({REPS} runs after warm-up, host clock, synchronized)")
    if missing or launches.get("presmooth") != 1 or \
            launches.get("applyq") != 3 or launches_v.get("applyq") != 1:
        raise RuntimeError(f"[12e] launch counts: {launches}, 'v' "
                           f"{launches_v}")
    if not (err < GATE_INTERIOR and err_dc < GATE_DCFREE
            and dmax < VV_TWINS):
        raise RuntimeError("[12e] GATE FAILED")
    return launches


# ---- phases 13 and 14: the rest of benchmarks/run_all.py, the Kerelsky
# fits, the wfr4 continuity scans and WFF
GATE_5_THETA, GATE_5_KAPPA = 0.01, 0.001     # run_all.py config 5
GATE_6_RAW, GATE_6_DCFREE = 0.004, 0.003     # run_all.py config 6
GATE_5F_THETA = 0.5                          # run_all.py config 5f
WFR4_AGREE, WFR4_PHASE = 0.999, 1e-4         # 14c: card vs the CPU
GATE_WFF = 0.97                              # tests/test_imagetools.py
# (theta, psi, epsilon, a_0, xi) of 14b, inside tests/test_kerelsky.py's
# ranges
KERELSKY_SETS = ((2.0, 15.0, 0.01, 0.246, 5.0),
                 (1.5, 30.0, 0.02, 0.246, 10.0),
                 (12.0, 80.0, 0.05, 3.0, 70.0))


def drive_config5():
    """Phase 13c: run_all.py config 5: four 4096^2 tiles (the lattice and
    its three flips) each through the bench extractor (chunk=4,
    unwrap_coarse=4) and props_from_u(u, 1.0), a Python loop in place of
    lax.map; tile 0's 8 sigma interior held to max |theta| < 0.01 deg and
    max |kappa - 1| < 0.001, and to the same step on the plain twins
    within a tenth of each (phase 10's bounds)."""
    import torch
    from pygpa_tpu_torch.gpa import pipeline
    from pygpa_tpu_torch.lattices import generate_ks, hexlattice_gen
    from pygpa_tpu_torch.props import props_from_u
    img = hexlattice_gen(0.02, 5.0, order=2, size=SIZE, dtype=torch.float32,
                         device=DEVICE)
    tiles = [img, img.flip(0).contiguous(), img.flip(1).contiguous(),
             img.flip(0, 1).contiguous()]
    ks = generate_ks(0.02, 5.0)[:3]
    extract = pipeline.make_displacement_extractor(
        (SIZE, SIZE), ks, chunk=4, unwrap_coarse=4, device=DEVICE)

    def step():
        return torch.stack([props_from_u(extract(t), 1.0) for t in tiles])

    props, launches = counted_run("13c", step)
    say(f"[13c] config 5: 4 x 4096^2 tiles, extractor (chunk=4, "
        f"unwrap_coarse=4) + props_from_u: launches in one run: {launches}")
    say(f"    {plan_line(extract)}; routes (4 tiles): "
        f"{json.dumps(launch_routes(launches))}")
    if tuple(props.shape) != (4, 4, SIZE, SIZE) or not torch.isfinite(
            props).all():
        raise RuntimeError(f"[13c] props bad: {tuple(props.shape)}")
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    th, ka = props[0, 0][b:-b, b:-b], props[0, 3][b:-b, b:-b]
    gates = {"theta_offset_interior_deg": float(th.abs().max()),
             "kappa_err_interior": float((ka - 1.0).abs().max()),
             "gated": f"theta<{GATE_5_THETA}, kappa<{GATE_5_KAPPA}"}
    say(f"    gates (tile 0): {json.dumps(gates)}")
    if not (gates["theta_offset_interior_deg"] < GATE_5_THETA
            and gates["kappa_err_interior"] < GATE_5_KAPPA):
        raise RuntimeError("[13c] ACCURACY GATE FAILED")
    dt, peak = timed(step, 1)
    with plain_versions():
        pp = step()
    dth = float((props[0, 0] - pp[0, 0])[b:-b, b:-b].abs().max())
    dka = float((props[0, 3] - pp[0, 3])[b:-b, b:-b].abs().max())
    del pp
    say(f"    with kernels vs plain versions, tile 0's interior: max |dtheta| "
        f"{dth!r} deg, max |dkappa| {dka!r} (bounds {GATE_5_THETA / 10}, "
        f"{GATE_5_KAPPA / 10})")
    say(f"    seconds per step {dt!r}, Mpix/s {4 * SIZE * SIZE / 1e6 / dt!r} "
        f"(1 run after warm-up, host clock, synchronized); peak device "
        f"memory {peak!r} GiB")
    if not (dth < GATE_5_THETA / 10 and dka < GATE_5_KAPPA / 10):
        raise RuntimeError("[13c] kernels change the result")
    return launches


def drive_config6():
    """Phase 13d: run_all.py config 6: one 8192^2 image (the bench's
    lattice) through the bench extractor (chunk=4, unwrap_coarse=4): the
    route of each stage, launch counts, raw interior max |u| < 0.004 px
    and dc-free < 0.003 px (8 sigma border), the path on the plain twins
    (interior p99 < 1e-3 px, max < 1e-2 px), seconds per image over 2
    runs after warm-up, peak memory; then check_path_kernels on the same
    extractor."""
    import torch
    from pygpa_tpu_torch.gpa import pipeline
    from pygpa_tpu_torch.lattices import generate_ks, hexlattice_gen
    size = 2 * SIZE
    ks = generate_ks(R_K, THETA, kappa=KAPPA, psi=PSI)[:3]
    img = hexlattice_gen(R_K, THETA, order=2, size=size, kappa=KAPPA,
                         psi=PSI, dtype=torch.float32, device=DEVICE)
    fn = pipeline.make_displacement_extractor(
        (size, size), ks, chunk=4, unwrap_coarse=4, device=DEVICE)
    u, launches = counted_run("13d", lambda: fn(img))
    say(f"[13d] config 6: make_displacement_extractor((8192, 8192), ks, "
        f"chunk=4, unwrap_coarse=4): launches in one run: {launches}")
    say(f"    {plan_line(fn)}; routes: {json.dumps(launch_routes(launches))}")
    if tuple(u.shape) != (2, size, size) or not torch.isfinite(u).all():
        raise RuntimeError(f"[13d] output bad, shape {tuple(u.shape)}")
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    ui = u[:, b:-b, b:-b]
    gates = {"u_err_interior_px": float(ui.abs().max()),
             "u_err_interior_dcfree_px": float(
                 (ui - ui.mean(dim=(1, 2), keepdim=True)).abs().max()),
             "gated": f"interior<{GATE_6_RAW}, dcfree<{GATE_6_DCFREE}"}
    say(f"    gates: {json.dumps(gates)}")
    if not (gates["u_err_interior_px"] < GATE_6_RAW
            and gates["u_err_interior_dcfree_px"] < GATE_6_DCFREE):
        raise RuntimeError("[13d] ACCURACY GATE FAILED")
    dt, peak = timed(lambda: fn(img), 2)
    events = []
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(img, events=events)
    torch.cuda.synchronize()
    stages, prev = {}, start
    for name, ev in events:
        stages[name] = prev.elapsed_time(ev)
        prev = ev
    with plain_versions():
        up = fn(img)
    p99, dmax = interior_dist(u, up, ks)
    del up
    say(f"    with kernels vs plain versions: interior p99 |du| {p99!r} max "
        f"{dmax!r} px (bounds 1e-3, 1e-2); seconds per image {dt!r}, Mpix/s "
        f"{size * size / 1e6 / dt!r} (2 runs after warm-up, host clock, "
        f"synchronized); peak device memory {peak!r} GiB")
    say(f"    stage ms (CUDA events): {json.dumps(stages)}; card "
        f"{card_line()}")
    if not (p99 < 1e-3 and dmax < 1e-2):
        raise RuntimeError("[13d] kernels change the result")
    del u, ui
    img_d = hexlattice_gen(R_K, THETA, order=2, size=size, kappa=KAPPA,
                           psi=PSI, shift=bench_field(size),
                           dtype=torch.float32, device=DEVICE)
    check_path_kernels("13d", fn, img_d)
    return launches


def config6_unwrap_calls():
    """The early-stopping CG calls one run of config 6's extractor (phase
    13d: 8192^2, chunk=4, unwrap_coarse=4) hands the kernel on the
    lattice displaced by bench_field: the 2048^2 coarse and correction
    solves (aligned, kmax 6 and 4) and the 4096^2 refinement step."""
    import torch
    from pygpa_tpu_torch.gpa import pipeline
    from pygpa_tpu_torch.lattices import generate_ks, hexlattice_gen
    from pygpa_tpu_torch.solvers import unwrap
    size = 2 * SIZE
    ks = generate_ks(R_K, THETA, kappa=KAPPA, psi=PSI)[:3]
    img_d = hexlattice_gen(R_K, THETA, order=2, size=size, kappa=KAPPA,
                           psi=PSI, shift=bench_field(size),
                           dtype=torch.float32, device=DEVICE)
    fn = pipeline.make_displacement_extractor(
        (size, size), ks, chunk=4, unwrap_coarse=4, device=DEVICE)
    with Capture(unwrap._cg, "cg_unwrap") as c:
        fn(img_d)
        torch.cuda.synchronize()
    return c.calls


def unwrap_stage(label, call):
    """One call(events) with its stage times (CUDA events), printed with
    the "unwrap" stage and the card's name and power limit."""
    import torch
    events = []
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    call(events)
    torch.cuda.synchronize()
    stages, prev = {}, start
    for name, ev in events:
        stages[name] = prev.elapsed_time(ev)
        prev = ev
    say(f"    [{label}] stage ms (CUDA events): {json.dumps(stages)}; unwrap "
        f"stage {stages.get('unwrap')!r} ms; card {card_line()}")
    return stages


def moire_ks(theta, psi, epsilon, a, xi):
    """tests/test_kerelsky.py's moire k-vectors of (theta, psi, epsilon,
    a, xi)."""
    from pygpa_tpu_torch.lattices import generate_ks
    from pygpa_tpu_torch.lattices.transformations import (a_0_to_r_k,
                                                          epsilon_to_kappa)
    r_k = a_0_to_r_k(a)
    r_k2, kappa = epsilon_to_kappa(r_k, epsilon)
    return (generate_ks(r_k2, xi + theta, kappa=kappa, psi=psi)[:3]
            - generate_ks(r_k, xi, kappa=1, psi=psi)[:3])


def pdiff(x, y, period):
    return (x - y + period / 2) % period - period / 2


def drive_5f():
    """Phase 14a: run_all.py config 5f: the 128^2 JacA0 field (A0 of
    generate_ks(0.02, 1.2) plus its 1e-3 sin/cos perturbation) in
    float32 through iterate_J_leastsq from Kerelsky_Jac's refest:
    max |theta - refest theta| < 0.5 deg, kfits/s, the same fit in
    float64 on the card beside it, and one traced fit's kernel count and
    device time against its seconds."""
    import torch
    from pygpa_tpu_torch.lattices import generate_ks
    from pygpa_tpu_torch.props import Kerelsky_Jac, iterate_J_leastsq
    from pygpa_tpu_torch.props.kerelsky import _jac_a0
    kvecs = generate_ks(0.02, 1.2)[:3]
    t0 = time.perf_counter()
    refest = Kerelsky_Jac(kvecs, device=DEVICE)
    t_ref = time.perf_counter() - t0
    _, A0 = _jac_a0(kvecs, 1.0, 0.246, 0)
    n = 128
    xg, yg = np.meshgrid(np.linspace(0, 2 * np.pi, n),
                         np.linspace(0, 2 * np.pi, n), indexing="ij")
    pert = 1e-3 * np.stack([np.sin(xg), np.cos(yg), np.sin(xg + yg),
                            np.cos(xg - yg)], axis=-1).reshape(n, n, 2, 2)
    J64 = torch.as_tensor(A0[None, None] + pert, device=DEVICE)
    J32 = J64.float()
    r32 = torch.tensor(refest, dtype=torch.float32, device=DEVICE)
    X, launches = counted_run(
        "14a", lambda: iterate_J_leastsq(J32, r32, device=DEVICE))
    if tuple(X.shape) != (n, n, 4) or X.dtype != torch.float32:
        raise RuntimeError(f"[14a] fits bad: {tuple(X.shape)} {X.dtype}")
    dev = float((X[..., 0] - float(np.float32(refest[0]))).abs().max())
    dt, peak = timed(lambda: iterate_J_leastsq(J32, r32, device=DEVICE), 2)
    X64 = iterate_J_leastsq(J64, refest, device=DEVICE)
    dth = float((X[..., 0].double() - X64[..., 0]).abs().max())
    say(f"[14a] config 5f: Kerelsky_Jac refest {refest.tolist()} "
        f"({t_ref!r} s on the card); iterate_J_leastsq on the {n}^2 "
        f"float32 field: launches {launches}")
    say(f"    gates: {json.dumps({'fit_theta_dev_deg': dev, 'gated': f'<{GATE_5F_THETA}'})}")
    say(f"    float32 vs float64 on the card: max |dtheta| {dth!r} deg; "
        f"seconds per field {dt!r}, kfits/s {n * n / 1e3 / dt!r} (2 runs "
        f"after warm-up, host clock, synchronized); peak device memory "
        f"{peak!r} GiB")
    by_name, n_kern = device_kernels(
        lambda: iterate_J_leastsq(J32, r32, device=DEVICE))
    if by_name is not None:
        busy = sum(by_name.values())
        say(f"    one field fit traced (torch.profiler): {n_kern} kernels, "
            f"{busy!r} ms of device time, {busy / (dt * 1e3)!r} of the "
            f"unprofiled seconds per field (the rest: the device idle, "
            f"waiting on the host's dispatch)")
    else:
        say("    one field fit traced: the profiler recorded no device "
            "activity")
    if not (dev < GATE_5F_THETA and torch.isfinite(X).all()):
        raise RuntimeError("[14a] ACCURACY GATE FAILED")


def drive_kerelsky_fits():
    """Phase 14b: Kerelsky_plus and Kerelsky_Jac on the card for three
    moire k-vector sets, each through tests/test_kerelsky.py's round-trip
    gates, with seconds per fit."""
    from pygpa_tpu_torch.props import Kerelsky_Jac, Kerelsky_plus
    for theta, psi, epsilon, a, xi in KERELSKY_SETS:
        mks = moire_ks(theta, psi, epsilon, a, xi)
        for name, fit in (("Kerelsky_plus", Kerelsky_plus),
                          ("Kerelsky_Jac", Kerelsky_Jac)):
            fit(mks, nmperpixel=1, a_0=a, device=DEVICE)
            t0 = time.perf_counter()
            p = fit(mks, nmperpixel=1, a_0=a, device=DEVICE)
            dt = time.perf_counter() - t0
            errs = [abs(pdiff(abs(p[0]), theta, 60)), abs(pdiff(p[1], psi, 180)),
                    abs(p[2] - epsilon), abs(pdiff(p[3], xi, 360))]
            ok = (errs[0] < 1e-2 and errs[1] < 1e-2 and errs[3] < 1e-2
                  and errs[2] <= 1e-6 + 1e-3 * abs(epsilon))
            say(f"[14b] {name} of (theta, psi, epsilon, a, xi) = "
                f"{(theta, psi, epsilon, a, xi)}: {p.tolist()}; errors "
                f"{errs} (gates 1e-2 deg; epsilon rtol 1e-3, atol 1e-6); "
                f"{dt!r} s a fit")
            if not ok:
                raise RuntimeError(f"[14b] {name} round trip failed")


def drive_wfr4(img, ks):
    """Phase 14c: gt.gpa.wfr4 on the 4096^2 bench fixture for each Bragg
    peak, config 2g's bank (k +- kw, steps of kw / 3) and dk one step:
    the route, seconds per call, finite output; then on the 1024^2 crop
    against the port's own device="cpu" call: winners agree on >= 99.9%
    of the 5 sigma interior, and there the lock-in's phase within 1e-4
    rad."""
    import torch
    from pygpa_tpu_torch.gpa import wfr4
    from pygpa_tpu_torch.ops import _build
    from pygpa_tpu_torch.ops.wfr import _plan_zoom
    wlists, sigma = config2g_banks(ks)
    step = float(np.linalg.norm(ks, axis=1).mean()) / 2.5 / 3
    crop = img[:1024, :1024].contiguous()
    crop_h = crop.cpu()
    b = 5 * sigma
    for k, wl in zip(ks, wlists):
        routes = ["zoom" if _plan_zoom(s, wl, float(sigma)) is not None
                  else "full-FFT" for s in ((SIZE, SIZE), (1024, 1024))]
        def call():
            return wfr4(img, sigma, wl, k, step, device=DEVICE)
        g, launches = counted_run("14c", call)
        dt, peak = timed(call, 2)
        if not (torch.isfinite(g["lockin"]).all()
                and tuple(g["w"].shape) == (2, SIZE, SIZE)):
            raise RuntimeError("[14c] wfr4 output bad")
        gc = wfr4(crop, sigma, wl, k, step, device=DEVICE)
        gh = wfr4(crop_h, sigma, wl, k, step, device="cpu")
        same = (gc["w"].cpu() == gh["w"]).all(0)[b:-b, b:-b]
        dph = torch.angle(gc["lockin"].cpu() * gh["lockin"].conj())
        dph = float(dph[b:-b, b:-b][same].abs().max())
        frac = float(same.double().mean())
        say(f"[14c] wfr4 at k = {k.tolist()}, P = {len(wl)}, dk = {step!r}: "
            f"route {routes[0]} at 4096^2, {routes[1]} at 1024^2; "
            f"launches {launches}; seconds per call {dt!r} (2 runs after "
            f"warm-up), peak device memory {peak!r} GiB; 1024^2 crop, card "
            f"vs CPU: winners agree on {frac!r} of the 5 sigma interior "
            f"(bound {WFR4_AGREE}), lock-in phase there within {dph!r} rad "
            f"(bound {WFR4_PHASE})")
        if not (frac >= WFR4_AGREE and dph < WFR4_PHASE):
            raise RuntimeError("[14c] the card's wfr4 disagrees with the CPU's")
    del g, gc, gh, crop, crop_h


def drive_wff(img):
    """Phase 14d: gt.gpa.wff on a 1024^2 crop of the bench fixture (mean
    removed) plus seeded Gaussian noise of the crop's own std, at
    tests/test_imagetools.py's sizes scaled 8x (sigma 64, 16 -> 128 px
    border; the threshold 3 noise stds), its grid -0.3..0.3 rad/px
    covering the lattice's first- and second-order peaks: correlation
    with the clean crop > 0.97 and above the noisy input's."""
    import torch
    from pygpa_tpu_torch.gpa import wff
    clean = img[:1024, :1024].double()
    clean = clean - clean.mean()
    std = float(clean.std())
    noise = np.random.default_rng(14).normal(size=(1024, 1024)) * std
    noisy = (clean + torch.as_tensor(noise, device=DEVICE)).float()
    def call():
        return wff(noisy, 64, [3 * std], -0.3, 0.3, device=DEVICE)
    out, launches = counted_run("14d", call)
    dt, peak = timed(call, 2)
    sl = np.s_[128:-128, 128:-128]

    def corr(a):
        a, c = a[sl].double().flatten(), clean[sl].flatten()
        a, c = a - a.mean(), c - c.mean()
        return float((a * c).sum() / torch.sqrt((a * a).sum() * (c * c).sum()))

    c0, c1 = corr(noisy), corr(out[0])
    say(f"[14d] wff(noisy 1024^2 crop, sigma 64, threshold 3 std, "
        f"-0.3..0.3 rad/px): launches {launches}; correlation with the "
        f"clean crop {c1!r} (gate > {GATE_WFF}), the noisy input's {c0!r}; "
        f"seconds per call {dt!r} (2 runs after warm-up), peak device "
        f"memory {peak!r} GiB")
    if not (c1 > GATE_WFF and c1 > c0):
        raise RuntimeError("[14d] WFF GATE FAILED")


# ---- phase 15: the batch axis (config 1b, config 5 as one batched call,
# a 16384^2 mosaic from disk through the tile loader and checkpoints)
BATCH_P99, BATCH_MAX = 1e-3, 1e-2   # batch vs loop, phase 13's path bounds
GATE_1B = 0.02                       # run_all.py config 1b, dc-free
# the batched kernels' rows of the kernels line: kernel -> the row of the
# single-image kernel it extends
BATCH_ROWS = {"sweep_uv_1b": "sweep_uv", "presmooth_1b": "presmooth",
              "applyq_1b": "applyq", "cg_poisson_1b": "cg_poisson"}
MOSAIC = 16384


FIELD_SPREAD = 0.1   # px: each displaced image from 0 and from the others


def lattice_stack(size, shifts):
    """Config 1's lattice (r_k 0.1, theta 7 deg, order 2, float32) at
    `size`, one image a constant shift (px, both axes) of `shifts`; on
    DEVICE."""
    import torch
    from pygpa_tpu_torch.lattices import hexlattice_gen
    base = np.zeros((2, size, size), np.float32)
    return torch.stack([hexlattice_gen(0.1, 7.0, order=2, size=size,
                                       shift=base + np.float32(c),
                                       dtype=torch.float32, device=DEVICE)
                        for c in shifts])


def hole_radius(size):
    """The distance of each pixel (size, size) from the centre of
    displaced_stack's hole, (-size / 4, size / 4) from the image's
    centre, and the hole's radius, size / 10."""
    import torch
    S = size // 2
    ax = torch.arange(-S, S, dtype=torch.float32, device=DEVICE)
    return torch.hypot(ax[:, None] + S / 2, ax[None, :] - S / 2), S / 5


def hole_pixels(size, b):
    """displaced_stack's hole as the checks set it apart in the last
    image: out to 1.5 times its radius, where the lattice is back to
    99%, plus 3 sigma of the sweep's window (b = 8 sigma); (size, size)
    bool."""
    r, rad = hole_radius(size)
    return r < 1.5 * rad + 3 * b / 8


def displaced_stack(size, nb, r_k=0.1, theta=7.0, scale=1.0):
    """nb lattices (r_k, theta, order 2, float32) at `size` on DEVICE, each
    with a field of its own: image i displaced by bench_field(size) *
    scale * (i + 1) / nb plus 1b's constant shift of 0.31 i px; the last
    image has a hole of seeded noise (3 times the lattice's std; at
    hole_radius) off centre, so its weight differs from the others' where
    its phases are garbage. A batched path that mixes the images up,
    returns zeros or hands one image another's weight fails a
    stack-vs-loop check on it (a shared weight moves the last image by
    ~0.7 px at 256^2, outside the hole too)."""
    import torch
    from pygpa_tpu_torch.lattices import hexlattice_gen
    field = bench_field(size) * np.float32(scale)
    r, rad = hole_radius(size)
    env = 1 - torch.exp(-(r / rad) ** 4)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    imgs = []
    for i in range(nb):
        im = hexlattice_gen(r_k, theta, order=2, size=size,
                            shift=field * np.float32((i + 1) / nb)
                            + np.float32(0.31 * i),
                            dtype=torch.float32, device=DEVICE)
        if i == nb - 1:
            noise = torch.randn((size, size), generator=gen, device=DEVICE)
            im = im * env + 3 * im.std() * noise * (1 - env)
        imgs.append(im)
    return torch.stack(imgs)


def batch_vs_loop(u, loop, b):
    """(interior p99, max |u - loop| over every image, bits equal)."""
    import torch
    d = (u - loop)[..., b:-b, b:-b].abs()
    return p99(d), float(d.max()), torch.equal(u, loop)


def hold_displaced(label, fn, imgs, b):
    """A displaced_stack through one call of fn against the loop of
    fn(images[i]) within 15a's bounds, after checking that the loop's
    fields (dc removed, interior) lie over FIELD_SPREAD from 0 and from
    each other, so that a mix-up or a shared weight would show. The
    last image is held outside its hole (out to 1.5 times its radius,
    where the lattice is back to 99%, plus 3 sigma of the sweep's
    window): inside, the phases are noise, and a near-tie winner that
    flips between the stack's windows and one image's (an ulp apart)
    may move u by pixels; that maximum is printed."""
    import torch
    u = fn(imgs)
    loop = torch.stack([fn(im) for im in imgs])
    ui = loop[..., b:-b, b:-b]
    ui = ui - ui.mean(dim=(-2, -1), keepdim=True)
    size = float(ui.abs().amax(dim=(1, 2, 3)).min())
    apart = min(float((ui[i] - ui[j]).abs().max())
                for i in range(len(ui)) for j in range(i))
    inside = hole_pixels(imgs.shape[-1], b)
    d = (u - loop).abs()
    in_hole = float(d[-1][:, inside].max())
    d[-1][:, inside] = 0
    d = d[..., b:-b, b:-b]
    bp99, bmax = p99(d), float(d.max())
    say(f"    {tuple(imgs.shape)} stack with a field of its own in each "
        f"image (displaced_stack; the last with a hole of noise): the "
        f"smallest field {size!r} px, the closest two images {apart!r} px "
        f"apart (each must exceed {FIELD_SPREAD}); stack vs loop interior, "
        f"the hole aside, p99 {bp99!r} max {bmax!r} px (bounds {BATCH_P99}, "
        f"{BATCH_MAX}); in the hole, max {in_hole!r} px; bits equal: "
        f"{torch.equal(u, loop)}")
    if not (size > FIELD_SPREAD and apart > FIELD_SPREAD):
        raise RuntimeError(f"[{label}] the displaced stack's fields are too "
                           "close to tell the images apart")
    if not (bp99 < BATCH_P99 and bmax < BATCH_MAX):
        raise RuntimeError(f"[{label}] the displaced stack differs from its "
                           "images' calls")


def windows_cause(fn, imgs):
    """Why a stack's fields may differ from its images' own calls: whether
    the stack's spectrum windows (one set of products for every image)
    equal each image's own, and if they do, whether the sweep's outputs
    do."""
    import torch
    from pygpa_tpu_torch.ops import sweep, wfr
    sw = wfr.GroupedSweep(fn.plan, device=imgs.device)
    img0 = imgs - imgs.mean(dim=(-2, -1), keepdim=True)
    Sr, Si = sw.windows(img0)
    one = [sw.windows(img0[i]) for i in range(imgs.shape[0])]
    dw = max(float((Sr[i] - o[0]).abs().max()) for i, o in enumerate(one))
    if dw > 0:
        return (f"the stack's windows differ from each image's own by up to "
                f"{dw!r} (cuBLAS picks other products for the stack's "
                "shapes), which can flip a near-tie winner")
    rest = (sw.gx, sw.gy, sw.A0c, sw.A0s, sw.A1cb, sw.A1sb, sw.run, sw.off,
            sw.kconst, fn.plan.dr, sw.banded)
    uv = sweep.sweep_uv(Sr, Si, *rest)
    same = all(torch.equal(g[i], o) for i, (r, q) in enumerate(one)
               for g, o in zip(uv, sweep.sweep_uv(r, q, *rest)))
    if not same:
        return ("the stack's windows equal each image's own, its sweep "
                "outputs do not")
    return ("the stack's windows and sweep outputs equal each image's own; "
            "the unwrap's batched torch products and reductions (block "
            "means, resizes, dots) round in another order")


def check_slices(label, calls):
    """Each batched kernel call of a stack's run against the kernel's own
    single-image launch on each image's slice. A block's arithmetic does
    not depend on the image index or the stack's size, so the bits must
    be equal: any difference is an image read or written at another
    image's offset, and fails."""
    import torch
    from pygpa_tpu_torch.ops import cg, sweep, vcycle
    c_sw, c_ps, c_aq, c_cg = calls
    worst = {}

    def hold(name, got, one, i):
        for g, o in zip(got, one):
            g = g[i].reshape(o.shape)
            if not torch.equal(g, o):
                worst[name] = max(worst.get(name, 0.0),
                                  float((g - o).abs().max()))
    for a in c_sw:
        got = sweep.sweep_uv(*a)
        for i in range(a[0].shape[0]):
            hold("sweep_uv", got, sweep.sweep_uv(
                a[0][i].contiguous(), a[1][i].contiguous(), *a[2:]), i)
    for a in c_ps:
        got = vcycle.presmooth(*a)
        for i in range(a[0].shape[0]):
            hold("presmooth", got, vcycle.presmooth(
                *(t[i].contiguous() for t in a[:3]),
                a[3][i].reshape(a[3].shape[-2:]).contiguous(), *a[4:]), i)
    for a in c_aq:
        got = (vcycle.applyq(*a),)
        for i in range(a[0].shape[0]):
            hold("applyq", got, (vcycle.applyq(
                a[0][i].contiguous(),
                a[1][i].reshape(a[1].shape[-2:]).contiguous()),), i)
    for a in c_cg:
        got = (cg.cg_poisson(*a),)
        for i in range(a[0].shape[0]):
            hold("cg_poisson", got, (cg.cg_poisson(
                a[0][i].contiguous(),
                *(w[i].reshape(w.shape[-2:]).contiguous() for w in a[1:3]),
                a[3]),), i)
    say(f"[{label}] each batched kernel against its single-image launch on "
        f"each image's slice: "
        f"{'the same bits everywhere' if not worst else worst}")
    if worst:
        raise RuntimeError(f"[{label}] a batched kernel differs from its "
                           f"single-image launch on an image's slice (largest "
                           f"absolute differences {worst})")


def batch_rows(calls, errs, launches):
    """The batched kernels' rows of the kernels line, from the first
    captured call of each kernel in a run of config 1b's stack: kernel
    and twin ms (CUDA events), the bound from those inputs, the launches
    of 15a's counted run, and the largest absolute difference from the
    twin of the 16-image displaced check (errs)."""
    from pygpa_tpu_torch.ops import cg, sweep, vcycle
    c_sw, c_ps, c_aq, c_cg = calls
    rows = {}
    a = c_sw[0]
    Bs, G, _, W0, Wb = a[0].shape
    P, n, m = a[2].shape[1], a[4].shape[1], a[6].shape[1]
    f1, f2 = 8 * Bs * G * P * n * W0 * Wb, 8 * Bs * G * P * n * m * Wb
    _, b_tc = zoom_bounds(tensor_bytes(a, sweep.sweep_uv_plain(*a)), f1, f2)
    rows["sweep_uv_1b"] = dict(
        ms=cuda_ms(lambda: sweep.sweep_uv(*a), 5),
        plain_ms=cuda_ms(lambda: sweep.sweep_uv_plain(*a), 2),
        bound_ms=b_tc, bound_by="operations")
    a = c_ps[0]
    rows["presmooth_1b"] = dict(
        ms=cuda_ms(lambda: vcycle.presmooth(*a), 20),
        plain_ms=cuda_ms(lambda: vcycle.presmooth_plain(*a), 5),
        **bound_row(tensor_bytes(a, vcycle.presmooth_plain(*a)),
                    40 * a[0].numel()))
    a = c_aq[0]
    rows["applyq_1b"] = dict(
        ms=cuda_ms(lambda: vcycle.applyq(*a), 20),
        plain_ms=cuda_ms(lambda: vcycle.applyq_plain(*a), 5),
        **bound_row(tensor_bytes(a, vcycle.applyq_plain(*a)),
                    12 * a[0].numel()))
    a = c_cg[0]
    npx = a[0].shape[-2] * a[0].shape[-1]
    b_ms, b_by = bound(tensor_bytes(a[:3], a[0]),
                       a[0].numel() * a[3] * (5 * np.log2(npx) + 12))
    rows["cg_poisson_1b"] = dict(
        ms=cuda_ms(lambda: cg.cg_poisson(*a), 10),
        plain_ms=cuda_ms(lambda: cg.cg_poisson_plain(*a), 5),
        bound_ms=b_ms, bound_by=b_by)
    shapes = {"sweep_uv_1b": tuple(c_sw[0][0].shape),
              "presmooth_1b": tuple(c_ps[0][0].shape),
              "applyq_1b": tuple(c_aq[0][0].shape),
              "cg_poisson_1b": tuple(c_cg[0][0].shape) + (c_cg[0][3],)}
    for name, r in rows.items():
        single = BATCH_ROWS[name]
        r.update(max_abs_err=errs[single], library_ms=None,
                 launches=launches.get(single, 0))
        say(f"    {name} {shapes[name]}: kernel {r['ms']!r} ms, twin "
            f"{r['plain_ms']!r} ms, bound {r['bound_ms']!r} ms "
            f"({r['bound_by']}), launches a stack {r['launches']}")
    return rows


def drive_1b():
    """Phase 15a: run_all.py config 1b: 16 x 512^2 config 1 lattices (image
    i shifted by 0.31 i px) through one call of
    make_displacement_extractor((512, 512), ks, unwrap_coarse=4) (ks the
    port's float64 generate_ks(0.1, 7.0)[:3]): launches per stack against
    one image's (equal, or fail), the gate (each image's u less its mean,
    8 sigma interior max < 0.02 px), the stack against a loop of
    run(images[i]) (interior p99 < 1e-3, max < 1e-2 px; bits and their
    cause printed), seconds per stack, Mpix/s, the loop's seconds, peak
    memory; then, on a displaced_stack of 16 (a field of its own in each
    image, one with a hole of noise), the stack against its loop,
    check_path_kernels (each batched kernel against its twin, phase 3's
    bounds) and check_slices (against its own single-image launches, bit
    for bit). Returns (the stack's launches, the batched kernels'
    rows)."""
    import torch
    from pygpa_tpu_torch.gpa import pipeline
    from pygpa_tpu_torch.lattices import generate_ks
    from pygpa_tpu_torch.ops import wfr
    from pygpa_tpu_torch.solvers import unwrap
    size, nb = 512, 16
    ks = generate_ks(0.1, 7.0)[:3]
    imgs = lattice_stack(size, [0.31 * i for i in range(nb)])
    fn = pipeline.make_displacement_extractor((size, size), ks,
                                              unwrap_coarse=4, device=DEVICE)
    u, launches = counted_run("15a", lambda: fn(imgs))
    _, one = counted_run("15a", lambda: fn(imgs[0]))
    say(f"[15a] config 1b: 16 x 512^2 through one call of "
        f"make_displacement_extractor((512, 512), ks, unwrap_coarse=4): "
        f"launches per stack {launches}, per image {one}")
    say(f"    {plan_line(fn)}; routes: {json.dumps(launch_routes(launches))}")
    if any(launches.get(k) != one.get(k) for k in PATH_KERNELS["15a"]):
        raise RuntimeError("[15a] the stack launches its kernels more often "
                           "than one image")
    if tuple(u.shape) != (nb, 2, size, size) or not torch.isfinite(u).all():
        raise RuntimeError(f"[15a] output bad, shape {tuple(u.shape)}")
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    ui = u[..., b:-b, b:-b]
    per = (ui - ui.mean(dim=(-2, -1), keepdim=True)).abs().amax(
        dim=(1, 2, 3))
    gates = {"u_err_interior_dcfree_px_max": float(per.max()),
             "per_image": [float(v) for v in per],
             "gated": f"<{GATE_1B} each image, 8 sigma border"}
    say(f"    gates: {json.dumps(gates)}")
    if not gates["u_err_interior_dcfree_px_max"] < GATE_1B:
        raise RuntimeError("[15a] ACCURACY GATE FAILED")
    loop = torch.stack([fn(im) for im in imgs])
    bp99, bmax, bits = batch_vs_loop(u, loop, b)
    say(f"    stack vs the loop of run(images[i]): interior p99 {bp99!r} max "
        f"{bmax!r} px (bounds {BATCH_P99}, {BATCH_MAX}); bits equal: {bits}"
        + ("" if bits else f" ({windows_cause(fn, imgs)})"))
    if not (bp99 < BATCH_P99 and bmax < BATCH_MAX):
        raise RuntimeError("[15a] the stack differs from its images' calls")
    del u, loop, ui
    dt, peak = timed(lambda: fn(imgs), REPS_NEW)
    dt_loop, peak_loop = timed(lambda: [fn(im) for im in imgs], REPS_NEW)
    say(f"    seconds per stack {dt!r}, Mpix/s "
        f"{nb * size * size / 1e6 / dt!r}; the 16-image loop {dt_loop!r} s "
        f"({nb * size * size / 1e6 / dt_loop!r} Mpix/s) ({REPS_NEW} runs "
        f"after warm-up, host clock, synchronized); peak device memory "
        f"{peak!r} GiB (loop {peak_loop!r})")
    # 16 images with fields of their own: the stack against its loop, the
    # batched kernels against their twins and their single-image launches
    img_d = displaced_stack(size, nb)
    hold_displaced("15a", fn, img_d, b)
    calls16, errs = check_path_kernels("15a", fn, img_d)
    check_slices("15a", calls16)
    del img_d, calls16
    # the inputs of config 1b's own stack, for the rows' times and bounds
    with Capture(wfr._sweep, "sweep_uv", keep=1) as c_sw, \
            Capture(unwrap._vcycle, "presmooth", keep=1) as c_ps, \
            Capture(unwrap._vcycle, "applyq", keep=1) as c_aq, \
            Capture(unwrap._cg, "cg_poisson", keep=1) as c_cg:
        fn(imgs)
        torch.cuda.synchronize()
    rows = batch_rows((c_sw.calls, c_ps.calls, c_aq.calls, c_cg.calls),
                      errs, launches)
    return launches, rows


def config5_tiles():
    """Phase 13c's four 4096^2 tiles (the lattice and its three flips)
    stacked (4, 4096, 4096), its extractor and its k-vectors."""
    import torch
    from pygpa_tpu_torch.gpa import pipeline
    from pygpa_tpu_torch.lattices import generate_ks, hexlattice_gen
    img = hexlattice_gen(0.02, 5.0, order=2, size=SIZE, dtype=torch.float32,
                         device=DEVICE)
    tiles = torch.stack([img, img.flip(0), img.flip(1), img.flip(0, 1)])
    ks = generate_ks(0.02, 5.0)[:3]
    extract = pipeline.make_displacement_extractor(
        (SIZE, SIZE), ks, chunk=4, unwrap_coarse=4, device=DEVICE)
    return tiles, extract, ks


def props_gates(props, b):
    """The config-5 gates of each tile's properties (4, n, m) in a list:
    (max |theta| on the interior, max |kappa - 1| there), device scalars."""
    import torch
    return [torch.stack([p[0][b:-b, b:-b].abs().max(),
                         (p[3][b:-b, b:-b] - 1.0).abs().max()])
            for p in props]


def drive_config5_batched():
    """Phase 15b: config 5's step as one batched call: the four tiles
    (4, 4096, 4096) through one call of 13c's extractor, then
    props_from_u per tile. Gates (13c's): tile 0's interior max |theta| <
    0.01 deg, max |kappa - 1| < 0.001; each tile's u against 13c's loop
    within 15a's bounds, and so a displaced_stack of four 4096^2 tiles;
    seconds per step, launches, peak memory."""
    import torch
    from pygpa_tpu_torch.props import props_from_u
    tiles, extract, ks = config5_tiles()

    def step():
        us = extract(tiles)
        return us, [props_from_u(u, 1.0) for u in us]

    (us, props), launches = counted_run("15b", step)
    say(f"[15b] config 5 as one call: {tuple(tiles.shape)} through the "
        f"extractor (chunk=4, unwrap_coarse=4) + props_from_u per tile: "
        f"launches in one step {launches}")
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    th, ka = (float(v) for v in props_gates(props[:1], b)[0])
    gates = {"theta_offset_interior_deg": th, "kappa_err_interior": ka,
             "gated": f"theta<{GATE_5_THETA}, kappa<{GATE_5_KAPPA}"}
    say(f"    gates (tile 0): {json.dumps(gates)}")
    if not (th < GATE_5_THETA and ka < GATE_5_KAPPA):
        raise RuntimeError("[15b] ACCURACY GATE FAILED")
    del props
    loop = torch.stack([extract(t) for t in tiles])
    bp99, bmax, bits = batch_vs_loop(us, loop, b)
    say(f"    each tile's u vs 13c's loop: interior p99 {bp99!r} max {bmax!r} "
        f"px (bounds {BATCH_P99}, {BATCH_MAX}); bits equal: {bits}")
    if not (bp99 < BATCH_P99 and bmax < BATCH_MAX):
        raise RuntimeError("[15b] the batched call differs from the loop")
    del us, loop
    # the flips of a perfect lattice all give u ~ 0: four tiles with fields
    # of their own (bench_field at a quarter, up to 2.5% strain) tell a
    # mix-up or a shared weight apart
    img_d = displaced_stack(SIZE, 4, r_k=0.02, theta=5.0, scale=0.25)
    hold_displaced("15b", extract, img_d, b)
    del img_d
    dt, peak = timed(step, 2)
    say(f"    seconds per step {dt!r}, Mpix/s {4 * SIZE * SIZE / 1e6 / dt!r} "
        f"(2 runs after warm-up, host clock, synchronized; 13c's loop "
        f"0.2421-0.2471 s, PERF.md section 5); peak device memory {peak!r} "
        f"GiB (13c: 5.61)")
    return launches, extract, ks


def render_mosaic(path):
    """Config 5's lattice (r_k 0.02, theta 5 deg, order 2) at 16384^2,
    rendered in float64 on the card, scaled to 0-60000 and written as a
    uint16 GPAM mosaic (512 MiB) to `path`. Returns (render s, write s)."""
    import torch
    from pygpa_tpu_torch import data
    from pygpa_tpu_torch.lattices import hexlattice_gen
    t0 = time.perf_counter()
    img = hexlattice_gen(0.02, 5.0, order=2, size=MOSAIC,
                         dtype=torch.float64, device=DEVICE)
    lo, hi = img.min(), img.max()
    img = torch.round((img - lo) * (60000.0 / (hi - lo))).to(torch.int32)
    host = img.cpu().numpy().astype(np.uint16)
    del img
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    data.write_mosaic(path, host)
    return t1 - t0, time.perf_counter() - t1


def idle_share(call):
    """(device busy ms, wall ms, idle share) of one call of `call` from
    torch.profiler's device records (the union of their intervals); None
    busy when the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    for a, z in spans:
        if end is None or a > end:
            busy += z - a
            end = z
        elif z > end:
            busy += z - end
            end = z
    if busy == 0:
        return None, wall, None
    return busy / 1e3, wall, 1 - busy / 1e3 / wall


def drive_mosaic(extract, ks):
    """Phase 15c: a 16384^2 mosaic from disk: render_mosaic into a
    temporary directory, MosaicTiles(path).batches(4096, batch_size=4) (16
    tiles in 4 stacks), each stack through 15b's extractor and
    props_from_u per tile; every tile held to config 5's gates (interior
    max |theta| < 0.01 deg, max |kappa - 1| < 0.001); one stack's u saved
    with io.save_checkpoint and loaded back with equal bits; render and
    write seconds, the pass's seconds and Mpix/s, per stack the host
    read_tiles ms and the device ms, the device idle share over one pass
    (torch.profiler), peak memory. Every tile is a translated perfect
    lattice, whose u is ~0, so the gates cannot tell a path that returns
    zeros: the same extractor at the same stack shape is held on
    displaced tiles in 15b. Returns the idle share and the 16 tiles in
    one host stack (16, 4096, 4096) float32, for phase 16d."""
    import tempfile
    import torch
    from pygpa_tpu_torch import data, io
    from pygpa_tpu_torch.props import props_from_u
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mosaic.gpam")
        t_render, t_write = render_mosaic(path)
        say(f"[15c] a {MOSAIC}^2 mosaic from disk: rendered in float64 on the "
            f"card and scaled to uint16 in {t_render!r} s, written "
            f"({os.path.getsize(path)} bytes) in {t_write!r} s")

        def one_pass(record=None, keep=None):
            """The tiled pass: per stack the host read, then the extractor
            and the properties (no host sync inside); the gates' maxima
            stay on the device until the end."""
            maxima = []
            with data.MosaicTiles(path) as mt:
                stacks = mt.batches(SIZE, batch_size=4)
                for k in range(len(mt.grid(SIZE)) // 4):
                    t0 = time.perf_counter()
                    tiles, coords = next(stacks)
                    t1 = time.perf_counter()
                    tiles = torch.as_tensor(tiles, device=DEVICE)
                    t2 = time.perf_counter()
                    ev0 = torch.cuda.Event(enable_timing=True)
                    ev1 = torch.cuda.Event(enable_timing=True)
                    ev0.record()
                    us = extract(tiles)
                    maxima += props_gates([props_from_u(u, 1.0)
                                           for u in us], b)
                    ev1.record()
                    if record is not None:
                        record.append((coords, (t1 - t0) * 1e3,
                                       (t2 - t1) * 1e3, ev0, ev1))
                    if keep is not None and k == 0:
                        keep.append(us)
            return torch.stack(maxima)

        one_pass()                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec, kept = [], []
        t0 = time.perf_counter()
        maxima = one_pass(rec, kept)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        stacks = [{"origins": c, "host_read_ms": h, "copy_ms": cp,
                   "device_ms": e0.elapsed_time(e1)}
                  for c, h, cp, e0, e1 in rec]
        ntiles = sum(len(s["origins"]) for s in stacks)
        say(f"    {len(stacks)} stacks, {ntiles} tiles: the pass {dt!r} s, "
            f"{ntiles * SIZE * SIZE / 1e6 / dt!r} Mpix/s (host clock, "
            f"synchronized, after a warm-up pass); peak device memory "
            f"{peak!r} GiB")
        for s in stacks:
            say(f"    stack at {s['origins']}: host read_tiles "
                f"{s['host_read_ms']!r} ms, copy to the card (waits for the "
                f"stream) {s['copy_ms']!r} ms, device {s['device_ms']!r} ms "
                f"(CUDA events)")
        th, ka = maxima[:, 0].cpu().numpy(), maxima[:, 1].cpu().numpy()
        gates = {"theta_offset_interior_deg_max": float(th.max()),
                 "kappa_err_interior_max": float(ka.max()),
                 "per_tile_theta": [float(v) for v in th],
                 "per_tile_kappa": [float(v) for v in ka],
                 "gated": f"theta<{GATE_5_THETA}, kappa<{GATE_5_KAPPA}, "
                          "every tile"}
        say(f"    gates: {json.dumps(gates)}")
        if ntiles != 16 or not (th.max() < GATE_5_THETA
                                and ka.max() < GATE_5_KAPPA):
            raise RuntimeError("[15c] ACCURACY GATE FAILED")
        busy, wall, idle = idle_share(one_pass)
        say(f"    device over one pass (torch.profiler): busy {busy!r} ms of "
            f"{wall!r} ms, idle share {idle!r}")
        ck = os.path.join(tmp, "stack0.npz")
        io.save_checkpoint(ck, u=kept[0], kvecs=ks)
        back = io.load_checkpoint(ck, device_put=True)
        same = torch.equal(back["u"], kept[0]) and np.array_equal(
            back["kvecs"].cpu().numpy(), ks)
        say(f"    checkpoint of stack 0's u {tuple(kept[0].shape)}: saved and "
            f"loaded back, bits equal: {same}")
        if not same:
            raise RuntimeError("[15c] the checkpoint does not round-trip")
        # the 16 tiles in one stack on the host, for phase 16d
        with data.MosaicTiles(path) as mt:
            tiles16, _ = next(mt.batches(SIZE, batch_size=16))
    return idle, tiles16


# ---- phase 16: one launch per stage for a stack on the eager path (its
# zoom sweeps) and on both gradient emissions; the utilities' device calls
# the stack rows of the kernels line: row -> the single-image kernel's row
STACK_ROWS = {"zoom_sweep_stack": "zoom_sweep",
              "zoom_grad_stack": "zoom_grad",
              "sweep_grad_stack": "sweep_grad"}
PREP_REL = 1e-3      # 16d prep_image, card vs CPU: max |d| / max |CPU|
LOCKIN_REL = 1e-5    # 16d tpuGPA, card vs CPU: max |d| / max |CPU|


def eager_fn(ks):
    """The eager path on DEVICE: a stack through one call of
    gt.parallel.extract_displacement_field_batch, an image through
    extract_displacement_field."""
    from pygpa_tpu_torch import parallel
    from pygpa_tpu_torch.gpa import pipeline

    def fn(x, events=None):
        if x.dim() == 3:
            return parallel.extract_displacement_field_batch(
                x, ks, device=DEVICE, events=events)
        return pipeline.extract_displacement_field(x, ks, device=DEVICE,
                                                   events=events)
    return fn


def same_launches(label, stack, one, names):
    """Fail unless the stack's run launched each of `names` as often as
    one image's run."""
    if any(stack.get(k, 0) != one.get(k, 0) for k in names):
        raise RuntimeError(f"[{label}] the stack launches its kernels more "
                           f"often than one image: {stack} vs {one}")


def stack_bits(label, fn, calls, kws, stacked, kw_stacked=()):
    """Each captured batched call of a kernel wrapper `fn` against its own
    launch on each image's slice, bit for bit (check_slices' rule: a
    block's arithmetic does not depend on the image index, so any
    difference is an image read or written at another image's offset,
    and fails). `stacked`: the positions of the stacked arguments;
    kw_stacked: (keyword, positions within its tuple)."""
    import torch
    worst = 0.0
    n_img = 0
    for a, kw in zip(calls, kws):
        got = fn(*a, **kw)
        B = a[stacked[0]].shape[0]
        n_img += B
        for i in range(B):
            ai = tuple(x[i].contiguous() if k in stacked else x
                       for k, x in enumerate(a))
            ki = dict(kw)
            for name, pos in kw_stacked:
                ki[name] = tuple(x[i].contiguous() if k in pos else x
                                 for k, x in enumerate(kw[name]))
            for g, o in zip(got, fn(*ai, **ki)):
                if not torch.equal(g[i], o):
                    worst = max(worst, float((g[i].double()
                                              - o.double()).abs().max()))
    say(f"    [{label}] {len(calls)} batched calls ({n_img} image slices) "
        f"against their single-image launches: "
        f"{'the same bits everywhere' if worst == 0 else worst}")
    if worst:
        raise RuntimeError(f"[{label}] a batched launch differs from its "
                           f"single-image launch (largest |d| {worst!r})")


def steps_bits(label, sw, T, win, ops, split, kernels):
    """Each launch of a gradient emission on a stack against its own
    launch on each image's slice, bit for bit: stage 1 (T), the
    tournament (win: Re M, Im M, index), then the band flags, stage 1 of
    the row-derivative windows on the flagged pairs (its flagged rows)
    and the winner products, all in the grouped layout (T (B, G, P, n,
    2K), win (B, G, n, m); ops = (S2r, S2i, gx, gy, A0c, A0s, run, A1c,
    A1s, A1yc, A1ys, off, banded), S2r, S2i (B, G, H, W0, K)). kernels:
    {"stage1": (stacked T, per-image T), "tournament": (stacked win,
    per-image wins)} from the emission's own first two launches. Fails
    on any difference."""
    import torch
    S2r, S2i, gx, gy, A0c, A0s, run, A1c, A1s, A1yc, A1ys, off, banded = ops
    P = T.shape[-3]
    flags = sw.band_winners(win[2], P)
    Tx = sw.stage1(S2r, S2i, gx, gy, A0c, A0s, run, flags)
    g = sw.winner_products(T, Tx, A1c, A1s, A1yc, A1ys, *win, flags, off,
                           banded, split)
    bad = [k for k, (st, one) in kernels.items()
           if not all(torch.equal(x[i], y) for i in range(len(one))
                      for x, y in zip(st, one[i]))]
    for i in range(T.shape[0]):
        wi = tuple(w[i].contiguous() for w in win)
        fi = sw.band_winners(wi[2], P)
        if not torch.equal(flags[i], fi):
            bad.append(f"band flags (image {i})")
        Txi = sw.stage1(S2r[i].contiguous(), S2i[i].contiguous(), gx, gy,
                        A0c, A0s, run, fi)
        rows = fi.permute(0, 2, 1).repeat_interleave(64, dim=2).bool()
        if not torch.equal(Tx[i][rows], Txi[rows]):
            bad.append(f"flagged stage 1 (image {i})")
        gi = sw.winner_products(T[i].contiguous(), Txi, A1c, A1s, A1yc,
                                A1ys, *wi, fi, off, banded, split)
        if not all(torch.equal(x[i], y) for x, y in zip(g, gi)):
            bad.append(f"winner products (image {i})")
    say(f"    [{label}] each launch of the emission on the stack against "
        f"its single-image launch (stage 1, tournament, band flags, "
        f"flagged stage 1, winner products): "
        f"{'the same bits everywhere' if not bad else bad}")
    if bad:
        raise RuntimeError(f"[{label}] batched launches differ from their "
                           f"single-image launches: {bad}")


def zoom_stack_row(zs, calls, err, launches):
    """The zoom_sweep_stack row from the captured batched calls (one a
    peak): kernel and twin ms summed over the peaks, the bound of the
    stack's work (stage 1's 8 B P n W0 W1 FLOP in float32 FMA, stage 2's
    8 B P n m W1 three times over at the dense TF32 rate, or its bytes)."""
    ms = plain = 0.0
    nbytes = f1 = f2 = 0
    for a in calls:
        B, W0, W1 = a[0].shape
        P, n, m = a[2].shape[0], a[4].shape[0], a[6].shape[0]
        ms += cuda_ms(lambda a=a: zs.zoom_sweep(*a), 3)
        plain += cuda_ms(lambda a=a: zs.zoom_sweep_plain(*a), 1)
        nbytes += tensor_bytes(a) + 4 * B * n * m * 4
        f1 += 8 * B * P * n * W0 * W1
        f2 += 8 * B * P * n * m * W1
    return dict(max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=zoom_bounds(nbytes, f1, f2)[1],
                bound_by="operations", library_ms=None,
                launches=launches.get("zoom_sweep", 0))


def drive_eager_stack():
    """Phase 16a: config 5's four 4096^2 tiles through one call of
    gt.parallel.extract_displacement_field_batch (one fft2, one zoom sweep
    launch pair a peak, the lstsq and the exact CG on every tile at once):
    launches per stack against one image's, config 5's gates on tile 0
    (props_from_u; every tile's values printed), the stack against the loop of four eager calls,
    seconds and peak memory of both; four displaced tiles
    (displaced_stack) held against their loop (hold_displaced), each
    batched zoom launch on them against its single-image launches (bits),
    and against its twin (check_zoom) on them, the last image's hole
    aside, and on the tiles. Returns (launches, the zoom_sweep_stack
    row)."""
    import torch
    from pygpa_tpu_torch.ops import wfr
    from pygpa_tpu_torch.ops import zoom_sweep as zs
    from pygpa_tpu_torch.props import props_from_u
    tiles, _, ks = config5_tiles()
    fn = eager_fn(ks)
    u, launches = counted_run("16a", lambda: fn(tiles))
    _, one = counted_run("16a", lambda: fn(tiles[0]))
    say(f"[16a] the eager path on config 5's {tuple(tiles.shape)} tiles in "
        f"one call of gt.parallel.extract_displacement_field_batch: "
        f"launches per stack {launches}, per image {one}")
    same_launches("16a", launches, one, ("zoom_sweep", "cg_unwrap"))
    if tuple(u.shape) != (4, 2, SIZE, SIZE) or not torch.isfinite(u).all():
        raise RuntimeError(f"[16a] output bad, shape {tuple(u.shape)}")
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    b = 8 * sigma
    # config 5's gates are tile 0's (run_all.py): a flipped tile mirrors
    # the lattice, which the unflipped k-vectors read as a twist of 2 x
    # 5 deg; every tile's values are printed
    mx = props_gates([props_from_u(x, 1.0) for x in u], b)
    th = [float(v[0]) for v in mx]
    ka = [float(v[1]) for v in mx]
    say(f"    gates (tile 0; run_all.py's): theta {th[0]!r}, kappa "
        f"{ka[0]!r} (theta < {GATE_5_THETA}, kappa < {GATE_5_KAPPA}); every "
        f"tile: theta {th}, kappa {ka}")
    if not (th[0] < GATE_5_THETA and ka[0] < GATE_5_KAPPA):
        raise RuntimeError("[16a] ACCURACY GATE FAILED")
    loop = torch.stack([fn(t) for t in tiles])
    bp99, bmax, bits = batch_vs_loop(u, loop, b)
    say(f"    stack vs the loop of four eager calls: interior p99 {bp99!r} "
        f"max {bmax!r} px (bounds {BATCH_P99}, {BATCH_MAX}); bits equal: "
        f"{bits}")
    if not (bp99 < BATCH_P99 and bmax < BATCH_MAX):
        raise RuntimeError("[16a] the stack differs from its images' calls")
    del u, loop
    dt, peak = timed(lambda: fn(tiles), 2)
    unwrap_stage("16a", lambda ev: fn(tiles, events=ev))
    dt_loop, peak_loop = timed(lambda: [fn(t) for t in tiles], 2)
    say(f"    seconds per stack {dt!r} ({4 * SIZE * SIZE / 1e6 / dt!r} "
        f"Mpix/s), the loop of four eager calls {dt_loop!r} s (2 runs after "
        f"warm-up each, host clock, synchronized); peak device memory "
        f"{peak!r} GiB (loop {peak_loop!r})")
    img_d = displaced_stack(SIZE, 4, r_k=0.02, theta=5.0, scale=0.25)
    hold_displaced("16a", fn, img_d, b)
    with Capture(wfr._zoom, "zoom_sweep") as c:
        fn(img_d)
        torch.cuda.synchronize()
    del img_d
    stack_bits("16a zoom_sweep", zs.zoom_sweep, c.calls, c.kws, (0, 1))
    # against the twin within phase 3's bounds: on the displaced stack
    # where the lattice is (the last image's hole aside: there |M| falls
    # where atan2 lifts float32 rounding above them), and on the tiles
    keep = torch.ones((4, SIZE, SIZE), dtype=torch.bool, device=DEVICE)
    keep[-1] = ~hole_pixels(SIZE, b)
    check_zoom(zs, c.calls, 2 * sigma, keep)
    with Capture(wfr._zoom, "zoom_sweep") as c:
        fn(tiles)
        torch.cuda.synchronize()
    err = check_zoom(zs, c.calls, 2 * sigma)
    row = zoom_stack_row(zs, c.calls, err, launches)
    say(f"    zoom_sweep_stack {tuple(c.calls[0][0].shape)} x 3 peaks: "
        f"kernel {row['ms']!r} ms, twin {row['plain_ms']!r} ms, bound "
        f"{row['bound_ms']!r} ms (operations), launches a stack "
        f"{row['launches']}")
    return launches, row


def drive_eager_chunks(tiles16, ks):
    """Phase 16a, its second part: 15c's sixteen 4096^2 mosaic tiles
    (config 5's lattice, a host stack) through one call of
    gt.parallel.extract_displacement_field_batch: the calls it splits
    the stack into on the card's free memory (images_per_call), their
    sizes, seconds and peak device memory. The estimate the split rests
    on (EAGER_BYTES_PER_PIXEL) must cover the peak: the largest call of
    c images may take no more than c + 1 estimated images above what
    was allocated before it. Config 5's gates hold on every tile
    (interior max |theta| < 0.01 deg, max |kappa - 1| < 0.001)."""
    import torch
    from pygpa_tpu_torch.parallel import sharded
    from pygpa_tpu_torch.props import props_from_u
    tiles = torch.as_tensor(tiles16).to(DEVICE)
    fn = eager_fn(ks)
    sizes = []
    run = sharded.extract_displacement_field

    def spy(images, *a, **kw):
        sizes.append(images.shape[0])
        return run(images, *a, **kw)
    cap = sharded._cap(tiles)
    sharded.extract_displacement_field = spy
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        u = fn(tiles)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        sharded.extract_displacement_field = run
    est = sharded.EAGER_BYTES_PER_PIXEL * SIZE * SIZE
    say(f"[16a] 15c's {tuple(tiles.shape)} tiles in one call of the eager "
        f"batch: at most {cap} images a call on the card's free memory, "
        f"calls of {sizes}; {dt!r} s (the first call at these shapes, host "
        f"clock, synchronized); peak device memory above the inputs "
        f"{peak / 2**30!r} GiB, the estimate for a call of {max(sizes)} "
        f"and the fixed part {(max(sizes) + 1) * est / 2**30!r} GiB")
    if tuple(u.shape) != (16, 2, SIZE, SIZE) or not torch.isfinite(u).all():
        raise RuntimeError(f"[16a] output bad, shape {tuple(u.shape)}")
    if peak > (max(sizes) + 1) * est:
        raise RuntimeError("[16a] the eager call's peak passes its memory "
                           "estimate")
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    mx = [[float(v) for v in x] for x in props_gates(
        [props_from_u(x, 1.0) for x in u], b)]
    say(f"    gates (every tile): max theta {max(v[0] for v in mx)!r}, "
        f"max kappa {max(v[1] for v in mx)!r} (theta < {GATE_5_THETA}, "
        f"kappa < {GATE_5_KAPPA})")
    if not all(v[0] < GATE_5_THETA and v[1] < GATE_5_KAPPA for v in mx):
        raise RuntimeError("[16a] ACCURACY GATE FAILED on a mosaic tile")


def drive_eager_1b():
    """Phase 16b: config 1b (16 x 512^2, image i shifted 0.31 i px)
    through the same call: launches per stack against one image's, 1b's
    gate on each image (dc-free, 8 sigma interior), the stack against its
    loop, seconds of both; then a displaced_stack of 16 held against its
    loop, and each batched zoom launch against its single-image
    launches. Returns the stack's launches."""
    import torch
    from pygpa_tpu_torch.lattices import generate_ks
    from pygpa_tpu_torch.ops import wfr
    from pygpa_tpu_torch.ops import zoom_sweep as zs
    size, nb = 512, 16
    ks = generate_ks(0.1, 7.0)[:3]
    fn = eager_fn(ks)
    imgs = lattice_stack(size, [0.31 * i for i in range(nb)])
    u, launches = counted_run("16b", lambda: fn(imgs))
    _, one = counted_run("16b", lambda: fn(imgs[0]))
    say(f"[16b] config 1b's 16 x 512^2 through the eager batch call: "
        f"launches per stack {launches}, per image {one}")
    same_launches("16b", launches, one, ("zoom_sweep", "cg_unwrap"))
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    ui = u[..., b:-b, b:-b]
    per = (ui - ui.mean(dim=(-2, -1), keepdim=True)).abs().amax(
        dim=(1, 2, 3))
    say(f"    gates: dc-free interior max per image "
        f"{[float(v) for v in per]} (< {GATE_1B} each)")
    if not float(per.max()) < GATE_1B:
        raise RuntimeError("[16b] ACCURACY GATE FAILED")
    loop = torch.stack([fn(im) for im in imgs])
    bp99, bmax, bits = batch_vs_loop(u, loop, b)
    say(f"    stack vs loop: interior p99 {bp99!r} max {bmax!r} px (bounds "
        f"{BATCH_P99}, {BATCH_MAX}); bits equal: {bits}")
    if not (bp99 < BATCH_P99 and bmax < BATCH_MAX):
        raise RuntimeError("[16b] the stack differs from its images' calls")
    del u, loop, ui
    dt, peak = timed(lambda: fn(imgs), REPS_NEW)
    unwrap_stage("16b", lambda ev: fn(imgs, events=ev))
    dt_loop, _ = timed(lambda: [fn(im) for im in imgs], REPS_NEW)
    say(f"    seconds per stack {dt!r} ({nb * size * size / 1e6 / dt!r} "
        f"Mpix/s), the 16-image loop {dt_loop!r} s ({REPS_NEW} runs after "
        f"warm-up, host clock, synchronized); peak device memory {peak!r} "
        f"GiB")
    img_d = displaced_stack(size, nb)
    hold_displaced("16b", fn, img_d, b)
    with Capture(wfr._zoom, "zoom_sweep") as c:
        fn(img_d)
        torch.cuda.synchronize()
    stack_bits("16b zoom_sweep", zs.zoom_sweep, c.calls, c.kws, (0, 1))
    return launches


def zoom_grad_stack_row(zs, sw, calls, kws, launches):
    """zoom_grad on 16c's captured batched calls against the float32
    twin (winners agree on > GRAD_AGREE of the pixels; the gradients
    within GRAD_RTOL, GRAD_ATOL there, or fail), and its row: kernel and
    twin ms summed over the peaks, the bound of the work the stack needs
    (phase 3's zoom_grad bound, counting the twin's band and tile
    winners)."""
    import torch
    mabs = ms = plain = 0.0
    nbytes = f1 = f2 = 0
    for a, kw in zip(calls, kws):
        gops = kw["grad_ops"]
        got = zs.zoom_sweep(*a, grad_ops=gops)
        want = zs.zoom_sweep_plain(*a, grad_ops=gops)
        same = got[3] == want[3]
        agree = float(same.float().mean())
        ok = agree > GRAD_AGREE
        for k in (4, 5):
            ex, dmax = grad_excess(got[k], want[k], same)
            ok &= ex <= 0 and bool(torch.isfinite(got[k]).all())
            mabs = max(mabs, dmax)
        B, W0, W1 = a[0].shape
        P, n, m = a[2].shape[0], a[4].shape[0], a[6].shape[0]
        say(f"  zoom_grad stack {(B, W0, W1)} P={P} vs twin: winners agree "
            f"{agree!r}; max |kernel - twin| of the gradients there "
            f"{mabs!r}")
        if not ok:
            raise RuntimeError("[16c] the batched zoom_grad disagrees with "
                               "its twin")
        pairs, wins = winner_counts(sw, want[3], P)
        del got, want
        ms += cuda_ms(lambda a=a: zs.zoom_sweep(*a, grad_ops=gops), 3)
        plain += cuda_ms(lambda a=a: zs.zoom_sweep_plain(*a, grad_ops=gops),
                         1)
        nbytes += tensor_bytes(a, gops) + 6 * B * n * m * 4
        f1 += 8 * B * P * n * W0 * W1 + 8 * pairs * 64 * W0 * W1
        f2 += 8 * B * P * n * m * W1 + 2 * 8 * wins * 64 * 64 * W1
    return dict(max_abs_err=mabs, ms=ms, plain_ms=plain,
                bound_ms=zoom_bounds(nbytes, f1, f2)[1],
                bound_by="operations", library_ms=None,
                launches=launches.get("zoom_grad", 0))


def sweep_grad_stack_row(sw, a, launches):
    """sweep_grad (emission (b)) on 16c's captured batched call against
    the float32 twin (phase 3's rule: the phases within 1e-3 rad and the
    gradients within GRAD_RTOL, GRAD_ATOL on all but 1 - GRAD_AGREE of
    the pixels, and where the phases agree every gradient within
    GRAD_SLIP), and its row: kernel and twin ms, the bound of the work the
    stack needs (stage 1 in full and on the twin's band winners in
    float32 FMA, stage 2 and the winner products in 3xTF32)."""
    import torch
    got = sw.sweep_grad(*a)
    want = sw.sweep_grad_plain(*a, winners=True)
    dph = (torch.remainder(got[0] - want[0] + np.pi, 2 * np.pi)
           - np.pi).abs()
    agree = dph < 1e-3
    bad = ~agree
    mabs = 0.0
    for k in (2, 3):
        d = (got[k] - want[k]).abs()
        bad |= d > GRAD_ATOL + GRAD_RTOL * want[k].abs()
        mabs = max(mabs, float(d[agree].max()))
    frac = float(bad.double().mean())
    B, G, _, W0, Wb = a[0].shape
    P, n, m = a[4].shape[1], a[6].shape[1], a[8].shape[1]
    say(f"  sweep_grad stack {tuple(a[0].shape)} P={P} vs twin: pixels off "
        f"the bounds {frac!r} (bound {1 - GRAD_AGREE!r}); where the phases "
        f"agree max |kernel - twin| of the gradients {mabs!r} (bound "
        f"{GRAD_SLIP})")
    if not (frac < 1 - GRAD_AGREE and mabs < GRAD_SLIP
            and all(bool(torch.isfinite(g).all()) for g in got)):
        raise RuntimeError("[16c] the batched sweep_grad disagrees with its "
                           "twin")
    idx = want[6]
    pairs = int(sw.band_winners_plain(idx, P).sum())
    wins = sum(tile_winners(x, P) for x in idx.reshape(-1, n, m))
    del got, want, idx
    f1 = 8 * B * G * P * n * W0 * Wb + 8 * pairs * 64 * W0 * Wb
    f2 = 8 * B * G * P * n * m * Wb + 2 * 8 * wins * 64 * 64 * Wb
    nbytes = tensor_bytes(a) + 4 * B * G * n * m * 4
    return dict(max_abs_err=mabs, ms=cuda_ms(lambda: sw.sweep_grad(*a), 3),
                plain_ms=cuda_ms(lambda: sw.sweep_grad_plain(*a), 1),
                bound_ms=zoom_bounds(nbytes, f1, f2)[1],
                bound_by="operations", library_ms=None,
                launches=launches.get("sweep_grad", 0))


def candidate_absq(Sr, Si, gx, gy, A0c, A0s, run, A1c, A1s, pix):
    """Every candidate's |M|^2 (k, P) in float64 at k pixels pix (k, 3)
    = (group, row, column) of one image, from its windows Sr, Si (G, H,
    W0, Wb) and the plan's operands in the grouped layout (gx (G, P,
    W0), gy (G, P, Wb), A0c, A0s (G, n, W0), run (G, P), A1c, A1s (G, m,
    Wb)): ops.sweep's plain stage 1 on the pixels' rows, then each
    pixel's column of stage 2 (M = T_i . B1; the banded column ramp has
    modulus 1)."""
    import torch
    from pygpa_tpu_torch.ops import sweep as sw
    d = torch.float64
    out = []
    for s in range(0, pix.shape[0], 1024):
        g, r, c = pix[s:s + 1024].long().unbind(1)
        rows, ri = torch.unique(r, return_inverse=True)
        T = sw._stage1_plain(Sr.to(d), Si.to(d), gx.to(d), gy.to(d),
                             A0c[:, rows].to(d), A0s[:, rows].to(d), run)
        Tp = T[g, :, ri]                                  # (k, P, 2 Wb)
        ac, as_ = A1c[g, c].to(d), A1s[g, c].to(d)        # (k, Wb)
        mr = (Tp * torch.cat([ac, -as_], 1)[:, None]).sum(-1)
        mi = (Tp * torch.cat([as_, ac], 1)[:, None]).sum(-1)
        out.append(mr * mr + mi * mi)
        del T, Tp
    return torch.cat(out)


def near_ties(label, name, c):
    """The pixels (B, n, m) of 16c's captured sweep calls (`c`; `name`
    the emission) where a peak's (a group's) winner differs between the
    kernel and its float32 twin and both winners' float64 |M|^2 lie
    within the kernel's |M|^2 bounds (check_zoom: ABSQ_RTOL of the
    largest candidate's, ABSQ_ATOL of the plane's largest) of the
    largest: near ties that float32 rounding decides. Prints every such
    flip (image, group, row, column, both winners, the gap between the
    top two candidates and each winner's gap to the top, relative to
    the top); a flip that is not a near tie is printed and stays held."""
    import torch
    from pygpa_tpu_torch.ops import sweep as sw
    from pygpa_tpu_torch.ops import zoom_sweep as zs
    parts = []   # (kernel winners, twin winners (B, G, n, m), twin's
    #              largest |M|^2 (B, G), one image's operands)
    if name == "zoom_grad":
        for a in c.calls:
            k = zs.zoom_sweep(*a)[3]
            w = zs.zoom_sweep_plain(*a)
            run = torch.zeros((1, a[2].shape[0]), dtype=torch.int32,
                              device=DEVICE)
            parts.append((k[:, None], w[3][:, None],
                          w[0].amax(dim=(-2, -1))[:, None],
                          lambda b, a=a, run=run: (
                              a[0][b][None, None], a[1][b][None, None],
                              a[2][None], a[3][None], a[4][None],
                              a[5][None], run, a[6][None], a[7][None])))
            del w
    else:
        a = c.calls[0]
        T = sw.stage1(a[0], a[1], *a[4:8], a[12])
        k = sw.stage2(T, a[8], a[9], a[13], a[14], a[15], winners=True)[4]
        del T
        w = sw.sweep_grad_plain(*a, winners=True)
        parts.append((k, w[6], (w[4] ** 2 + w[5] ** 2).amax(dim=(-2, -1)),
                      lambda b, a=a: (a[0][b], a[1][b], *a[4:8], a[12],
                                      a[8], a[9])))
        del w
    B, _, n, m = parts[0][0].shape
    ties = torch.zeros((B, n, m), dtype=torch.bool, device=DEVICE)
    rows, n_flip, n_tie = [], 0, 0
    for p, (k, w, amax, ops) in enumerate(parts):
        flip = (k != w).nonzero()                   # (F, 4): b, g, r, c
        n_flip += flip.shape[0]
        for b in flip[:, 0].unique().tolist():
            f = flip[flip[:, 0] == b]
            q = candidate_absq(*ops(b), f[:, 1:])
            top = q.topk(2, dim=1).values
            ik = k[b, f[:, 1], f[:, 2], f[:, 3]].long()[:, None]
            it = w[b, f[:, 1], f[:, 2], f[:, 3]].long()[:, None]
            gk = (top[:, 0] - q.gather(1, ik)[:, 0]) / top[:, 0]
            gt = (top[:, 0] - q.gather(1, it)[:, 0]) / top[:, 0]
            tol = ABSQ_RTOL + ABSQ_ATOL * amax[b, f[:, 1]].double() / top[:, 0]
            tie = torch.maximum(gk, gt) <= tol
            ties[b, f[tie, 2], f[tie, 3]] = True
            n_tie += int(tie.sum())
            for j in range(f.shape[0]):
                rows.append(
                    f"(image {b}, {'peak' if name == 'zoom_grad' else 'group'}"
                    f" {p if name == 'zoom_grad' else int(f[j, 1])}, row "
                    f"{int(f[j, 2])}, column {int(f[j, 3])}: kernel "
                    f"{int(ik[j])}, twin {int(it[j])}; top two "
                    f"{float((top[j, 0] - top[j, 1]) / top[j, 0])!r} apart, "
                    f"the winners {float(gk[j])!r} and {float(gt[j])!r} "
                    f"below the top; "
                    f"{'a near tie' if bool(tie[j]) else 'NOT a near tie'})")
    say(f"    [{label}] winners that differ between the kernel and its "
        f"float32 twin: {n_flip}, of which near ties (both winners' "
        f"float64 |M|^2 within rtol {ABSQ_RTOL} of the top candidate's, "
        f"atol {ABSQ_ATOL} of the plane's largest) {n_tie}; relative "
        f"gaps in float64:")
    for r in rows[:24]:
        say(f"      {r}")
    if len(rows) > 24:
        say(f"      ... {len(rows) - 24} more")
    return ties


def drive_grad_stack(img, img_d):
    """Phase 16c: config 2g's step on a stack of two 4096^2 images (the
    bench fixture and the same lattice displaced by the bench's field),
    through both gradient emissions: (a) float32 k-vectors, the zoom
    form (c), three "zoom_grad" launch chains; (b) float64 k-vectors,
    the grouped form (b), one "sweep_grad" chain. Each: launches per
    stack against one image's, config 2g's gates on the first image, the
    stack's property maps against the same step on the plain twins (each
    image's max within a tenth of each gate, as phase 10, on every pixel
    but those where a winner flips between kernel and twin at a near tie
    (near_ties), whose float64 gaps are printed), seconds of the stack
    and of the loop, each batched emission against its single-image
    launches (bits) and against its twin, and its stack row. Returns
    ({label: launches}, rows)."""
    import torch
    from pygpa_tpu_torch.ops import sweep as sw
    from pygpa_tpu_torch.ops import wfr
    from pygpa_tpu_torch.ops import zoom_sweep as zs
    from pygpa_tpu_torch.props import get_initial_props
    stack = torch.stack([img, img_d])
    launched, rows = {}, {}
    for label, ks, name in (("16ca", KS_BENCH_F32, "zoom_grad"),
                            ("16cb", np.asarray(KS_BENCH_F32, np.float64),
                             "sweep_grad")):
        step, sigma = config2g_step(ks)
        props, launches = counted_run(label, lambda: step(stack))
        _, one = counted_run(label, lambda: step(img))
        say(f"[{label}] config 2g on a stack {tuple(stack.shape)} (the second "
            f"image displaced), {name}: launches per stack {launches}, per "
            f"image {one}")
        same_launches(label, launches, one, (name,) + GRAD_STEPS)
        b = 4 * sigma
        theta0 = float(np.float32(float(get_initial_props(ks)[1])))
        th = float((props[0, 0] - theta0)[b:-b, b:-b].abs().max())
        ka = float((props[0, 3] - 1.005)[b:-b, b:-b].abs().max())
        say(f"    gates (first image): theta {th!r} deg, kappa {ka!r} "
            f"(theta < {GATE_2G_THETA}, kappa < {GATE_2G_KAPPA})")
        if not (th < GATE_2G_THETA and ka < GATE_2G_KAPPA):
            raise RuntimeError(f"[{label}] ACCURACY GATE FAILED")
        with plain_versions():
            pp = step(stack)
        with Capture(wfr._zoom if name == "zoom_grad" else wfr._sweep,
                     "zoom_sweep" if name == "zoom_grad" else "sweep_grad"
                     ) as c:
            step(stack)
            torch.cuda.synchronize()
        # each image as phase 10 holds it (max over the interior within a
        # tenth of each gate), but for the pixels where a winner flips at
        # a near tie between the kernels and the twins
        tie = near_ties(label, name, c)[..., b:-b, b:-b]
        dth = (props[:, 0] - pp[:, 0])[..., b:-b, b:-b].abs()
        dka = (props[:, 3] - pp[:, 3])[..., b:-b, b:-b].abs()
        held = [(float(dth[i][~tie[i]].max()), float(dka[i][~tie[i]].max()))
                for i in range(2)]
        every = [(float(dth[i].max()), float(dka[i].max())) for i in range(2)]
        say(f"    with kernels vs plain versions, 4 sigma interior, the "
            f"near ties aside ({int(tie[0].sum())}, {int(tie[1].sum())} "
            f"pixels): max |dtheta| {held[0][0]!r}, {held[1][0]!r} deg, max "
            f"|dkappa| {held[0][1]!r}, {held[1][1]!r} (first, displaced "
            f"image; bounds {GATE_2G_THETA / 10}, {GATE_2G_KAPPA / 10}); "
            f"on every pixel {every[0][0]!r}, {every[1][0]!r} deg, "
            f"{every[0][1]!r}, {every[1][1]!r}")
        if not all(h[0] < GATE_2G_THETA / 10 and h[1] < GATE_2G_KAPPA / 10
                   for h in held):
            raise RuntimeError(f"[{label}] kernels change the result")
        del props, pp, tie
        dt, peak = timed(lambda: step(stack), 2)
        dt_loop, _ = timed(lambda: [step(x) for x in stack], 2)
        say(f"    seconds per stack {dt!r}, the loop of two calls "
            f"{dt_loop!r} s (2 runs after warm-up each, host clock, "
            f"synchronized); peak device memory {peak!r} GiB")
        if name == "zoom_grad":
            stack_bits(label + " zoom_grad", zs.zoom_sweep, c.calls, c.kws,
                       (0, 1), (("grad_ops", (0, 1)),))
            for a, kw in zip(c.calls, c.kws):
                S2r, S2i, A1yc, A1ys = kw["grad_ops"]
                T = zs.stage1(*a[:6])
                out = zs.stage2(T, a[6], a[7], None)
                ones = [zs.stage1(a[0][i].contiguous(),
                                  a[1][i].contiguous(), *a[2:6])
                        for i in range(a[0].shape[0])]
                run = torch.zeros((1, a[2].shape[0]), dtype=torch.int32,
                                  device=T.device)
                steps_bits(label, sw, T.unsqueeze(-4),
                           tuple(o.unsqueeze(-3) for o in out[1:4]),
                           (S2r[:, None, None], S2i[:, None, None],
                            a[2][None], a[3][None], a[4][None], a[5][None],
                            run, a[6][None], a[7][None], A1yc[None],
                            A1ys[None], None, False), False,
                           {"stage1": ((T,), [(t,) for t in ones]),
                            "tournament": (out, [zs.stage2(t, a[6], a[7],
                                                           None)
                                                 for t in ones])})
                del T, out, ones
            rows["zoom_grad_stack"] = zoom_grad_stack_row(
                zs, sw, c.calls, c.kws, launches)
        else:
            stack_bits(label + " sweep_grad", sw.sweep_grad, c.calls, c.kws,
                       (0, 1, 2, 3))
            a = c.calls[0]
            T = sw.stage1(a[0], a[1], *a[4:8], a[12])
            win = sw.stage2(T, a[8], a[9], a[13], a[14], a[15], winners=True)
            ones = [sw.stage1(a[0][i].contiguous(), a[1][i].contiguous(),
                              *a[4:8], a[12]) for i in range(a[0].shape[0])]
            steps_bits(label, sw, T, win[2:],
                       (a[2], a[3], *a[4:8], a[12], *a[8:12], a[13], a[15]),
                       True,
                       {"stage1": ((T,), [(t,) for t in ones]),
                        "tournament": (win, [sw.stage2(
                            t, a[8], a[9], a[13], a[14], a[15],
                            winners=True) for t in ones])})
            del T, win, ones
            rows["sweep_grad_stack"] = sweep_grad_stack_row(
                sw, c.calls[0], launches)
        r = rows[name + "_stack"]
        say(f"    {name}_stack: kernel {r['ms']!r} ms, twin "
            f"{r['plain_ms']!r} ms, bound {r['bound_ms']!r} ms "
            f"(operations), launches a stack {r['launches']}")
        launched[label] = launches
        del c
    return launched, rows


def drive_utilities(img, ks, tiles16):
    """Phase 16d: the utilities' device calls at 4096^2, each timed on
    the card and held to the same call with device="cpu": prep_image on
    the bench fixture with a zero border (trim_nans2 peels it; max |card
    - CPU| / max |CPU| < PREP_REL), generate_mask on 15c's 16-tile stack
    with a zeroed block (masks equal), and the tpugpa mirror on the bench
    fixture (tpuGPA: < LOCKIN_REL of the largest lock-in; wfr2_grad_opt
    and wfr2_only_lockin through the zoom kernel, launches counted, and
    on a 1024^2 crop against the CPU: winners agree on >= WFR4_AGREE of
    the 5 sigma interior, the lock-in phase within WFR4_PHASE rad and
    the gradients within GRAD_RTOL, GRAD_ATOL there)."""
    import torch
    from pygpa_tpu_torch import imagetools, tpugpa
    from pygpa_tpu_torch.config import DEFAULTS
    from pygpa_tpu_torch.gpa.prep import prep_image
    raw = img.clone()
    raw[:5] = 0
    raw[:, -3:] = 0
    host = raw.cpu().numpy()
    del raw
    # one call each way: the host's quantiles and NaN trim, which both
    # run, take most of the card's call
    (dc, _, _), _, t_c = counted(lambda: prep_image(host, device=DEVICE))
    t0 = time.perf_counter()
    dh, _, _ = prep_image(host, device="cpu")
    t_h = time.perf_counter() - t0
    e = float((dc.cpu() - dh).abs().max() / dh.abs().max())
    say(f"[16d] prep_image on the {host.shape} bench fixture with a zero "
        f"border: trimmed to {tuple(dc.shape)}; card {t_c!r} s, CPU {t_h!r} "
        f"s; max |card - CPU| / max |CPU| {e!r} (bound {PREP_REL})")
    if not (tuple(dc.shape) == tuple(dh.shape) and e < PREP_REL):
        raise RuntimeError("[16d] prep_image on the card disagrees with the "
                           "CPU")
    del dc, dh, host
    tiles_h = np.array(tiles16, np.float32)
    tiles_h[5, 1000:1400, 2000:2600] = 0
    tiles = torch.as_tensor(tiles_h, device=DEVICE)
    imagetools.generate_mask(tiles, 0, r=20, device=DEVICE)
    mc, _, t_c = counted(lambda: imagetools.generate_mask(tiles, 0, r=20,
                                                          device=DEVICE))
    t0 = time.perf_counter()
    mh = imagetools.generate_mask(tiles_h, 0, r=20, device="cpu")
    t_h = time.perf_counter() - t0
    same = torch.equal(mc.cpu(), mh)
    say(f"[16d] generate_mask on 15c's {tuple(tiles.shape)} tiles (a zeroed "
        f"block in tile 5): {float(mh.double().mean())!r} of the pixels "
        f"kept; card {t_c!r} s, CPU {t_h!r} s; masks equal: {same}")
    if not same:
        raise RuntimeError("[16d] generate_mask on the card disagrees with "
                           "the CPU")
    del tiles, tiles_h, mc, mh
    k = np.asarray(ks[0], np.float64)
    kn = np.linalg.norm(ks, axis=1)
    sigma = int(np.ceil(1 / kn.min()))
    kw = kn.mean() / DEFAULTS.kw_scale
    kstep = kw / DEFAULTS.ksteps
    calls = {
        "tpuGPA": lambda x, d: tpugpa.tpuGPA(x, k, sigma, device=d),
        "wfr2_grad_opt": lambda x, d: tpugpa.wfr2_grad_opt(
            x, sigma, k[0], k[1], kw, kstep, device=d),
        "wfr2_only_lockin": lambda x, d: tpugpa.wfr2_only_lockin(
            x, sigma, k, kw, kstep, device=d)}
    want_launch = {"tpuGPA": {}, "wfr2_grad_opt": {"zoom_grad": 1},
                   "wfr2_only_lockin": {"zoom_sweep": 1}}
    for name, call in calls.items():
        call(img, DEVICE)
        out, launches, dt = counted(lambda: call(img, DEVICE))
        say(f"[16d] tpugpa.{name} on the {SIZE}^2 bench fixture: {dt!r} s "
            f"(one synchronized call after a warm-up); launches {launches}")
        if any(launches.get(n, 0) != v for n, v in want_launch[name].items()):
            raise RuntimeError(f"[16d] tpugpa.{name} did not run the zoom "
                               "kernel")
    crop = img[:1024, :1024].contiguous()
    crop_h = crop.cpu()
    lc, lh = (calls["tpuGPA"](x, d).cpu() for x, d in ((crop, DEVICE),
                                                       (crop_h, "cpu")))
    e = float((lc - lh).abs().max() / lh.abs().max())
    gc, gh = (calls["wfr2_grad_opt"](x, d) for x, d in ((crop, DEVICE),
                                                        (crop_h, "cpu")))
    oc = calls["wfr2_only_lockin"](crop, DEVICE).cpu()
    oh = calls["wfr2_only_lockin"](crop_h, "cpu")
    b = 5 * sigma
    same = (gc["w"].cpu() == gh["w"]).all(0)[b:-b, b:-b]
    frac = float(same.double().mean())
    dph = torch.angle(gc["lockin"].cpu() * gh["lockin"].conj())
    dph = float(dph[b:-b, b:-b][same].abs().max())
    dpo = float(torch.angle(oc * oh.conj())[b:-b, b:-b][same].abs().max())
    gd = (gc["grad"].cpu() - gh["grad"]).abs()[b:-b, b:-b][same]
    gex = float((gd - GRAD_ATOL - GRAD_RTOL
                 * gh["grad"][b:-b, b:-b][same].abs()).max())
    say(f"    1024^2 crop, card vs CPU: tpuGPA max |d| / max |CPU| {e!r} "
        f"(bound {LOCKIN_REL}); wfr2_grad_opt winners agree on {frac!r} of "
        f"the 5 sigma interior (bound {WFR4_AGREE}), its lock-in phase there "
        f"within {dph!r} rad and wfr2_only_lockin's within {dpo!r} rad "
        f"(bound {WFR4_PHASE}), the gradients' excess over rtol "
        f"{GRAD_RTOL}, atol {GRAD_ATOL} {gex!r} (<= 0 passes)")
    if not (e < LOCKIN_REL and frac >= WFR4_AGREE and dph < WFR4_PHASE
            and dpo < WFR4_PHASE and gex <= 0):
        raise RuntimeError("[16d] the tpugpa mirror on the card disagrees "
                           "with the CPU")


# ---- phase 17: the multi-device API on a world of one
SHARDED_P99, SHARDED_MAX = 1e-3, 1e-2   # 17a/17b vs the single card, px
FFT_REL = 1e-5       # 17e: max |pencil - torch.fft| / max |torch.fft|
SWEEP_LOCKIN = 1e-4  # 17d: max |d lock-in| / max |lock-in| where w agree
REPS_17 = 3


def world_of_one(backend="nccl"):
    """A process group of one rank through a file store in a new
    temporary directory; returns the directory (removed by the caller
    after dist.destroy_process_group())."""
    import tempfile
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip_smoke_world_")
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    return tmp


def zoom_rows_row(zs, calls, err, launches):
    """The zoom_sweep_sharded row from 17a's captured row-block calls (one
    a peak): kernel and twin ms summed over the peaks; the bound of the
    work (stage 1's 8 P r W0 W1 FLOP in float32 FMA, stage 2's 8 P r m W1
    three times over at the dense TF32 rate, or the bytes)."""
    ms = plain = 0.0
    nbytes = f1 = f2 = 0
    for a in calls:
        W0, W1 = a[0].shape
        P, r, m = a[2].shape[0], a[4].shape[0], a[6].shape[0]
        ms += cuda_ms(lambda a=a: zs.zoom_sweep(*a), 3)
        plain += cuda_ms(lambda a=a: zs.zoom_sweep_plain(*a), 1)
        nbytes += tensor_bytes(a) + 4 * r * m * 4
        f1 += 8 * P * r * W0 * W1
        f2 += 8 * P * r * m * W1
    return dict(max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=zoom_bounds(nbytes, f1, f2)[1],
                bound_by="operations", library_ms=None,
                launches=launches.get("zoom_sweep", 0))


def hold_row_block(zs, calls, dr):
    """17c: check_zoom on the row-block calls, then the winner flips
    between kernel and twin that are not near ties (near_ties) held to at
    most 1 - ZOOM_AGREE of the pixels."""
    import types
    import torch
    err = check_zoom(zs, calls, dr)
    stack = types.SimpleNamespace(calls=[(a[0][None], a[1][None], *a[2:])
                                         for a in calls])
    ties = near_ties("17c", "zoom_grad", stack)
    for p, a in enumerate(calls):
        flip = zs.zoom_sweep(*a)[3] != zs.zoom_sweep_plain(*a)[3]
        # near_ties marks a pixel where any peak flips at a near tie
        hard = float((flip & ~ties[0]).float().mean())
        say(f"    [17c] peak {p}: winner flips {int(flip.sum())}, not near "
            f"ties {hard!r} of the pixels (bound {1 - ZOOM_AGREE})")
        if hard > 1 - ZOOM_AGREE:
            raise RuntimeError("[17c] the row-block zoom kernel flips "
                               "winners away from near ties")
    torch.cuda.synchronize()
    return err


def drive_sharded(img, img_d, u_true, ks, backend="nccl"):
    """Phase 17 (module docstring): the multi-device API on a world of
    one. Returns ({path label: launches}, {kernels-line rows})."""
    import shutil
    import torch
    import torch.distributed as dist
    from pygpa_tpu_torch import parallel as par
    from pygpa_tpu_torch.core import fourier
    from pygpa_tpu_torch.gpa import pipeline
    from pygpa_tpu_torch.ops import _build
    from pygpa_tpu_torch.ops import dct as dm
    from pygpa_tpu_torch.ops import wfr
    from pygpa_tpu_torch.ops import zoom_sweep as zs
    from pygpa_tpu_torch.ops.kernel_smoke import run_kernel_smoke

    tmp = world_of_one(backend)
    launches, rows = {}, {}
    try:
        mesh = par.make_mesh(1, device_type=DEVICE)
        say(f"[17] {backend} world of {dist.get_world_size()}, mesh "
            f"{mesh.mesh_dim_names} {tuple(mesh.shape)} on "
            f"{mesh.device_type}")
        sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
        dr = 2 * sigma

        def sharded_u(im, coarse):
            return par.extract_displacement_field_sharded(
                im, ks, mesh, unwrap_coarse=coarse).full_tensor()

        # (a), (b): the row-sharded pipeline, multigrid and exact CG
        for label, coarse, single, what in (
                ("17a", 4, pipeline.make_displacement_extractor(
                    (SIZE, SIZE), ks, unwrap_coarse=4, device=DEVICE),
                 "the single-card factory at unwrap_coarse=4"),
                ("17b", None, lambda im: pipeline.extract_displacement_field(
                    im, ks, device=DEVICE),
                 "the eager extract_displacement_field")):
            with Capture(zs, "zoom_sweep") as c_zs, \
                    Capture(dm, "dct_lane", keep=1) as c_dl, \
                    Capture(dm, "idct_lane", keep=1) as c_il, \
                    Capture(dm, "dct_sub", keep=1) as c_ds, \
                    Capture(dm, "idct_sub", keep=1) as c_is:
                u, launches[label] = counted_run(
                    label, lambda c=coarse: sharded_u(img, c))
            say(f"    [{label}] extract_displacement_field_sharded(img, ks, "
                f"mesh, unwrap_coarse={coarse}): launches {launches[label]}")
            ud = pipeline.gaussian_deconvolve(sharded_u(img_d, coarse), sigma,
                                              dr)
            if tuple(u.shape) != (2, SIZE, SIZE) or \
                    not bool(torch.isfinite(u).all()):
                raise RuntimeError(f"[{label}] bad output {tuple(u.shape)}")
            g = gate_values(u, ud, u_true, ks)
            say(f"    [{label}] gates: interior {g[0]!r}, dc-free {g[1]!r}, "
                f"deformed {g[2]!r} px (bounds {GATE_INTERIOR}, "
                f"{GATE_DCFREE}, {GATE_DEFORMED})")
            if not (g[0] < GATE_INTERIOR and g[1] < GATE_DCFREE
                    and g[2] < GATE_DEFORMED):
                raise RuntimeError(f"[{label}] ACCURACY GATE FAILED")
            ref = single(img)
            d99, dmax = interior_dist(u, ref, ks)
            say(f"    [{label}] vs {what}: interior p99 {d99!r}, max "
                f"{dmax!r} px (bounds {SHARDED_P99}, {SHARDED_MAX})")
            if not (d99 < SHARDED_P99 and dmax < SHARDED_MAX):
                raise RuntimeError(f"[{label}] the sharded pipeline strays "
                                   f"from {what}")
            dt, peak = timed(lambda c=coarse: sharded_u(img, c), REPS_17)
            dt1, peak1 = timed(lambda: single(img), REPS_17)
            say(f"    [{label}] seconds {dt!r} (peak {peak!r} GiB); {what} "
                f"{dt1!r} s (peak {peak1!r} GiB); {REPS_17} runs, host "
                f"clock, synchronized")
            if label == "17a":
                zcalls = list(c_zs.calls[-3:])
            else:
                dct_in = {"dct_lane": c_dl.calls[0][0],
                          "idct_lane": c_il.calls[0][0],
                          "dct_sub": c_ds.calls[0][0],
                          "idct_sub": c_is.calls[0][0]}
            del u, ud, ref

        # (c) the zoom kernel on 17a's row blocks against its twin
        say(f"    [17c] row-block calls: P = "
            f"{[a[2].shape[0] for a in zcalls]}, rows "
            f"{[a[4].shape[0] for a in zcalls]}, windows "
            f"{[tuple(a[0].shape) for a in zcalls]}")
        e_z = hold_row_block(zs, zcalls, dr)
        rows["zoom_sweep_sharded"] = zoom_rows_row(zs, zcalls, e_z,
                                                   launches["17a"])

        # (d) the candidate-sharded sweep against the single-card one
        img0 = img - img.mean()
        k = np.asarray(ks[0], np.float64)
        kw = np.linalg.norm(ks, axis=1).mean() / 2.5
        wl = pipeline.arange_bank(k, kw, kw / 3)
        got = par.wfr_sweep_sharded(img0, wl, k, sigma, mesh, with_grad=True)
        want = wfr.wfr_sweep(img0, wl, k, sigma, with_grad=True, zoom=False)
        same = (got["w"] == want["w"]).all(0)
        agree = float(same.float().mean())
        dl = float((got["lockin"] - want["lockin"]).abs()[same].max()
                   / want["lockin"].abs().max())
        dg = float((got["grad"] - want["grad"]).abs()[same].max())
        say(f"    [17d] wfr_sweep_sharded (P={wl.shape[0]}) vs "
            f"ops.wfr.wfr_sweep(zoom=False): winners agree {agree!r}; where "
            f"they agree lock-in {dl!r} of max, grad {dg!r} rad/px (bounds "
            f"{ZOOM_AGREE}, {SWEEP_LOCKIN})")
        if not (agree > ZOOM_AGREE and dl < SWEEP_LOCKIN):
            raise RuntimeError("[17d] wfr_sweep_sharded strays from "
                               "wfr_sweep")
        dt, peak = timed(lambda: par.wfr_sweep_sharded(
            img0, wl, k, sigma, mesh, with_grad=True), 1)
        say(f"    [17d] seconds {dt!r} (peak {peak!r} GiB)")
        del got, want, same

        # (e) the pencil FFT
        spec = par.fft2_sharded(img, mesh)
        ref = torch.fft.fft2(img)
        e_f = rel_err(spec.full_tensor(), ref)
        back = par.ifft2_sharded(spec, mesh).full_tensor()
        e_b = rel_err(back.real, img)
        say(f"    [17e] fft2_sharded vs torch.fft.fft2: rel err {e_f!r}; "
            f"ifft2_sharded back: {e_b!r} (bound {FFT_REL})")
        if not (e_f < FFT_REL and e_b < FFT_REL):
            raise RuntimeError("[17e] the pencil FFT strays from torch.fft")
        dt, peak = timed(lambda: par.ifft2_sharded(par.fft2_sharded(
            img, mesh), mesh), REPS_17)
        say(f"    [17e] fft2 + ifft2 seconds {dt!r} (peak {peak!r} GiB)")
        del spec, ref, back

        # (f) the pencil DCT, and its local passes against their twins
        x = img_d - img_d.mean()
        _build.launches.clear()
        y = par.dct2n_sharded(x, mesh)
        xb = par.idct2n_sharded(y, mesh).full_tensor()
        torch.cuda.synchronize()
        n_dct = {c: _build.launches[c] for c in ("dct_lane", "dct_sub")}
        y = y.full_tensor()
        e_y = rel_err(y, fourier.dct2n(x))
        e_x = rel_err(xb, fourier.idct2n(fourier.dct2n(x)))
        say(f"    [17f] dct2n_sharded vs core.fourier.dct2n: rel err {e_y!r} "
            f"(bits {'equal' if torch.equal(y, fourier.dct2n(x)) else 'differ'}"
            f"), idct2n_sharded {e_x!r} (bound {DCT_BOUND}); launches "
            f"{n_dct}")
        if not (e_y <= DCT_BOUND and e_x <= DCT_BOUND
                and all(v >= 2 for v in n_dct.values())):
            raise RuntimeError("[17f] the pencil DCT strays from "
                               "core.fourier or skips its kernels")
        dt, peak = timed(lambda: par.idct2n_sharded(par.dct2n_sharded(
            x, mesh), mesh), REPS_17)
        say(f"    [17f] dct2n + idct2n seconds {dt!r} (peak {peak!r} GiB)")
        del x, y, xb
        e_dct = check_dct(dm, dct_in)
        for kern, inv in (("dct_lane", "idct_lane"), ("dct_sub", "idct_sub")):
            t = [(cuda_ms(lambda f=getattr(dm, nm), a=dct_in[nm]: f(a), 10),
                  cuda_ms(lambda f=getattr(dm, nm + "_plain"),
                          a=dct_in[nm]: f(a), 10),
                  bound(2 * tensor_bytes(dct_in[nm]),
                        dct_ops(dct_in[nm], -1 if "lane" in nm else -2)))
                 for nm in (kern, inv)]
            rows[kern + "_sharded"] = dict(
                max_abs_err=e_dct[kern], ms=(t[0][0] + t[1][0]) / 2,
                plain_ms=(t[0][1] + t[1][1]) / 2,
                bound_ms=(t[0][2][0] + t[1][2][0]) / 2, bound_by=t[0][2][1],
                library_ms=None, launches=launches["17b"].get(kern, 0))
            say(f"    [17f] {kern} on 17b's local passes "
                f"{tuple(dct_in[kern].shape)}: kernel {rows[kern + '_sharded']['ms']!r} "
                f"ms, twin {rows[kern + '_sharded']['plain_ms']!r} ms, bound "
                f"{rows[kern + '_sharded']['bound_ms']!r} ms")

        # (g) the batch over the mesh against the same call without one
        stack = torch.stack([img, img_d])
        ub, launches["17g"] = counted_run(
            "17g", lambda: par.extract_displacement_field_batch(
                stack, ks, mesh=mesh).full_tensor())
        u1 = par.extract_displacement_field_batch(stack, ks, device=DEVICE)
        say(f"    [17g] extract_displacement_field_batch(mesh=...) vs no "
            f"mesh: bits {'equal' if torch.equal(ub, u1) else 'DIFFER'}; "
            f"launches {launches['17g']}")
        if not torch.equal(ub, u1):
            raise RuntimeError("[17g] the mesh changes the batch's bits")
        dt, peak = timed(lambda: par.extract_displacement_field_batch(
            stack, ks, mesh=mesh).full_tensor(), REPS_17)
        say(f"    [17g] seconds {dt!r} (peak {peak!r} GiB)")
        del stack, ub, u1

        # (h) every kernel entry once at small shapes
        t0 = time.perf_counter()
        run_kernel_smoke(device=DEVICE)
        say(f"    [17h] run_kernel_smoke(device={DEVICE!r}): every entry's "
            f"launch counter rose; {time.perf_counter() - t0!r} s")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, rows


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
    from pygpa_tpu_torch.ops import drizzle as drizzle_mod
    from pygpa_tpu_torch.ops import expand as expand_mod
    from pygpa_tpu_torch.ops import fit as fit_mod
    from pygpa_tpu_torch.ops import warp as warp_mod
    from pygpa_tpu_torch.solvers import unwrap as unwrap_mod
    from pygpa_tpu_torch.ucell import averaging as ucell_mod
    from pygpa_tpu_torch import gpa as gt_gpa
    from pygpa_tpu_torch.lattices import generate_ks

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
    for key in SWEEP_KERNELS + ("bilinear_kernel", "cubic_disp_kernel",
                                "EpiEigen", "EpiDot", "p_applyq_kernel",
                                "applyq_strip_kernel",
                                "drizzle_shared_kernel"):
        lines = ptxas_lines(_build.build_log, key) or (
            "not in this run's log: the library was built by an earlier "
            "process")
        say(f"    ptxas {key}: {lines}")
        if key in SWEEP_KERNELS and spill_bytes(lines):
            raise RuntimeError(f"{key} spills registers (ptxas)")
    for key in WGMMA_KERNELS + MMA_SYNC_KERNELS:
        n_hg, n_hm = (sass_count(lib._name, key, op)
                      for op in ("HGMMA", "HMMA"))
        say(f"    {key} SASS: {n_hg} HGMMA, {n_hm} HMMA instructions "
            "(cuobjdump -sass)")
        if key in WGMMA_KERNELS and (n_hg == 0 or n_hm):
            raise RuntimeError(f"{key}: its products are not all warpgroup "
                               "wgmma (HGMMA) in its SASS")
        if key in MMA_SYNC_KERNELS and n_hm == 0:
            raise RuntimeError(f"{key} has no HMMA in its SASS: its "
                               "products do not run on the tensor cores")
    atoms = sass_ops(lib._name, "drizzle_shared_kernel", ("ATOM", "RED"))
    say(f"    drizzle_shared_kernel SASS atomics: {atoms} (cuobjdump -sass)")
    if "ATOMS.ADD" not in atoms or any(a.startswith(("ATOMS.CAS",
                                                     "ATOMS.CAST"))
                                       for a in atoms):
        raise RuntimeError("the drizzle's shared-memory adds are not native "
                           "ATOMS.ADD (a compare-and-swap loop?)")

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
    ops, outs = matmul_flops(sw_mod.sweep_uv_plain, *sw_args)
    # stage 1: 8 G P n W0 Wb FLOP in float32 FMA; stage 2: 8 G P n m Wb,
    # three times over at the dense TF32 rate (torch's flop counter over
    # the twin counts the same products)
    G, P, W0 = sw_args[2].shape
    n_sw, m_sw, Wb = sw_args[4].shape[1], sw_args[6].shape[1], \
        sw_args[6].shape[2]
    f1, f2 = 8 * G * P * n_sw * W0 * Wb, 8 * G * P * n_sw * m_sw * Wb
    b_fp32, b_tc = zoom_bounds(tensor_bytes(sw_args, outs), f1, f2)
    T_sw = sw_mod.stage1(*sw_args[:6], sw_args[8])
    ph_sw, wt_sw = sw_mod.stage2(T_sw, sw_args[6], sw_args[7], sw_args[9],
                                 sw_args[11], sw_args[12])
    sw_t = {"call": cuda_ms(lambda: sw_mod.sweep_uv(*sw_args), 3),
            "stage1": cuda_ms(lambda: sw_mod.stage1(*sw_args[:6],
                                                    sw_args[8]), 3),
            "stage2": cuda_ms(lambda: sw_mod.stage2(
                T_sw, sw_args[6], sw_args[7], sw_args[9], sw_args[11],
                sw_args[12]), 3),
            "uv": cuda_ms(lambda: sw_mod.epilogue(ph_sw, wt_sw,
                                                  sw_args[10]), 3)}
    sw_dev, _ = device_kernels(lambda: sw_mod.stage2(
        T_sw, sw_args[6], sw_args[7], sw_args[9], sw_args[11], sw_args[12]),
        3)
    del T_sw, ph_sw, wt_sw
    stage2_rate(f"sweep_uv G={G} P={P} Wb={Wb}", sw_t["stage2"], f2,
                kernel_ms(sw_dev, "grouped_stage2_kernel"))
    rows["split_basis"] = check_split(sw_mod, sw_args[6], sw_args[7])
    s2_fp32, s2_tc = zoom_bounds(0, 0, f2)
    say(f"    sweep_uv G={G} P={P} W0={W0} Wb={Wb}: call {sw_t['call']!r} ms "
        f"(stage 1 {sw_t['stage1']!r}, stage 2 {sw_t['stage2']!r}, uv "
        f"{sw_t['uv']!r}); stage 1 bound {f1 / FP32_FLOP_S * 1e3!r} ms "
        f"(float32 FMA); stage 2 bounds {s2_fp32!r} ms (float32 FMA), "
        f"{s2_tc!r} ms (3xTF32); call bounds {b_fp32!r} ms (float32 FMA), "
        f"{b_tc!r} ms (stage 2 in 3xTF32, the row's bound; {f1!r} + {f2!r} "
        f"FLOP, flop counter {ops!r})")
    rows["sweep_uv"] = dict(
        max_abs_err=check_sweep(sw_mod, sw_args), ms=sw_t["call"],
        plain_ms=cuda_ms(lambda: sw_mod.sweep_uv_plain(*sw_args), 3),
        bound_ms=b_tc, bound_by="operations", library_ms=None)
    # config 3's fixture (phase 7a): its unwrap's applyq call, one plane
    c3 = config3_fixture(torch)
    with Capture(unwrap_mod._vcycle, "applyq", keep=1) as c_aq7:
        unwrap_mod.phase_unwrap_mg(c3[3], c3[4])
        torch.cuda.synchronize()
    e_ps, e_aq = check_vcycle(vc_mod, ps_args, [aq_args, c_aq7.calls[0]])
    # stencils: a per-pixel count of the kernels' float32 operations
    rows["presmooth"] = dict(
        max_abs_err=e_ps, ms=cuda_ms(lambda: vc_mod.presmooth(*ps_args), 20),
        plain_ms=cuda_ms(lambda: vc_mod.presmooth_plain(*ps_args), 20),
        **bound_row(tensor_bytes(ps_args, vc_mod.presmooth_plain(*ps_args)),
                    40 * ps_args[0].numel()))
    # the bytes the strip kernel moves: halo columns and rows read again
    B_ps, (n_ps, m_ps) = ps_args[0].shape[0], ps_args[0].shape[-2:]
    ps_moved = vc_mod.presmooth_traffic(
        B_ps, n_ps, m_ps, int(ps_args[4]),
        torch.cuda.get_device_properties(0).multi_processor_count)
    ps_need = tensor_bytes(ps_args, vc_mod.presmooth_plain(*ps_args))
    say(f"    presmooth {tuple(ps_args[0].shape)} cr {ps_args[4]}: call "
        f"{rows['presmooth']['ms']!r} ms (CUDA events over 20 calls), "
        f"device {device_ms(lambda: vc_mod.presmooth(*ps_args), 20)!r} ms "
        f"(torch.profiler); moves {ps_moved} bytes "
        f"({ps_moved / HBM_BYTES_S * 1e3!r} ms at the HBM rate, "
        f"{ps_moved / ps_need!r} of the bound's {ps_need}); bound "
        f"{rows['presmooth']['bound_ms']!r} ms")
    rows["applyq"] = dict(
        max_abs_err=e_aq, ms=cuda_ms(lambda: vc_mod.applyq(*aq_args), 20),
        plain_ms=cuda_ms(lambda: vc_mod.applyq_plain(*aq_args), 20),
        **bound_row(tensor_bytes(aq_args, vc_mod.applyq_plain(*aq_args)),
                    12 * aq_args[0].numel()))
    # the bytes the strip kernel moves: halo columns and rows read again
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for a in (aq_args, c_aq7.calls[0]):
        B_aq = int(np.prod(a[0].shape[:-2]))
        n_aq, m_aq = a[0].shape[-2:]
        aq_moved = vc_mod.applyq_traffic(B_aq, n_aq, m_aq, sms)
        aq_need = tensor_bytes(a, vc_mod.applyq_plain(*a))
        say(f"    applyq {tuple(a[0].shape)} (tiling "
            f"{vc_mod.applyq_tiling(n_aq, m_aq, sms)}): call "
            f"{cuda_ms(lambda: vc_mod.applyq(*a), 20)!r} ms (CUDA events "
            f"over 20 calls), device "
            f"{device_ms(lambda: vc_mod.applyq(*a), 20)!r} ms "
            f"(torch.profiler); moves {aq_moved} bytes "
            f"({aq_moved / HBM_BYTES_S * 1e3!r} ms at the HBM rate, "
            f"{aq_moved / aq_need!r} of the bound's {aq_need}); bound "
            f"{aq_need / HBM_BYTES_S * 1e3!r} ms")
    # both captured calls (the coarse solve, kmax 6, and the V-branch's
    # correction, kmax 4) and a dense-route call at sides no Stockham
    # plan covers
    dense_call = dense_cg_call(torch, 2, 384, 640, 4)
    e_cg = check_cg(cg_mod, c_cg.calls + [dense_call])
    cg_rows = []
    for a in c_cg.calls + [dense_call]:
        rk0, kmax = a[0], a[3]
        B, n_cg, m_cg = (int(np.prod(rk0.shape[:-2])),) + tuple(
            rk0.shape[-2:])
        npx = n_cg * m_cg
        # kmax iterations of an FFT-form 2D DCT pair plus the stencil
        b_ms, b_by = bound(tensor_bytes(a[:3], rk0),
                           rk0.numel() * kmax * (5 * np.log2(npx) + 12))
        k_ms = cuda_ms(lambda a=a: cg_mod.cg_poisson(*a), 10)
        t_ms = cuda_ms(lambda a=a: cg_mod.cg_poisson_plain(*a), 10)
        by_kernel, _ = device_kernels(lambda a=a: cg_mod.cg_poisson(*a))
        fft = cg_mod.fft_route(n_cg, m_cg)
        g_per_it = len(_build.graph_kernels(
            lambda a=a: cg_mod.cg_poisson(*a))) / kmax
        line = (f"    cg_poisson {tuple(rk0.shape)} kmax {kmax} "
                f"({'FFT' if fft else 'dense'} route): kernel {k_ms!r} ms, "
                f"twin {t_ms!r} ms, bound {b_ms!r} ms ({b_by}); kernel "
                f"launches per iteration {g_per_it!r} (captured graph)")
        if fft:
            l2 = chain_bytes(B, n_cg, m_cg)
            with cg_dense_route():
                d_ms = cuda_ms(lambda a=a: cg_mod.cg_poisson(*a), 10)
            line += (f"; L2 traffic of the launch chain {l2!r} bytes per "
                     f"iteration ({l2 * kmax / HBM_BYTES_S * 1e3!r} ms at "
                     f"the HBM rate for the call); the dense route on the "
                     f"same inputs {d_ms!r} ms")
            # exactly six launches an iteration (four DCT passes, the
            # p/stencil and x/r kernels)
            if g_per_it != 6:
                raise RuntimeError(f"the FFT-route CG launches {g_per_it} "
                                   f"kernels per iteration, not 6")
        say(line)
        say(f"      device ms per kernel over the call: "
            f"{json.dumps(by_kernel)}")
        cg_rows.append((k_ms, t_ms, b_ms, b_by))
    rk0 = c_cg.calls[0][0]
    rows["cg_poisson"] = dict(max_abs_err=e_cg, ms=cg_rows[0][0],
                              plain_ms=cg_rows[0][1], bound_ms=cg_rows[0][2],
                              bound_by=cg_rows[0][3], library_ms=None)
    del dense_call
    # the eager path's inputs: one zoom sweep per Bragg peak and its
    # exact early-stopping CG solve
    ks32 = KS_BENCH_F32
    if np.abs(ks32 - ks).max() > 1e-8:
        raise RuntimeError("KS_BENCH_F32 is not the bench fixture's ks")
    with Capture(wfr_mod._zoom, "zoom_sweep") as c_zs, \
            Capture(unwrap_mod._cg, "cg_unwrap", keep=1) as c_cu:
        pipeline.extract_displacement_field(img, ks32)
        torch.cuda.synchronize()
    say(f"    captured eager-path calls: zoom_sweep P = "
        f"{[a[2].shape[0] for a in c_zs.calls]}, windows "
        f"{[tuple(a[0].shape) for a in c_zs.calls]}")
    dr = 2 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    e_zs = check_zoom(zs_mod, c_zs.calls, dr)
    # per peak: the call (both launches), stage 1 (sweep_stage1, float32
    # FMA) and stage 2 (3xTF32 on the tensor cores) alone, and the twin;
    # FLOP: 8 P n W0 W1 in stage 1 and 8 P n m W1 in stage 2 (the twin's
    # products, as torch's flop counter counts them)
    zs = {"call": 0.0, "stage1": 0.0, "stage2": 0.0, "twin": 0.0,
          "stage2_kernel": 0.0}
    zs_bytes = flops1 = flops2 = 0
    for a in c_zs.calls:
        (W0, W1), P = a[0].shape, a[2].shape[0]
        n, m = a[4].shape[0], a[6].shape[0]
        T = zs_mod.stage1(*a[:6])
        t = {"call": cuda_ms(lambda a=a: zs_mod.zoom_sweep(*a), 3),
             "stage1": cuda_ms(lambda a=a: zs_mod.stage1(*a[:6]), 3),
             "stage2": cuda_ms(lambda T=T, a=a: zs_mod.stage2(
                 T, a[6], a[7], None), 3),
             "twin": cuda_ms(lambda a=a: zs_mod.zoom_sweep_plain(*a), 2)}
        z_dev, _ = device_kernels(lambda T=T, a=a: zs_mod.stage2(
            T, a[6], a[7], None), 3)
        del T
        f1, f2 = 8 * P * n * W0 * W1, 8 * P * n * m * W1
        zs["stage2_kernel"] += kernel_ms(z_dev, "zoom_stage2_kernel") or 0.0
        stage2_rate(f"zoom_sweep P={P} W1={W1}", t["stage2"], f2,
                    kernel_ms(z_dev, "zoom_stage2_kernel"))
        s2_fp32, s2_tc = zoom_bounds(0, 0, f2)
        say(f"    zoom_sweep P={P} W0={W0} W1={W1}: call {t['call']!r} ms "
            f"(stage 1 {t['stage1']!r}, stage 2 {t['stage2']!r}), twin "
            f"{t['twin']!r} ms; stage 1 bound {f1 / FP32_FLOP_S * 1e3!r} ms "
            f"(float32 FMA); stage 2 bounds {s2_fp32!r} ms (float32 FMA), "
            f"{s2_tc!r} ms (3xTF32)")
        for k in t:
            zs[k] += t[k]
        zs_bytes += tensor_bytes(a) + 6 * n * m * 4
        flops1 += f1
        flops2 += f2
    b_fp32, b_tc = zoom_bounds(zs_bytes, flops1, flops2)
    stage2_rate("zoom_sweep, three peaks,", zs["stage2"], flops2,
                zs["stage2_kernel"] or None)
    say(f"    zoom_sweep, three peaks: call {zs['call']!r} ms, stage 1 "
        f"{zs['stage1']!r} ms, stage 2 {zs['stage2']!r} ms; bound "
        f"{b_fp32!r} ms in float32 FMA, {b_tc!r} ms with stage 2 in "
        f"3xTF32 (the row's bound; {flops1!r} + {flops2!r} FLOP)")
    rows["zoom_sweep"] = dict(max_abs_err=e_zs, ms=zs["call"],
                              plain_ms=zs["twin"], bound_ms=b_tc,
                              bound_by="operations", library_ms=None)
    # the gradient path's inputs, from one run of each of config 2g's
    # routes: per peak (float32 k-vectors, 10a) and grouped (float64, 10b)
    step32, _ = config2g_step(ks32)
    step64, _ = config2g_step(np.asarray(ks, np.float64))
    with Capture(wfr_mod._zoom, "zoom_sweep") as c_zg:
        step32(img)
        torch.cuda.synchronize()
    with Capture(wfr_mod._sweep, "sweep_grad") as c_sg:
        step64(img)
        torch.cuda.synchronize()
    del step32, step64
    sg = c_sg.calls[0]
    say(f"    captured gradient-path calls: zoom_grad P = "
        f"{[a[2].shape[0] for a in c_zg.calls]}, windows "
        f"{[tuple(a[0].shape) for a in c_zg.calls]}; sweep_grad windows "
        f"{tuple(sg[0].shape)}, G, P = {tuple(sg[4].shape[:2])}, Wb = "
        f"{sg[8].shape[2]}, banded {sg[15]}")
    rows.update(check_zoom_grad(zs_mod, sw_mod, c_zg.calls, c_zg.kws))
    rows.update(check_grouped_emissions(sw_mod, sg))
    del c_zg, c_sg, sg
    # the early-stopping CG on the inputs its paths hand it: phase 5's
    # exact solve (the row), 13d's 2048^2 levels and 4096^2 refinement,
    # a stack of four displaced 512^2 images with their own weights (16b's
    # path), and 12b's first (3, 4086^2) unwrap (refine_ks: the chirp-z
    # passes)
    cu_calls = {"5": c_cu.calls, "13d": config6_unwrap_calls()}
    ks1 = generate_ks(0.1, 7.0)[:3]
    stack = displaced_stack(512, 4)
    with Capture(unwrap_mod._cg, "cg_unwrap", keep=1) as c_st:
        pipeline.extract_displacement_field(stack, ks1)
        torch.cuda.synchronize()
    with Capture(unwrap_mod._cg, "cg_unwrap", keep=1) as c_rk, \
            Capture(fit_mod, "fit_plane_irls") as c_fit:
        gt_gpa.refine_ks(img, np.asarray(ks32))
        torch.cuda.synchronize()
    # the fits again from ks off by 12d's offset: the first round's
    # phases then slope by ~1e-2 rad/px to offsets of many radians
    with Capture(fit_mod, "fit_plane_irls") as c_fit_off:
        gt_gpa.refine_ks(img, np.asarray(ks32) + ITERATE_OFFSET)
        torch.cuda.synchronize()
    cu_calls["16b"], cu_calls["12b"] = c_st.calls, c_rk.calls
    del stack
    say(f"    captured early-stopping CG calls: "
        f"{ {k: [tuple(a[0].shape) + (a[3], a[4]) for a in v] for k, v in cu_calls.items()} }")
    # the route each call must take, apart from ops.cg's gate: chirp-z
    # passes an iteration (4086^2: both axes; the rest powers of two)
    cu_czt = {"5": 0, "13d": 0, "16b": 0, "12b": 4}
    # and the chirp-z passes at every length L = 256 ... 4096 with N =
    # side / 2 odd and even on both axes (seeded aligned problems)
    cu_calls["czt L"] = [dense_cg_call(torch, 1, n, m, 4) + (True,)
                         for n, m in CZT_COVER]
    cu_czt["czt L"] = 4
    e_cu, cu_rows = 0.0, {}
    for label, calls in cu_calls.items():
        e, r = check_cg_unwrap(cg_mod, calls, label, czt=cu_czt[label])
        e_cu = max(e_cu, e)
        cu_rows[label] = r
    rows["cg_unwrap"] = dict(max_abs_err=e_cu, **cu_rows["5"][0])
    # the plane fit on 12b's inputs: refine_ks's three fits of the
    # (3, 4086^2) unwrapped phase stacks, from the true ks (near-flat
    # phases) and from ks + 12d's offset (the row)
    say(f"    captured plane fits (12b): "
        f"{[tuple(a[0].shape) + (a[3],) for a in c_fit.calls]}, from ks "
        f"+ {ITERATE_OFFSET.tolist()}: "
        f"{[tuple(a[0].shape) + (a[3],) for a in c_fit_off.calls]}")
    e_fit, fit_row = check_fit(fit_mod, c_fit_off.calls, "12b, ks + offset")
    e_flat, _ = check_fit(fit_mod, c_fit.calls, "12b")
    rows["fit_plane"] = dict(max_abs_err=max(e_fit, e_flat), **fit_row)
    del c_fit, c_fit_off
    # the DCT kernels on the first transform of each direction in the
    # exact CG's preconditioner (phase 5's residual, through the twins)
    rk5 = cu_calls["5"][0][0]
    y5 = dct_mod.dct_lane_plain(rk5)
    zh5 = dct_mod.dct_sub_plain(y5) / cg_mod.poisson_scale(
        *rk5.shape[-2:], rk5.dtype, rk5.device)
    dct_in = {"dct_lane": rk5, "dct_sub": y5.contiguous(),
              "idct_sub": zh5.contiguous(),
              "idct_lane": dct_mod.idct_sub_plain(zh5).contiguous()}
    del cu_calls, y5, zh5
    e_dct = check_dct(dct_mod, dct_in)
    dct_ms = {name: (cuda_ms(lambda f=getattr(dct_mod, name), x=x: f(x), 10),
                     cuda_ms(lambda f=getattr(dct_mod, name + "_plain"),
                             x=x: f(x), 10))
              for name, x in dct_in.items()}
    dct_bound = {}
    for name, x in dct_in.items():
        dct_bound[name] = bound(2 * tensor_bytes(x),
                                dct_ops(x, -1 if "lane" in name else -2))
        (k_ms, t_ms), (b_ms, b_by) = dct_ms[name], dct_bound[name]
        say(f"    {name} {tuple(x.shape)}: kernel {k_ms!r} ms, twin "
            f"{t_ms!r} ms, bound {b_ms!r} ms ({b_by}), kernel at "
            f"{b_ms / k_ms!r} of the bound")
    for kern, inv in (("dct_lane", "idct_lane"), ("dct_sub", "idct_sub")):
        rows[kern] = dict(max_abs_err=e_dct[kern],
                          ms=(dct_ms[kern][0] + dct_ms[inv][0]) / 2,
                          plain_ms=(dct_ms[kern][1] + dct_ms[inv][1]) / 2,
                          bound_ms=(dct_bound[kern][0]
                                    + dct_bound[inv][0]) / 2,
                          bound_by=dct_bound[kern][1], library_ms=None)
    # the undistortion paths' warps and the unit-cell path's drizzle and
    # expansion, captured from one run of phases 7b, 7a and 8a
    with Capture(warp_mod, "warp_cubic_disp", keep=1) as c_wc:
        pipeline.undistort_image(img_d, u_true)
        torch.cuda.synchronize()
    with Capture(warp_mod, "warp_bilinear", keep=1) as c_wb:
        pipeline.undistort_image(c3[0], c3[2], coarse=4)
        torch.cuda.synchronize()
    img4, ks4 = config4_fixture(torch)
    with Capture(ucell_mod._drizzle, "drizzle", keep=1) as c_dz, \
            Capture(ucell_mod._expand, "expand_cell", keep=1) as c_ex:
        ucell_mod.expand_unitcell(
            ucell_mod.unit_cell_average(img4, ks4, z=2), ks4, (SIZE, SIZE),
            z=2)
        torch.cuda.synchronize()
    # the first Picard step of 7b's inversion (both coefficient planes of
    # u at r + u_it, written in place) and its final 'constant' warp
    wc_calls = [a[:6] for a in (c_wc.calls[0], c_wc.last)]
    e_wc = max(check_cubic_disp(warp_mod, a) for a in wc_calls)
    coef, u_wc = wc_calls[0][:2]
    u_step = u_wc.clone()
    wc_ms = cuda_ms(lambda: warp_mod.warp_cubic_disp(
        coef, u_step, *wc_calls[0][2:6], u_step), 20)
    wc_twin = cuda_ms(lambda: warp_mod.warp_cubic_disp_plain(*wc_calls[0]), 2)
    wc_last = (cuda_ms(lambda: warp_mod.warp_cubic_disp(*wc_calls[1]), 20),
               cuda_ms(lambda: warp_mod.warp_cubic_disp_plain(*wc_calls[1]),
                       2))
    del u_step
    # bytes: the coefficient planes and u read once, u written once;
    # operations: the position, taps and weights once a pixel (24) and 32
    # a plane (16 taps, a multiply and an add each)
    C, h_wc, w_wc = coef.shape[-1], u_wc.shape[1], u_wc.shape[2]
    wc_bound = bound_row(tensor_bytes(coef, u_wc) + 4 * C * h_wc * w_wc,
                         (24 + 32 * C) * h_wc * w_wc)
    say(f"    warp_cubic_disp per Picard step ({C} planes {tuple(coef.shape)}"
        f" at {h_wc}x{w_wc}, in place): kernel {wc_ms!r} ms, twin "
        f"{wc_twin!r} ms, bound {wc_bound['bound_ms']!r} ms "
        f"({wc_bound['bound_by']}); final 'constant' warp (kernel, twin) "
        f"{wc_last!r} ms")
    # the coordinate form on the same step's positions, one plane
    wc_coords = cubic_coords(wc_calls[0])
    e_wc = max(e_wc, check_warp(warp_mod, "warp_cubic", wc_coords))
    say(f"    warp_cubic coordinate form, one plane of that step: kernel "
        f"{cuda_ms(lambda: warp_mod.warp_cubic(*wc_coords), 20)!r} ms "
        "(the displacement form takes both planes in one launch)")
    del wc_coords
    rows["warp_cubic"] = dict(max_abs_err=e_wc, ms=wc_ms, plain_ms=wc_twin,
                              **wc_bound)
    # the first bilinear call of 7a's coarse inversion: both planes of u
    # at the 512^2 grid's positions, one launch
    wb = c_wb.calls[0]
    wb_out = warp_mod.warp_bilinear_plain(*wb)
    rows["warp_bilinear"] = dict(
        max_abs_err=check_warp(warp_mod, "warp_bilinear", wb),
        ms=cuda_ms(lambda: warp_mod.warp_bilinear(*wb), 20),
        plain_ms=cuda_ms(lambda: warp_mod.warp_bilinear_plain(*wb), 5),
        **bound_row(tensor_bytes(wb[:3], wb_out), 12 * wb_out.numel()))
    wb_dev = device_ms(lambda: warp_mod.warp_bilinear(*wb), 20)
    lib = bilinear_library(wb)
    if lib is not None:
        e = rel_err(lib().reshape(wb_out.shape), warp_mod.warp_bilinear(*wb))
        say(f"    warp_bilinear vs library F.grid_sample: max |delta| / max "
            f"|kernel| {e!r} (bound {LIBRARY_BOUND})")
        if not e <= LIBRARY_BOUND:
            raise RuntimeError("F.grid_sample computes another function "
                               "than the bilinear warp kernel")
        rows["warp_bilinear"]["library_ms"] = cuda_ms(lib, 20)
        lib_dev = device_ms(lib, 20)
        say(f"    warp_bilinear {tuple(wb[0].shape)} at {tuple(wb[1].shape)} "
            f"positions: per call (CUDA events over 20 calls) kernel "
            f"{rows['warp_bilinear']['ms']!r} ms, F.grid_sample "
            f"{rows['warp_bilinear']['library_ms']!r} ms; device time "
            f"(torch.profiler kernel records) kernel {wb_dev!r} ms, "
            f"F.grid_sample {lib_dev!r} ms")
    dz, ex = c_dz.calls[0], c_ex.calls[0]
    dz_out = drizzle_mod.drizzle(*dz)
    rows["drizzle"] = dict(
        max_abs_err=check_drizzle(drizzle_mod, dz),
        ms=cuda_ms(lambda: drizzle_mod.drizzle(*dz), 10),
        plain_ms=cuda_ms(lambda: drizzle_mod.drizzle_plain(*dz), 3),
        **bound_row(tensor_bytes(dz, dz_out), 40 * dz[0].numel()))
    with drizzle_global_route():
        dz_glob = cuda_ms(lambda: drizzle_mod.drizzle(*dz), 10)
    say(f"    drizzle {tuple(dz[0].shape)} -> {tuple(dz_out[0].shape)}: call "
        f"on the shared-memory route {rows['drizzle']['ms']!r} ms, on the "
        f"global-atomic route {dz_glob!r} ms; the max|v| pass both run "
        f"{absmax_ms(dz[0])!r} ms alone; bound "
        f"{rows['drizzle']['bound_ms']!r} ms")
    # the expand call (the cell's prefilter in torch, then the kernel):
    # the kernel's device time apart from the call's CUDA-event time
    ex_out = expand_mod.expand_cell_plain(*ex)
    e_ex = check_expand(expand_mod, ex)
    ex_call = cuda_ms(lambda: expand_mod.expand_cell(*ex), 10)
    ex_by, ex_n = device_kernels(lambda: expand_mod.expand_cell(*ex), 10)
    with expand_l1_route():
        l1_by, _ = device_kernels(lambda: expand_mod.expand_cell(*ex), 10)
    ex_k = kernel_ms(ex_by, "expand_kernel")
    ex_dev = device_ms(lambda: expand_mod.expand_cell(*ex), 10)
    rows["expand"] = dict(
        max_abs_err=e_ex, ms=ex_call if ex_k is None else ex_k,
        plain_ms=cuda_ms(lambda: expand_mod.expand_cell_plain(*ex), 3),
        **bound_row(tensor_bytes(ex, ex_out), 56 * ex_out.numel()))
    say(f"    expand {tuple(ex[0].shape)} -> {tuple(ex_out.shape)}: kernel "
        f"device {ex_k!r} ms on the shared route, "
        f"{kernel_ms(l1_by, 'expand_kernel')!r} ms on the L1 route "
        f"(torch.profiler over 10 calls); the call {ex_call!r} ms (CUDA "
        f"events over 10 calls), device {ex_dev!r} ms, {ex_n} launches a "
        f"call (the kernel and the prefilter's "
        f"torch kernels); bound {rows['expand']['bound_ms']!r} ms "
        f"(the row's ms is the kernel's device time)")
    say(f"      device ms per kernel over the call: {json.dumps(ex_by)}")
    # the captured operands would count in phase 4's peak memory
    del c_sw, c_ps, c_aq, c_aq7, c_cg, sw_args, ps_args, aq_args, rk0, outs
    del c_zs, c_cu, c_st, c_rk, rk5, dct_in, x
    del c_wc, wc_calls, coef, u_wc, c_wb, wb, wb_out, c_dz, dz, dz_out, c_ex
    del ex, ex_out, a
    for name, r in rows.items():
        say(f"    {name}: kernel {r['ms']!r} ms, twin {r['plain_ms']!r} ms, "
            f"bound {r['bound_ms']!r} ms ({r['bound_by']}), library "
            f"{r['library_ms']!r} ms")
    # the timed phases start from the allocator's state without phase
    # 3's cached blocks
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say(f"    device memory after phase 3: allocated "
        f"{torch.cuda.memory_allocated() / 2**30!r} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2**30!r} GiB; card (SM clock, "
        f"temperature, power draw) {card_state()}")

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
    say(f"    deformed gate margin: {GATE_DEFORMED - u_err_def!r} px below "
        f"{GATE_DEFORMED}")
    if not (u_err < GATE_INTERIOR and u_err_dc < GATE_DCFREE
            and u_err_def < GATE_DEFORMED):
        raise RuntimeError("ACCURACY GATE FAILED")
    # the path against the path with a float64 grouped sweep, and the
    # path with the sweep's float32 twin against it: the other kernels
    # run as built in all three, since the multigrid's CG kernel and its
    # twin differ by itself (phase 3: 3e-6 to 1.5e-5 relative); the path
    # on all the plain versions is printed beside them
    with plain_versions():
        up = fn(img)
    with float64_sweep():
        u64 = fn(img)
    with float32_sweep():
        u32 = fn(img)
    k99, kmax = interior_dist(u, u64, ks)
    t99, tmax = interior_dist(u32, u64, ks)
    a99, amax = interior_dist(up, u64, ks)
    say(f"    vs the path with a float64 sweep: with kernels p99 {k99!r} max "
        f"{kmax!r} px, with the sweep's float32 twin p99 {t99!r} max "
        f"{tmax!r} px, on all plain versions p99 {a99!r} max {amax!r} px "
        f"(bounds: p99 < {SWEEP_PATH_F64}, max < 1e-2; the kernels' path "
        f"lies {'nearer' if k99 <= t99 else 'further'} than the float32 "
        "twin's)")
    del up, u64, u32
    if not (k99 < SWEEP_PATH_F64 and kmax < 1e-2):
        raise RuntimeError("bench extractor: kernels change the result")
    say(f"    seconds_per_image {dt!r}, Mpix/s {SIZE * SIZE / 1e6 / dt!r} "
        f"({REPS} runs after warm-up, host clock, synchronized)")
    say(f"    stage ms (CUDA events): {json.dumps(stages)}")
    say(f"    peak device memory {peak / 2**30!r} GiB")

    # ---- 5. the README's eager path
    say(f"    card before phase 5: {card_state()}")
    path_launches = {4: launches}
    path_launches[5] = drive_path(
        5, "extract_displacement_field(img, ks)",
        lambda im, events=None: pipeline.extract_displacement_field(
            im, ks32, events=events),
        lambda im, events=None: pipeline.extract_displacement_field(
            im, ks32, deconvolve=True, events=events),
        img, img_d, u_true, ks32, float64_zoom, ZOOM_PATH_F64)
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
        img, img_d, u_true, ks32, float64_sweep, SWEEP_PATH_F64)

    # ---- 7. the README's undistortion: (a) config 3, (b) the default call
    from pygpa_tpu_torch.solvers.unwrap import phase_unwrap_mg
    img3, clean3, u3, psi3, w3 = c3

    def gates_7a(outs):
        phi, rec = outs
        dphi = (phi - psi3).flatten()
        dphi = (dphi - dphi.mean()).abs()
        v = {"unwrap_plane_err_p99_rad": float(torch.quantile(
                 dphi, torch.tensor(0.99, device=dphi.device))),
             "unwrap_plane_err_max_rad": float(dphi.max()),
             "undistort_rel_rms": rel_rms(rec, clean3, 32),
             "gated": f"p99<{GATE_UNWRAP_P99}, max<{GATE_UNWRAP_MAX}, "
                      f"rel_rms<{GATE_UNDISTORT}"}
        return v, (v["unwrap_plane_err_p99_rad"] < GATE_UNWRAP_P99
                   and v["unwrap_plane_err_max_rad"] < GATE_UNWRAP_MAX
                   and v["undistort_rel_rms"] < GATE_UNDISTORT)

    path_launches["7a"] = run_path(
        "7a", "config 3: phase_unwrap_mg(psi, |img|) + "
        "undistort_image(img, u, coarse=4), 2048^2",
        lambda: (phase_unwrap_mg(psi3, w3),
                 pipeline.undistort_image(img3, u3, coarse=4)),
        gates_7a)
    # 17 Picard steps and 2 Newton steps on both planes of u, one
    # Jacobian of four gradient planes: one bilinear launch each
    if path_launches["7a"].get("warp_bilinear") != 20:
        raise RuntimeError("config 3 should launch the bilinear warp 20 "
                           f"times: {path_launches['7a']}")

    def gates_7b(outs):
        v = {"undistort_rel_rms": rel_rms(outs[0], img, 128),
             "gated": f"rel_rms<{GATE_UNDISTORT}"}
        return v, v["undistort_rel_rms"] < GATE_UNDISTORT

    path_launches["7b"] = run_path(
        "7b", "undistort_image(img_d, u_true) defaults, 4096^2",
        lambda: (pipeline.undistort_image(img_d, u_true),), gates_7b)
    # 36 Picard steps (both planes of u, in place) and the final warp
    if path_launches["7b"].get("warp_cubic") != 37:
        raise RuntimeError("the default undistortion should launch the "
                           f"cubic warp 37 times: {path_launches['7b']}")

    # ---- 8. the README's unit cell: (a) config 4, (b) with u
    avg4 = ucell_mod.unit_cell_average(None, ks4, z=2,
                                       only_generate_func=True)

    def step_8a():
        cell = avg4(img4)
        return cell, ucell_mod.expand_unitcell(cell, ks4, (SIZE, SIZE), z=2)

    def step_8b():
        cell = ucell_mod.unit_cell_average(img_d, ks[:2], u=u_true, z=2)
        return cell, ucell_mod.expand_unitcell(cell, ks[:2], (SIZE, SIZE),
                                               z=2, u=u_true)

    for label, title, step, want in (
            ("8a", "config 4: unit_cell_average + expand_unitcell, z=2, "
             "4096^2", step_8a, img4),
            ("8b", "unit_cell_average(img_d, ks[:2], u=u_true, z=2) + "
             "expand_unitcell(..., u=u_true), 4096^2", step_8b, img_d)):
        def gates_8(outs, want=want):
            v = {"ucell_roundtrip_rel_rms": rel_rms(outs[1], want, 128),
                 "cell_shape": list(outs[0].shape),
                 "gated": f"rel_rms<{GATE_UCELL}"}
            return v, v["ucell_roundtrip_rel_rms"] < GATE_UCELL
        path_launches[label] = run_path(label, title, step, gates_8)

    # ---- 9. short runs at shapes the bench does not use: config 1's
    # lattice at 2048^2 (the grouped sweep at Wb = 448) and at 500^2 with
    # the multigrid (the V-branch on its twins)
    for label, size, kw in (("9a", 2048, {}), ("9b", 500,
                                                {"unwrap_coarse": 4})):
        drive_short(label, size, kw)

    # ---- 10. config 2g, the property maps from the winner gradients:
    # (a) float32 k-vectors (per-peak zoom sweeps), (b) float64 (grouped)
    path_launches["10a"] = drive_2g(
        "10a", "config 2g, float32 k-vectors: per-peak zoom sweeps",
        KS_BENCH_F32, img)
    path_launches["10b"] = drive_2g(
        "10b", "config 2g, float64 k-vectors: one grouped sweep",
        np.asarray(ks, np.float64), img)

    # ---- 11. the eager path with gradients, the demodulated factory
    path_launches["11a"] = drive_eager_grad(img, img_d, u_true, ks32)
    path_launches["11b"] = drive_demod(img, img_d, u_true, ks32)

    # ---- 12. the README quick start from the raw image
    say(f"    card before phase 12: {card_state()}")
    t12 = time.perf_counter()
    refined, path_launches["12b"] = drive_peaks(img, ks)
    drive_refined_u(img, ks32, refined)
    drive_lockin(img, ks)
    path_launches["12e"] = drive_vv(img, ks)
    say(f"    phase 12 took {time.perf_counter() - t12!r} s")

    # ---- 13. benchmarks/run_all.py configs 1, 2, 5 and 6
    say(f"    card before phase 13: {card_state()}")
    t13 = time.perf_counter()
    path_launches["13a"] = drive_short("13a", 512, {"unwrap_coarse": 4},
                                       title="config 1", kernels=True)
    path_launches["13b"] = drive_short("13b", 1024, {"unwrap_coarse": 4},
                                       r_k=0.015, theta=3.0, gate=0.6,
                                       mult=2, title="config 2",
                                       kernels=True)
    path_launches["13c"] = drive_config5()
    path_launches["13d"] = drive_config6()
    say(f"    phase 13 took {time.perf_counter() - t13!r} s")

    # ---- 14. config 5f and the Kerelsky fits, wfr4, WFF
    t14 = time.perf_counter()
    drive_5f()
    drive_kerelsky_fits()
    drive_wfr4(img, ks)
    drive_wff(img)
    say(f"    phase 14 took {time.perf_counter() - t14!r} s")

    # ---- 15. the batch axis: config 1b, config 5 as one call, a mosaic
    say(f"    card before phase 15: {card_state()}")
    t15 = time.perf_counter()
    path_launches["15a"], rows_1b = drive_1b()
    path_launches["15b"], extract5, ks5 = drive_config5_batched()
    _, tiles16 = drive_mosaic(extract5, ks5)
    del extract5
    say(f"    phase 15 took {time.perf_counter() - t15!r} s")

    # ---- 16. one launch per stage for a stack on the eager path and on
    # both gradient emissions; the utilities' device calls
    say(f"    card before phase 16: {card_state()}")
    t16 = time.perf_counter()
    path_launches["16a"], row_z = drive_eager_stack()
    drive_eager_chunks(tiles16, ks5)
    path_launches["16b"] = drive_eager_1b()
    launches_c, rows_16 = drive_grad_stack(img, img_d)
    path_launches.update(launches_c)
    rows_16["zoom_sweep_stack"] = row_z
    drive_utilities(img, ks32, tiles16)
    del tiles16
    say(f"    phase 16 took {time.perf_counter() - t16!r} s")

    # ---- 17. the multi-device API on a world of one
    say(f"    card before phase 17: {card_state()}")
    t17 = time.perf_counter()
    launches_17, rows_17 = drive_sharded(img, img_d, u_true, ks)
    path_launches.update(launches_17)
    say(f"    phase 17 took {time.perf_counter() - t17!r} s")

    kernels = []
    for name, (src, rep) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep,
                        "launches": path_launches[PATH_OF[name]][name],
                        **rows[name]})
    # the batched kernels at config 1b's stack (launches: 15a's run)
    for name, r in rows_1b.items():
        src, rep = KERNELS[BATCH_ROWS[name]]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, **r})
    # the stack rows of phase 16 (launches: the stack's counted run)
    for name in STACK_ROWS:
        src, rep = KERNELS[STACK_ROWS[name]]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, **rows_16[name]})
    # the zoom kernel on 17a's row blocks, the DCT kernels on 17b's
    # pencil passes (launches: the counted runs)
    for name, base in (("zoom_sweep_sharded", "zoom_sweep"),
                       ("dct_lane_sharded", "dct_lane"),
                       ("dct_sub_sharded", "dct_sub")):
        src, rep = KERNELS[base]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, **rows_17[name]})
    say(card_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
