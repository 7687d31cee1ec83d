"""Single-peak zoom WFR sweep: every candidate's full-resolution lock-in
from the spectrum window, the per-pixel argmax of |M|^2 and, optionally,
the winner's phase and rim-masked weight.

Replaces the TPU kernel ``pygpa_tpu/ops/pallas_sweep.py`` ``_kernel``
(reached through ``fused_zoom_sweep_chunk`` and ``fused_zoom_sweep``);
here ops.wfr's per-peak route (``_wfr_sweep_zoom``,
``_wfr_sweep_zoom_pw``) calls it. For candidate i with Gaussian factors gx_i (W0), gy_i (W1):

    M_i = A0 (gx_i . S . gy_i) A1^T,   A0 = A0c + i A0s, A1 = A1c + i A1s

and the tournament keeps, per pixel, the first candidate of largest
|M_i|^2 (strict '>' from a zero start, candidates in order). One
launch covers all P candidates; the reference's 48-candidate chunks,
bf16 screen and HIGH->HIGHEST clamp were TPU devices, and this is the
same strict chunk merge in a single pass, in float32.

CUDA route, two launches on the current stream: stage 1 is the grouped
sweep's ``sweep_stage1`` (``csrc/sweep.cu``, float32 FMA) with one group
and one band run, into a (P, n, 2 W1) float32 scratch T; stage 2 is
``csrc/zoom_sweep.cu`` on the tensor cores in 3xTF32 (each float32
product as lo.hi + hi.lo + hi.hi of TF32 halves; one float32
tensor-core chain per 32 columns of W1, since the tensor cores truncate
their adds, and the chains' sums added in float32 registers with
rounding to nearest), with T and the column basis streamed through a
cp.async ring and the tournament in registers. The eager path on it
lies nearer the same path with a float64 zoom sweep than the path on
the float32 twin does (chip_smoke.py, phase 5). Shape limits: n, m and
W1 multiples of 64, W0 a multiple of 16. Bound on an H100 by stage 2's
P*n*m*8*W1 FLOP, three times over, at the dense TF32 rate (about 26 ms
for the three 4096^2 bench peaks; 65 ms in float32 FMA, the kernel this
one replaced). Launch count: "zoom_sweep".

The plain twin :func:`zoom_sweep_plain` is the reference's einsum and
where-tournament (``_wfr_sweep_zoom``'s scan body), chunked over the
candidates; a CPU tensor runs it, a CUDA tensor the kernels.
"""
import torch

from . import _build
from . import sweep as _sweep
from .sweep import TILE, rim_weights


def zoom_sweep_plain(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, dr=None,
                     chunk=8):
    """Plain PyTorch twin (same arguments as :func:`zoom_sweep`; `chunk`
    candidates are evaluated per batched product)."""
    P = gx.shape[0]
    n, m = A0c.shape[0], A1c.shape[0]
    rdt, dev = Sr.dtype, Sr.device
    ba = torch.zeros((n, m), dtype=rdt, device=dev)
    br = torch.zeros_like(ba)
    bi = torch.zeros_like(ba)
    bx = torch.zeros((n, m), dtype=torch.int32, device=dev)
    for s in range(0, P, chunk):
        g0 = gx[s:s + chunk, :, None]
        g1 = gy[s:s + chunk, None, :]
        Swr = g0 * Sr[None] * g1
        Swi = g0 * Si[None] * g1
        Tr = A0c @ Swr - A0s @ Swi                 # (C, n, W1)
        Ti = A0c @ Swi + A0s @ Swr
        Mr = Tr @ A1c.T - Ti @ A1s.T               # (C, n, m)
        Mi = Tr @ A1s.T + Ti @ A1c.T
        absq = Mr * Mr + Mi * Mi
        for i in range(absq.shape[0]):
            better = absq[i] > ba
            ba = torch.where(better, absq[i], ba)
            br = torch.where(better, Mr[i], br)
            bi = torch.where(better, Mi[i], bi)
            bx = torch.where(better, s + i, bx)
    out = (ba, br, bi, bx)
    if dr is not None:
        out += (torch.atan2(bi, br), torch.sqrt(torch.clamp(ba, min=0.0))
                * rim_weights(n, m, int(dr), rdt, dev))
    return out


def _check(Sr, Si, gx, gy, A0c, A0s, A1c, A1s):
    """Raise unless the operands are what the two launches take."""
    W0, W1 = Sr.shape
    P = gx.shape[0]
    n, m = A0c.shape[0], A1c.shape[0]
    f32, dev = torch.float32, Sr.device
    for name, t, shape in (
            ("Sr", Sr, (W0, W1)), ("Si", Si, (W0, W1)), ("gx", gx, (P, W0)),
            ("gy", gy, (P, W1)), ("A0c", A0c, (n, W0)), ("A0s", A0s, (n, W0)),
            ("A1c", A1c, (m, W1)), ("A1s", A1s, (m, W1))):
        _build.check_tensor("zoom_sweep", name, t, shape, f32, dev)
    if n % TILE or m % TILE or W0 % 16 or W1 % TILE or P < 1:
        raise ValueError(
            f"zoom_sweep kernel needs n, m, W1 multiples of {TILE}, W0 a "
            f"multiple of 16 and P >= 1 (got n={n}, m={m}, W0={W0}, "
            f"W1={W1}, P={P})")


def stage1(Sr, Si, gx, gy, A0c, A0s):
    """Stage 1 on the card (checked operands): T (P, n, 2 W1), the rows
    [Re | Im] of ((A0c + i A0s) . gx_i) @ (Sr + i Si) . gy_i: the grouped
    sweep's stage 1 with one group and one band run."""
    run = torch.zeros((1, gx.shape[0]), dtype=torch.int32, device=Sr.device)
    return _sweep.stage1(Sr[None, None], Si[None, None], gx[None], gy[None],
                         A0c[None], A0s[None], run)[0]


def stage2(T, A1c, A1s, dr):
    """Stage 2 and the tournament on the card (checked operands): the
    outputs of :func:`zoom_sweep` from stage 1's T."""
    P, n, W1 = T.shape[0], T.shape[1], T.shape[2] // 2
    m, dev = A1c.shape[0], T.device
    ba = torch.empty((n, m), dtype=torch.float32, device=dev)
    br = torch.empty_like(ba)
    bi = torch.empty_like(ba)
    bx = torch.empty((n, m), dtype=torch.int32, device=dev)
    emit = dr is not None
    ph = torch.empty_like(ba) if emit else ba
    wt = torch.empty_like(ba) if emit else ba
    with torch.cuda.device(dev):
        _build.check(_build.bind("zoom_sweep_stage2", "pppppppppiiiiip")(
            T.data_ptr(), A1c.data_ptr(), A1s.data_ptr(), ba.data_ptr(),
            br.data_ptr(), bi.data_ptr(), bx.data_ptr(), ph.data_ptr(),
            wt.data_ptr(), P, n, m, W1, int(dr) if emit else -1,
            torch.cuda.current_stream(dev).cuda_stream), "zoom_sweep_stage2")
    out = (ba, br, bi, bx)
    return out + (ph, wt) if emit else out


def zoom_sweep(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, dr=None):
    """Zoom sweep of one Bragg peak -> (best_absq, best_r, best_i,
    best_idx) planes (n, m) [+ (phase, weight) when dr is given].

    Sr, Si : (W0, W1) spectrum window, pre-scaled by 1/(n*m).
    gx, gy : (P, W0), (P, W1) per-candidate Gaussian factors.
    A0c, A0s : (n, W0) row inverse-DFT basis; A1c, A1s : (m, W1) column
        basis.
    dr : border of the interior weight mask (emission off when None).
    best_idx is int32; a pixel whose |M|^2 is 0 for every candidate
    keeps index 0 and M = 0."""
    if Sr.device.type == "cpu":
        return zoom_sweep_plain(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, dr)
    if Sr.device.type != "cuda":
        raise ValueError(f"zoom_sweep: unsupported device {Sr.device}")
    _check(Sr, Si, gx, gy, A0c, A0s, A1c, A1s)
    out = stage2(stage1(Sr, Si, gx, gy, A0c, A0s), A1c, A1s, dr)
    _build.launches["zoom_sweep"] += 1
    return out
