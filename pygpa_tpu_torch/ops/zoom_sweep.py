"""Single-peak zoom WFR sweep: every candidate's full-resolution lock-in
from the spectrum window, the per-pixel argmax of |M|^2 and, optionally,
the winner's phase and rim-masked weight and the winner's phase
gradients.

Replaces the TPU kernel ``pygpa_tpu/ops/pallas_sweep.py`` ``_kernel``
(reached through ``fused_zoom_sweep_chunk`` and ``fused_zoom_sweep``,
with and without ``grad_ops``); here ops.wfr's per-peak route
(``_wfr_sweep_zoom``, ``_wfr_sweep_zoom_pw``) calls it. For candidate i
with Gaussian factors gx_i (W0), gy_i (W1):

    M_i = A0 (gx_i . S . gy_i) A1^T,   A0 = A0c + i A0s, A1 = A1c + i A1s

and the tournament keeps, per pixel, the first candidate of largest
|M_i|^2 (strict '>' from a zero start, candidates in order). One
launch covers all P candidates; the reference's 48-candidate chunks,
bf16 screen and HIGH->HIGHEST clamp were TPU devices, and this is the
same strict chunk merge in a single pass, in float32.

The gradient emission (``grad_ops = (S2r, S2i, A1yc, A1ys)``, the
row-derivative window S2 = (2 pi i f0) S and the column-derivative
basis A1y = (2 pi i f1) A1) adds the winner's derivatives of -angle(M)
along rows and columns, gx = (Im M Re Mx - Re M Im Mx) / |M|^2 with Mx
= A0 (gx_i . S2 . gy_i) A1^T, and gy alike with My = A0 (gx_i . S .
gy_i) A1y^T: exact derivatives of the band-limited interpolant.

CUDA route, three launches on the current stream: stage 1 is the
grouped sweep's ``sweep_stage1`` (``csrc/sweep.cu``, float32 FMA) with
one group and one band run, into a (P, n, 2 W1) float32 scratch T; the
grouped sweep's ``split_basis`` splits the column basis into its TF32
hi and lo planes; stage 2 is ``csrc/zoom_sweep.cu`` on Hopper's
tensor-core path in 3xTF32 (warpgroup ``wgmma`` fed by a TMA ring over
T and the split basis, loaded two stages ahead; each float32 product
as lo.hi + hi.lo + hi.hi of TF32 halves; one float32 tensor-core chain
per 32 columns of W1, since the tensor cores truncate their adds, and
the chains' sums added in float32 registers with rounding to nearest),
with the tournament in registers. The gradient emission
runs the same launches (its tournament, phase and weight are the
plain launch's bits) and then the grouped sweep's gradient steps
(``ops.sweep.winner_grads``): the band flags, stage 1 on S2 for the
(64-row band, candidate) pairs that win a pixel of the band (Tx), and
the winner products, Mx and My for just the candidates that win a
pixel of each tile, in the zoom sweep's chain rounding. The eager path
on it lies nearer the same path with a float64 zoom sweep than the
path on the float32 twin does (chip_smoke.py, phase 5). Shape limits:
n, m and W1 multiples of 64, W0 a multiple of 16. A stack of B
windows (B, W0, W1) of one plan (the eager path's batch axis) runs in
the launches of one window, the image on stage 1's and stage 2's grid z
and beside the group in the gradient steps, each image's outputs (B, n,
m) the bits of its own launch; stacks past CUDA's gridDim.z (65535) go
in launches of whole images. Bound on an H100 by
stage 2's P*n*m*8*W1 FLOP, three times over, at the dense TF32 rate
(about 26 ms for the three 4096^2 bench peaks; 65 ms in float32 FMA,
the kernel this one replaced). Launch counts: "zoom_sweep", "zoom_grad"
(with gradients, one per call, beside the steps' "grad_flags",
"grad_stage1" and "grad_products").

The plain twin :func:`zoom_sweep_plain` is the reference's einsum and
where-tournament (``_wfr_sweep_zoom``'s scan body), chunked over the
candidates, with the analytic gradients of ``fused_zoom_sweep``'s
``grad_ops``; a CPU tensor runs it, a CUDA tensor the kernels. Its
``fd_grad`` form is the reference's other route (float64 and sides off
the kernel's gate): np.gradient of each candidate's -angle(M).
"""
import torch

from . import _build
from . import sweep as _sweep
from .sweep import TILE, np_gradient_2d, rim_weights, winner_gradients


def zoom_sweep_plain(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, dr=None, chunk=8,
                     grad_ops=None, fd_grad=False):
    """Plain PyTorch twin (same arguments as :func:`zoom_sweep`; `chunk`
    candidates are evaluated per batched product). fd_grad=True adds the
    winner's np.gradient of -angle(M) (the reference's XLA route)
    instead of the analytic grad_ops gradients. A stack of windows
    (B, W0, W1) runs image by image."""
    if Sr.dim() == 3:
        outs = [zoom_sweep_plain(
            Sr[b], Si[b], gx, gy, A0c, A0s, A1c, A1s, dr, chunk,
            None if grad_ops is None else (grad_ops[0][b], grad_ops[1][b],
                                           *grad_ops[2:]), fd_grad)
            for b in range(Sr.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    P = gx.shape[0]
    n, m = A0c.shape[0], A1c.shape[0]
    rdt, dev = Sr.dtype, Sr.device
    grad = grad_ops is not None or fd_grad
    ba = torch.zeros((n, m), dtype=rdt, device=dev)
    br = torch.zeros_like(ba)
    bi = torch.zeros_like(ba)
    bx = torch.zeros((n, m), dtype=torch.int32, device=dev)
    bgx = torch.zeros_like(ba)
    bgy = torch.zeros_like(ba)

    def stage1(xr, xi, g0, g1):
        Swr = g0 * xr[None] * g1
        Swi = g0 * xi[None] * g1
        return A0c @ Swr - A0s @ Swi, A0c @ Swi + A0s @ Swr   # (C, n, W1)

    for s in range(0, P, chunk):
        g0 = gx[s:s + chunk, :, None]
        g1 = gy[s:s + chunk, None, :]
        Tr, Ti = stage1(Sr, Si, g0, g1)
        Mr = Tr @ A1c.T - Ti @ A1s.T               # (C, n, m)
        Mi = Tr @ A1s.T + Ti @ A1c.T
        absq = Mr * Mr + Mi * Mi
        if fd_grad:
            ggx, ggy = np_gradient_2d(-torch.atan2(Mi, Mr))
        elif grad_ops is not None:
            S2r, S2i, A1yc, A1ys = grad_ops
            Txr, Txi = stage1(S2r, S2i, g0, g1)
            ggx = winner_gradients(Mr, Mi, Txr @ A1c.T - Txi @ A1s.T,
                                   Txr @ A1s.T + Txi @ A1c.T)
            ggy = winner_gradients(Mr, Mi, Tr @ A1yc.T - Ti @ A1ys.T,
                                   Tr @ A1ys.T + Ti @ A1yc.T)
        for i in range(absq.shape[0]):
            better = absq[i] > ba
            ba = torch.where(better, absq[i], ba)
            br = torch.where(better, Mr[i], br)
            bi = torch.where(better, Mi[i], bi)
            bx = torch.where(better, s + i, bx)
            if grad:
                bgx = torch.where(better, ggx[i], bgx)
                bgy = torch.where(better, ggy[i], bgy)
    out = (ba, br, bi, bx)
    if grad:
        out += (bgx, bgy)
    if dr is not None:
        out += (torch.atan2(bi, br), torch.sqrt(torch.clamp(ba, min=0.0))
                * rim_weights(n, m, int(dr), rdt, dev))
    return out


def _check(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, grad_ops=None):
    """Raise unless the operands are what the launches take (one window
    (W0, W1) or a stack (B, W0, W1))."""
    if Sr.dim() not in (2, 3):
        raise ValueError("zoom_sweep: the window must be (W0, W1) or (B, W0, "
                         f"W1), got {tuple(Sr.shape)}")
    win = tuple(Sr.shape)
    W0, W1 = win[-2:]
    P = gx.shape[0]
    n, m = A0c.shape[0], A1c.shape[0]
    f32, dev = torch.float32, Sr.device
    named = [("Sr", Sr, win), ("Si", Si, win), ("gx", gx, (P, W0)),
             ("gy", gy, (P, W1)), ("A0c", A0c, (n, W0)),
             ("A0s", A0s, (n, W0)), ("A1c", A1c, (m, W1)),
             ("A1s", A1s, (m, W1))]
    if grad_ops is not None:
        named += list(zip(("S2r", "S2i", "A1yc", "A1ys"), grad_ops,
                          (win, win, (m, W1), (m, W1))))
    for name, t, shape in named:
        _build.check_tensor("zoom_sweep", name, t, shape, f32, dev)
    if n % TILE or m % TILE or W0 % 16 or W1 % TILE or P < 1:
        raise ValueError(
            f"zoom_sweep kernel needs n, m, W1 multiples of {TILE}, W0 a "
            f"multiple of 16 and P >= 1 (got n={n}, m={m}, W0={W0}, "
            f"W1={W1}, P={P})")
    _sweep._grid_z_ok("zoom_sweep", 1, P)


def _groups(X):
    """A window (W0, W1) or a stack (B, W0, W1) as the grouped sweep's
    windows of one group and one band run: (1, 1, W0, W1) or (B, 1, 1,
    W0, W1)."""
    return X.unsqueeze(-3).unsqueeze(-4)


def stage1(Sr, Si, gx, gy, A0c, A0s):
    """Stage 1 on the card (checked operands): T (P, n, 2 W1), the rows
    [Re | Im] of ((A0c + i A0s) . gx_i) @ (Sr + i Si) . gy_i: the grouped
    sweep's stage 1 with one group and one band run; a stack of windows
    (B, W0, W1) gives (B, P, n, 2 W1) from one launch."""
    run = torch.zeros((1, gx.shape[0]), dtype=torch.int32, device=Sr.device)
    return _sweep.stage1(_groups(Sr), _groups(Si), gx[None], gy[None],
                         A0c[None], A0s[None], run).squeeze(-4)


def stage2(T, A1c, A1s, dr):
    """Stage 2 and the tournament on the card (checked operands): the
    outputs of :func:`zoom_sweep` without gradients, from stage 1's T
    (P, n, 2 W1), or (B, P, n, 2 W1) for a stack, giving (B, n, m)
    planes from one launch."""
    lead = tuple(T.shape[:-3])
    B = T.shape[0] if lead else 1
    P, n, W1 = T.shape[-3], T.shape[-2], T.shape[-1] // 2
    m, dev = A1c.shape[0], T.device
    ba = torch.empty(lead + (n, m), dtype=torch.float32, device=dev)
    br = torch.empty_like(ba)
    bi = torch.empty_like(ba)
    bx = torch.empty(ba.shape, dtype=torch.int32, device=dev)
    emit = dr is not None
    ph = torch.empty_like(ba) if emit else ba
    wt = torch.empty_like(ba) if emit else ba
    Bs = _sweep.split_basis(A1c[None], A1s[None])
    with torch.cuda.device(dev):
        _build.check(_build.bind("zoom_sweep_stage2", "ppppppppiiiiiip")(
            T.data_ptr(), Bs.data_ptr(), ba.data_ptr(), br.data_ptr(),
            bi.data_ptr(), bx.data_ptr(), ph.data_ptr(), wt.data_ptr(), B, P,
            n, m, W1, int(dr) if emit else -1,
            torch.cuda.current_stream(dev).cuda_stream), "zoom_sweep_stage2")
    out = (ba, br, bi, bx)
    return out + (ph, wt) if emit else out


def winner_grads(T, out, gx, gy, A0c, A0s, A1c, A1s, grad_ops):
    """The gradient emission's steps after the tournament (its outputs
    `out`, T its stage 1): the grouped sweep's band flags, stage 1 of
    the row-derivative window on the flagged pairs and winner products
    (:func:`pygpa_tpu_torch.ops.sweep.winner_grads`) as one group with
    one band run, in the zoom sweep's tensor-core chain rounding:
    (grad_x, grad_y) (n, m), or (B, n, m) for a stack (T (B, P, n,
    2 W1), the windows of grad_ops (B, W0, W1))."""
    S2r, S2i, A1yc, A1ys = grad_ops
    run = torch.zeros((1, gx.shape[0]), dtype=torch.int32, device=T.device)
    gxo, gyo = _sweep.winner_grads(
        T.unsqueeze(-4), _groups(S2r), _groups(S2i), gx[None], gy[None],
        A0c[None], A0s[None], run, A1c[None], A1s[None], A1yc[None],
        A1ys[None], out[1].unsqueeze(-3), out[2].unsqueeze(-3),
        out[3].unsqueeze(-3), None, False, False)
    return gxo.squeeze(-3), gyo.squeeze(-3)


def zoom_sweep(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, dr=None, grad_ops=None):
    """Zoom sweep of one Bragg peak -> (best_absq, best_r, best_i,
    best_idx) planes (n, m) [+ (grad_x, grad_y) when grad_ops is given]
    [+ (phase, weight) when dr is given]; for a stack of windows (B, W0,
    W1) each plane is (B, n, m), from the launches of one window.

    Sr, Si : (W0, W1) spectrum window, pre-scaled by 1/(n*m), or a stack
        (B, W0, W1) of windows at the same bins.
    gx, gy : (P, W0), (P, W1) per-candidate Gaussian factors.
    A0c, A0s : (n, W0) row inverse-DFT basis; A1c, A1s : (m, W1) column
        basis.
    dr : border of the interior weight mask (emission off when None).
    grad_ops : (S2r, S2i, A1yc, A1ys), the pre-scaled row-derivative
        window (W0, W1) (a stack: (B, W0, W1)) and the column-derivative
        basis (m, W1); the
        gradients are those of -angle(M) of the winner, along rows and
        columns, before any rebase.
    best_idx is int32; a pixel whose |M|^2 is 0 for every candidate
    keeps index 0 and M = 0 (and gradient 0)."""
    if Sr.device.type == "cpu":
        return zoom_sweep_plain(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, dr,
                                grad_ops=grad_ops)
    if Sr.device.type != "cuda":
        raise ValueError(f"zoom_sweep: unsupported device {Sr.device}")
    _check(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, grad_ops)
    T = stage1(Sr, Si, gx, gy, A0c, A0s)
    out = stage2(T, A1c, A1s, dr)
    if grad_ops is None:
        _build.launches["zoom_sweep"] += 1
        return out
    grads = winner_grads(T, out, gx, gy, A0c, A0s, A1c, A1s, grad_ops)
    _build.launches["zoom_grad"] += 1
    return out[:4] + grads + out[4:]
