"""Fixed-iteration DCT-preconditioned CG on the weighted Poisson system.

Replaces the TPU kernel ``pygpa_tpu/ops/pallas_cg.py`` ``_cg_kernel``
(entry ``cg_poisson``), which the multigrid unwrap runs for its coarse
solve and for the V-branch's coarse-grid correction (both 1024^2 at the
4096^2 bench shapes, kmax 6 and 4).

Each iteration: z = P^-1 r with the unweighted-Poisson preconditioner
idct2n(dct2n(r) / eigenvalues), rz = <r, z>, beta = rz / rzprev
(0 when rzprev == 0), p = z (first iteration) or z + beta p,
Qp = A^T (W^T W) A p with the aligned cyclic stencil, alpha = rz /
<p, Qp> (0 when the denominator is 0), phi += alpha p, r -= alpha Qp.
The guarded coefficients make post-convergence iterations no-ops, so
the loop runs a fixed kmax like the TPU kernel.

CUDA routes (``csrc/cg.cu``), chosen by :func:`fft_route`: on sides
that are powers of two (128 ... 1024) each iteration is six launches,
the preconditioner as four one-axis FFT-form DCT passes over the batch
(``csrc/dct_fft.cuh``, shared with the DCT kernels; the eigenvalue
division fused into the second pass's store, the r.z partials into the
fourth's), then a fused p-update and stencil kernel and the x/r update.
On the other sides the reference takes (384, 640, 768, 896) it is four
hand-written tiled fp32 GEMMs against dense DCT matrices built on the
device, then four stencil / update kernels. Both keep alpha and beta on
the device (no host sync inside the loop) and reduce block partials in
a fixed order, so a solve repeats bit for bit. The plain twin uses the
FFT-based DCT pair of core.fourier.

rk0 carries batch axes (..., n, m); WWx, WWy (..., n, m) broadcast
against it with their axes leading (ops.vcycle.image_axis): (n, m) is
one pair shared by every plane, (B, 1, n, m) beside rk0 (B, C, n, m) is
image b's own pair for its C planes (the kernel reads plane i's pair
i // C). Returns phi shaped like rk0.
"""
import ctypes

import torch

from . import _build
from . import dct as _dct
from .vcycle import _q as _apply_q
from .vcycle import image_axis
from ..core.fourier import dct2n, idct2n

_NT_RED = 256 * 16   # elements per reduction block (csrc/cg.cu)
# largest side the reference sends to its CG kernel (pallas_cg._MAX_SIDE,
# a VMEM bound there); larger levels take the early-stopping loop in
# both packages
MAX_SIDE = 1024


# sides of the FFT route: powers of two, whose half lengths have a
# Stockham plan (ops/dct.RADICES)
FFT_SIDES = (128, 256, 512, 1024)


def supported(n, m):
    """Sides the reference's CG kernel takes (pallas_cg.supported)."""
    return n % 128 == 0 and m % 128 == 0 and n <= MAX_SIDE and m <= MAX_SIDE


def fft_route(n, m):
    """True where the kernel runs its preconditioner as FFT-form DCT
    passes (both sides in FFT_SIDES), False where it takes the dense
    DCT-matrix route (the other supported sides)."""
    return n in FFT_SIDES and m in FFT_SIDES


def poisson_scale(n, m, dtype, device):
    """DCT-II eigenvalues of the Neumann 5-point Laplacian with the
    [0, 0] entry set to 1."""
    i = torch.arange(n, dtype=dtype, device=device)[:, None]
    j = torch.arange(m, dtype=dtype, device=device)[None, :]
    scale = 2.0 * (torch.cos(torch.pi * i / n) + torch.cos(torch.pi * j / m)
                   - 2.0)
    scale[0, 0].fill_(1.0)     # a fill launch: no host scalar copied
    return scale


def cg_poisson_plain(rk0, WWx, WWy, kmax):
    """Plain PyTorch twin of the CG kernel."""
    n, m = rk0.shape[-2:]
    scale = poisson_scale(n, m, rk0.dtype, rk0.device)
    lead = rk0.shape[:-2]
    one = torch.ones(lead + (1, 1), dtype=rk0.dtype, device=rk0.device)
    zero = torch.zeros_like(one)
    phi = torch.zeros_like(rk0)
    rk = rk0
    pk = torch.zeros_like(rk0)
    rzprev = one
    for k in range(int(kmax)):
        zk = idct2n(dct2n(rk) / scale)
        rz = (rk * zk).sum((-2, -1), keepdim=True)
        beta = torch.where(rzprev != 0,
                           rz / torch.where(rzprev != 0, rzprev, one), zero)
        pk = zk if k == 0 else zk + beta * pk
        Qpk = _apply_q(pk, WWx, WWy)
        pq = (pk * Qpk).sum((-2, -1), keepdim=True)
        alpha = torch.where(pq != 0, rz / torch.where(pq != 0, pq, one),
                            zero)
        phi = phi + alpha * pk
        rk = rk - alpha * Qpk
        rzprev = rz
    return phi


def cg_poisson(rk0, WWx, WWy, kmax):
    """`kmax` preconditioned CG iterations from phi = 0 (see module
    docstring); CPU tensors run the twin, CUDA tensors the kernel."""
    if rk0.device.type == "cpu":
        return cg_poisson_plain(rk0, WWx, WWy, kmax)
    if rk0.device.type != "cuda":
        raise ValueError(f"cg_poisson: unsupported device {rk0.device}")
    n, m = rk0.shape[-2:]
    kmax = int(kmax)
    if n % 128 or m % 128 or (n * m) % _NT_RED or kmax < 1:
        raise ValueError(f"cg_poisson kernel needs n, m multiples of 128 "
                         f"and kmax >= 1 (got n={n}, m={m}, kmax={kmax})")
    rk_b = rk0.reshape((-1, n, m)).contiguous()
    B = rk_b.shape[0]
    I, C = image_axis("cg_poisson", rk0, WWx)
    if tuple(WWy.shape) != tuple(WWx.shape):
        raise ValueError(f"cg_poisson: WWx {tuple(WWx.shape)} and WWy "
                         f"{tuple(WWy.shape)} differ")
    WWx, WWy = (t.reshape((I, n, m)).contiguous() for t in (WWx, WWy))
    _build.check_tensor("cg_poisson", "rk0", rk_b, (B, n, m),
                        torch.float32, rk0.device)
    for name, t in (("WWx", WWx), ("WWy", WWy)):
        _build.check_tensor("cg_poisson", name, t, (I, n, m),
                            torch.float32, rk0.device)
    phi = torch.empty_like(rk_b)
    fft = fft_route(n, m)
    with torch.cuda.device(rk0.device):
        stream = torch.cuda.current_stream(rk0.device).cuda_stream
        size = _build.load()["cg_fft_workspace_floats" if fft
                             else "cg_workspace_floats"]
        size.argtypes = [ctypes.c_int] * 4
        size.restype = ctypes.c_longlong
        ws = torch.empty(int(size(B, n, m, kmax)), dtype=torch.float32,
                         device=rk0.device)
        ptrs = (rk_b.data_ptr(), WWx.data_ptr(), WWy.data_ptr(),
                phi.data_ptr(), ws.data_ptr())
        if fft:
            tabs = [_dct._device_table(s, inv, rk0.device).data_ptr()
                    for s, inv in ((m, False), (n, False), (n, True),
                                   (m, True))]
            fn = _build.bind("cg_poisson_fft", "pppppppppiiiiip")
            code = fn(*ptrs, *tabs, B, C, n, m, kmax, stream)
        else:
            fn = _build.bind("cg_poisson", "pppppiiiiip")
            code = fn(*ptrs, B, C, n, m, kmax, stream)
    _build.check(code, "cg_poisson")
    _build.launches["cg_poisson"] += 1
    return phi.reshape(rk0.shape)
