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

The early-stopping solve of every other level and of the exact unwrap
(:func:`cg_unwrap`, ``csrc/cg_unwrap.cu``) replaces
``pygpa_tpu/solvers/unwrap.py`` ``_cg_unwrap_body``, the reference's
``lax.while_loop`` that XLA fuses on the TPU: per plane, at most kmax
iterations, a stop at ||r|| < 1e-6 ||r0||, at rz == 0 or at kmax, a
plane whose rk0 is all zero done at the start, and a done plane frozen
while the others run on. Its plain twin :func:`cg_unwrap_plain` is that
loop in torch (which ``solvers.unwrap`` also runs for float64, for the
row-sharded solver's ``precond``/``rows`` and on the CPU). The kernel
takes float32 sides 2 ... 8192 (:func:`unwrap_supported`). Where each
side has a DCT pass of its own (:func:`unwrap_pass_side`: a power of two
from 128 to 8192, a Stockham pass; an even side from 130 to 4094, a
chirp-z pass of two four-step FFTs of L = 256 ... 4096 points in
registers, ``cg_unwrap_czt.cu``), the FFT route
(:func:`unwrap_fft_route`) runs each iteration as six launches (the
four DCT passes, with the eigenvalue division and the r.z partials in
their stores, then the p/stencil and the phi/r/stop kernels): the exact
path's 4086^2 (the 5 px trim of ``iterate_GPA``),
500^2 or 4096 x 4086. Other sides (odd, under 128, past 4094 and not a
power of two) keep core.fourier's DCT pair and add three launches an
iteration. Scalars, done flags and counts stay on the device; a done
plane's blocks return at once.
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from . import dct as _dct
from .vcycle import _q as _apply_q_aligned
from .vcycle import image_axis
from ..core.fourier import dct2n, idct2n
from ..core.rows import plane_sum

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
        Qpk = _apply_q_aligned(pk, WWx, WWy)
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


# ---- the early-stopping solve

# sides of the early-stopping kernel: the DCT passes' plans reach 8192
# (ops/dct.RADICES), in-plane offsets are int; planes lie on grid y
UNWRAP_MAX_SIDE = 8192
UNWRAP_MAX_PLANES = 65535
# sides of the Stockham DCT passes inside the solve: powers of two
UNWRAP_FFT_SIDES = tuple(2 * N for N in sorted(_dct.RADICES))
# the largest side of the chirp-z passes: its L, 4096, is the largest
# of the chirp-z split (ops/dct.py CZT_SPLIT)
UNWRAP_CZT_MAX = 4094
_UNWRAP_TILE = 256 * 16   # elements per block of its elementwise kernels


@functools.lru_cache(maxsize=32)
def _cos_axis(s, device):
    """cos(pi i / s), i < s, in float32 on `device`, by poisson_scale's
    own ops (the early-stopping kernel forms its eigenvalues from these,
    so they are the twin's bits on the same device)."""
    i = torch.arange(s, dtype=torch.float32, device=device)
    return torch.cos(torch.pi * i / s)


def unwrap_supported(shape):
    """Shapes (..., n, m) the early-stopping kernel takes: 2 <= n, m <=
    UNWRAP_MAX_SIDE and at most UNWRAP_MAX_PLANES planes."""
    n, m = shape[-2:]
    planes = int(torch.Size(shape[:-2]).numel())
    return (2 <= n <= UNWRAP_MAX_SIDE and 2 <= m <= UNWRAP_MAX_SIDE
            and 1 <= planes <= UNWRAP_MAX_PLANES)


def unwrap_pass_side(s):
    """True where a side has a DCT pass inside the early-stopping kernel:
    a power of two in UNWRAP_FFT_SIDES (the Stockham pass) or an even
    side from 130 to UNWRAP_CZT_MAX (the chirp-z pass)."""
    return s in UNWRAP_FFT_SIDES or (s % 2 == 0
                                     and 128 < s <= UNWRAP_CZT_MAX)


def unwrap_fft_route(n, m):
    """True where the early-stopping kernel runs its preconditioner as
    its own DCT passes (both sides pass sides, unwrap_pass_side);
    elsewhere core.fourier's DCT pair runs between its launches."""
    return unwrap_pass_side(n) and unwrap_pass_side(m)


def _diff0(a, axis):
    """diff along `axis` with a zero prepended and appended."""
    pad = (1, 1) if axis == -1 else (0, 0, 1, 1)
    return torch.diff(F.pad(a, pad), dim=axis)


def apply_q_unaligned(p, WWx, WWy):
    """Weighted transformation (A^T)(W^T W)(A) p on unaligned planes:
    WWx (..., n, m-1), WWy (..., n-1, m)."""
    return (_diff0(WWx * torch.diff(p, dim=-1), -1)
            + _diff0(WWy * torch.diff(p, dim=-2), -2))


def aligned_weights(WWx, WWy):
    """Unaligned weights WWx (..., n, m-1), WWy (..., n-1, m) padded to
    (..., n, m) with a zero last column and row: the aligned cyclic
    stencil ops.vcycle._q then gives apply_q_unaligned's values."""
    return F.pad(WWx, (0, 1)), F.pad(WWy, (0, 0, 0, 1))


def cg_unwrap_plain(rk0, WWx, WWy, kmax, aligned=False, precond=None,
                    rows=None, norms=None):
    """The early-stopping PCG loop in torch (the kernel's twin, and the
    solve of every call the kernel does not take), batched over the
    leading axes: a plane stops at ||r|| < eps ||r0|| (eps 1e-6 in
    float32, 1e-9 in float64), at rz == 0 or after kmax iterations (at
    least one, as the reference's while_loop runs its body once before
    testing k), and starts done when its rk0 is all zero; a stopped plane
    is frozen while the others run on. On the card all iterations are
    enqueued without a host sync (frozen iterations change nothing); a
    CPU run leaves the loop once every plane is done. `precond` (rk ->
    zk) replaces the DCT preconditioner; with `rows` (core.rows.RowBlock,
    aligned planes only) the dots and the all-zero test are all-reduced
    over the row group, so every rank stops at the same iteration.
    `aligned`: weights (..., n, m) with zero tails and ops.vcycle._q,
    else (..., n, m-1), (..., n-1, m) and apply_q_unaligned. `norms`, a
    tensor (..., 2) of rk0's dtype, receives each plane's ||r|| after its
    last iteration and eps ||r0|| (its stop threshold). Returns (phi, k
    per plane)."""
    dt = rk0.dtype
    lead = rk0.shape[:-2]
    if precond is None:
        scale = poisson_scale(*rk0.shape[-2:], dt, rk0.device)

        def precond(r):
            return idct2n(dct2n(r) / scale)
    if rows is not None and not aligned:
        raise ValueError("a row-sharded CG solve takes aligned planes")

    def apply_q(p):
        if aligned:
            return _apply_q_aligned(p, WWx, WWy, rows)
        return apply_q_unaligned(p, WWx, WWy)

    eps = 1e-9 if dt == torch.float64 else 1e-6

    def dot(a, b):
        return plane_sum(a * b, rows)

    one = torch.ones(lead + (1, 1), dtype=dt, device=rk0.device)
    zero = torch.zeros_like(one)
    norm_r0 = torch.sqrt(dot(rk0, rk0))
    rlast = norm_r0
    phi = torch.zeros_like(rk0)
    rk = rk0
    pk = torch.zeros_like(rk0)
    rzprev = one
    k = torch.zeros(lead + (1, 1), dtype=torch.int32, device=rk0.device)
    done = (rk0 == 0).all(-1, keepdim=True).all(-2, keepdim=True)
    if rows is not None:
        done = rows.all(done)
    for it in range(max(kmax, 1)):
        if rk0.device.type == "cpu" and bool(done.all()):
            break
        zk = precond(rk)
        rz = dot(rk, zk)
        beta = torch.where(rzprev != 0,
                           rz / torch.where(rzprev != 0, rzprev, one), zero)
        pk_new = zk if it == 0 else zk + beta * pk
        Qpk = apply_q(pk_new)
        pq = dot(pk_new, Qpk)
        alpha = torch.where(pq != 0, rz / torch.where(pq != 0, pq, one),
                            zero)
        phi = torch.where(done, phi, phi + alpha * pk_new)
        rk_new = rk - alpha * Qpk
        rnorm = torch.sqrt(dot(rk_new, rk_new))
        stop = (k + 1 >= kmax) | (rnorm < eps * norm_r0) | (rz == 0)
        if norms is not None:
            rlast = torch.where(done, rlast, rnorm)
        rk = torch.where(done, rk, rk_new)
        pk = torch.where(done, pk, pk_new)
        rzprev = torch.where(done, rzprev, rz)
        k = torch.where(done, k, k + 1)
        done = done | stop
    if norms is not None:
        norms.copy_(torch.cat([rlast, eps * norm_r0], -1).reshape(
            norms.shape))
    return phi, k.reshape(lead)


def cg_unwrap(rk0, WWx, WWy, kmax, aligned=False, norms=None):
    """The early-stopping PCG solve from phi = 0 (module docstring), as
    :func:`cg_unwrap_plain` computes it: rk0 (..., n, m); WWx, WWy aligned
    (..., n, m) with zero tails, or (`aligned` False) the exact path's
    (..., n, m-1) and (..., n-1, m), padded once here; the weights'
    leading axes as ops.vcycle.image_axis reads them. Returns (phi, k per
    plane, int32); `norms` as the twin's. CPU tensors run the twin, CUDA
    float32 tensors the kernel (ValueError outside unwrap_supported)."""
    if rk0.device.type == "cpu":
        return cg_unwrap_plain(rk0, WWx, WWy, kmax, aligned, norms=norms)
    if rk0.device.type != "cuda":
        raise ValueError(f"cg_unwrap: unsupported device {rk0.device}")
    n, m = rk0.shape[-2:]
    kmax = int(kmax)
    if rk0.dtype != torch.float32 or not unwrap_supported(rk0.shape):
        raise ValueError(f"cg_unwrap kernel needs float32 planes with 2 <= "
                         f"n, m <= {UNWRAP_MAX_SIDE}, at most "
                         f"{UNWRAP_MAX_PLANES} of them (got {rk0.dtype} "
                         f"{tuple(rk0.shape)})")
    if not aligned:
        WWx, WWy = aligned_weights(WWx, WWy)
    if tuple(WWy.shape) != tuple(WWx.shape):
        raise ValueError(f"cg_unwrap: WWx {tuple(WWx.shape)} and WWy "
                         f"{tuple(WWy.shape)} differ")
    I, C = image_axis("cg_unwrap", rk0, WWx)
    lead = rk0.shape[:-2]
    rk_b = rk0.reshape((-1, n, m)).contiguous()
    B = rk_b.shape[0]
    WWx, WWy = (t.reshape((I, n, m)).contiguous() for t in (WWx, WWy))
    for name, t in (("WWx", WWx), ("WWy", WWy)):
        _build.check_tensor("cg_unwrap", name, t, (I, n, m), torch.float32,
                            rk0.device)
    dev = rk0.device
    r, phi, z, qp = (torch.empty_like(rk_b) for _ in range(4))
    pbuf = torch.empty((2, B, n, m), dtype=torch.float32, device=dev)
    nb = -(-n * m // _UNWRAP_TILE)
    sc = torch.empty((5, B), dtype=torch.float32, device=dev)
    si = torch.empty((3, B), dtype=torch.int32, device=dev)
    part_nz = torch.empty(B * nb, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        size = _build.bind("cg_unwrap_part_floats", "iii")
        size.restype = ctypes.c_longlong
        part = torch.empty(int(size(B, n, m)), dtype=torch.float32,
                           device=dev)
        state = (part.data_ptr(), sc.data_ptr(), si.data_ptr())
        code = _build.bind("cg_unwrap_init", "pppppppiiip")(
            rk_b.data_ptr(), r.data_ptr(), phi.data_ptr(), part.data_ptr(),
            part_nz.data_ptr(), sc.data_ptr(), si.data_ptr(), B, n, m,
            stream)
        _build.check(code, "cg_unwrap")
        cos = (_cos_axis(n, dev).data_ptr(), _cos_axis(m, dev).data_ptr())
        if unwrap_fft_route(n, m):
            x1 = torch.empty_like(rk_b)
            tabs = [_dct._device_table(s, inv, dev).data_ptr()
                    for s, inv in ((m, False), (n, False), (n, True),
                                   (m, True))]
            code = _build.bind("cg_unwrap_fft", "p" * 18 + "i" * 6 + "p")(
                WWx.data_ptr(), WWy.data_ptr(), r.data_ptr(),
                phi.data_ptr(), z.data_ptr(), x1.data_ptr(),
                pbuf[0].data_ptr(), pbuf[1].data_ptr(), qp.data_ptr(),
                *state, *tabs, *cos, B, C, n, m, kmax, int(bool(aligned)),
                stream)
            _build.check(code, "cg_unwrap")
        else:
            eig = _build.bind("cg_unwrap_eigen", "pppppp" + "iii" + "p")
            stp = _build.bind("cg_unwrap_step", "p" * 11 + "i" * 7 + "p")
            for it in range(max(kmax, 1)):
                y = dct2n(r).contiguous()
                _build.check(eig(y.data_ptr(), *state, *cos, B, n, m,
                                 stream), "cg_unwrap")
                zt = idct2n(y).contiguous()
                code = stp(zt.data_ptr(), pbuf[it & 1].data_ptr(),
                           pbuf[(it + 1) & 1].data_ptr(), qp.data_ptr(),
                           r.data_ptr(), phi.data_ptr(), WWx.data_ptr(),
                           WWy.data_ptr(), *state, B, C, n, m, int(it == 0),
                           kmax, int(bool(aligned)), stream)
                _build.check(code, "cg_unwrap")
    _build.launches["cg_unwrap"] += 1
    if norms is not None:
        norms.copy_(torch.stack([sc[4], sc[3]], -1).reshape(norms.shape))
    return phi.reshape(rk0.shape), si[1].reshape(lead)
