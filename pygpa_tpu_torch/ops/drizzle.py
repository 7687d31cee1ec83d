"""Drizzle of an image into its averaged unit cell.

Replaces the TPU kernel ``pygpa_tpu/ops/pallas_drizzle.py``
``_drizzle_kernel`` (entry ``drizzle``). Every pixel (i, j), displaced
by u when given, maps into the cell: f = (A x) mod 1 (as f - floor f),
X = (A^-1 f - rmin) z, and adds its value and a unit weight into the 2 x
2 bins around X with the bilinear hat weights (1 - t, t) per axis. Taps
outside the (R0, R1) cell are dropped on both axes, as the TPU kernel's
cropped dense accumulators drop them (the reference's XLA scatter
instead wraps a tap at column R1 into the next row; see
tests/test_torch_ucell.py). NaN pixels add neither value nor weight.

CUDA routes (``csrc/drizzle.cu``): one pass finds max|v| over the
non-NaN pixels (NaN-aware, order-free, so deterministic), which sets
the fixed-point scale 2^(62 - e) with N max|v| < 2^e (N pixels), so no
bin can overflow and each add is rounded by at most 2^(e - 63), i.e. at
16.8 M pixels of magnitude <= 4 by 1.5e-11, far below float32 rounding.
Each pixel computes X from the 11 scalars, as the TPU kernel does, and
adds its four taps into two int64 fixed-point planes. Where one plane
fits a block's shared memory (:func:`shared_route`: config 4's 118 x
166 cell, 157 KB) a grid of one block per SM and plane adds them there
and flushes each block's nonzero bins with one global atomic; larger
cells (up to two x 2 MB at the reference's 512 x 512 limit) add every
tap into the planes in device memory with L2 atomics. A fixed-point sum
does not depend on the order of the adds, so both routes and any two
launches give bit-identical output (float atomics would not). A last
launch converts the planes back to float32. The TPU kernel's dense
hat-matrix MXU contraction was its way around scatters and is not
carried over.

The plain twin ``drizzle_plain`` computes X with the same operations and
scatters with index_add_ (float sums: not bitwise repeatable on the
card). A CPU tensor runs the twin; a CUDA tensor the kernel (float32)
or an error.
"""
import numpy as np
import torch

from . import _build

MAX_CELL = 512     # largest cell side the reference's kernel takes
# shared memory one block may opt in to on an H100 (sm_90: 227 KB)
SHARED_BYTES = 232448


def supported(rsize):
    """Cells the reference's drizzle kernel takes (pallas_drizzle.
    supported: at most 512 bins per side)."""
    return rsize[0] <= MAX_CELL and rsize[1] <= MAX_CELL


def shared_route(rsize):
    """True where one int64 cell plane (R0 R1 x 8 bytes) fits a block's
    shared memory, so the kernel accumulates in shared memory; False
    where it adds into the planes in device memory."""
    return int(rsize[0]) * int(rsize[1]) * 8 <= SHARED_BYTES


def scalars(ks, rmin, z, dtype):
    """The kernel's scalars (a00, a01, a10, a11, b00, b01, b10, b11,
    rmin0, rmin1, z), reckoned in float64 from the k-vectors and rounded
    once to `dtype`, as Python floats."""
    A = np.asarray(ks, np.float64)
    Ainv = np.linalg.inv(A)
    v = [A[0, 0], A[0, 1], A[1, 0], A[1, 1],
         Ainv[0, 0], Ainv[0, 1], Ainv[1, 0], Ainv[1, 1],
         float(rmin[0]), float(rmin[1]), float(z)]
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    return [float(x) for x in np.asarray(v, np_dt)]


def cell_coords(s, ii, jj):
    """Cell coordinates (X0, X1) of lattice positions (ii, jj) from the
    scalars `s` (a00..b11, rmin0, rmin1, z)."""
    a00, a01, a10, a11, b00, b01, b10, b11, rmin0, rmin1, z = s[:11]
    f0 = a00 * ii + a01 * jj
    f1 = a10 * ii + a11 * jj
    f0 = f0 - torch.floor(f0)
    f1 = f1 - torch.floor(f1)
    X0 = (b00 * f0 + b01 * f1 - rmin0) * z
    X1 = (b10 * f0 + b11 * f1 - rmin1) * z
    return X0, X1


def _positions(n, m, u, dtype, device):
    ii = torch.arange(n, device=device).to(dtype)[:, None]
    jj = torch.arange(m, device=device).to(dtype)[None, :]
    if u is not None:
        ii = ii + u[0]
        jj = jj + u[1]
    return ii.expand(n, m), jj.expand(n, m)


def drizzle_plain(image, ks, rmin, rsize, z, u=None):
    """Plain PyTorch twin of the drizzle kernel: (sum, weights), each of
    shape rsize."""
    dt = image.dtype
    n, m = image.shape
    R0, R1 = int(rsize[0]), int(rsize[1])
    if u is not None:
        u = torch.as_tensor(u, device=image.device).to(dt)
    ii, jj = _positions(n, m, u, dt, image.device)
    X0, X1 = cell_coords(scalars(ks, rmin, z, dt), ii, jj)
    fl0 = torch.floor(X0)
    fl1 = torch.floor(X1)
    t0 = X0 - fl0
    t1 = X1 - fl1
    r0 = fl0.to(torch.int64)
    c0 = fl1.to(torch.int64)
    valid = ~torch.isnan(image)
    val = torch.where(valid, image, 0.0)
    vw = valid.to(dt)
    res = torch.zeros(R0 * R1, dtype=dt, device=image.device)
    wsum = torch.zeros(R0 * R1, dtype=dt, device=image.device)
    for li in range(2):
        hy = t0 if li else 1.0 - t0
        r = r0 + li
        hv = hy * val
        hw = hy * vw
        for lj in range(2):
            hx = t1 if lj else 1.0 - t1
            c = c0 + lj
            ok = (r >= 0) & (r < R0) & (c >= 0) & (c < R1)
            idx = torch.where(ok, r * R1 + c, 0).reshape(-1)
            res.index_add_(0, idx, torch.where(ok, hv * hx, 0.0).reshape(-1))
            wsum.index_add_(0, idx,
                            torch.where(ok, hw * hx, 0.0).reshape(-1))
    return res.reshape(R0, R1), wsum.reshape(R0, R1)


def drizzle(image, ks, rmin, rsize, z, u=None):
    """Accumulate `image` (n, m), displaced by u (2, n, m) when given,
    into the unit cell: (sum, weights) of shape rsize, the unnormalised
    drizzle of unit_cell_average. CPU tensors run the twin, CUDA tensors
    the kernel (float32, deterministic)."""
    if image.device.type == "cpu":
        return drizzle_plain(image, ks, rmin, rsize, z, u)
    if image.device.type != "cuda":
        raise ValueError(f"drizzle: unsupported device {image.device}")
    n, m = image.shape
    R0, R1 = int(rsize[0]), int(rsize[1])
    if n * m >= 2 ** 31 or R0 < 1 or R1 < 1:
        raise ValueError(f"drizzle kernel: image {n}x{m}, cell {R0}x{R1} "
                         "out of range")
    img = image.contiguous()
    _build.check_tensor("drizzle", "image", img, (n, m), torch.float32,
                        image.device)
    if u is not None:
        u = torch.as_tensor(u, device=image.device).contiguous()
        _build.check_tensor("drizzle", "u", u, (2, n, m), torch.float32,
                            image.device)
    # the planes and, last, the slot the kernel's max|v| pass writes
    acc = torch.zeros(2 * R0 * R1 + 1, dtype=torch.int64,
                      device=image.device)
    out = torch.empty((2, R0, R1), dtype=torch.float32, device=image.device)
    s = scalars(ks, rmin, z, torch.float32)
    u0 = u[0].data_ptr() if u is not None else None
    u1 = u[1].data_ptr() if u is not None else None
    with torch.cuda.device(image.device):
        fn = _build.bind("drizzle", "pppppiiiii" + "f" * 11 + "p")
        _build.check(fn(img.data_ptr(), u0, u1, acc.data_ptr(),
                        out.data_ptr(), n, m, R0, R1,
                        int(shared_route((R0, R1))), *s,
                        torch.cuda.current_stream(image.device).cuda_stream),
                     "drizzle")
    _build.launches["drizzle"] += 1
    return out[0], out[1]
