"""Periodic expansion of an averaged unit cell onto an image grid.

Replaces the TPU kernel ``pygpa_tpu/ops/pallas_expand.py``
``_expand_kernel`` (entry ``expand_cell``). Every output pixel (i, j)
maps into the cell, x = (i, j) / z2 + u, f = (A x) mod 1 (as f - floor
f), X = (A^-1 f - rmin) z, and samples the cell there with the bilinear
hat (order 1), the cubic B-spline basis (order 3, 'bspline') or
Catmull-Rom (order 3, 'catmull'), each tap weighted by the kernel
function at its signed distance and taps outside the cell weighted 0
(map_coordinates' mode='constant', cval=0). For the B-spline the
wrapper folds scipy's legacy mirror boundary into the coefficients, as
the reference wrapper does: spline_filter(cell, 'constant'), two
reflected rings and an rmin shift of 2/z, so in-domain X lands in
[2, R + 1] and every stencil stays inside the extended cell. Near its
rim that samples the mirror-extended spline, where the reference's
map_coordinates route cuts positions outside [0, R - 1] to 0 (see
tests/test_torch_ucell.py); the port follows the kernel.

CUDA route (``csrc/expand.cu``): work items are runs of 4 * threads
columns of one row, taken by a grid sized to the card's SMs; a thread
computes X for 4 adjacent pixels from the 12 scalars, as the TPU kernel
does, sums their 2 x 2 or 4 x 4 taps, and writes them as one 16-byte
store when rows start on a 16-byte boundary (else 4 scalar stores,
the row's tail masked). Cells up to 227 KB (:func:`shared_route`; a
(122, 170) float32 cell is 83 KB) take the shared route: persistent
512-thread blocks stage the cell once each. Larger cells take the L1
route: no staging, the cell read through the read-only cache. Bound
on an H100 by the output write (4 bytes a pixel, 12 with u). The TPU
kernel's dense W_x @ cell MXU product over all cell columns was its
way around gathers and is not carried over.

The plain twin ``expand_cell_plain`` computes the same taps with torch
gathers. A CPU tensor runs the twin; a CUDA tensor the kernel (float32)
or an error.
"""
import numpy as np
import torch

from . import _build
from .drizzle import MAX_CELL, cell_coords, scalars

ORDERS = (1, 3)
_WEIGHT_FN = {"hat": 0, "catmull": 1, "bspline": 2}   # csrc/expand.cu
SMEM_BYTES = 227 * 1024     # csrc/expand.cu SMEM_MAX
THREADS = {"shared": 512, "l1": 256}   # csrc/expand.cu NT_SMEM, NT_L1
VEC = 4                     # adjacent pixels a thread


def supported(cell_shape, out_shape, order):
    """Cells the reference's expand kernel takes (pallas_expand.
    supported: order 1 or 3, at most 512 per side)."""
    return (order in ORDERS and cell_shape[0] <= MAX_CELL
            and cell_shape[1] <= MAX_CELL)


def shared_route(cell_shape):
    """True when the kernel stages the (prepared) cell in shared memory:
    its float32 plane fits a block's opt-in shared memory."""
    return cell_shape[0] * cell_shape[1] * 4 <= SMEM_BYTES


def _hat(d):
    return torch.clamp(1.0 - d.abs(), min=0.0)


def _catmull_rom(d):
    a = d.abs()
    inner = (1.5 * a - 2.5) * a * a + 1.0
    outer = ((-0.5 * a + 2.5) * a - 4.0) * a + 2.0
    return torch.where(a < 1.0, inner, torch.where(a < 2.0, outer, 0.0))


def _bspline3(d):
    a = d.abs()
    s = 1.0 / 6.0
    inner = s * (4.0 + a * a * (3.0 * a - 6.0))
    t = 2.0 - a
    outer = s * t * t * t
    return torch.where(a < 1.0, inner, torch.where(a < 2.0, outer, 0.0))


def _prepare(cell, ks, rmin, z, z2, order, cubic):
    """(cell as the kernel samples it, kernel-function name, 12 scalars
    rounded once to the cell's dtype)."""
    rmin = (float(rmin[0]), float(rmin[1]))
    if order == 3 and cubic == "bspline":
        from ..core.interp import pad_np, spline_filter
        cell = pad_np(spline_filter(cell, mode="constant"), 2, "reflect")
        rmin = (rmin[0] - 2.0 / float(z), rmin[1] - 2.0 / float(z))
    kfn = "hat" if order == 1 else ("bspline" if cubic == "bspline"
                                    else "catmull")
    np_dt = np.float32 if cell.dtype == torch.float32 else np.float64
    return cell, kfn, (scalars(ks, rmin, z, cell.dtype)
                       + [float(np_dt(1.0 / float(z2)))])


def expand_cell_plain(cell, ks, rmin, z, z2, u, out_shape, order=3,
                      cubic="bspline"):
    """Plain PyTorch twin of the expand kernel."""
    if order not in ORDERS:
        raise NotImplementedError(f"expand_cell: order={order}")
    cell, kfn, s = _prepare(cell, ks, rmin, z, z2, order, cubic)
    K = {"hat": _hat, "catmull": _catmull_rom, "bspline": _bspline3}[kfn]
    dt = cell.dtype
    R0, R1 = cell.shape
    n, m = out_shape
    ii = torch.arange(n, device=cell.device).to(dt)[:, None] * s[11]
    jj = torch.arange(m, device=cell.device).to(dt)[None, :] * s[11]
    if u is not None:
        u = torch.as_tensor(u, device=cell.device).to(dt)
        ii = ii + u[0]
        jj = jj + u[1]
    ii, jj = ii.expand(n, m), jj.expand(n, m)
    X0, X1 = cell_coords(s, ii, jj)
    taps = 2 if order == 1 else 4
    first = 0 if order == 1 else -1
    fl0 = torch.floor(X0)
    fl1 = torch.floor(X1)
    flat = cell.reshape(-1)
    out = torch.zeros_like(X0)
    cols = []
    for b in range(taps):
        c = fl1 + (first + b)
        ok = (c >= 0) & (c < R1)
        cols.append((torch.where(ok, K(X1 - c), 0.0),
                     torch.where(ok, c, 0.0).to(torch.int64)))
    for a in range(taps):
        r = fl0 + (first + a)
        ok = (r >= 0) & (r < R0)
        wy = torch.where(ok, K(X0 - r), 0.0)
        ri = torch.where(ok, r, 0.0).to(torch.int64) * R1
        g = torch.zeros_like(X0)
        for wx, ci in cols:
            g = g + wx * flat[ri + ci]
        out = out + wy * g
    return out


def expand_cell(cell, ks, rmin, z, z2, u, out_shape, order=3,
                cubic="bspline"):
    """Expand the averaged unit `cell` (R0, R1) (NaNs already replaced)
    onto an out_shape grid: k-vectors ks (2, 2), cell-box offset rmin,
    cell zoom z, output supersampling z2, optional displacement u (2, n,
    m). CPU tensors run the twin, CUDA tensors the kernel (float32)."""
    if cell.device.type == "cpu":
        return expand_cell_plain(cell, ks, rmin, z, z2, u, out_shape,
                                 order, cubic)
    if cell.device.type != "cuda":
        raise ValueError(f"expand_cell: unsupported device {cell.device}")
    if order not in ORDERS:
        raise ValueError(f"expand_cell kernel: order={order}")
    n, m = (int(out_shape[0]), int(out_shape[1]))
    if n * m >= 2 ** 31:
        raise ValueError(f"expand_cell kernel: {n}x{m} output too large")
    c, kfn, s = _prepare(cell, ks, rmin, z, z2, order, cubic)
    c = c.contiguous()
    _build.check_tensor("expand_cell", "cell", c, tuple(c.shape),
                        torch.float32, cell.device)
    if u is not None:
        u = torch.as_tensor(u, device=cell.device).contiguous()
        _build.check_tensor("expand_cell", "u", u, (2, n, m), torch.float32,
                            cell.device)
    out = torch.empty((n, m), dtype=torch.float32, device=cell.device)
    R0, R1 = c.shape
    with torch.cuda.device(cell.device):
        fn = _build.bind("expand_cell", "pii" + "pp" + "p" + "iiii" + "i"
                         + "f" * 12 + "p")
        _build.check(fn(c.data_ptr(), R0, R1,
                        u[0].data_ptr() if u is not None else None,
                        u[1].data_ptr() if u is not None else None,
                        out.data_ptr(), n, m, order, _WEIGHT_FN[kfn],
                        int(shared_route((R0, R1))), *s,
                        torch.cuda.current_stream(cell.device).cuda_stream),
                     "expand_cell")
    _build.launches["expand"] += 1
    return out
