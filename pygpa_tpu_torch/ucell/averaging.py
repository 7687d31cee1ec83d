"""Unit-cell averaging (counterpart of pygpa_tpu/ucell/averaging.py):
drizzle every pixel, after undoing the local displacement u, into one
zoomed unit cell, and the inverse expansion.

Routes, as the reference's TPU route with its own ``supported`` limits
(a cell of at most 512 bins per side): a CUDA float32 image goes to the
drizzle kernel and a CUDA float32 cell to the expand kernel (ops.drizzle,
ops.expand); CPU tensors, float64 and larger cells take their plain
twins, which hold the kernels' semantics. Both follow the TPU kernels
where the reference's CPU route differs: a drizzle tap at column R1 is
dropped (the XLA scatter wraps it into the next row), and the B-spline
expansion samples the mirror-extended spline near the cell's rim (the
map_coordinates route cuts positions outside [0, R - 1] to 0).

The k-vectors `ks` are a host (2, 2) array (numpy, or a CPU tensor):
they set the cell's shape.
"""
import numpy as np
import torch

from ..core import entry_device
from ..ops import drizzle as _drizzle
from ..ops import expand as _expand


def _operands(vecs, mat):
    vecs = torch.as_tensor(vecs)
    if not isinstance(mat, torch.Tensor):
        mat = torch.tensor(np.asarray(mat))
    mat = mat.to(vecs.device)
    dt = torch.promote_types(vecs.dtype, mat.dtype)
    return vecs.to(dt), mat.to(dt)


def forward_transform(vecs, ks):
    """Cartesian -> lattice fractional coordinates: vecs @ ks^T."""
    vecs, ks = _operands(vecs, ks)
    return vecs @ ks.T


def backward_transform(vecs, ks):
    """Lattice fractional -> cartesian coordinates: vecs @ inv(ks)^T."""
    vecs, ks = _operands(vecs, ks)
    return vecs @ torch.linalg.inv(ks).T


def cart_in_uc(vecs, ks, rmin=0):
    """Map cartesian vectors into one unit cell."""
    return backward_transform(forward_transform(vecs, ks) % 1.0, ks) - rmin


def float_overlap(f):
    """2 x 2 bilinear overlap weights of a unit square shifted by f."""
    f = torch.as_tensor(f)
    A = torch.stack([1 - f, f])
    return A[:, 0] * A[:, 1][:, None]


def add_to_position(value, R, res, weights):
    """One drizzle sample: (res, weights) with `value` spread bilinearly
    at the fractional position R (new tensors; indices out of range are
    dropped after negative ones are taken from the end, as JAX's
    .at[].add(mode='drop') does)."""
    R = torch.as_tensor(R)
    Rf = torch.floor(R)
    overlap = float_overlap(R - Rf)
    r0, c0 = (int(v) for v in Rf)
    res, weights = res.clone(), weights.clone()
    n, m = res.shape[-2:]
    for li in range(2):
        for lj in range(2):
            r, c = r0 + li, c0 + lj
            r, c = r + n if -n <= r < 0 else r, c + m if -m <= c < 0 else c
            if 0 <= r < n and 0 <= c < m:
                res[r, c] += value * overlap[li, lj]
                weights[r, c] += overlap[li, lj]
    return res, weights


def calc_ucell_parameters(ks, z):
    """Bounding box (rmin, rsize) of the unit cell spanned by ks, zoomed
    by z (host numpy: rsize sets the output shapes)."""
    ks = np.asarray(ks)
    corners = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]])
    cornervals = corners @ np.linalg.inv(ks).T
    rmin = cornervals.min(axis=0)
    rsize = tuple((z * np.ceil(cornervals.max(axis=0)
                               - np.floor(rmin))).astype(int))
    return rmin, rsize


def drizzle_kernel_ok(image, rsize):
    """The reference's TPU drizzle route read for the card: a CUDA
    float32 image and a cell the kernel takes (ops.drizzle.supported)."""
    return (image.device.type == "cuda" and image.dtype == torch.float32
            and _drizzle.supported(rsize))


def expand_kernel_ok(cell, shape, order):
    """The reference's TPU expand route read for the card: a CUDA float32
    cell the kernel takes (ops.expand.supported)."""
    return (cell.device.type == "cuda" and cell.dtype == torch.float32
            and _expand.supported(cell.shape, shape, order))


def unit_cell_average(image, ks, u=None, z=1, return_weights=False,
                      only_generate_func=False, device=None):
    """Average an image (n, m) over all its unit cells (drizzle). NaN
    pixels are skipped; unvisited bins come back NaN (0/0). `u` (2, n, m)
    is applied before binning. only_generate_func=True returns the
    averaging function f(image, u=None) with (ks, z) fixed. The image
    and u move to `device` (None: the card; "cpu" for the plain
    route)."""
    dev = entry_device(device)
    ks = np.asarray(ks)
    rmin, rsize = calc_ucell_parameters(ks, z)
    rmin = tuple(float(r) for r in rmin)
    rsize = tuple(int(r) for r in rsize)

    def run(image, u=None):
        image = torch.as_tensor(image, device=dev)
        if u is not None:
            u = torch.as_tensor(u, device=image.device).to(image.dtype)
        if drizzle_kernel_ok(image, rsize):
            res, wsum = _drizzle.drizzle(image, ks, rmin, rsize, z, u)
        else:
            res, wsum = _drizzle.drizzle_plain(image, ks, rmin, rsize, z, u)
        return res / wsum, wsum

    if only_generate_func:
        return lambda image, u=None: run(image, u)[0]
    res, wsum = run(image, u)
    if return_weights:
        return res, wsum
    return res


def expand_unitcell(unit_cell_image, ks, shape, z=1, z2=1, u=0, order=3,
                    device=None):
    """Re-expand an averaged unit cell (NaNs taken as 0) to an image of
    `shape`: every output pixel, displaced by u when given, is mapped
    into the cell and resampled (order 3 B-spline by default, or 1).
    The cell and u move to `device` (None: the card; "cpu" for the plain
    route)."""
    cell = torch.nan_to_num(torch.as_tensor(unit_cell_image,
                                            device=entry_device(device)))
    rmin, _ = calc_ucell_parameters(np.asarray(ks), z)
    uu = None
    if not (isinstance(u, (int, float)) and u == 0):
        uu = torch.as_tensor(u, device=cell.device).to(cell.dtype)
    shape = (int(shape[0]), int(shape[1]))
    if expand_kernel_ok(cell, shape, order):
        return _expand.expand_cell(cell, ks, rmin, z, z2, uu, shape, order)
    return _expand.expand_cell_plain(cell, ks, rmin, z, z2, uu, shape, order)
