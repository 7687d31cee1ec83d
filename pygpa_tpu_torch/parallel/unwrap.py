"""Row-sharded weighted phase unwrap and the row-sharded displacement
pipeline (counterpart of pygpa_tpu/parallel/unwrap.py).

After the row-sharded WFR sweep (parallel/fft.py) the image's phases
stay ROW-SHARDED through the remaining stages:

- the wrapped differences and the per-pixel weighted lstsq are
  elementwise on each rank's block (the row differences take one halo
  row from the next rank);
- the unwrap is exactly solvers/unwrap.py: the multigrid and the CG run
  with the row context core.rows.RowBlock (halo rows for the stencils
  along rows, all-reduced dots and norms, so every rank stops at the
  same iteration) and a DISTRIBUTED DCT preconditioner, plugged in
  through the reference's precond / precond_factory seam: the pencil
  pattern of fft2_sharded with DCT-II (lane-axis DCT on the local rows,
  all_to_all to column blocks, row-axis DCT, all_to_all back). Each local
  pass goes through the gate core.fourier.dct2n uses, so axes of 4096
  and more run the ops.dct kernels.

The planes keep the multigrid's aligned (..., n, m) form with a
structurally zero last column (x-differences) and row (y-differences),
so every plane splits evenly over the ranks. No rank ever holds a whole
(n, m) plane.
"""
import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..config import DEFAULTS
from ..core import fourier as _fourier
from ..core.mathtools import wrap_to_pi
from ..core.rows import RowBlock, roll_rows
from ..gpa.pipeline import arange_bank
from ..ops import dct as _dct
from ..ops.sweep import wrap_diff
from ..solvers.lstsq import weighted_lstsq_stack
from ..solvers.unwrap import (_cg_unwrap, _mask_last, _pad_last,
                              _residual_aligned, phase_unwrap_prediff_mg)
from .fft import (all_to_all, check_divisible, spectrum_local,
                  sweep_rows_local)
from .mesh import axis_info, local_block, mesh_device, sharded


def _pass(fn, plain, x, axis):
    """One DCT pass along `axis` of x: the kernel where core.fourier's
    gate holds for that axis, the FFT twin otherwise."""
    return fn(x) if _fourier.dct_kernel_ok(x.shape[axis], x.dtype) \
        else plain(x)


def dct2_local(x, group, world, inverse=False):
    """The pencil 2D DCT-II (inverse=True: its inverse) of this rank's row
    block (..., n/D, m); returns its row block of the transform. The
    forward runs the lane axis first, the inverse the row axis first,
    as core.fourier.dct2n / idct2n do."""
    if inverse:
        xt = all_to_all(x, group, world, split=-1, concat=-2)
        xt = _pass(_dct.idct_sub, _dct.idct_sub_plain, xt, -2)
        x = all_to_all(xt, group, world, split=-2, concat=-1)
        return _pass(_dct.idct_lane, _dct.idct_lane_plain, x, -1)
    x = _pass(_dct.dct_lane, _dct.dct_lane_plain, x, -1)
    xt = all_to_all(x, group, world, split=-1, concat=-2)
    xt = _pass(_dct.dct_sub, _dct.dct_sub_plain, xt, -2)
    return all_to_all(xt, group, world, split=-2, concat=-1)


def _dct_sharded(x, mesh, axis, inverse):
    group, _, world = axis_info(mesh, axis)
    ndim = x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)
    xl = local_block(x, mesh, axis, ndim - 2)
    check_divisible((xl.shape[-2] * world, xl.shape[-1]), world,
                    "the pencil DCT")
    return sharded(dct2_local(xl, group, world, inverse), mesh, axis,
                   ndim - 2)


def dct2n_sharded(x, mesh, axis="batch"):
    """2D DCT-II (scipy.fft.dctn, norm=None) of a row-sharded (..., N, M)
    array: a full tensor or a DTensor sharded on axis -2 over `axis`;
    returns the row-sharded transform (a DTensor)."""
    return _dct_sharded(x, mesh, axis, False)


def idct2n_sharded(x, mesh, axis="batch"):
    """The inverse of dct2n_sharded."""
    return _dct_sharded(x, mesh, axis, True)


def poisson_scale_rows(n, m, r0, rows, dtype, device):
    """Rows [r0, r0 + rows) of ops.cg.poisson_scale(n, m) (the same
    values, built for the block alone)."""
    i = torch.arange(r0, r0 + rows, dtype=dtype, device=device)[:, None]
    j = torch.arange(m, dtype=dtype, device=device)[None, :]
    scale = 2.0 * (torch.cos(torch.pi * i / n) + torch.cos(torch.pi * j / m)
                   - 2.0)
    if r0 == 0:
        scale[0, 0].fill_(1.0)
    return scale


_FACTORY_CACHE = {}


def make_sharded_precond_factory(mesh, axis, dtype):
    """precond_factory for solvers.unwrap.phase_unwrap_prediff_mg and
    _cg_unwrap's precond on row blocks: for a level (n, m), the
    unweighted-Poisson solve of this rank's row block whose DCT pair runs
    the pencil all_to_all pattern. Levels must keep both axes divisible
    by the mesh axis size. Factories are cached per (mesh, axis, dtype)
    and their preconditioners (with their eigenvalue blocks) per level
    shape, as the reference caches them."""
    key = (id(mesh), axis, dtype)
    hit = _FACTORY_CACHE.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    group, rank, world = axis_info(mesh, axis)
    cache = {}

    def factory(shape):
        shape = (int(shape[0]), int(shape[1]))
        if shape not in cache:
            check_divisible(shape, world, "the sharded preconditioner")
            rows = shape[0] // world
            scale = poisson_scale_rows(shape[0], shape[1], rank * rows, rows,
                                       dtype, mesh_device(mesh))

            def precond(rk, scale=scale):
                return dct2_local(dct2_local(rk, group, world) / scale,
                                  group, world, inverse=True)

            cache[shape] = precond
        return cache[shape]

    _FACTORY_CACHE[key] = (mesh, factory)
    return factory


def _unwrap_local(dxp, dyp, w, rows, factory, kmax, coarse):
    """The unwrap of this rank's row block of aligned planes: the
    multigrid with `coarse`, the exact early-stopping CG otherwise,
    both with the sharded preconditioner."""
    if coarse:
        # clamp the coarse-level iterations as the single-card path
        # (gpa.reconstruct._integrate_uv) does, so the two schedules agree
        kmg = min(int(kmax), DEFAULTS.unwrap_kmax_mg)
        return phase_unwrap_prediff_mg(dxp, dyp, w, kmax=kmg, coarse=coarse,
                                       precond_factory=factory, rows=rows)
    rk, WWx, WWy = _residual_aligned(wrap_to_pi(dxp), wrap_to_pi(dyp), w,
                                     rows)
    n = dxp.shape[-2] * rows.world
    phi, _ = _cg_unwrap(rk, WWx, WWy, int(kmax), aligned=True,
                        precond=factory((n, dxp.shape[-1])), rows=rows)
    return phi


def _row_context(mesh, axis):
    group, rank, world = axis_info(mesh, axis)
    return RowBlock(group, rank, world)


def phase_unwrap_prediff_sharded(dx, dy, weight, mesh, axis="batch",
                                 kmax=10, coarse=None):
    """Row-sharded weighted gradient integration (drop-in for
    solvers.unwrap.phase_unwrap_prediff / _mg on sharded planes): dx
    (..., n, m-1) and dy (..., n-1, m) as full tensors, or both in the
    aligned form (..., n, m) with a zero last column / row (full, or
    DTensors sharded on axis -2 over `axis`); weight (..., n, m) or None.
    coarse selects the multigrid (its coarse iterations clamped as the
    single-card reconstruction clamps them), None the exact CG. Returns
    the row-sharded solution (a DTensor)."""
    if not isinstance(dx, DTensor):
        # the reference's unaligned planes: pad to the aligned form
        dx, dy = (t if isinstance(t, torch.Tensor)
                  else torch.as_tensor(np.asarray(t)) for t in (dx, dy))
        n, m = dx.shape[-2], dy.shape[-1]
        if dx.shape[-1] == m - 1:
            dx = _pad_last(dx, -1)
        if dy.shape[-2] == n - 1:
            dy = _pad_last(dy, -2)
    ndim = dx.dim()
    dxl = local_block(dx, mesh, axis, ndim - 2)
    dyl = local_block(dy, mesh, axis, ndim - 2)
    wl = None if weight is None else local_block(
        weight, mesh, axis, (weight.dim() if isinstance(weight, torch.Tensor)
                             else np.ndim(weight)) - 2)
    rows = _row_context(mesh, axis)
    check_divisible((dxl.shape[-2] * rows.world, dxl.shape[-1]), rows.world,
                    "phase_unwrap_prediff_sharded")
    factory = make_sharded_precond_factory(mesh, axis, dxl.dtype)
    phi = _unwrap_local(dxl, dyl, wl, rows, factory, kmax, coarse)
    return sharded(phi, mesh, axis, ndim - 2)


def _reconstruct_local(K, ph, wt, rows, factory, kmax, coarse):
    """reconstruct_u_inv_from_demod on this rank's row block: phases and
    weights (G, r, m) -> u (2, r, m). The differences wrap as the
    single-card reconstruction's do (ops.sweep.wrap_diff); the row
    differences read the next rank's first row, and the global last
    row's (structurally absent) difference is zeroed."""
    shape = (-1, 1, 1)
    dbdx = wrap_diff(torch.diff(ph, dim=-1) + K[:, 1].reshape(shape))
    dbdy = wrap_diff(roll_rows(ph, -1, rows) - ph + K[:, 0].reshape(shape))
    dudx = weighted_lstsq_stack(dbdx, K, wt[..., :-1])
    dudy = weighted_lstsq_stack(dbdy, K, wt)
    dudx = _pad_last(dudx, -1)
    dudy = _mask_last(dudy, -2, rows)
    wnorm = torch.linalg.vector_norm(wt, dim=0)
    return _unwrap_local(dudx, dudy, wnorm, rows, factory, kmax, coarse)


def reconstruct_u_inv_from_demod_sharded(kvecs, phases_demod, weights,
                                         mesh, axis="batch", kmax=10,
                                         unwrap_coarse=None):
    """Row-sharded counterpart of gpa.reconstruct.
    reconstruct_u_inv_from_demod: phases_demod and weights (G, n, m), full
    or DTensors sharded on axis 1 over `axis`; the wrapped differences
    and the per-pixel lstsq are elementwise on the blocks, and both
    displacement components integrate in one row-sharded unwrap. Returns
    u (2, n, m), row-sharded (a DTensor)."""
    ph = local_block(phases_demod, mesh, axis, 1)
    wt = local_block(weights, mesh, axis, 1)
    rows = _row_context(mesh, axis)
    check_divisible((ph.shape[-2] * rows.world, ph.shape[-1]), rows.world,
                    "reconstruct_u_inv_from_demod_sharded")
    K = (2 * math.pi) * torch.as_tensor(np.asarray(kvecs), device=ph.device
                                        ).to(ph.dtype)
    factory = make_sharded_precond_factory(mesh, axis, ph.dtype)
    u = _reconstruct_local(K, ph, wt, rows, factory, kmax, unwrap_coarse)
    return sharded(u, mesh, axis, 1)


def extract_displacement_field_sharded(image, kvecs, mesh, axis="batch",
                                       sigma=None,
                                       kwscale=DEFAULTS.kw_scale,
                                       ksteps=DEFAULTS.ksteps,
                                       kmax=DEFAULTS.unwrap_kmax_reconstruct,
                                       unwrap_coarse=None):
    """extract_displacement_field for ONE image too large for one card:
    the image (n, m) (a full tensor or a DTensor sharded on its rows over
    `axis`) stays row-sharded through the pencil FFT -> the row-sharded
    WFR zoom sweeps (the zoom kernel on each block) -> the per-pixel
    lstsq -> the row-sharded multigrid (unwrap_coarse) or exact CG
    unwrap. Same math as the single-card pipeline: candidate banks by
    np.arange around each k-vector (float64), sigma = ceil(1 / min |k|),
    weights sqrt(|M|^2) times the 2 sigma interior mask (floor 1e-6).
    Returns u (2, n, m), row-sharded (a DTensor)."""
    kvecs_h = np.asarray(kvecs, np.float64)
    knorms = np.linalg.norm(kvecs_h, axis=1)
    if not np.all(knorms > 0):
        raise ValueError("all k-vectors must be nonzero")
    kw = knorms.mean() / kwscale
    if sigma is None:
        sigma = int(np.ceil(1 / knorms.min()))
    kstep = kw / ksteps
    dr = 2 * sigma

    rows = _row_context(mesh, axis)
    group, rank, world = rows.group, rows.rank, rows.world
    img = local_block(image, mesh, axis, 0)
    r, m = img.shape
    n = r * world
    check_divisible((n, m), world, "extract_displacement_field_sharded")
    rdt = img.dtype
    spec = spectrum_local(img, group, world)

    ii = torch.arange(rank * r, rank * r + r, device=img.device)[:, None]
    jj = torch.arange(m, device=img.device)[None, :]
    interior = (ii >= dr) & (ii < n - dr) & (jj >= dr) & (jj < m - dr)
    mask = interior.to(rdt) + 1e-6

    phs, wts = [], []
    for pk in kvecs_h:
        ba, br, bi, _ = sweep_rows_local(spec, arange_bank(pk, kw, kstep),
                                         sigma, (n, m), group, rank,
                                         world)[:4]
        phs.append(torch.atan2(bi, br).to(rdt))
        wts.append(torch.sqrt(ba) * mask)
    K = (2 * math.pi) * torch.as_tensor(kvecs_h, device=img.device).to(rdt)
    factory = make_sharded_precond_factory(mesh, axis, rdt)
    u = _reconstruct_local(K, torch.stack(phs), torch.stack(wts), rows,
                           factory, kmax, unwrap_coarse)
    return sharded(u, mesh, axis, 1)
