"""Weighted 2D phase unwrapping (Ghiglia-Romero): the exact
early-stopping DCT-preconditioned CG (counterpart of
pygpa_tpu/solvers/unwrap.py ``phase_unwrap`` / ``phase_unwrap_prediff``
and their ``_cg_unwrap``), the multigrid-accelerated
``phase_unwrap_prediff_mg`` (weighted or not, any schedule, the "v" and
"vv" V-branches) and the reference's API-parity names.

Leading axes are batch axes (the two displacement components, and for a
stack of images the images before them); the reference vmaps over
them. A weight (..., n, m) broadcasts against the planes (..., C, n,
m): one (n, m) plane shared by every plane, or (B, 1, n, m) giving image
b's C components its own; the min-neighbour weights, the coarse levels'
block means, the V-branch's Jacobi diagonal and the kernels follow it,
and every CG dot and line-search sum stays per plane. Each component
keeps its own early stop: the loop runs the iterations with a
per-component done mask and freezes a finished component (torch.where),
which equals the reference's vmapped while_loop. On the card a float32
solve runs that loop as the ops.cg early-stopping kernel (cg_unwrap:
its own DCT passes where both sides are powers of two from 128 to 8192,
core.fourier's DCT pair between its launches elsewhere); float64, the
CPU and the row-sharded seam run it in torch (ops.cg.cg_unwrap_plain),
its preconditioner's 2D DCTs through core.fourier, which routes 4096-
and 8192-long float32 axes to the ops.dct kernels.

The multigrid keeps every plane (..., n, m) with a structurally zero
last column (x-diffs) or row (y-diffs), so neighbour shifts are cyclic
rolls whose wrap-around terms vanish: the arithmetic equals the
reference stencils entry for entry. Its CG solves route as the
reference's ``_cg_kernel_ok`` does: float32 levels with sides that are
multiples of 128 and at most 1024 go to the ops.cg kernel (fixed
iteration count; the guarded coefficients make post-convergence
iterations no-ops), every other level to the early-stopping loop (the
kernel above, on the card). The
V-branch stencil passes run in the ops.vcycle kernels where
``vcycle_kernel_ok`` holds (the reference's ``_vcycle_kernel_ok``) and
in their plain twins, the reference's XLA stencils, elsewhere.

The reference's seam for the row-sharded solver is kept: ``_cg_unwrap``
takes a ``precond`` override of the DCT preconditioner and
``phase_unwrap_prediff_mg`` a ``precond_factory`` (level shape ->
precond); either turns the CG and V-branch kernels off, as the
reference does. The multigrid's row-axis primitives (the rolls, the
last-row masks, the block means and upsampling along rows, every dot,
norm and line-search sum) take one optional row context ``rows`` (a
core.rows.RowBlock): the planes are then this rank's block of the rows
and those primitives exchange one halo row with the adjacent ranks or
all-reduce over the group (parallel/unwrap.py). With ``rows=None`` they
are the single-device torch calls. Each early stop reads all-reduced
norms, so every rank runs the same iterations.
"""

import torch

from ..config import DEFAULTS
from ..core.fourier import dct2n, idct2n
from ..core.mathtools import wrap_to_pi
from ..core.rows import clamped_neighbours, plane_sum, roll_rows
from ..ops import cg as _cg
from ..ops import vcycle as _vcycle
from ..ops.cg import poisson_scale

_JACOBI_OMEGA = 0.8   # damped-Jacobi factor (2D optimum 4/5)


def stamp(events, name):
    """Append (name, recorded CUDA timing event) to `events` when it is
    a list (stage timing on the card); no-op when it is None."""
    if events is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))


def solve_poisson(rho, scale=None):
    """Solve the Neumann Poisson equation P phi = rho by DCT (the
    unweighted preconditioner of the CG)."""
    if scale is None:
        scale = poisson_scale(*rho.shape[-2:], rho.dtype, rho.device)
    return idct2n(dct2n(rho) / scale)


_diff0 = _cg._diff0
_apply_q = _cg.apply_q_unaligned


def _residual(dx, dy, weight):
    """WWx, WWy (eq. 34 min-neighbour weighting) and the initial
    residual from wrapped phase diffs dx (..., n, m-1), dy (..., n-1,
    m); weight (..., n, m) or None (unweighted)."""
    if weight is None:
        WWx = torch.ones_like(dx)
        WWy = torch.ones_like(dy)
        WWdx, WWdy = dx, dy
    else:
        WW = weight * weight
        WWx = torch.minimum(WW[..., :, :-1], WW[..., :, 1:])
        WWy = torch.minimum(WW[..., :-1, :], WW[..., 1:, :])
        WWdx = WWx * dx
        WWdy = WWy * dy
    return _diff0(WWdx, -1) + _diff0(WWdy, -2), WWx, WWy


def cg_kernel_ok(shape, dtype):
    """The reference's _cg_kernel_ok read for the card: a float32 level
    whose sides the CG kernel takes (multiples of 128, at most
    ops.cg.MAX_SIDE)."""
    n, m = shape[-2:]
    return dtype == torch.float32 and _cg.supported(n, m)


def cg_unwrap_kernel_ok(shape, dtype):
    """Whether a solve that the reference runs as its early-stopping loop
    (pygpa_tpu's _cg_unwrap_body) takes the ops.cg early-stopping kernel
    on the card: float32 and a shape ops.cg.unwrap_supported admits
    (sides 2 ... 8192, at most 65535 planes)."""
    return dtype == torch.float32 and _cg.unwrap_supported(shape)


def _cg_unwrap(rk0, WWx, WWy, kmax, aligned=False, precond=None, rows=None):
    """PCG on the weighted Poisson system from phi = 0. Returns (phi,
    iterations per batch element). Aligned (multigrid) solves that
    cg_kernel_ok admits run the ops.cg fixed-iteration kernel for kmax
    iterations, as the reference's _cg_kernel_ok routes them; every
    other solve is the reference's early-stopping loop, on the ops.cg
    early-stopping kernel where cg_unwrap_kernel_ok holds (its wrapper
    runs the twin on a CPU tensor) and as the torch loop otherwise.
    `precond` (a callable rk -> zk) replaces the DCT preconditioner and
    keeps the kernels off, as the reference's does; `rows`
    (core.rows.RowBlock) solves on this rank's block of the rows
    (aligned planes only), on the torch loop."""
    kmax = int(kmax)
    if precond is None and rows is None:
        if aligned and kmax >= 1 and cg_kernel_ok(rk0.shape, rk0.dtype):
            phi = _cg.cg_poisson(rk0, WWx, WWy, kmax)
            return phi, torch.full(rk0.shape[:-2], kmax, dtype=torch.int32,
                                   device=rk0.device)
        if cg_unwrap_kernel_ok(rk0.shape, rk0.dtype):
            return _cg.cg_unwrap(rk0, WWx, WWy, kmax, aligned)
    return _cg.cg_unwrap_plain(rk0, WWx, WWy, kmax, aligned, precond, rows)


def phase_unwrap(psi, weight=None, kmax=DEFAULTS.unwrap_kmax,
                 return_iters=False):
    """Unwrap the phase image psi (..., n, m) given weight (the
    magnitude of a complex lock-in signal); batched over leading axes.
    With return_iters=True also returns the CG iteration count per
    batch element."""
    dx = wrap_to_pi(torch.diff(psi, dim=-1))
    dy = wrap_to_pi(torch.diff(psi, dim=-2))
    rk, WWx, WWy = _residual(dx, dy, weight)
    phi, k = _cg_unwrap(rk, WWx, WWy, kmax)
    return (phi, k) if return_iters else phi


def phase_unwrap_prediff(dx, dy, weight=None, kmax=DEFAULTS.unwrap_kmax,
                         return_iters=False, events=None):
    """Unwrap from phase gradients dx = diff(psi, -1) (..., n, m-1) and
    dy = diff(psi, -2) (..., n-1, m) with the exact early-stopping CG;
    weight (..., n, m) broadcasts against the batch (module docstring).
    `events` (a list) collects a CUDA timing event after the solve."""
    dx = wrap_to_pi(dx)
    dy = wrap_to_pi(dy)
    rk, WWx, WWy = _residual(dx, dy, weight)
    phi, k = _cg_unwrap(rk, WWx, WWy, kmax)
    stamp(events, "unwrap")
    return (phi, k) if return_iters else phi


def phase_unwrap_mg(psi, weight=None, kmax=10, coarse=4, **kw):
    """Multigrid-accelerated phase_unwrap (pygpa_tpu.solvers.unwrap.
    phase_unwrap_mg): the phase image psi (..., n, m) is differenced and
    integrated by phase_unwrap_prediff_mg against `weight` (n, m); with
    no weight the unwrap is one exact Poisson solve of the wrapped
    differences."""
    dx = torch.diff(psi, dim=-1)
    dy = torch.diff(psi, dim=-2)
    if weight is None:
        rk, _, _ = _residual(wrap_to_pi(dx), wrap_to_pi(dy), None)
        return solve_poisson(rk)
    return phase_unwrap_prediff_mg(dx, dy, weight, kmax=int(kmax),
                                   coarse=coarse, **kw)


def _mask_last(a, axis, rows=None):
    """Zero the last slice along `axis` (along rows with `rows`: the
    global last row, on the last rank)."""
    out = a.clone()
    if axis == -2 and rows is not None and not rows.last:
        return out
    out.select(axis, a.shape[axis] - 1).zero_()
    return out


def _pad_last(a, axis):
    """Append one zero slice along `axis` ((n, m-1) -> aligned (n, m))."""
    shape = list(a.shape)
    shape[axis] = 1
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _residual_aligned(dxp, dyp, weight, rows=None):
    """Weighted residual rk and aligned min-neighbour weights WWx/WWy
    (zero last column / row) from aligned diffs; weight None is the
    unweighted problem (WWx, WWy ones but for the zero tails)."""
    if weight is None:
        WWx = _mask_last(torch.ones_like(dxp), -1)
        WWy = _mask_last(torch.ones_like(dyp), -2, rows)
    else:
        WW = weight * weight
        WWx = _mask_last(torch.minimum(WW, torch.roll(WW, -1, -1)), -1)
        WWy = _mask_last(torch.minimum(WW, roll_rows(WW, -1, rows)), -2,
                         rows)
    WWdx = WWx * dxp
    WWdy = WWy * dyp
    rk = (WWdx - torch.roll(WWdx, 1, -1)
          + WWdy - roll_rows(WWdy, 1, rows))
    return rk, WWx, WWy


def _avg_right(m_in, cols, c, dtype=torch.float32, device=None):
    """(m_in, cols) right-multiplication block-averaging matrix."""
    i = torch.arange(m_in, device=device)[:, None]
    j = torch.arange(cols, device=device)[None, :]
    # torch.full, not torch.tensor: a host value copied to the card would
    # wait for the stream, stalling the host behind the queued work
    return torch.where(i // c == j,
                       torch.full((), 1.0 / c, dtype=dtype, device=device),
                       torch.zeros((), dtype=dtype, device=device))


def _resize_right(m_in, m_out, dtype=torch.float32, device=None):
    """(m_in, m_out) right-multiplication linear-interpolation matrix
    (half-pixel centres, edge clamp)."""
    scale = m_in / m_out
    pos = (torch.arange(m_out, dtype=dtype, device=device) + 0.5) \
        * scale - 0.5
    lo = torch.clamp(torch.floor(pos), 0, m_in - 1)
    hi = torch.clamp(lo + 1, 0, m_in - 1)
    t = torch.clamp(pos - lo, 0.0, 1.0)
    i = torch.arange(m_in, dtype=dtype, device=device)[:, None]
    return ((i == lo[None, :]) * (1.0 - t)[None, :]
            + (i == hi[None, :]) * t[None, :]).to(dtype)


def block_mean(a, rows, cols, c):
    """Average c x c blocks over the last two axes: rows by reshape-mean,
    columns by the averaging product. On a row block whose rows c
    divides, the row means are the block's own."""
    a = a[..., : rows * c, : cols * c]
    a = a.reshape(a.shape[:-2] + (rows, c, cols * c)).mean(-2)
    return a @ _avg_right(cols * c, cols, c, a.dtype, a.device)


def upsample(phi, nc, mc, rows=None):
    """Linear resize of the last two axes to (nc, mc): integer-factor
    rows as a shifted-plane interleave (the resize's own samples),
    columns by the interpolation product. With `rows` phi is this rank's
    block and nc its block's rows after the resize, an integer factor
    of its rows (the taps beyond the block come from the adjacent
    ranks)."""
    dt = phi.dtype
    rin = phi.shape[-2]
    if rows is not None and (nc % rin or nc < rin):
        raise ValueError(f"a row-sharded upsample takes integer factors "
                         f"(block rows {rin} -> {nc})")
    if nc % rin == 0 and nc // rin > 1:
        cfac = nc // rin
        prev, nxt = clamped_neighbours(phi, rows)
        pieces = []
        for j in range(cfac):
            o = (j + 0.5) / cfac - 0.5
            if o < 0:
                t = torch.full((), 1.0 + o, dtype=dt, device=phi.device)
                pieces.append((1 - t) * prev + t * phi)
            else:
                t = torch.full((), o, dtype=dt, device=phi.device)
                pieces.append((1 - t) * phi + t * nxt)
        phi = torch.stack(pieces, dim=-2).reshape(
            phi.shape[:-2] + (rin * cfac, phi.shape[-1]))
    elif rin != nc:
        phi = (_resize_right(rin, nc, dt, phi.device).T @ phi)
    if phi.shape[-1] != mc:
        phi = phi @ _resize_right(phi.shape[-1], mc, dt, phi.device)
    return phi


def default_schedule(n, m, kmax, coarse, refine_iters=3):
    """((factor, iters), ...) coarsest -> finest, as the reference
    builds it: the mid level (coarse//2) is skipped ("auto") once it
    would be >= 1024 px, and the finest level is the V-branch."""
    c = int(coarse)
    if c < 4:
        return ((c, int(kmax)), (1, int(refine_iters)))
    mid_cfg = DEFAULTS.unwrap_mg_mid
    if mid_cfg == "auto":
        mid_iters = 0 if min(n, m) // (c // 2) >= 1024 else 1
    else:
        mid_iters = int(mid_cfg)
    mid = ((c // 2, mid_iters),) if mid_iters else ()
    return ((c, int(kmax)),) + mid + ((1, DEFAULTS.unwrap_mg_final),)


def phase_unwrap_prediff_mg(dx, dy, weight=None, kmax=10, coarse=4,
                            refine_iters=3, precision=None, schedule=None,
                            precond_factory=None, v_coarse_mult=4,
                            events=None, rows=None):
    """Multigrid-accelerated gradient integration (reference
    pygpa_tpu.solvers.unwrap.phase_unwrap_prediff_mg, aligned kernel
    route): coarse weighted-Poisson CG solve, then progressively finer
    levels, each polishing the upsampled solution: int iterations of CG
    on the residual gradients, or the V-branch, "v" (damped-Jacobi
    pre-smooth, coarse-grid correction on the grid v_coarse_mult times
    coarser with an exact line search, Jacobi post-smooth) or "vv" (a
    second correct-and-smooth round on the updated residual).

    dx : (..., n, m-1) and dy : (..., n-1, m) phase differences (or
    already aligned (..., n, m)); weight : (..., n, m) broadcasting
    against the batch (the module docstring), or None for the
    unweighted problem. schedule : ((factor, iters),
    ...) coarsest -> finest, default_schedule's when None. `events` (a
    list) collects CUDA timing events per level.

    precond_factory : the reference's seam, a callable (level rows,
    level cols) -> precond (rk -> zk) replacing each level's DCT
    preconditioner; with it the CG and V-branch kernels are off, as in
    the reference. precision : the reference's MXU pass split, accepted
    and unused (the products here run in the planes' dtype).
    rows : a core.rows.RowBlock: dx, dy (aligned) and weight are this
    rank's block of the rows of planes (..., n, m) split evenly over the
    row group, every level's factor divides the block's rows, and the
    factory's preconditioners act on row blocks
    (parallel/unwrap.py); the result is this rank's block."""
    del precision
    if rows is not None and precond_factory is None:
        raise ValueError("a row-sharded multigrid needs a precond_factory "
                         "whose preconditioners act on row blocks")
    dx = wrap_to_pi(dx)
    dy = wrap_to_pi(dy)
    n_loc = dx.shape[-2]
    world = 1 if rows is None else rows.world
    n = n_loc * world
    m = dy.shape[-1]
    if rows is not None and tuple(dx.shape[-2:]) != tuple(dy.shape[-2:]):
        raise ValueError("a row-sharded multigrid takes aligned (..., n, m) "
                         f"planes, got dx {tuple(dx.shape)}, dy "
                         f"{tuple(dy.shape)}")
    if schedule is None:
        schedule = default_schedule(n, m, kmax, coarse, refine_iters)
    if rows is not None:
        factors = {int(c) for c, _ in schedule} | {
            int(v_coarse_mult) * int(c) for c, it in schedule
            if isinstance(it, str)}
        if any(n_loc % c for c in factors):
            raise ValueError(f"row-sharded multigrid: the block's {n_loc} "
                             f"rows are not a multiple of every level "
                             f"factor {sorted(factors)}")
    dxp = _pad_last(dx, -1) if dx.shape[-1] == m - 1 else dx
    dyp = _pad_last(dy, -2) if dy.shape[-2] == n_loc - 1 else dy

    def level_data(c):
        if c == 1:
            return dxp, dyp, weight
        nc, mc = n_loc // c, m // c
        # coarse differences = c * block-averaged fine differences (no
        # re-wrapping); the last coarse column/row mixes pad values and
        # is masked back to the structural zero
        dxyc = block_mean(torch.stack([dxp, dyp], 0), nc, mc, c) * c
        wc = None if weight is None else block_mean(weight, nc, mc, c)
        return _mask_last(dxyc[0], -1), _mask_last(dxyc[1], -2, rows), wc

    def precond(c):
        return None if precond_factory is None \
            else precond_factory((n // c, m // c))

    phi = None
    for c, iters in schedule:
        c = int(c)
        dxc, dyc, wc = level_data(c)
        nc, mc = n_loc // c, m // c
        if phi is None:
            rk, WWx, WWy = _residual_aligned(dxc, dyc, wc, rows)
            phi, _ = _cg_unwrap(rk, WWx, WWy, iters, aligned=True,
                                precond=precond(c), rows=rows)
            stamp(events, "unwrap_coarse")
            continue
        phi = upsample(phi, nc, mc, rows)
        if isinstance(iters, str):
            if iters not in ("v", "vv"):
                raise ValueError(
                    f"schedule iters must be an int, 'v' or 'vv' (got "
                    f"{iters!r}); check DEFAULTS.unwrap_mg_final")
            cv = int(v_coarse_mult) * c
            phi = phi + _v_branch(phi, dxc, dyc, wc, int(v_coarse_mult),
                                  level_data(cv), kmax,
                                  2 if iters == "vv" else 1,
                                  precond(cv), rows)
            stamp(events, "unwrap_v")
            continue
        # residual gradients are small and unwrapped by construction
        rdx = dxc - _mask_last(torch.roll(phi, -1, -1) - phi, -1)
        rdy = dyc - _mask_last(roll_rows(phi, -1, rows) - phi, -2, rows)
        if iters > 0:
            rk, WWx, WWy = _residual_aligned(rdx, rdy, wc, rows)
            dphi, _ = _cg_unwrap(rk, WWx, WWy, iters, aligned=True,
                                 precond=precond(c), rows=rows)
            phi = phi + dphi
        stamp(events, f"unwrap_level{c}")
    if int(schedule[-1][0]) != 1:
        phi = upsample(phi, n_loc, m, rows)
    return phi


def _v_branch(phi, dxc, dyc, wc, cv, coarse_data, kmax, rounds,
              precond=None, rows=None):
    """The V-branch's update d of phi on its level (..., nc, mc):
    damped-Jacobi pre-smooth, then `rounds` times a coarse-grid
    correction of the residual on the level cv times coarser
    (`coarse_data`: its differences and weight; an exact energy line
    search along the correction) and a Jacobi smooth, the residual
    updated between rounds. On the finest level this is the reference's
    V-branch; the reference restricts by the finest level's sides, so it
    runs the branch on that level only. The pre-smooth and Q p run in
    the ops.vcycle kernels where vcycle_kernel_ok holds (weighted levels
    only, as the reference gates them, and without a `precond` for the
    correction's CG) and in their twins elsewhere;
    the unweighted level hands the twins weights of ones, whose
    min-neighbour weights are the unweighted problem's. `rows` as
    phase_unwrap_prediff_mg takes it."""
    nc, mc = phi.shape[-2:]
    if wc is not None and precond is None \
            and _vcycle.vcycle_kernel_ok(phi, wc, cv):
        presmooth, applyq = _vcycle.presmooth, _vcycle.applyq
    else:
        def presmooth(*a):
            return _vcycle.presmooth_plain(*a, rows=rows)

        def applyq(p, w):
            return _vcycle.applyq_plain(p, w, rows=rows)
    if wc is None:
        wc = torch.ones((nc, mc), dtype=phi.dtype, device=phi.device)
    # fused pre-smooth: residual gradients, weights, residual, Jacobi
    # diagonal, d = Dinv rk, r = rk - Q d, and the row half of the
    # restriction of r
    r, d, Dinv, rrow = presmooth(phi, dxc, dyc, wc, cv, _JACOBI_OMEGA)
    _, WWxv, WWyv = _residual_aligned(*coarse_data, rows)
    vk = int(kmax) if DEFAULTS.unwrap_mg_v_kmax is None \
        else int(DEFAULTS.unwrap_mg_v_kmax)
    one = torch.ones((), dtype=phi.dtype, device=phi.device)
    for j in range(rounds):
        # the restriction of r: the pre-smooth's row means finished by
        # the column-averaging product, then block means of the update
        if j == 0:
            r2c = rrow @ _avg_right(mc, mc // cv, cv, rrow.dtype,
                                    rrow.device)
        else:
            r2c = block_mean(r, nc // cv, mc // cv, cv)
        dcor, _ = _cg_unwrap(r2c, WWxv, WWyv, vk, aligned=True,
                             precond=precond, rows=rows)
        dcu = upsample(dcor, nc, mc, rows)
        q = applyq(dcu, wc)
        num = plane_sum(r * dcu, rows)
        den = plane_sum(dcu * q, rows)
        alpha = torch.where(den != 0, num / torch.where(den != 0, den, one),
                            torch.zeros_like(den))
        d = d + alpha * dcu
        r = r - alpha * q
        s = r * Dinv
        d = d + s
        if j < rounds - 1:
            r = r - applyq(s, wc)
    return d


# --- the reference's phase_unwrap API-parity names -----------------------

def _wrapToPi(x):
    """wrap_to_pi under the reference's name."""
    return wrap_to_pi(x)


def phase_unwrap_ref(psi, weight=None, kmax=DEFAULTS.unwrap_kmax):
    """The reference's non-precomputed variant: the same solver."""
    return phase_unwrap(psi, weight, kmax)


def phase_unwrap_ref_prediff(dx, dy, weight=None, kmax=DEFAULTS.unwrap_kmax):
    """The reference's non-precomputed prediff variant: the same
    solver."""
    return phase_unwrap_prediff(dx, dy, weight, kmax)


def solvePoisson(rho):
    """solve_poisson under the reference's name."""
    return solve_poisson(rho)


def precomp_Poissonscaling(rho):
    """The DCT eigenvalues solvePoisson_precomped divides by, for rho's
    last two axes."""
    return poisson_scale(*rho.shape[-2:], rho.dtype, rho.device)


def solvePoisson_precomped(rho, scale):
    """solve_poisson with precomputed eigenvalues."""
    return solve_poisson(rho, scale)


def applyQ(p, WWx, WWy):
    """The weighted transformation A^T W^T W A p on unaligned weights
    WWx (..., n, m-1), WWy (..., n-1, m)."""
    return _apply_q(p, WWx, WWy)
