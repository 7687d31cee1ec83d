"""Weighted 2D phase unwrapping by multigrid-accelerated PCG
(counterpart of the aligned-form subset of pygpa_tpu/solvers/unwrap.py:
``phase_unwrap_prediff_mg`` with its default schedule, which the
production displacement extractor runs).

Every plane is kept (..., n, m) with a structurally zero last column
(x-diffs) or row (y-diffs), so neighbour shifts are cyclic rolls whose
wrap-around terms vanish: the arithmetic equals the reference
Ghiglia-Romero stencils entry for entry. Leading axes are batch axes
(the two displacement components); weights are one shared (n, m)
plane. The CG solves run in ops.cg with a fixed iteration count (the
guarded coefficients make post-convergence iterations no-ops, so the
reference's early stop changes nothing), the V-branch stencil passes
in ops.vcycle.
"""

import torch

from ..config import DEFAULTS
from ..core.mathtools import wrap_to_pi
from ..ops import cg as _cg
from ..ops import vcycle as _vcycle

_JACOBI_OMEGA = 0.8   # damped-Jacobi factor (2D optimum 4/5)
_V_COARSE_MULT = 4    # V-branch correction grid: finest level / 4


def stamp(events, name):
    """Append (name, recorded CUDA timing event) to `events` when it is
    a list (stage timing on the card); no-op when it is None."""
    if events is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))


def _mask_last(a, axis):
    """Zero the last slice along `axis`."""
    out = a.clone()
    out.select(axis, a.shape[axis] - 1).zero_()
    return out


def _pad_last(a, axis):
    """Append one zero slice along `axis` ((n, m-1) -> aligned (n, m))."""
    shape = list(a.shape)
    shape[axis] = 1
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _residual_aligned(dxp, dyp, weight):
    """Weighted residual rk and aligned min-neighbour weights WWx/WWy
    (zero last column / row) from aligned diffs."""
    WW = weight * weight
    WWx = _mask_last(torch.minimum(WW, torch.roll(WW, -1, -1)), -1)
    WWy = _mask_last(torch.minimum(WW, torch.roll(WW, -1, -2)), -2)
    WWdx = WWx * dxp
    WWdy = WWy * dyp
    rk = (WWdx - torch.roll(WWdx, 1, -1)
          + WWdy - torch.roll(WWdy, 1, -2))
    return rk, WWx, WWy


def _avg_right(m_in, cols, c, dtype=torch.float32, device=None):
    """(m_in, cols) right-multiplication block-averaging matrix."""
    i = torch.arange(m_in, device=device)[:, None]
    j = torch.arange(cols, device=device)[None, :]
    return torch.where(i // c == j,
                       torch.tensor(1.0 / c, dtype=dtype, device=device),
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
    columns by the averaging product."""
    a = a[..., : rows * c, : cols * c]
    a = a.reshape(a.shape[:-2] + (rows, c, cols * c)).mean(-2)
    return a @ _avg_right(cols * c, cols, c, a.dtype, a.device)


def upsample(phi, nc, mc):
    """Linear resize of the last two axes to (nc, mc): integer-factor
    rows as a shifted-plane interleave (the resize's own samples),
    columns by the interpolation product."""
    dt = phi.dtype
    rin = phi.shape[-2]
    if nc % rin == 0 and nc // rin > 1:
        cfac = nc // rin
        prev = torch.cat([phi[..., :1, :], phi[..., :-1, :]], dim=-2)
        nxt = torch.cat([phi[..., 1:, :], phi[..., -1:, :]], dim=-2)
        pieces = []
        for j in range(cfac):
            o = (j + 0.5) / cfac - 0.5
            if o < 0:
                t = torch.tensor(1.0 + o, dtype=dt, device=phi.device)
                pieces.append((1 - t) * prev + t * phi)
            else:
                t = torch.tensor(o, dtype=dt, device=phi.device)
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


def phase_unwrap_prediff_mg(dx, dy, weight, kmax=10, coarse=4,
                            refine_iters=3, events=None):
    """Multigrid-accelerated gradient integration (reference
    pygpa_tpu.solvers.unwrap.phase_unwrap_prediff_mg, aligned kernel
    route): coarse weighted-Poisson CG solve, then progressively finer
    levels; the finest level runs the V-branch (damped-Jacobi
    pre-smooth, coarse-grid correction with an exact line search,
    Jacobi post-smooth).

    dx : (..., n, m-1) and dy : (..., n-1, m) phase differences (or
    already aligned (..., n, m)); weight : (n, m) shared by the batch.
    `events` (a list) collects CUDA timing events per level."""
    if weight is None:
        raise NotImplementedError(
            "phase_unwrap_prediff_mg: the unweighted multigrid unwrap is "
            "not ported (ROADMAP queue 1)")
    dx = wrap_to_pi(dx)
    dy = wrap_to_pi(dy)
    n = dx.shape[-2]
    m = dy.shape[-1]
    schedule = default_schedule(n, m, kmax, coarse, refine_iters)
    dxp = _pad_last(dx, -1) if dx.shape[-1] == m - 1 else dx
    dyp = _pad_last(dy, -2) if dy.shape[-2] == n - 1 else dy

    def level_data(c):
        if c == 1:
            return dxp, dyp, weight
        nc, mc = n // c, m // c
        # coarse differences = c * block-averaged fine differences (no
        # re-wrapping); the last coarse column/row mixes pad values and
        # is masked back to the structural zero
        dxyc = block_mean(torch.stack([dxp, dyp], 0), nc, mc, c) * c
        return (_mask_last(dxyc[0], -1), _mask_last(dxyc[1], -2),
                block_mean(weight, nc, mc, c))

    phi = None
    for c, iters in schedule:
        c = int(c)
        dxc, dyc, wc = level_data(c)
        nc, mc = n // c, m // c
        if phi is None:
            rk, WWx, WWy = _residual_aligned(dxc, dyc, wc)
            phi = _cg.cg_poisson(rk, WWx, WWy, int(iters))
            stamp(events, "unwrap_coarse")
            continue
        phi = upsample(phi, nc, mc)
        if isinstance(iters, str):
            if iters != "v":
                raise NotImplementedError(
                    f"unwrap_mg_final={iters!r}: only the 'v' branch is "
                    "ported (ROADMAP queue 1)")
            cv = _V_COARSE_MULT * c
            # fused pre-smooth: residual gradients, weights, residual,
            # Jacobi diagonal, d = Dinv rk, r = rk - Q d, and the row
            # half of the restriction of r
            r, d, Dinv, rrow = _vcycle.presmooth(phi, dxc, dyc, wc, cv,
                                                 _JACOBI_OMEGA)
            dxv, dyv, wv = level_data(cv)
            _, WWxv, WWyv = _residual_aligned(dxv, dyv, wv)
            vk = int(kmax) if DEFAULTS.unwrap_mg_v_kmax is None \
                else int(DEFAULTS.unwrap_mg_v_kmax)
            # coarse-grid correction of the smoothed residual (the
            # kernel's row means finished by the column-averaging
            # product), exact energy line search, Jacobi post-smooth
            r2c = rrow @ _avg_right(mc, mc // cv, cv, rrow.dtype,
                                    rrow.device)
            dcu = upsample(_cg.cg_poisson(r2c, WWxv, WWyv, vk), nc, mc)
            q = _vcycle.applyq(dcu, wc)
            num = (r * dcu).sum((-2, -1), keepdim=True)
            den = (dcu * q).sum((-2, -1), keepdim=True)
            one = torch.ones((), dtype=den.dtype, device=den.device)
            alpha = torch.where(den != 0,
                                num / torch.where(den != 0, den, one),
                                torch.zeros_like(den))
            d = d + alpha * dcu
            r = r - alpha * q
            phi = phi + (d + r * Dinv)
            stamp(events, "unwrap_v")
            continue
        # residual gradients are small and unwrapped by construction
        rdx = dxc - _mask_last(torch.roll(phi, -1, -1) - phi, -1)
        rdy = dyc - _mask_last(torch.roll(phi, -1, -2) - phi, -2)
        if iters > 0:
            rk, WWx, WWy = _residual_aligned(rdx, rdy, wc)
            phi = phi + _cg.cg_poisson(rk, WWx, WWy, int(iters))
        stamp(events, f"unwrap_level{c}")
    return phi
