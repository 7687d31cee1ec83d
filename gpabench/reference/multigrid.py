"""The factory's multigrid integration (unwrap_coarse), in plain PyTorch,
float64: the weighted least-squares integral of a gradient field, solved
approximately as the configuration states it, so that the reference gives
the same approximate answer from the same data.

Gradients dx (..., n, m-1) along the last axis and dy (..., n-1, m) along
the one before are padded with a zero last column and row; the squared
weight norm w^2 gives each difference the smaller weight of its two
pixels. The schedule, coarsest first:

1. `kmax` conjugate-gradient iterations from zero on the grid `coarse`
   times coarser (differences: c times the c x c block means; weights the
   block means), preconditioned by the Neumann Laplacian's DCT inverse;
2. a level `coarse // 2` times coarser with one CG iteration, only while
   that grid is under 1024 px;
3. on the full grid, after a linear upsampling (half-pixel centres, edge
   rows and columns repeated): a V-branch, damped Jacobi (omega 0.8) on
   the residual, the residual's block means on the grid `v_mult` times
   coarser, `v_kmax` CG iterations there, the upsampled correction added
   along an exact line search, and a Jacobi step.
"""
import torch

from .gpa import F64, _dct, _idct

OMEGA = 0.8


def _roll(x, s, dim):
    return torch.roll(x, s, dim)


def _lane_row_masks(n, m, device):
    lane = torch.arange(m, device=device)[None, :] < m - 1
    row = torch.arange(n, device=device)[:, None] < n - 1
    return lane, row


def weights(w):
    """(Wx, Wy): min-neighbour squared weights, zero on the last column
    and row."""
    n, m = w.shape[-2:]
    lane, row = _lane_row_masks(n, m, w.device)
    WW = w * w
    Wx = torch.where(lane, torch.minimum(WW, _roll(WW, -1, -1)), 0.0)
    Wy = torch.where(row, torch.minimum(WW, _roll(WW, -1, -2)), 0.0)
    return Wx, Wy


def q(p, Wx, Wy):
    """-D^T W D p on the padded grid."""
    tx = Wx * (_roll(p, -1, -1) - p)
    ty = Wy * (_roll(p, -1, -2) - p)
    return tx - _roll(tx, 1, -1) + ty - _roll(ty, 1, -2)


def rhs(dx, dy, Wx, Wy):
    """-D^T W d of padded differences."""
    a, b = Wx * dx, Wy * dy
    return a - _roll(a, 1, -1) + b - _roll(b, 1, -2)


def cg(r0, Wx, Wy, iters):
    """`iters` preconditioned CG iterations on q(phi) = r0 from zero."""
    n, m = r0.shape[-2:]
    i = torch.arange(n, dtype=F64, device=r0.device)[:, None]
    j = torch.arange(m, dtype=F64, device=r0.device)[None, :]
    scale = 2 * (torch.cos(torch.pi * i / n) + torch.cos(torch.pi * j / m)
                 - 2)
    scale[0, 0] = 1.0
    phi = torch.zeros_like(r0)
    r, p, rz_prev = r0, None, None
    dims = (-2, -1)
    for k in range(int(iters)):
        z = _idct(_idct(_dct(_dct(r, -1), -2) / scale, -2), -1)
        rz = (r * z).sum(dims, keepdim=True)
        p = z if k == 0 else z + torch.where(
            rz_prev != 0, rz / torch.where(rz_prev != 0, rz_prev, 1.0),
            0.0) * p
        qp = q(p, Wx, Wy)
        pq = (p * qp).sum(dims, keepdim=True)
        alpha = torch.where(pq != 0, rz / torch.where(pq != 0, pq, 1.0),
                            0.0)
        phi = phi + alpha * p
        r = r - alpha * qp
        rz_prev = rz
    return phi


def block_mean(a, c):
    n, m = a.shape[-2:]
    nc, mc = n // c, m // c
    a = a[..., : nc * c, : mc * c]
    return a.reshape(a.shape[:-2] + (nc, c, mc, c)).mean((-3, -1))


def resize_matrix(n_in, n_out, device):
    """(n_out, n_in) linear interpolation, half-pixel centres, edge
    clamp."""
    pos = (torch.arange(n_out, dtype=F64, device=device) + 0.5) \
        * (n_in / n_out) - 0.5
    lo = torch.clamp(torch.floor(pos), 0, n_in - 1)
    hi = torch.clamp(lo + 1, 0, n_in - 1)
    t = torch.clamp(pos - lo, 0.0, 1.0)
    i = torch.arange(n_in, dtype=F64, device=device)[None, :]
    return (i == lo[:, None]) * (1 - t)[:, None] \
        + (i == hi[:, None]) * t[:, None]


def upsample(phi, n, m):
    R = resize_matrix(phi.shape[-2], n, phi.device)
    C = resize_matrix(phi.shape[-1], m, phi.device)
    return R @ phi @ C.T


def level(dxp, dyp, w, c):
    """A level's padded differences and weight, c times coarser."""
    if c == 1:
        return dxp, dyp, w
    lane, row = _lane_row_masks(dxp.shape[-2] // c, dxp.shape[-1] // c,
                                dxp.device)
    return (torch.where(lane, block_mean(dxp, c) * c, 0.0),
            torch.where(row, block_mean(dyp, c) * c, 0.0),
            block_mean(w, c))


def v_branch(phi, dxp, dyp, w, coarse, v_kmax):
    """The V-branch's update of phi on the full grid."""
    n, m = phi.shape[-2:]
    lane, row = _lane_row_masks(n, m, phi.device)
    Wx, Wy = weights(w)
    rdx = dxp - torch.where(lane, _roll(phi, -1, -1) - phi, 0.0)
    rdy = dyp - torch.where(row, _roll(phi, -1, -2) - phi, 0.0)
    rk = rhs(rdx, rdy, Wx, Wy)
    D = -(Wx + _roll(Wx, 1, -1) + Wy + _roll(Wy, 1, -2))
    dinv = torch.where(D.abs() > 1e-8, OMEGA / torch.where(D != 0, D, 1.0),
                       0.0)
    d = rk * dinv
    r = rk - q(d, Wx, Wy)
    cdx, cdy, cw = level(dxp, dyp, w, coarse)
    cWx, cWy = weights(cw)
    dc = upsample(cg(block_mean(r, coarse), cWx, cWy, v_kmax), n, m)
    qd = q(dc, Wx, Wy)
    num = (r * dc).sum((-2, -1), keepdim=True)
    den = (dc * qd).sum((-2, -1), keepdim=True)
    alpha = torch.where(den != 0, num / torch.where(den != 0, den, 1.0), 0.0)
    d = d + alpha * dc
    r = r - alpha * qd
    return d + r * dinv


def integrate(dx, dy, w, coarse=4, kmax=6, v_mult=4, v_kmax=4):
    """The multigrid's phi (..., n, m) of the gradient (dx, dy) with the
    weight norm w (n, m)."""
    n, m = w.shape[-2:]
    dxp = torch.cat([dx, torch.zeros_like(dx[..., :1])], -1)
    dyp = torch.cat([dy, torch.zeros_like(dy[..., :1, :])], -2)
    c = int(coarse)
    schedule = [(c, kmax)]
    if c >= 4 and min(n, m) // (c // 2) < 1024:
        schedule.append((c // 2, 1))
    phi = None
    for f, iters in schedule:
        ldx, ldy, lw = level(dxp, dyp, w, f)
        Wx, Wy = weights(lw)
        if phi is None:
            phi = cg(rhs(ldx, ldy, Wx, Wy), Wx, Wy, iters)
            continue
        phi = upsample(phi, n // f, m // f)
        lane, row = _lane_row_masks(n // f, m // f, w.device)
        rdx = ldx - torch.where(lane, _roll(phi, -1, -1) - phi, 0.0)
        rdy = ldy - torch.where(row, _roll(phi, -1, -2) - phi, 0.0)
        phi = phi + cg(rhs(rdx, rdy, Wx, Wy), Wx, Wy, iters)
    phi = upsample(phi, n, m)
    return phi + v_branch(phi, dxp, dyp, w, v_mult * 1, v_kmax)
