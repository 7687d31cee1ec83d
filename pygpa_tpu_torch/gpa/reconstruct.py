"""Displacement-field reconstruction from the sweep's emitted gradients
(counterpart of pygpa_tpu/gpa/reconstruct.py: _integrate_uv and
reconstruct_u_inv_from_uv)."""
from ..config import DEFAULTS
from ..solvers.unwrap import phase_unwrap_prediff_mg


def _integrate_uv(dudx, dudy, wnorm, kmax=10, unwrap_coarse=None,
                  refine_iters=3, events=None):
    """Integrate the per-pixel displacement gradients dudx (2, n, m-1)
    and dudy (2, n-1, m): one weighted multigrid unwrap with the two
    displacement components as its batch axis and wnorm (n, m) as the
    shared weight."""
    if not unwrap_coarse:
        raise NotImplementedError(
            "only the multigrid unwrap (unwrap_coarse >= 1) is ported; "
            "the exact phase_unwrap_prediff CG path is ROADMAP queue 1 "
            "work")
    kmg = min(int(kmax), DEFAULTS.unwrap_kmax_mg)
    return phase_unwrap_prediff_mg(dudx, dudy, wnorm, kmax=kmg,
                                   coarse=unwrap_coarse,
                                   refine_iters=refine_iters, events=events)


def reconstruct_u_inv_from_uv(dudx_s, dudy_s, wnorm, kmax=10,
                              unwrap_coarse=None, refine_iters=3,
                              events=None):
    """Reconstruction from the sweep's SHIFTED displacement-gradient
    planes (2, n, m): position j holds the diff ending at j, so column 0
    of dudx_s and row 0 of dudy_s are dropped here."""
    return _integrate_uv(dudx_s[:, :, 1:], dudy_s[:, 1:, :], wnorm,
                         kmax=kmax, unwrap_coarse=unwrap_coarse,
                         refine_iters=refine_iters, events=events)
