"""Displacement-field reconstruction from GPA phases (counterpart of
pygpa_tpu/gpa/reconstruct.py: reconstruct_u_inv_from_phases,
reconstruct_u_inv_from_demod, _integrate_uv and
reconstruct_u_inv_from_uv).

Each route wrap-differences the phases, solves the per-pixel weighted
lstsq for the displacement gradients and integrates each component
with the weighted phase unwrapper; the two components are one batch of
the unwrap (a vmap in the reference)."""
import math

import torch

from ..config import DEFAULTS
from ..core.mathtools import wrap_to_pi
from ..ops.sweep import wrap_diff
from ..solvers.lstsq import weighted_lstsq_stack
from ..solvers.unwrap import (phase_unwrap_prediff, phase_unwrap_prediff_mg,
                              stamp)


def reconstruct_u_inv_from_phases(kvecs, phases, weights,
                                  weighted_unwrap=True, pre_diff=False,
                                  kmax=10, events=None):
    """Reconstruct u (2, n, m) from wrapped phases (G, n, m) and weights
    (G, n, m) along kvecs (G, 2): wrapped differences, per-pixel
    weighted lstsq, then the exact weighted unwrap of each component.
    With pre_diff, phases is (G, n, m, 2) holding the x- and y-diffs.
    `events` (a list) collects CUDA timing events after the lstsq and
    the unwrap."""
    K = (2 * math.pi) * torch.as_tensor(kvecs, dtype=phases.dtype,
                                        device=phases.device)
    if pre_diff:
        dbdx = wrap_to_pi(phases[..., 0])[:, :, :-1]
        dbdy = wrap_to_pi(phases[..., 1])[:, :-1]
    else:
        dbdx = wrap_to_pi(torch.diff(phases, dim=2))
        dbdy = wrap_to_pi(torch.diff(phases, dim=1))
    dudx = weighted_lstsq_stack(dbdx, K, weights[:, :, : dbdx.shape[2]])
    dudy = weighted_lstsq_stack(dbdy, K, weights[:, : dbdy.shape[1], :])
    stamp(events, "lstsq")
    if weighted_unwrap:
        wnorm = torch.linalg.vector_norm(weights, dim=0)
        return phase_unwrap_prediff(dudx, dudy, wnorm, kmax=kmax,
                                    events=events)
    return phase_unwrap_prediff(dudx, dudy, events=events)


def reconstruct_u_inv_from_demod(kvecs, phases_demod, weights, kmax=10,
                                 unwrap_coarse=None, refine_iters=3,
                                 events=None):
    """Reconstruction from demodulated phases (full phase =
    phases_demod + 2 pi k . r): the plane-wave ramp enters the wrapped
    differences as a constant per-axis shift, so no full-size rebase is
    needed. Equal to reconstruct_u_inv_from_phases on rebased phases.

    The differences wrap as the uv epilogue's do (ops.sweep.wrap_diff),
    not in the reference's (x + pi) form: each is near 2 pi k, and in
    float32 that form rounds it to the spacing at pi, a bias the unwrap
    integrates across the image (on the 4096^2 bench fixture it put the
    dc-free error over its 0.0012 px gate)."""
    K = (2 * math.pi) * torch.as_tensor(kvecs, dtype=phases_demod.dtype,
                                        device=phases_demod.device)
    dbdx = wrap_diff(torch.diff(phases_demod, dim=2) + K[:, 1, None, None])
    dbdy = wrap_diff(torch.diff(phases_demod, dim=1) + K[:, 0, None, None])
    dudx = weighted_lstsq_stack(dbdx, K, weights[:, :, : dbdx.shape[2]])
    dudy = weighted_lstsq_stack(dbdy, K, weights[:, : dbdy.shape[1], :])
    wnorm = torch.linalg.vector_norm(weights, dim=0)
    stamp(events, "lstsq")
    return _integrate_uv(dudx, dudy, wnorm, kmax=kmax,
                         unwrap_coarse=unwrap_coarse,
                         refine_iters=refine_iters, events=events)


def _integrate_uv(dudx, dudy, wnorm, kmax=10, unwrap_coarse=None,
                  refine_iters=3, events=None):
    """Integrate the per-pixel displacement gradients dudx (2, n, m-1)
    and dudy (2, n-1, m) with wnorm (n, m) as the shared weight: the
    multigrid unwrap when unwrap_coarse is set, the exact early-stopping
    CG otherwise."""
    if unwrap_coarse:
        kmg = min(int(kmax), DEFAULTS.unwrap_kmax_mg)
        return phase_unwrap_prediff_mg(dudx, dudy, wnorm, kmax=kmg,
                                       coarse=unwrap_coarse,
                                       refine_iters=refine_iters,
                                       events=events)
    return phase_unwrap_prediff(dudx, dudy, wnorm, kmax=kmax, events=events)


def reconstruct_u_inv_from_uv(dudx_s, dudy_s, wnorm, kmax=10,
                              unwrap_coarse=None, refine_iters=3,
                              events=None):
    """Reconstruction from the sweep's SHIFTED displacement-gradient
    planes (2, n, m): position j holds the diff ending at j, so column 0
    of dudx_s and row 0 of dudy_s are dropped here."""
    return _integrate_uv(dudx_s[:, :, 1:], dudy_s[:, 1:, :], wnorm,
                         kmax=kmax, unwrap_coarse=unwrap_coarse,
                         refine_iters=refine_iters, events=events)
