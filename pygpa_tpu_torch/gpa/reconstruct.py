"""Displacement-field reconstruction from GPA phases, and the iterative
k refinement (counterpart of pygpa_tpu/gpa/reconstruct.py).

The gradient routes wrap-difference the phases, solve the per-pixel
weighted lstsq for the displacement gradients and integrate each
component with the weighted phase unwrapper; the two components are one
batch of the unwrap (a vmap in the reference). reconstruct_u_inv solves
2 pi K u = b per pixel from unwrapped phases. iterate_GPA and refine_ks
refine k-vectors by lock-in, unwrap and plane fit, each round's peaks in
one batch (lock-ins, unwraps and fits alike), on the device without a
host sync."""
import math

import numpy as np
import torch

from ..config import DEFAULTS
from ..core import entry_tensor, host_to_device
from ..core.mathtools import fit_plane, wrap_to_pi
from ..ops.lockin import gpa_lockin_batch
from ..ops.sweep import wrap_diff
from ..solvers.lstsq import weighted_lstsq_stack
from ..solvers.unwrap import (phase_unwrap, phase_unwrap_prediff,
                              phase_unwrap_prediff_mg, stamp)


def myweighed_lstsq(b, K, w):
    """Per-pixel weighted lstsq, the reference's name for
    weighted_lstsq_stack."""
    return weighted_lstsq_stack(b, K, w)


def fit_delta_k(phases):
    """The k-correction of unwrapped phase maps (..., n, m): each plane
    fit's slope over 2 pi, (..., 2)."""
    return fit_plane(phases)[..., :2] / (2 * math.pi)


def reconstruct_u_inv(kvecs, b, weights=None, use_only_ks=None):
    """u (2, n, m) from unwrapped phases b (G, n, m) along kvecs (G, 2):
    b less its mean, then 2 pi K u = b per pixel, by weighted lstsq over
    all G (weights default to ones) or, with use_only_ks (two indices),
    by the inverse of those two rows of 2 pi K. The arithmetic runs in
    the promoted dtype of b and kvecs, as in JAX."""
    b = torch.as_tensor(b)
    kv = torch.as_tensor(np.asarray(kvecs)) if not isinstance(
        kvecs, torch.Tensor) else kvecs
    K = 2 * math.pi * kv.to(b.device)
    b = b - b.mean(dim=(-2, -1), keepdim=True)
    if use_only_ks is None:
        if weights is None:
            weights = torch.ones_like(b)
        return weighted_lstsq_stack(b, K, torch.as_tensor(weights,
                                                          device=b.device))
    assert len(use_only_ks) == 2
    dt = torch.promote_types(b.dtype, K.dtype)
    Kinv = torch.linalg.inv(K[list(use_only_ks)].to(dt))
    return torch.einsum("ij,j...->i...", Kinv,
                        b[list(use_only_ks)].to(dt))


def reconstruct_u_inv_from_phases(kvecs, phases, weights,
                                  weighted_unwrap=True, pre_diff=False,
                                  kmax=10, events=None):
    """Reconstruct u (2, n, m) from wrapped phases (G, n, m) and weights
    (G, n, m) along kvecs (G, 2): wrapped differences, per-pixel
    weighted lstsq, then the exact weighted unwrap of each component.
    With pre_diff, phases is (G, n, m, 2) holding the x- and y-diffs. A
    stack (B, G, n, m) gives (B, 2, n, m), each image unwrapped against
    its own weight norm and each component stopping on its own norm.
    `events` (a list) collects CUDA timing events after the lstsq and
    the unwrap."""
    if isinstance(kvecs, torch.Tensor):
        K = kvecs.to(phases.device, phases.dtype)
    else:
        K = host_to_device(np.asarray(kvecs), phases.device, phases.dtype)
    K = (2 * math.pi) * K
    # the peaks' axis leads for the lstsq; the solution's two components
    # go back beside the image axis
    pk = -4 if pre_diff else -3
    ph = phases.movedim(pk, 0)
    wt = weights.movedim(-3, 0)
    if pre_diff:
        dbdx = wrap_to_pi(ph[..., 0])[..., :-1]
        dbdy = wrap_to_pi(ph[..., 1])[..., :-1, :]
    else:
        dbdx = wrap_to_pi(torch.diff(ph, dim=-1))
        dbdy = wrap_to_pi(torch.diff(ph, dim=-2))
    dudx = weighted_lstsq_stack(dbdx, K, wt[..., : dbdx.shape[-1]])
    dudy = weighted_lstsq_stack(dbdy, K, wt[..., : dbdy.shape[-2], :])
    dudx, dudy = dudx.movedim(0, -3), dudy.movedim(0, -3)
    stamp(events, "lstsq")
    if weighted_unwrap:
        wnorm = torch.linalg.vector_norm(wt, dim=0)
        if wnorm.dim() > 2:
            wnorm = wnorm.unsqueeze(-3)  # (B, 1, n, m) beside (B, 2, ...)
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
    phases_demod and weights are (G, n, m), giving u (2, n, m), or a
    stack (B, G, n, m), giving (B, 2, n, m), each image with its own
    weight norm.

    The differences wrap as the uv epilogue's do (ops.sweep.wrap_diff),
    not in the reference's (x + pi) form: each is near 2 pi k, and in
    float32 that form rounds it to the spacing at pi, a bias the unwrap
    integrates across the image (on the 4096^2 bench fixture it put the
    dc-free error over its 0.0012 px gate)."""
    K = (2 * math.pi) * torch.as_tensor(kvecs, dtype=phases_demod.dtype,
                                        device=phases_demod.device)
    # the peaks' axis leads for the lstsq; the solution's two components
    # go back beside the image axis
    ph = phases_demod.movedim(-3, 0)
    wt = weights.movedim(-3, 0)
    dbdx = wrap_diff(torch.diff(ph, dim=-1) + K[:, 1].reshape(
        (-1,) + (1,) * (ph.dim() - 1)))
    dbdy = wrap_diff(torch.diff(ph, dim=-2) + K[:, 0].reshape(
        (-1,) + (1,) * (ph.dim() - 1)))
    dudx = weighted_lstsq_stack(dbdx, K, wt[..., : dbdx.shape[-1]])
    dudy = weighted_lstsq_stack(dbdy, K, wt[..., : dbdy.shape[-2], :])
    dudx, dudy = dudx.movedim(0, -3), dudy.movedim(0, -3)
    wnorm = torch.linalg.vector_norm(wt, dim=0)
    stamp(events, "lstsq")
    return _integrate_uv(dudx, dudy, wnorm, kmax=kmax,
                         unwrap_coarse=unwrap_coarse,
                         refine_iters=refine_iters, events=events)


def _integrate_uv(dudx, dudy, wnorm, kmax=10, unwrap_coarse=None,
                  refine_iters=3, events=None):
    """Integrate the per-pixel displacement gradients dudx (2, n, m-1)
    and dudy (2, n-1, m) with wnorm (n, m) as the weight of both
    components (a stack: (B, 2, ...) with wnorm (B, n, m), image b's
    components with its own weight): the multigrid unwrap when
    unwrap_coarse is set, the exact early-stopping CG otherwise."""
    if wnorm.dim() > 2:
        wnorm = wnorm.unsqueeze(-3)      # (B, 1, n, m) beside (B, 2, ...)
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
    planes (2, n, m) (a stack: (B, 2, n, m) with wnorm (B, n, m)):
    position j holds the diff ending at j, so column 0 of dudx_s and row
    0 of dudy_s are dropped here."""
    return _integrate_uv(dudx_s[..., 1:], dudy_s[..., 1:, :], wnorm,
                         kmax=kmax, unwrap_coarse=unwrap_coarse,
                         refine_iters=refine_iters, events=events)


def iterate_GPA(image, kvecs, sigma, edge=5, iters=3,
                kmax_iter=DEFAULTS.unwrap_kmax_iterate,
                kmax=DEFAULTS.unwrap_kmax_final, verbose=False,
                device=None):
    """Refine the reference k-vectors (G, 2): lock-in at k + corr, trim
    `edge`, unwrap the phases (weights sqrt(|lock-in| / max)), plane-fit
    them and move corr by minus the slope over 2 pi, `iters` times; then
    a final unwrap with kmax. Returns (unwrapped phases (G, n', m'),
    lock-in magnitudes, corrections (G, 2)), tensors on the device. The
    image moves to `device` (None: the card; "cpu" for the plain
    route)."""
    image = entry_tensor(image, device)
    kv = torch.as_tensor(np.array(kvecs), device=image.device).to(
        image.dtype)
    corr = torch.zeros_like(kv)
    for i in range(iters + 1):
        rs = gpa_lockin_batch(image, kv + corr, sigma, device=image.device)
        if edge > 0:
            rs = rs[:, edge:-edge, edge:-edge]
        prs, w = torch.angle(rs), torch.abs(rs)
        wn = torch.sqrt(w / w.amax(dim=(-2, -1), keepdim=True))
        if i < iters:
            unwrapped = phase_unwrap(prs, wn, kmax=kmax_iter)
            delta_ks = fit_delta_k(unwrapped)
            if verbose:
                print(delta_ks)
            corr = corr - delta_ks
        else:
            unwrapped = phase_unwrap(prs, wn, kmax=kmax)
    return unwrapped, w, corr


def refine_ks(image, kvecs, sigma=None, iters=3,
              kmax_iter=DEFAULTS.unwrap_kmax_iterate, device=None):
    """Refine detected k-vectors (limited to about 1/size by the FFT
    grid) to sub-grid accuracy with iterate_GPA's plane-fit loop, the
    final unwrap at kmax_iter too; sigma defaults to ceil(1 / min |k|).
    Returns the corrected k-vectors (host numpy)."""
    kvecs = np.asarray(kvecs)
    if sigma is None:
        sigma = int(np.ceil(1 / np.linalg.norm(kvecs, axis=1).min()))
    _, _, corr = iterate_GPA(image, kvecs, sigma, iters=iters,
                             kmax_iter=kmax_iter, kmax=kmax_iter,
                             device=device)
    return kvecs + corr.cpu().numpy()
