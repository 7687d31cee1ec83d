"""The production displacement extractor (counterpart of a subset of
pygpa_tpu/gpa/pipeline.py: make_displacement_extractor on its fused uv
route, gaussian_deconvolve and _next_fast_fft_size).

One call of the extractor runs: mean subtraction -> the grouped banded
WFR sweep with reconstruction-prologue emission (ops.wfr / ops.sweep)
-> the multigrid unwrap of the two displacement components
(gpa.reconstruct / solvers.unwrap) -> optional Wiener deconvolution.
Everything that does not depend on the image (the sweep plan, DFT
bases, Gaussian factors) is built once by the factory on `device`.
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULTS
from ..core.fourier import fourier_gaussian_multiplier, wiener_deconvolve
from ..ops.wfr import SweepPlan, UVSweep, plan_sweep
from ..solvers.unwrap import stamp
from .reconstruct import reconstruct_u_inv_from_uv

_NOT_PORTED_ROUTE = ("is not ported: only the fused uv route with the "
                     "multigrid unwrap (unwrap_coarse >= 1) runs in "
                     "pygpa_tpu_torch; the phase/weight route and the "
                     "exact-CG unwrap are ROADMAP queue 1 work")


def _next_fast_fft_size(n):
    """Smallest 5-smooth integer >= n (keeps the deconvolution's FFTs
    on small radices; the padded size also sets where the reflect pad
    ends, so it moves the rim the deformed gate sees)."""
    best = 1
    while best < n:
        best *= 2
    c5 = 1
    while c5 < best:
        c3 = c5
        while c3 < best:
            c2 = c3
            while c2 < n:
                c2 *= 2
            best = min(best, c2)
            c3 *= 3
        c5 *= 5
    return best


def gaussian_deconvolve(data, sigma, dr=DEFAULTS.wiener_pad,
                        balance=DEFAULTS.wiener_balance):
    """Wiener-deconvolve a (stack of) image(s) (..., n, m) by the GPA
    Gaussian window: reflect-pad by 2*dr (widened to the next 5-smooth
    FFT size), divide by the Gaussian transfer with Laplacian
    regularization, crop."""
    n, m = data.shape[-2], data.shape[-1]
    pn = _next_fast_fft_size(n + 4 * dr)
    pm = _next_fast_fft_size(m + 4 * dr)
    # the extra pad must stay below the reflectable width; the exact
    # 2*dr pad is kept on tiny images
    en = pn - n - 4 * dr if pn - n - 2 * dr < n else 0
    em = pm - m - 4 * dr if pm - m - 2 * dr < m else 0
    lead = data.shape[:-2]
    x = data.reshape((-1, n, m))
    # F.pad orders (left, right, top, bottom) from the last axis
    padded = F.pad(x, (2 * dr, 2 * dr + em, 2 * dr, 2 * dr + en),
                   mode="reflect")
    H = fourier_gaussian_multiplier(padded.shape[-2:], sigma, data.dtype,
                                    data.device)
    out = wiener_deconvolve(padded, H, balance)
    out = out[..., 2 * dr: 2 * dr + n, 2 * dr: 2 * dr + m]
    return out.reshape(lead + (n, m))


def candidate_banks(kvecs, kwscale=DEFAULTS.kw_scale,
                    ksteps=DEFAULTS.ksteps, dtype=np.float32):
    """Per-peak (2*ksteps)^2 candidate grids around each k-vector, as
    the reference factory builds them (a fixed point count per axis so
    every peak has the same P). Returns a list of (P, 2) `dtype`
    arrays."""
    kvecs_h = np.asarray(kvecs, np.float64)
    knorms = np.linalg.norm(kvecs_h, axis=1)
    kw = knorms.mean() / kwscale
    steps = kw / ksteps * np.arange(2 * ksteps)
    banks = []
    for pk in kvecs_h:
        wx, wy = np.meshgrid(pk[0] - kw + steps, pk[1] - kw + steps,
                             indexing="ij")
        banks.append(np.stack([wx.ravel(), wy.ravel()], -1).astype(dtype))
    return banks


def plan_from_numpy(shape, sigma, dr, wl, idx0s, idx1s, col_groups,
                    uv_ks):
    """The port's sweep plan from a host plan given as numpy/tuples (the
    reference's wl (G, P, 2), idx0s (G, W0), idx1s (G, W1),
    col_groups (Wb, runs) or None, and the G (k_row, k_col) uv_ks), so
    two planners can be compared field by field."""
    if col_groups is not None:
        Wb, runs = col_groups
        col_groups = (int(Wb), tuple(tuple((int(c), int(o)) for c, o in r)
                                     for r in runs))
    return SweepPlan(
        shape=tuple(int(s) for s in shape), sigma=float(sigma),
        dr=int(dr), wl=np.asarray(wl, np.float64),
        idx0s=np.asarray(idx0s, np.int32), idx1s=np.asarray(idx1s, np.int32),
        col_groups=col_groups,
        uv_ks=tuple((float(a), float(b)) for a, b in uv_ks))


def make_displacement_extractor(shape, kvecs, sigma=None,
                                kwscale=DEFAULTS.kw_scale,
                                ksteps=DEFAULTS.ksteps,
                                deconvolve=False, chunk=8,
                                unwrap_kmax=DEFAULTS.unwrap_kmax_reconstruct,
                                unwrap_coarse=None, gauss_cut=None,
                                dtype=torch.float32, device=None):
    """Build the displacement extractor for a fixed image shape and
    k-vector set: grouped WFR sweep with fused per-pixel lstsq ->
    multigrid unwrap (-> optional Wiener deconvolution).

    Arguments follow pygpa_tpu.gpa.pipeline.make_displacement_extractor;
    `device` places the precomputed operands and the work. `chunk` only
    steers the reference's per-peak sweep route, which is not ported.
    Raises NotImplementedError where the reference would leave the
    grouped uv route or the multigrid unwrap.

    Returns run(image, events=None) -> u (2, n, m). `events`, a list,
    collects (stage name, CUDA event) pairs after each stage (sweep,
    unwrap levels, deconvolve) for stage timing on the card."""
    if not DEFAULTS.pipeline_fused_uv:
        raise NotImplementedError("the phase/weight sweep route "
                                  + _NOT_PORTED_ROUTE)
    if not unwrap_coarse:
        raise NotImplementedError("unwrap_coarse=None (exact CG unwrap) "
                                  + _NOT_PORTED_ROUTE)
    if dtype != torch.float32:
        raise NotImplementedError(f"dtype {dtype}: only float32 "
                                  + _NOT_PORTED_ROUTE)
    kvecs_h = np.asarray(kvecs, np.float64)
    knorms = np.linalg.norm(kvecs_h, axis=1)
    if not np.all(knorms > 0):
        raise ValueError("all k-vectors must be nonzero")
    sig = sigma if sigma is not None else int(np.ceil(1 / knorms.min()))
    dr = 2 * sig
    gc = (DEFAULTS.pipeline_gauss_cut if gauss_cut is None
          else float(gauss_cut))
    wlists = candidate_banks(kvecs_h, kwscale, ksteps)
    plan = plan_sweep(shape, wlists, sig, dr, kvecs_h, gauss_cut=gc,
                      dtype=dtype)
    sweep = UVSweep(plan, device=device)

    def run(image, events=None):
        image = torch.as_tensor(image, device=device).to(dtype)
        img0 = image - image.mean()
        uv = sweep(img0)
        stamp(events, "sweep")
        u = reconstruct_u_inv_from_uv(*uv, kmax=unwrap_kmax,
                                      unwrap_coarse=unwrap_coarse,
                                      events=events)
        if deconvolve:
            u = gaussian_deconvolve(u, sig, dr)
            stamp(events, "deconvolve")
        return u

    run.plan = plan
    run.sigma = sig
    return run
