"""Displacement extraction (counterpart of a subset of
pygpa_tpu/gpa/pipeline.py: extract_displacement_field,
make_displacement_extractor, gaussian_deconvolve and
_next_fast_fft_size).

extract_displacement_field, the eager entry: one fft2, one WFR sweep
per Bragg peak (ops.wfr.wfr_sweep, on the ops.zoom_sweep kernel where
the reference runs its fused sweep), rebased phases and rim-masked
weights, then the exact reconstruction (gpa.reconstruct: lstsq + the
early-stopping CG unwrap, whose DCTs run on the ops.dct kernels at
4096 px and up).

make_displacement_extractor, the factory: mean subtraction -> the
grouped banded sweep (ops.sweep) where the grouped plan applies, with
reconstruction-prologue emission (DEFAULTS.pipeline_fused_uv) or
phase/weight emission and the demodulated reconstruction, else the
per-peak phase/weight sweeps -> the multigrid (unwrap_coarse) or exact
(unwrap_coarse=None) unwrap of the two displacement components ->
optional Wiener deconvolution.
Everything that does not depend on the image (the sweep plan, DFT
bases, Gaussian factors) is built once by the factory on `device`.
"""


import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULTS
from ..core import entry_device, interp
from ..core.fourier import (fourier_gaussian_multiplier,
                            laplacian_transfer, wiener_filter)
from ..ops.sweep import rim_weights
from ..ops.wfr import (GroupedSweep, SweepPlan, plan_sweep, wfr_sweep,
                       wfr_sweep_phase_weight_multi)
from ..solvers.unwrap import _resize_right, stamp
from .reconstruct import (reconstruct_u_inv_from_demod,
                          reconstruct_u_inv_from_phases,
                          reconstruct_u_inv_from_uv)


def _grid(n0, n1, m0, m1, dtype, device):
    """jnp.mgrid[n0:n1, m0:m1] as two (n1-n0, m1-m0) planes of `dtype`."""
    xx = torch.arange(n0, n1, device=device).to(dtype)[:, None]
    yy = torch.arange(m0, m1, device=device).to(dtype)[None, :]
    shape = (n1 - n0, m1 - m0)
    return xx.expand(shape), yy.expand(shape)


def _coefficients(us, mode):
    """(margin, B-spline coefficients of both planes of us, stored
    planes-last (n, m, 2)): the inversion's prefilter, run once outside
    its Picard loop, in the layout the displacement-form warp reads."""
    mg = interp.NEAREST_MARGIN if mode == "nearest" else 0
    usf = interp.spline_filter(us, mode=mode, axes=(-2, -1), margin=mg)
    return mg, usf.permute(1, 2, 0).contiguous()


def invert_u(us, iters=35, edge=0, mode="nearest", order=3):
    """Fixed-point inversion of the displacement field us (2, n, m):
    u_it(r) = us(r + u_it(r)), one step from zero and `iters` more
    (pygpa_tpu.gpa.pipeline.invert_u). At order 3 the B-spline prefilter
    runs once, outside the loop, and each step samples both coefficient
    planes at r + u_it in one displacement-form warp that updates u_it in
    place (core.interp.map_displaced)."""
    us = torch.as_tensor(us)
    n, m = us.shape[1], us.shape[2]
    u_it = torch.zeros_like(us, memory_format=torch.contiguous_format)
    if order == 3:
        mg, usf = _coefficients(us, mode)
        for _ in range(int(iters) + 1):
            interp.map_displaced(usf, u_it, (-edge, -edge), mode, mg,
                                 out=u_it)
        return u_it
    xx, yy = _grid(-edge, n - edge, -edge, m - edge, us.dtype, us.device)
    for _ in range(int(iters) + 1):
        u_it = interp._map_coordinates_stack(
            us, torch.stack([xx + u_it[0], yy + u_it[1]]), order, mode)
    return u_it


def invert_u_overlap(us, iters=35, edge=0, mode="nearest", order=3,
                     coarse=1, refine_iters=2):
    """invert_u on an `edge`-wide overlap border, output (2, n + 2 edge,
    m + 2 edge) (pygpa_tpu.gpa.pipeline.invert_u_overlap). coarse > 1
    runs the Picard iteration at order 1 on the coarse-x subsampled grid
    and polishes at full resolution with `refine_iters` frozen-Jacobian
    Newton steps (J = grad us at r + u_coarse, upsampled by the linear
    resize products); coarse=1 is the reference algorithm."""
    us = torch.as_tensor(us)
    n, m = us.shape[1], us.shape[2]
    dt, dev = us.dtype, us.device
    xx, yy = _grid(-edge, n + edge, -edge, m + edge, dt, dev)

    if coarse > 1:
        c = int(coarse)
        usc = us[:, ::c, ::c] / c      # displacements in coarse pixels
        nc, mc = usc.shape[1], usc.shape[2]
        uc = invert_u(usc, iters=min(int(iters), 16), edge=0, mode=mode,
                      order=1)
        # the reference's _sep2 (L @ a @ R) as float32/float64 products
        L = _resize_right(nc, n, dt, dev).T
        R = _resize_right(mc, m, dt, dev)
        xxc, yyc = _grid(0, nc, 0, mc, dt, dev)
        coordsc = torch.stack([xxc + uc[0], yyc + uc[1]])
        # d/d(coarse px) of usc, the four planes sampled in one launch
        grads = torch.stack([g for i in (0, 1)
                             for g in torch.gradient(usc[i])])
        J = interp._map_coordinates_stack(grads, coordsc, 1, mode)
        with interp.no_tf32():
            u0 = L @ (uc * float(c)) @ R
            J = L @ J @ R
        if edge > 0:
            u0 = interp.pad_np(u0, edge, "edge")
            J = interp.pad_np(J, edge, "edge")
        a = 1.0 - J[0]
        b = -J[1]
        cc = -J[2]
        d = 1.0 - J[3]
        det = a * d - b * cc
        # |det| ~ 0 means |grad u| ~ 1: plain Picard step there
        safe = det.abs() > 0.1
        det = torch.where(safe, det, 1.0)
        u_it = u0
        for _ in range(int(refine_iters)):
            gu = interp._map_coordinates_stack(
                us, torch.stack([xx + u_it[0], yy + u_it[1]]), 1, mode)
            r0 = gu - u_it
            du0 = (d * r0[0] - b * r0[1]) / det
            du1 = (a * r0[1] - cc * r0[0]) / det
            u_it = u_it + torch.stack([torch.where(safe, du0, r0[0]),
                                       torch.where(safe, du1, r0[1])])
        return u_it

    if order == 3:
        # one step from zero and `iters` more, in place (invert_u)
        mg, usf = _coefficients(us, mode)
        u_it = torch.zeros((2,) + xx.shape, dtype=dt, device=dev)
        for _ in range(int(iters) + 1):
            interp.map_displaced(usf, u_it, (-edge, -edge), mode, mg,
                                 out=u_it)
        return u_it
    u_it = interp._map_coordinates_stack(us, torch.stack([xx, yy]), order,
                                         mode)
    for _ in range(int(iters)):
        u_it = interp._map_coordinates_stack(
            us, torch.stack([xx + u_it[0], yy + u_it[1]]), order, mode)
    return u_it


def undistort_image(deformed, u, order=3, coarse=1, invert_iters=35,
                    device=None):
    """Lawler-Fujita undistortion (pygpa_tpu.gpa.pipeline.
    undistort_image): invert -u, then resample the deformed image at
    r + u_inv in 'constant' mode. coarse > 1 inverts on the coarse grid
    (see invert_u_overlap). The image and u move to `device` (None: the
    card; "cpu" for the plain route)."""
    dev = entry_device(device)
    deformed = torch.as_tensor(deformed, device=dev)
    u = torch.as_tensor(u, device=dev)
    u_inv = invert_u_overlap(-u, iters=invert_iters, coarse=coarse)
    if order == 3:
        # map_coordinates(order=3, mode='constant') in displacement form
        coef = interp.spline_filter(deformed, mode="constant")
        return interp.map_displaced(coef[..., None], u_inv, (0, 0),
                                    "constant")[0]
    xx, yy = _grid(0, u.shape[1], 0, u.shape[2], u.dtype, u.device)
    coords = torch.stack([xx + u_inv[0], yy + u_inv[1]])
    return interp.map_coordinates(deformed, coords, order=order,
                                  mode="constant", cval=0.0)


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


def _deconvolve_pads(n, m, dr):
    """gaussian_deconvolve's padding of an (n, m) plane: reflect by 2 dr
    on each side, widened at the end to the next 5-smooth FFT size while
    the extra pad stays below the reflectable width (the exact 2 dr pad
    is kept on tiny images). Returns the (row, column) extra pads."""
    pn = _next_fast_fft_size(n + 4 * dr)
    pm = _next_fast_fft_size(m + 4 * dr)
    en = pn - n - 4 * dr if pn - n - 2 * dr < n else 0
    em = pm - m - 4 * dr if pm - m - 2 * dr < m else 0
    return en, em


def deconvolution_filter(shape, sigma, dr, balance, dtype, device):
    """gaussian_deconvolve's Fourier filter for planes of `shape`: the
    Gaussian transfer and the Laplacian transfer of the padded shape,
    built on `device` from device-side frequencies (no host copy, so no
    wait on the stream), and combined."""
    n, m = shape
    en, em = _deconvolve_pads(n, m, dr)
    padded = (n + 4 * dr + en, m + 4 * dr + em)
    H = fourier_gaussian_multiplier(padded, sigma, dtype, device)
    return wiener_filter(H, laplacian_transfer(padded, dtype, device),
                         balance)


def _deconvolve(data, filt, dr):
    """Pad, filter by deconvolution_filter's `filt` and crop."""
    n, m = data.shape[-2], data.shape[-1]
    en, em = _deconvolve_pads(n, m, dr)
    lead = data.shape[:-2]
    x = data.reshape((-1, n, m))
    # F.pad orders (left, right, top, bottom) from the last axis
    padded = F.pad(x, (2 * dr, 2 * dr + em, 2 * dr, 2 * dr + en),
                   mode="reflect")
    out = torch.fft.ifft2(torch.fft.fft2(padded) * filt).real
    out = out[..., 2 * dr: 2 * dr + n, 2 * dr: 2 * dr + m]
    return out.reshape(lead + (n, m))


def gaussian_deconvolve(data, sigma, dr=DEFAULTS.wiener_pad,
                        balance=DEFAULTS.wiener_balance):
    """Wiener-deconvolve a (stack of) image(s) (..., n, m) by the GPA
    Gaussian window: reflect-pad by 2*dr (widened to the next 5-smooth
    FFT size), divide by the Gaussian transfer with Laplacian
    regularization, crop."""
    filt = deconvolution_filter(tuple(data.shape[-2:]), sigma, dr, balance,
                                data.dtype, data.device)
    return _deconvolve(data, filt, dr)


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


def arange_bank(pk, kw, kstep):
    """One peak's candidate bank as the eager path builds it: np.arange
    from pk - kw to pk + kw in steps of kstep along each axis, (P, 2) in
    their dtype."""
    wx, wy = np.meshgrid(np.arange(pk[0] - kw, pk[0] + kw, kstep),
                         np.arange(pk[1] - kw, pk[1] + kw, kstep),
                         indexing="ij")
    return np.stack([wx.ravel(), wy.ravel()], -1)


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
    k-vector set: WFR sweeps -> per-pixel weighted lstsq -> unwrap (->
    optional Wiener deconvolution).

    Arguments follow pygpa_tpu.gpa.pipeline.make_displacement_extractor;
    `device` places the precomputed operands and the work, and each
    image moves there (None: the card, "cuda"; "cpu" runs the plain
    twins). The grouped sweep runs where its plan applies (float32,
    sides multiples of 128, equal windows, P <= 48): with
    DEFAULTS.pipeline_fused_uv its uv emission feeds
    reconstruct_u_inv_from_uv, without it its phase/weight emission
    feeds reconstruct_u_inv_from_demod. Other shapes and float64 take
    the per-peak phase/weight sweeps (`chunk` candidates per batched
    product on the plain route). unwrap_coarse selects the multigrid
    unwrap, None the exact early-stopping CG.

    Returns run(image, events=None) -> u (2, n, m). `events`, a list,
    collects (stage name, CUDA event) pairs after each stage (sweep,
    lstsq, unwrap levels, deconvolve) for stage timing on the card.

    run also takes a stack of images (B, n, m) and returns (B, 2, n, m),
    image i's field what run(images[i]) gives (jax.vmap of the
    reference's run): each image is mean-subtracted on its own, and on
    the grouped routes the stack goes through each stage at once (one
    grouped sweep launch, the multigrid's CG, presmooth and applyq
    launches and torch passes over all of it, each image's components
    with its own weight), as many launches as one image. Where the
    grouped plan does not apply (float64, sides off multiples of 128)
    the per-peak route sweeps each peak on the whole stack (the zoom
    kernel where its gate holds, the twins elsewhere), as many launches
    as one image. `events` is stamped once per stage either way."""
    device = entry_device(device)
    kvecs_h = np.asarray(kvecs, np.float64)
    knorms = np.linalg.norm(kvecs_h, axis=1)
    if not np.all(knorms > 0):
        raise ValueError("all k-vectors must be nonzero")
    sig = sigma if sigma is not None else int(np.ceil(1 / knorms.min()))
    dr = 2 * sig
    gc = (DEFAULTS.pipeline_gauss_cut if gauss_cut is None
          else float(gauss_cut))
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    wlists = candidate_banks(kvecs_h, kwscale, ksteps, dtype=np_dtype)
    fused_uv = DEFAULTS.pipeline_fused_uv
    plan = plan_sweep(shape, wlists, sig, dr, kvecs_h, gauss_cut=gc,
                      dtype=dtype)
    sweep = None if plan is None else GroupedSweep(
        plan, device=device, emit="uv" if fused_uv else "pw")
    kv = torch.tensor(kvecs_h, device=device).to(dtype)
    # the deconvolution's transfer, built on the device once for the
    # fixed shape
    filt = deconvolution_filter(
        tuple(int(s) for s in shape), sig, dr, DEFAULTS.wiener_balance,
        dtype, device) if deconvolve else None

    def run(image, events=None):
        image = torch.as_tensor(image, device=device).to(dtype)
        if image.dim() not in (2, 3):
            raise ValueError("run takes an image (n, m) or a stack (B, n, "
                             f"m), got {tuple(image.shape)}")
        return run_one(image, events)

    def run_one(image, events=None):
        if image.dim() == 3:
            img0 = image - image.mean(dim=(-2, -1), keepdim=True)
        else:
            img0 = image - image.mean()
        if sweep is not None and fused_uv:
            uv = sweep(img0)
            stamp(events, "sweep")
            u = reconstruct_u_inv_from_uv(*uv, kmax=unwrap_kmax,
                                          unwrap_coarse=unwrap_coarse,
                                          events=events)
        else:
            if sweep is not None:
                ph, wt = sweep(img0)
            else:
                ph, wt = wfr_sweep_phase_weight_multi(
                    img0, wlists, sig, dr, chunk=chunk, gauss_cut=gc)
            stamp(events, "sweep")
            u = reconstruct_u_inv_from_demod(kv, ph, wt, kmax=unwrap_kmax,
                                             unwrap_coarse=unwrap_coarse,
                                             events=events)
        if deconvolve:
            u = _deconvolve(u, filt, dr)
            stamp(events, "deconvolve")
        return u

    run.plan = plan
    run.sigma = sig
    return run


def extract_displacement_field(image, kvecs, sigma=None,
                               kwscale=DEFAULTS.kw_scale,
                               ksteps=DEFAULTS.ksteps,
                               return_gs=False, wfr_func=None,
                               deconvolve=False, with_grad=False,
                               chunk=8,
                               unwrap_kmax=DEFAULTS.unwrap_kmax_reconstruct,
                               events=None, device=None):
    """Extract the displacement field u (2, n, m) of a (moire) lattice
    image (pygpa_tpu.gpa.pipeline.extract_displacement_field): sigma =
    ceil(1 / min |k|), sweep range kw = mean |k| / kwscale in steps of
    kw / ksteps; one WFR sweep per Bragg peak on a shared fft2; phases
    weighted by the lock-in magnitude with the 2 sigma interior mask
    (floor 1e-6); exact reconstruction; optional Wiener deconvolution.

    `wfr_func` is the reference's plug-in seam: a callable
    f(img0, sigma, kx, ky, kw=..., kstep=...) -> {'lockin': ...} that
    replaces the built-in sweep. The image keeps its dtype and moves to
    `device` (None: the card, "cuda"; "cpu" for the plain route; without
    a card the default raises). `events`, a list,
    collects (stage name, CUDA event) pairs after the fft2, the sweeps,
    the lstsq, the unwrap and the deconvolution. with_grad adds each
    peak's winner phase gradient to its g-dict ('grad' (n, m, 2),
    wfr2_grad_opt's), returned with return_gs.

    A stack of images (B, n, m) gives (B, 2, n, m), image i's field the
    one this call gives on images[i] (jax.vmap of the reference's
    eager function): each image less its own mean, one fft2 of the stack,
    one zoom sweep per peak on the whole stack (the launches of one
    image), and the lstsq and the early-stopping CG on every image at
    once, each component stopping on its own norm; the g-dicts then
    hold (B, ...) arrays. With `wfr_func` the stack is a loop over the
    images (the seam takes one image)."""
    # the k-vectors keep their dtype: kw, kstep and the np.arange banks
    # are computed in it, as the reference does (float32 and float64
    # k-vectors can give banks of different lengths)
    kvecs_h = np.array(kvecs)
    knorms = np.linalg.norm(kvecs_h, axis=1)
    if not np.all(knorms > 0):
        raise ValueError("all k-vectors must be nonzero (got norms "
                         f"{knorms})")
    kw = knorms.mean() / kwscale
    if sigma is None:
        sigma = int(np.ceil(1 / knorms.min()))
    kstep = kw / ksteps
    if not isinstance(image, torch.Tensor):
        image = np.asarray(image)
    image = torch.as_tensor(image, device=entry_device(device))
    if image.dim() not in (2, 3):
        raise ValueError("extract_displacement_field takes an image (n, m) "
                         f"or a stack (B, n, m), got {tuple(image.shape)}")
    if image.dim() == 3 and wfr_func is not None:
        # the seam takes one image (the reference vmaps it, which a torch
        # callable does not allow): the stack is a loop
        outs = [extract_displacement_field(
            im, kvecs_h, sigma, kwscale, ksteps, True, wfr_func, deconvolve,
            with_grad, chunk, unwrap_kmax, events, im.device)
            for im in image]
        u = torch.stack([o[0] for o in outs])
        if not return_gs:
            return u
        return u, [{k: torch.stack([o[1][p][k] for o in outs])
                    for k in outs[0][1][p]} for p in range(len(kvecs_h))]
    img0 = image - image.mean(dim=(-2, -1), keepdim=True)
    gs = []
    if wfr_func is not None:
        for pk in kvecs_h:
            gs.append(wfr_func(img0, sigma, pk[0], pk[1], kw=kw,
                               kstep=kstep))
    else:
        spectrum = torch.fft.fft2(img0)
        stamp(events, "fft2")
        for pk in kvecs_h:
            gs.append(wfr_sweep(img0, arange_bank(pk, kw, kstep), pk, sigma,
                                with_grad=with_grad, chunk=chunk,
                                spectrum=spectrum))
    stamp(events, "sweeps")
    lockins = torch.stack([g["lockin"] for g in gs], dim=-3)
    phases = torch.angle(lockins)
    dr = 2 * sigma
    weights = torch.abs(lockins) * rim_weights(*image.shape[-2:], dr,
                                               image.dtype, image.device)
    u = reconstruct_u_inv_from_phases(kvecs_h, phases, weights,
                                      kmax=unwrap_kmax, events=events)
    if deconvolve:
        u = gaussian_deconvolve(u, sigma, dr)
        stamp(events, "deconvolve")
    if return_gs:
        return u, gs
    return u
