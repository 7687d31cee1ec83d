"""Image resampling (counterpart of pygpa_tpu/core/interp.py):
spline_filter, the cubic B-spline prefilter of scipy.ndimage, and
map_coordinates at orders 0, 1 and 3 in the 'nearest' and 'constant'
modes, with scipy's order-3 semantics (prefilter + B-spline basis).

Routes, as the reference's ``_use_pallas_warp`` sends them: a CUDA
float32 2-D image with float32 coordinates (2, ...) of 1-D or 2-D
planes, order 1 or 3, mode 'nearest' or 'constant', goes to the warp
kernels (ops.warp, csrc/warp.cu); everything else (CPU tensors,
float64, other shapes) takes the plain samplers: the bilinear twin for
order 1, ``_map_coordinates_cubic`` (the reference's own plain sampler,
mirror taps for constant-mode B-splines) for order 3. Routing by
device, dtype and shape is the reference's; nothing falls back.

``map_coordinates`` keeps the reference's 2-D contract. The private
``_map_coordinates_stack`` samples a stack of planes at the same
positions at order 1 (the coarse inversion's two planes of u and four
gradient planes): one bilinear launch per stack on the card, under the
same gate, and the twin on the CPU. ``map_displaced`` samples up to two
B-spline coefficient planes at r + u(r) (the order-3 inversion's
Picard step, the undistortion's final warp): the displacement form of
the cubic warp on the card, under the same gate, and on the CPU its
twin, which is the composition of positions and map_coordinates.

spline_filter stays a torch operation, as it is an XLA convolution in
the reference: per axis a mode-extended pad and the 55-tap truncated
inverse filter (|z1|^27 < 1e-15) as a float32/float64 conv1d. cuDNN
would run a float32 convolution in TF32 (about 1e-3 relative) by
default, so the call switches TF32 off for its own convolutions.
"""
import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import warp as _warp

_cubic_weights = _warp.catmull_weights
_bspline_weights = _warp.bspline_weights

# cubic B-spline prefilter pole z1 = sqrt(3) - 2; the exact inverse of
# the [1/6, 4/6, 1/6] sampling filter is h[d] = -6 z1 / (1 - z1^2) z1^|d|,
# truncated at radius 27
_BSPLINE_POLE = 3.0 ** 0.5 - 2.0
_BSPLINE_RADIUS = 27

# 'nearest'-mode sampling margin reproducing scipy's npad=12 pre-pad:
# 12 off-image px of extended-spline evaluation + 1 for the outer tap
NEAREST_MARGIN = 13


def _bspline_fir(dtype, device):
    z = _BSPLINE_POLE
    d = np.abs(np.arange(-_BSPLINE_RADIUS, _BSPLINE_RADIUS + 1))
    return torch.tensor(-6.0 * z / (1.0 - z * z) * z ** d, dtype=dtype,
                        device=device)


def _pad_mode(mode):
    """numpy pad mode of each map_coordinates mode's prefilter extension
    ('constant' prefilters with mirror boundaries, as scipy does)."""
    return {"mirror": "reflect", "constant": "reflect",
            "nearest": "edge", "grid-wrap": "wrap",
            "wrap": "wrap"}.get(mode, "reflect")


def _extension_index(n, r, jmode, device):
    """Source indices of an axis of length n padded by r <= max(n-1, 1)
    on both sides with numpy's `jmode` ('reflect', 'edge' or 'wrap')."""
    i = torch.arange(-r, n + r, device=device)
    if jmode == "edge":
        return i.clamp(0, n - 1)
    if jmode == "wrap":
        return i.remainder(n)
    p = 2 * n - 2
    if p <= 0:
        return torch.zeros_like(i)
    i = i.abs().remainder(p)
    return torch.minimum(i, p - i)


def _pad_np_axis(x, r, axis, jmode):
    """np.pad of one axis by r with `jmode`, applied repeatedly in steps
    of at most n-1 as the reference's _pad_axis does."""
    while r > 0:
        n = x.shape[axis]
        step = min(r, max(n - 1, 1))
        x = x.index_select(axis, _extension_index(n, step, jmode, x.device))
        r -= step
    return x


def pad_np(x, r, jmode):
    """np.pad(x, r, mode=jmode) over the last two axes ('reflect',
    'edge' or 'wrap')."""
    return _pad_np_axis(_pad_np_axis(x, r, -2, jmode), r, -1, jmode)


def _pad_axis(x, r, axis, mode):
    """Pad `x` by r along `axis` with the extension of map_coordinates
    mode `mode`."""
    return _pad_np_axis(x, r, axis, _pad_mode(mode))


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions and cuBLAS products of float32 in full float32
    (not TF32) within the block, whatever the global flags say."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def spline_filter(image, mode="mirror", axes=None, margin=0):
    """Cubic B-spline prefilter (scipy.ndimage.spline_filter order=3):
    the coefficients c with B3 * c = image under the mode's boundary
    extension, separable over `axes` (all by default). margin > 0 keeps
    `margin` extra extension coefficients on each side of each filtered
    axis (length n + 2 margin); 'nearest' sampling needs
    margin=NEAREST_MARGIN (see pygpa_tpu.core.interp.spline_filter)."""
    image = torch.as_tensor(image)
    nd = image.ndim
    if axes is None:
        axes = tuple(range(nd))
    h = _bspline_fir(image.dtype, image.device).reshape(1, 1, -1)
    r = _BSPLINE_RADIUS
    with no_tf32():
        for ax in axes:
            ax = ax % nd
            x = _pad_axis(image, r + int(margin), ax, mode)
            x = torch.movedim(x, ax, -1)
            lead = x.shape[:-1]
            out = F.conv1d(x.reshape(-1, 1, x.shape[-1]), h)
            image = torch.movedim(out.reshape(lead + (-1,)), -1, ax)
    return image


def _map_coordinates_cubic(image, coords, cval, mode, cubic="catmull"):
    """The reference's plain order-3 sampler: 16 gathers with
    Catmull-Rom or B-spline weights; 'nearest' clamps each tap,
    'constant' puts cval on taps outside, except constant-mode B-splines,
    which mirror their taps and cut positions outside [0, dim-1] to
    cval (scipy's legacy 'constant')."""
    x, y = coords[0], coords[1]
    n, m = image.shape
    dt = image.dtype
    ix = torch.floor(x)
    iy = torch.floor(y)
    tx = (x - ix).to(dt)
    ty = (y - iy).to(dt)
    ix = ix.to(torch.int64)
    iy = iy.to(torch.int64)
    weight_fn = _bspline_weights if cubic == "bspline" else _cubic_weights
    wx = weight_fn(tx)
    wy = weight_fn(ty)

    def _reflect(i, nn):
        # mirror tap reflection (period 2*nn - 2) about the edge samples
        p = 2 * nn - 2
        if p <= 0:
            return torch.zeros_like(i)
        i = i.abs().remainder(p)
        return torch.minimum(i, p - i)

    mirror_taps = mode == "constant" and cubic == "bspline"
    flat = image.reshape(-1)
    cv = torch.tensor(cval, dtype=dt, device=image.device)
    out = torch.zeros(x.shape, dtype=dt, device=image.device)
    for a in range(4):
        xi = ix + (a - 1)
        vx = None
        if mode == "nearest" or mirror_taps:
            xi = _reflect(xi, n) if mirror_taps else xi.clamp(0, n - 1)
        else:
            vx = (xi >= 0) & (xi < n)
            xi = xi.clamp(0, n - 1)
        row_acc = torch.zeros(x.shape, dtype=dt, device=image.device)
        for b in range(4):
            yi = iy + (b - 1)
            if mode == "nearest" or mirror_taps:
                yi = _reflect(yi, m) if mirror_taps else yi.clamp(0, m - 1)
                val = flat[xi * m + yi]
            else:
                vy = (yi >= 0) & (yi < m) & vx
                yi = yi.clamp(0, m - 1)
                val = torch.where(vy, flat[xi * m + yi], cv)
            row_acc = row_acc + wy[b] * val
        out = out + wx[a] * row_acc
    if mirror_taps:
        indom = (x >= 0) & (x <= n - 1) & (y >= 0) & (y <= m - 1)
        out = torch.where(indom, out, cv)
    return out


def _map_coordinates_nearest(image, coords, cval, mode):
    """order=0 (jax.scipy.ndimage): the sample at the coordinates
    rounded half away from zero; 'nearest' clamps, 'constant' gives cval
    outside."""
    idx, ok = [], None
    for c, size in zip(coords, image.shape):
        i = (torch.sign(c) * torch.floor(c.abs() + 0.5)).to(torch.int64)
        if mode == "constant":
            v = (i >= 0) & (i < size)
            ok = v if ok is None else ok & v
        idx.append(i.clamp(0, size - 1))
    out = image[idx[0], idx[1]]
    if mode == "constant":
        out = torch.where(ok, out, torch.tensor(cval, dtype=image.dtype,
                                                device=image.device))
    return out


def warp_kernel_ok(image, coordinates, order, mode):
    """The reference's _use_pallas_warp read for the card: the warp
    kernels take a CUDA float32 2-D image sampled at float32
    coordinates (2, ...) with 1-D or 2-D planes, order 1 or 3, mode
    'nearest' or 'constant'; the bilinear kernel also a stack (C, n, m)
    of up to ops.warp.MAX_PLANES planes."""
    return (order in (1, 3)
            and image.device.type == "cuda"
            and image.dtype == torch.float32
            and coordinates.dtype == torch.float32
            and (image.ndim == 2 or (
                image.ndim == 3 and order == 1
                and 0 < image.shape[0] <= _warp.MAX_PLANES))
            and coordinates.shape[0] == 2
            and coordinates.ndim in (2, 3)
            and mode in _warp.MODES)


def margin_coords(coordinates, shape, margin):
    """Positions (2, ...) on the logical grid of margin-extended
    coefficients of `shape` clamped at +-(margin - 1) px off that grid
    and shifted into the extended frame (no change for margin 0)."""
    mg = int(margin)
    if not mg:
        return coordinates
    ext = mg - 1
    n_l = shape[0] - 2 * mg
    m_l = shape[1] - 2 * mg
    return torch.stack([coordinates[0].clamp(-ext, n_l - 1 + ext) + mg,
                        coordinates[1].clamp(-ext, m_l - 1 + ext) + mg])


def map_coordinates(image, coordinates, order=3, mode="nearest", cval=0.0,
                    cubic="bspline", prefilter=True, margin=0):
    """Sample the 2-D `image` at fractional `coordinates` (2, ...).

    order=1 is bilinear (jax.scipy.ndimage semantics), order=3 matches
    scipy.ndimage.map_coordinates: B-spline prefilter + cubic B-spline
    basis sampling; order=0 takes the nearest sample. mode='nearest'
    clamps to the border, mode='constant' fills with cval outside.
    prefilter=False takes `image` as B-spline coefficients already
    (hoist spline_filter out of loops); pass the `margin` the
    coefficients were filtered with (NEAREST_MARGIN for scipy-exact
    'nearest'). cubic='catmull' samples the Catmull-Rom interpolant of
    the image itself (no prefilter)."""
    image = torch.as_tensor(image)
    if not isinstance(coordinates, torch.Tensor):
        if isinstance(coordinates, (list, tuple)) and all(
                isinstance(c, torch.Tensor) for c in coordinates):
            coordinates = torch.stack(list(coordinates))
        else:
            coordinates = torch.as_tensor(np.asarray(coordinates),
                                          device=image.device)
    if image.ndim != 2 or coordinates.shape[0] != 2:
        raise NotImplementedError("map_coordinates: only 2-D images are "
                                  "ported")
    if mode not in _warp.MODES:
        raise NotImplementedError(f"mode={mode!r} not supported")
    if order == 0:
        return _map_coordinates_nearest(image, coordinates, cval, mode)
    if order == 1:
        if warp_kernel_ok(image, coordinates, order, mode):
            # the kernel takes contiguous planes (a view is copied here)
            return _warp.warp_bilinear(
                image.contiguous(), coordinates[0].contiguous(),
                coordinates[1].contiguous(), mode, cval)
        return _warp.warp_bilinear_plain(image, coordinates[0],
                                         coordinates[1], mode, cval)
    if order != 3:
        raise NotImplementedError(f"order={order} (0, 1 and 3 are ported)")
    if cubic == "bspline" and prefilter:
        if mode == "nearest":
            margin = NEAREST_MARGIN
            image = spline_filter(image, mode=mode, margin=margin)
        else:
            image = spline_filter(image, mode=mode)
    if margin:
        coordinates = margin_coords(coordinates, image.shape, margin)
    if warp_kernel_ok(image, coordinates, order, mode):
        return _warp.warp_cubic(image, coordinates[0], coordinates[1], mode,
                                cval, cubic)
    return _map_coordinates_cubic(image, coordinates, cval, mode,
                                  cubic=cubic)


def _map_coordinates_stack(images, coordinates, order, mode, margin=0):
    """map_coordinates(prefilter=False) of each plane of a stack (C, n,
    m) at the same float coordinates (2, ...): output (C, ...), each
    plane bit-identical to its own map_coordinates call. Order 1 takes
    one bilinear launch for a stack of up to ops.warp.MAX_PLANES planes
    on the card (the warp_kernel_ok gate) and the twin elsewhere; other
    orders sample plane by plane."""
    if order != 1:
        return torch.stack([map_coordinates(im, coordinates, order=order,
                                            mode=mode, prefilter=False,
                                            margin=margin) for im in images])
    if warp_kernel_ok(images, coordinates, order, mode):
        return _warp.warp_bilinear(images.contiguous(),
                                   coordinates[0].contiguous(),
                                   coordinates[1].contiguous(), mode)
    return _warp.warp_bilinear_plain(images, coordinates[0], coordinates[1],
                                     mode)


def map_displaced(coef, u, origin, mode, margin=0, cval=0.0, out=None):
    """map_coordinates(order=3, prefilter=False) of each B-spline
    coefficient plane of `coef` (n, m, C), C <= 2 planes stored last, at
    the grid points (r + origin) + u(r) of u (2, h, w): output (C, h, w),
    written into `out` when given (u itself for an in-place Picard step).
    The displacement form of the cubic warp takes it on the card where
    warp_kernel_ok holds for a plane of `coef` at u; elsewhere its twin,
    the same composition as building the positions and calling
    map_coordinates, bit for bit."""
    if coef.shape[-1] <= 2 and warp_kernel_ok(coef[..., 0], u, 3, mode):
        return _warp.warp_cubic_disp(coef, u, origin, margin, mode, cval,
                                     out)
    return _warp.warp_cubic_disp_plain(coef, u, origin, margin, mode, cval,
                                       out)
