"""Bilinear and cubic image resampling at per-pixel coordinates.

Replaces the TPU kernels ``pygpa_tpu/ops/pallas_warp.py``
``_warp_kernel`` (entry ``warp_bilinear``) and ``_warp_cubic_kernel``
(entry ``warp_cubic``), both behind ``_warp_core``. They sample a 2-D
image at fractional (row, column) coordinates cy, cx of any shape:

- warp_bilinear: 2 x 2 taps, the algebra of
  jax.scipy.ndimage.map_coordinates(order=1); 'nearest' clamps the
  sample position, 'constant' blends a one-pixel cval ring and masks
  positions further out. It also takes a stack (C, n, m) of up to
  MAX_PLANES planes sampled at the same positions, output (C, ...):
  each plane is bit-identical to that plane warped alone;
- warp_cubic: 4 x 4 taps with Catmull-Rom or cubic B-spline weights
  (the B-spline samples spline_filter'ed coefficients: scipy's order-3
  interpolant); 'nearest' clamps each tap, 'constant' blends cval out
  to two pixels (Catmull-Rom) or samples the mirror-extended spline
  inside the image and cuts to cval outside it (B-spline, scipy's
  legacy 'constant').

Each wrapper does the reference wrapper's boundary algebra exactly: the
fraction is taken in the coordinates' dtype (floor, then the
difference) and cast to the image's, the integer taps are shifted and
clamped into an image padded by 1 (bilinear constant), 2 (cubic
nearest, edge) or 3 (cubic constant, cval or reflect) rings, and the
'constant' outside mask is applied last.

CUDA route (``csrc/warp.cu``): one thread per output pixel computes its
taps and fractions from the coordinates and gathers the taps through
the read-only cache; the padded rings are index arithmetic (clamp,
reflect or cval), never materialised. The TPU kernel's 3 x 3 block
windows, bit-packed scalar prefetch, row-shift loop and validity guard
with its dense fallback existed because Mosaic has no sublane gather; a
CUDA gather is exact for any coordinates, so none of them is carried
over. Bound on an H100 by device memory (the coordinates read and the
output written once; the taps mostly hit L1/L2 because neighbouring
pixels sample neighbouring positions). All arithmetic uses the _rn
intrinsics in the twin's order, so the kernel repeats the twin's
rounding.

The bilinear kernel's device time at the inversion's 512^2 grid is a
few microseconds, so its launch path sets its time per call: a stack
of planes takes one launch, and ``_launch_bilinear`` does only the
host work a launch needs (one combined check that raises on every
input the kernel does not take: device, dtype, contiguity, shapes,
mode; the output allocated once; the launcher bound once; no device
context switch and no Stream object when the tensor is on the current
device).

The cubic B-spline warp also takes its positions in displacement form,
``warp_cubic_disp``: up to two coefficient planes, stored planes-last
(n, m, C) so that one 8-byte load reads a tap of both, sampled at the
grid point r + u(r) of each output pixel, the position built (with the
'nearest' margin's clamp and shift) from the pixel's own u in the
kernel, the taps and weights computed once for both planes. It is what
the displacement inversion's Picard step (both planes of u, updated in
place) and the undistortion's final warp run; its bound is the bytes
of u in and out and of the coefficients, 0.120 ms per 4096^2 Picard
step. Both forms count their launches as "warp_cubic".

The plain twins (``warp_bilinear_plain``, ``warp_cubic_plain``) hold
the dense tap/weight algebra of the reference's ``_warp_xla`` on
materialised padded images; ``warp_cubic_disp_plain`` is the
composition the displacement form replaces (positions built in torch,
then core.interp's plain sampler), bit for bit. A CPU tensor runs the
twin; a CUDA tensor the kernel (float32 image and coordinates; a 2-D
image, or for the bilinear warp a stack of up to MAX_PLANES planes) or
an error.
"""
import torch
import torch.nn.functional as F

from . import _build

MODES = ("nearest", "constant")
MAX_PLANES = 4      # planes of a bilinear stack in one launch
_WEIGHT_FN = {"catmull": 1, "bspline": 2}   # csrc/warp.cu weight codes


def catmull_weights(t):
    """Catmull-Rom weights for taps at offsets (-1, 0, 1, 2)."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return (w0, w1, w2, w3)


def bspline_weights(t):
    """Cubic B-spline basis weights for taps at offsets (-1, 0, 1, 2)
    (sampling spline_filter'ed coefficients gives scipy's prefiltered
    order-3 interpolant)."""
    t2 = t * t
    t3 = t2 * t
    s = 1.0 / 6.0
    w0 = s * (1.0 - 3.0 * t + 3.0 * t2 - t3)
    w1 = s * (4.0 - 6.0 * t2 + 3.0 * t3)
    w2 = s * (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3)
    w3 = s * t3
    return (w0, w1, w2, w3)


def _dense(img, iy0, ix0, fy, fx, taps, cubic="catmull"):
    """The reference's _warp_xla: separable taps of the padded image at
    integer base taps (iy0, ix0) with fractions (fy, fx); the bilinear
    form also takes a stack (C, n, m), sampled plane by plane."""
    m = img.shape[-1]
    flat = img.reshape(img.shape[:-2] + (-1,))
    if taps == 2:
        r0 = flat[..., iy0 * m + ix0]
        r1 = flat[..., iy0 * m + ix0 + 1]
        r2 = flat[..., (iy0 + 1) * m + ix0]
        r3 = flat[..., (iy0 + 1) * m + ix0 + 1]
        return ((1.0 - fy) * ((1.0 - fx) * r0 + fx * r1)
                + fy * ((1.0 - fx) * r2 + fx * r3))
    weight_fn = bspline_weights if cubic == "bspline" else catmull_weights
    wy = weight_fn(fy)
    wx = weight_fn(fx)
    out = torch.zeros_like(fy)
    for a in range(4):
        row = torch.zeros_like(fy)
        for b in range(4):
            row = row + wx[b] * flat[(iy0 + a) * m + ix0 + b]
        out = out + wy[a] * row
    return out


def _floor_frac(c, dtype):
    """(floor(c) as int64, fraction in c's dtype cast to `dtype`)."""
    fl = torch.floor(c)
    return fl.to(torch.int64), (c - fl).to(dtype), fl


def warp_bilinear_plain(image, cy, cx, mode="nearest", cval=0.0):
    """Plain PyTorch twin of the bilinear warp kernel (a 2-D image or a
    stack (C, n, m) of planes)."""
    if mode not in MODES:
        raise NotImplementedError(f"mode={mode!r}")
    n, m = image.shape[-2:]
    ty, fy, _ = _floor_frac(cy, image.dtype)
    tx, fx, _ = _floor_frac(cx, image.dtype)
    if mode == "nearest":
        # clamp the sample position: outside, both taps hit the border
        fy = torch.where((ty < 0) | (ty > n - 2), 0.0, fy)
        fx = torch.where((tx < 0) | (tx > m - 2), 0.0, fx)
        fy = torch.where(cy >= n - 1, 1.0, fy)
        fx = torch.where(cx >= m - 1, 1.0, fx)
        ty = ty.clamp(0, n - 2)
        tx = tx.clamp(0, m - 2)
        img = image
    else:
        # one cval ring: taps within a pixel outside blend with cval
        img = F.pad(image, (1, 1, 1, 1), value=float(cval))
        outside = (cy <= -1) | (cy >= n) | (cx <= -1) | (cx >= m)
        ty = (ty + 1).clamp(0, n)
        tx = (tx + 1).clamp(0, m)
    out = _dense(img, ty, tx, fy, fx, 2)
    if mode == "constant":
        out = torch.where(outside, float(cval), out)
    return out


def warp_cubic_plain(image, cy, cx, mode="nearest", cval=0.0,
                     cubic="catmull"):
    """Plain PyTorch twin of the cubic warp kernel."""
    from ..core.interp import pad_np
    if mode not in MODES:
        raise NotImplementedError(f"mode={mode!r}")
    n, m = image.shape
    if mode == "nearest":
        # two edge rings reproduce per-tap clamping out to 1 px; beyond,
        # the clamped position with fraction 1 picks the border tap
        img = pad_np(image, 2, "edge")
        cyc = cy.clamp(-1, n)
        cxc = cx.clamp(-1, m)
        ty, fy, fl_y = _floor_frac(cyc, image.dtype)
        tx, fx, fl_x = _floor_frac(cxc, image.dtype)
        fy = torch.where(fl_y > n - 1, 1.0, fy)
        fx = torch.where(fl_x > m - 1, 1.0, fx)
        ty = ty.clamp(max=n - 1) + 1
        tx = tx.clamp(max=m - 1) + 1
    else:
        if cubic == "bspline":
            # inside: the mirror-extended spline; outside: cval
            img = pad_np(image, 3, "reflect")
            outside = (cy < 0) | (cy > n - 1) | (cx < 0) | (cx > m - 1)
            cyc = cy.clamp(0.0, n - 1.0)
            cxc = cx.clamp(0.0, m - 1.0)
        else:
            img = F.pad(image, (3, 3, 3, 3), value=float(cval))
            outside = ((cy <= -2) | (cy >= n + 1)
                       | (cx <= -2) | (cx >= m + 1))
            cyc = cy.clamp(-2, n + 1)
            cxc = cx.clamp(-2, m + 1)
        ty, fy, _ = _floor_frac(cyc, image.dtype)
        tx, fx, _ = _floor_frac(cxc, image.dtype)
        ty = ty.clamp(max=n) + 2
        tx = tx.clamp(max=m) + 2
    out = _dense(img, ty, tx, fy, fx, 4, cubic)
    if mode == "constant":
        out = torch.where(outside, float(cval), out)
    return out


def _launch_cubic(image, cy, cx, mode, cval, weight):
    """Run the cubic warp kernel on a CUDA float32 2-D image."""
    op = "warp_cubic"
    if image.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {image.device}")
    if image.ndim != 2 or mode not in MODES or cy.shape != cx.shape:
        raise ValueError(f"{op} kernel needs a 2-D image, mode in {MODES} "
                         "and coordinate planes of one shape (got "
                         f"{tuple(image.shape)}, {mode!r}, "
                         f"{tuple(cy.shape)}, {tuple(cx.shape)})")
    n, m = image.shape
    count = cy.numel()
    if count >= 2 ** 31 or n * m >= 2 ** 31 or min(n, m) < 2:
        raise ValueError(f"{op} kernel: image {n}x{m} or {count} samples "
                         "out of range")
    img = image.contiguous()
    ys = cy.reshape(-1).contiguous()
    xs = cx.reshape(-1).contiguous()
    _build.check_tensor(op, "image", img, (n, m), torch.float32,
                        image.device)
    for name, t in (("cy", ys), ("cx", xs)):
        _build.check_tensor(op, name, t, (count,), torch.float32,
                            image.device)
    out = torch.empty_like(ys)
    with torch.cuda.device(image.device):
        fn = _build.bind(op, "piipppiiifp")
        _build.check(fn(img.data_ptr(), n, m, ys.data_ptr(), xs.data_ptr(),
                        out.data_ptr(), count, MODES.index(mode), weight,
                        float(cval),
                        torch.cuda.current_stream(image.device).cuda_stream),
                     op)
    _build.launches[op] += 1
    return out.reshape(cy.shape)


def warp_cubic_disp_plain(coef, u, origin=(0, 0), margin=0, mode="nearest",
                          cval=0.0, out=None):
    """Plain PyTorch twin of the displacement-form cubic warp: the
    positions (r + origin) + u(r) built in torch, clamped and shifted
    into the margin as core.interp.map_coordinates does, then each plane
    coef[..., p] sampled by core.interp's plain B-spline sampler."""
    from ..core import interp
    h, w = u.shape[-2:]
    dev, dt = u.device, u.dtype
    xx = torch.arange(origin[0], origin[0] + h, device=dev).to(dt)[:, None]
    yy = torch.arange(origin[1], origin[1] + w, device=dev).to(dt)[None, :]
    coords = interp.margin_coords(torch.stack([xx + u[0], yy + u[1]]),
                                  coef.shape[:2], margin)
    res = torch.stack([interp._map_coordinates_cubic(
        coef[..., p], coords, cval, mode, cubic="bspline")
        for p in range(coef.shape[-1])])
    return res if out is None else out.copy_(res)


def _launch_cubic_disp(coef, u, origin, margin, mode, cval, out):
    """Run the displacement-form cubic kernel on CUDA float32 planes."""
    op = "warp_cubic_disp"
    dev = coef.device
    if dev.type != "cuda":
        raise ValueError(f"{op}: unsupported device {dev}")
    C = coef.shape[-1] if coef.ndim == 3 else 0
    h, w = u.shape[-2:]
    if out is None:
        out = torch.empty((C, h, w), dtype=torch.float32, device=dev)
    f32 = torch.float32
    if (coef.ndim != 3 or not 0 < C <= 2 or u.shape != (2, h, w)
            or mode not in MODES or out.shape != (C, h, w)
            or any(t.dtype != f32 or t.device != dev or not t.is_contiguous()
                   for t in (coef, u, out))
            or out.data_ptr() == coef.data_ptr()):
        raise ValueError(
            f"{op} kernel needs contiguous float32 coefficients (n, m, C <= "
            f"2), u (2, h, w) and out (C, h, w), apart from coef, on {dev} "
            f"and mode in {MODES}; got coef {coef.dtype} "
            f"{tuple(coef.shape)}, u {u.dtype} {tuple(u.shape)} on {u.device},"
            f" out {out.dtype} {tuple(out.shape)} on {out.device}, mode "
            f"{mode!r}")
    n, m = coef.shape[:2]
    mg = int(margin)
    if C * n * m >= 2 ** 31 or 2 * h * w >= 2 ** 31 or min(n, m) - 2 * mg < 2:
        raise ValueError(f"{op} kernel: coefficients {tuple(coef.shape)} "
                         f"(margin {mg}) or grid {h}x{w} out of range")
    with torch.cuda.device(dev):
        fn = _build.bind(op, "piiippiiiiiifp")
        _build.check(fn(coef.data_ptr(), C, n, m, u.data_ptr(),
                        out.data_ptr(), h, w, int(origin[0]), int(origin[1]),
                        mg, MODES.index(mode), float(cval),
                        torch.cuda.current_stream(dev).cuda_stream), op)
    _build.launches["warp_cubic"] += 1
    return out


def _launch_bilinear(image, cy, cx, mode, cval):
    """Run the bilinear kernel on a CUDA float32 image (n, m) or stack
    (C, n, m), C <= MAX_PLANES, at contiguous float32 coordinates of one
    shape; output (C, ...) for a stack. Raises on any other input."""
    dev = image.device
    if dev.type != "cuda":
        raise ValueError(f"warp_bilinear: unsupported device {dev}")
    shape = image.shape
    nd = len(shape)
    C = shape[0] if nd == 3 else 1
    f32 = torch.float32
    if (image.dtype != f32 or cy.dtype != f32 or cx.dtype != f32
            or cy.device != dev or cx.device != dev
            or cy.shape != cx.shape or nd not in (2, 3)
            or not 0 < C <= MAX_PLANES or mode not in MODES
            or not (image.is_contiguous() and cy.is_contiguous()
                    and cx.is_contiguous())):
        raise ValueError(
            "warp_bilinear kernel needs a contiguous float32 image (n, m) or "
            f"stack (C <= {MAX_PLANES}, n, m), contiguous float32 coordinate "
            f"planes of one shape on {dev} and mode in {MODES}; got image "
            f"{image.dtype} {tuple(shape)}, cy {cy.dtype} {tuple(cy.shape)} "
            f"on {cy.device}, cx {cx.dtype} {tuple(cx.shape)} on "
            f"{cx.device}, mode {mode!r}")
    n, m = shape[-2], shape[-1]
    count = cy.numel()
    if C * count >= 2 ** 31 or C * n * m >= 2 ** 31 or min(n, m) < 2:
        raise ValueError(f"warp_bilinear kernel: image {tuple(shape)} or "
                         f"{count} samples out of range")
    out = torch.empty(shape[:-2] + cy.shape, dtype=f32, device=dev)
    fn = _build.bind("warp_bilinear", "piiipppiifp")
    args = (image.data_ptr(), C, n, m, cy.data_ptr(), cx.data_ptr(),
            out.data_ptr(), count, MODES.index(mode), float(cval))
    idx = dev.index
    if idx == torch.cuda.current_device():
        # the current stream's cudaStream_t, as
        # torch.cuda.current_stream(dev).cuda_stream gives it
        code = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    _build.check(code, "warp_bilinear")
    _build.launches["warp_bilinear"] += 1
    return out


def warp_bilinear(image, cy, cx, mode="nearest", cval=0.0):
    """map_coordinates(order=1) of a 2-D image, or of each plane of a
    stack (C, n, m) with C <= MAX_PLANES, at coordinates (cy, cx) (any
    shape; the output's is cy.shape, or (C,) + cy.shape for a stack);
    CPU tensors run the twin, CUDA tensors the kernel."""
    if image.device.type == "cpu":
        return warp_bilinear_plain(image, cy, cx, mode, cval)
    return _launch_bilinear(image, cy, cx, mode, cval)


def warp_cubic(image, cy, cx, mode="nearest", cval=0.0, cubic="catmull"):
    """map_coordinates(order=3) of a 2-D image (cubic='catmull') or of
    its B-spline coefficients (cubic='bspline') at coordinates (cy,
    cx); CPU tensors run the twin, CUDA tensors the kernel."""
    if image.device.type == "cpu":
        return warp_cubic_plain(image, cy, cx, mode, cval, cubic)
    return _launch_cubic(image, cy, cx, mode, cval,
                         _WEIGHT_FN["bspline" if cubic == "bspline"
                                    else "catmull"])


def warp_cubic_disp(coef, u, origin=(0, 0), margin=0, mode="nearest",
                    cval=0.0, out=None):
    """map_coordinates(order=3, prefilter=False) of each B-spline
    coefficient plane of `coef` (n, m, C), C <= 2 planes stored last, at
    the grid points (r + origin) + u(r), u (2, h, w): output (C, h, w),
    written into `out` when given (which may be u itself: the kernel
    reads each pixel of u before it writes that pixel). `margin` is the
    coefficients' extension (core.interp.NEAREST_MARGIN for scipy-exact
    'nearest'). CPU tensors run the twin, CUDA tensors the kernel."""
    if coef.device.type == "cpu":
        return warp_cubic_disp_plain(coef, u, origin, margin, mode, cval, out)
    return _launch_cubic_disp(coef, u, origin, margin, mode, cval, out)
