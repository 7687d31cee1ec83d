"""The robust plane fit's Huber IRLS on the card, one kernel launch a
step (``csrc/fit_plane.cu``).

Replaces ``pygpa_tpu/core/mathtools.py`` ``_fit_plane_irls``, the
reference's jitted ``lax.fori_loop`` that XLA fuses on the TPU (it has no
Pallas kernel): a first weighted least-squares solve and ``iters`` IRLS
steps of the Huber weights min(1, f_scale / |r|), each the 3x3 normal
equations of the plane a0 x + a1 y + a2. The quick start runs three such
fits of (3, 4086^2) phase stacks in ``refine_ks`` and ``iterate_GPA``
(``gpa.reconstruct.fit_delta_k``).

:func:`fit_plane_irls` launches the kernel ``iters + 1`` times on the
caller's stream: each launch reads the stack once (16-byte loads, a few
blocks an SM looping over each plane: :func:`fit_grid`), forms the nine
normal-equation sums of every plane (float32 a thread over a tile of
16 pixels, the three w v sums with Kahan's compensation, float64 across
tiles, threads and blocks, in a fixed order),
and the plane's last block solves the system in float64 and stores the
next coefficients on the device;
the last launch moves the offset back from the grid's centre. No host
sync and no solver library, and a fit repeats bit for bit.
:func:`fit_plane_irls_plain` is its twin in torch (batched
``torch.linalg.solve_ex``). :func:`fit_plane` is the route
``core.mathtools``' fits take: the kernel where :func:`fit_kernel_ok`
holds, the twin otherwise (float64, the CPU).
"""
import functools
import math

import torch

from . import _build

# the kernel's grid: planes on grid y, in-plane pixel counts below 2^31
FIT_MAX_PLANES = 65535
FIT_MAX_PIXELS = 2 ** 31 - 1
# threads a block, float4 loads a thread a tile, pixels a tile and the
# blocks an SM the grid is sized for (csrc/fit_plane.cu NT, LPT and its
# __launch_bounds__)
NT, LPT = 256, 4
TILE = 4 * NT * LPT
BLOCKS_PER_SM = 3


def fit_grid(B, n, m, sms):
    """G, the kernel's blocks a plane: BLOCKS_PER_SM blocks an SM of a
    card with `sms` SMs over the B planes, at most one a TILE of a
    plane's pixels (at least one). Each block loops over the plane's
    tiles g, g + G, ...; the plane's G partials are added in a fixed
    order, so a fit repeats bit for bit on one card."""
    tiles = -(-n * m // TILE)
    return max(1, min(tiles, -(-BLOCKS_PER_SM * sms // B)))


def fit_kernel_ok(shape, dtype, device):
    """Whether a fit of planes `shape` (..., n, m) in `dtype` on `device`
    takes the kernel: a CUDA device, float32, n m <= FIT_MAX_PIXELS and
    1 ... FIT_MAX_PLANES planes."""
    if len(shape) < 2 or torch.device(device).type != "cuda" \
            or dtype != torch.float32:
        return False
    n, m = shape[-2:]
    B = math.prod(shape[:-2])
    return 1 <= n * m <= FIT_MAX_PIXELS and 1 <= B <= FIT_MAX_PLANES


def fit_plane_irls_plain(image, mask, f_scale, iters):
    """Huber-loss plane fit a0 x + a1 y + a2 over the last two axes (a
    batch of planes in one call) by iteratively reweighted least
    squares over the pixels where the boolean `mask` holds (None: every
    pixel): weights min(1, f_scale / |r|), each step the 3x3 weighted
    normal equations, solved batched with torch.linalg.solve_ex (no
    host sync). The normal equations' sums go through row and column
    sums (x and y are separable), so a step is a few passes over the
    planes. The coordinates are taken from the grid's centre (half
    integers, exact in any float dtype) and the offset is moved back at
    the end: the same fit, with normal equations that keep their digits
    in float32. Returns (..., 3)."""
    nx, ny = image.shape[-2:]
    dt, dev = image.dtype, image.device
    cx, cy = (nx - 1) / 2, (ny - 1) / 2
    x = torch.arange(nx, dtype=dt, device=dev) - cx
    y = torch.arange(ny, dtype=dt, device=dev) - cy
    xx, yy = x[:, None], y[None, :]
    if mask is None:
        img, maskf = image, None
    else:
        img = torch.where(mask, image,
                          torch.zeros((), dtype=dt, device=dev))
        maskf = mask.to(dt)

    def solve(w):
        wm = w if maskf is None else w * maskf
        q = wm * img
        rw, cw = wm.sum(-1), wm.sum(-2)        # over y; over x
        rq, cq = q.sum(-1), q.sum(-2)
        sxy = ((wm * yy).sum(-1) * x).sum(-1)
        sx, sx1, s1 = (rw * x * x).sum(-1), (rw * x).sum(-1), rw.sum(-1)
        sy, sy1 = (cw * y * y).sum(-1), (cw * y).sum(-1)
        A = torch.stack([sx, sxy, sx1, sxy, sy, sy1, sx1, sy1, s1],
                        -1).reshape(s1.shape + (3, 3))
        rhs = torch.stack([(rq * x).sum(-1), (cq * y).sum(-1), rq.sum(-1)],
                          -1)
        return torch.linalg.solve_ex(A, rhs)[0]

    p = solve(torch.ones_like(image))
    for _ in range(int(iters)):
        plane = p[..., 0, None, None] * xx + (p[..., 1, None, None] * yy
                                              + p[..., 2, None, None])
        r = img - plane
        w = torch.clamp(f_scale / torch.clamp(r.abs(), min=1e-30), max=1.0)
        p = solve(w)
    return torch.stack([p[..., 0], p[..., 1],
                        p[..., 2] - p[..., 0] * cx - p[..., 1] * cy], -1)


def _mask_planes(mask, shape):
    """(uint8 view of the mask's planes, elements between planes): one
    (n, m) plane shared by every image (stride 0), or one per image."""
    n, m = shape[-2:]
    B = math.prod(shape[:-2])
    if mask.dtype != torch.bool:
        raise ValueError(f"fit_plane_irls: the mask must be boolean, got "
                         f"{mask.dtype}")
    if math.prod(mask.shape[:-2]) == 1 and tuple(mask.shape[-2:]) == (n, m):
        return mask.reshape(n, m).contiguous().view(torch.uint8), 0
    return (mask.expand(shape).reshape(B, n, m).contiguous()
            .view(torch.uint8), n * m)


@functools.lru_cache(maxsize=8)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def fit_plane_irls(image, mask, f_scale, iters):
    """The Huber IRLS plane fit (module docstring) of `image` (..., n, m)
    over the pixels where the boolean `mask` holds (broadcast against
    the image; None: every pixel, and no mask bytes are read): returns
    (..., 3) in the image's dtype. A CPU tensor runs the twin; a CUDA
    tensor launches the kernel ``iters + 1`` times (ValueError outside
    fit_kernel_ok, RuntimeError if a launch fails)."""
    if image.device.type == "cpu":
        return fit_plane_irls_plain(image, mask, f_scale, iters)
    if image.device.type != "cuda":
        raise ValueError(f"fit_plane_irls: unsupported device {image.device}")
    if not fit_kernel_ok(image.shape, image.dtype, image.device):
        raise ValueError(f"fit_plane_irls kernel needs float32 planes with "
                         f"n m <= {FIT_MAX_PIXELS}, at most "
                         f"{FIT_MAX_PLANES} of them (got {image.dtype} "
                         f"{tuple(image.shape)})")
    lead, (n, m) = image.shape[:-2], image.shape[-2:]
    B = math.prod(lead)
    img = image.reshape(B, n, m).contiguous()
    dev = image.device
    mask_ptr, mask_plane = 0, 0
    if mask is not None:
        planes, mask_plane = _mask_planes(mask.to(dev), image.shape)
        mask_ptr = planes.data_ptr()
    p = torch.empty((B, 3), dtype=torch.float32, device=dev)
    out = torch.empty_like(p)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    iters = int(iters)
    with torch.cuda.device(dev):
        G = fit_grid(B, n, m, _sm_count(dev))
        part = torch.empty(B * 9 * G, dtype=torch.float64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        step = _build.bind("fit_plane_step", "ppippppiiiifiip")
        for it in range(iters + 1):
            code = step(img.data_ptr(), mask_ptr, mask_plane, p.data_ptr(),
                        part.data_ptr(), count.data_ptr(), out.data_ptr(),
                        G, B, n, m, float(f_scale), int(it == 0),
                        int(it == iters), stream)
            _build.check(code, "fit_plane")
            _build.launches["fit_plane"] += 1
    return out.reshape(lead + (3,))


def fit_plane(image, mask, f_scale, iters):
    """The fit's route: the kernel (fit_plane_irls) where fit_kernel_ok
    holds, float32 on the card; the twin otherwise (float64, the CPU)."""
    if fit_kernel_ok(image.shape, image.dtype, image.device):
        return fit_plane_irls(image, mask, f_scale, iters)
    return fit_plane_irls_plain(image, mask, f_scale, iters)
