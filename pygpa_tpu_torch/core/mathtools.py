"""Elementwise maths, the robust plane fit and k-vector list helpers
(counterpart of pygpa_tpu/core/mathtools.py). The array functions take
tensors (or array-likes, which become float64 tensors as numpy makes
them) and keep their dtype and device; the k-vector list helpers are
host numpy, as in the reference (tiny inputs, data-dependent output
shapes)."""
import math

import numpy as np
import torch


def as_tensor(x):
    """x as a tensor: a tensor as it is, anything else through a numpy
    copy (so a Python float becomes float64, as under JAX's x64, and a
    read-only or reversed array is taken as well)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x))


def wrap_to_pi(x):
    """Wrap all values of x to the interval [-pi, pi) (floor modulo,
    as pygpa_tpu.core.mathtools.wrap_to_pi)."""
    return (x + math.pi) % (2 * math.pi) - math.pi


# the reference's name (pyGPA.mathtools.wrapToPi)
wrapToPi = wrap_to_pi


def periodic_average(X, period=2 * math.pi, weights=1.0, axis=None):
    """Weighted circular mean of X with period `period`: the angle of the
    mean unit phasor, rescaled to the period (over all elements, or
    along `axis`)."""
    X = as_tensor(X)
    phx = (2 * math.pi / period) * X
    Y = weights * torch.complex(torch.cos(phx), torch.sin(phx))
    Y = torch.angle(Y.mean() if axis is None else Y.mean(dim=axis))
    return Y * period / (2 * math.pi)


def periodic_difference(X, Y, period=2 * math.pi):
    """Periodic difference of X and Y, in (-period/2, period/2]."""
    phz = (2 * math.pi / period) * (as_tensor(X) - as_tensor(Y))
    Z = torch.complex(torch.cos(phz), torch.sin(phz))
    return torch.angle(Z) * period / (2 * math.pi)


def _fit_plane_irls(image, mask, f_scale, iters):
    """Huber-loss plane fit a0 x + a1 y + a2 over the last two axes (a
    batch of planes in one call) by iteratively reweighted least
    squares: weights min(1, f_scale / |r|), each step the 3x3 weighted
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
    img = torch.where(mask, image, torch.zeros((), dtype=dt, device=dev))
    maskf = mask.to(dt)

    def solve(w):
        wm = w * maskf
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


def lfit_func(x, image, xx, yy):
    """Plane residuals image - (ax xx + ay yy + b), flattened."""
    ax, ay, b = x
    return torch.ravel(as_tensor(image) - (ax * xx + ay * yy + b))


def lfit_func_mask(x, image, xx, yy, mask):
    """Plane residuals inside `mask`, zero outside, flattened."""
    ax, ay, b = x
    image = as_tensor(image)
    r = image - (ax * xx + ay * yy + b)
    return torch.ravel(torch.where(as_tensor(mask), r,
                                   torch.zeros((), dtype=r.dtype,
                                               device=r.device)))


def fit_plane(image, verbose=False, iters=60, f_scale=1.0):
    """Fit a plane a0 x + a1 y + a2 through `image` (..., nx, ny) with a
    Huber loss (scipy least_squares(loss='huber')'s M-estimate); returns
    (..., 3). Leading axes are fitted in one batch."""
    image = as_tensor(image)
    mask = torch.ones(image.shape, dtype=torch.bool, device=image.device)
    return _fit_plane_irls(image, mask, f_scale, iters)


def fit_plane_masked(image, verbose=False, mask=False, iters=60,
                     f_scale=1.0):
    """fit_plane over the pixels where `mask` (boolean) holds."""
    image = as_tensor(image)
    if mask is False or mask is None:
        mask = torch.ones(image.shape, dtype=torch.bool, device=image.device)
    else:
        mask = torch.as_tensor(as_tensor(mask), dtype=torch.bool,
                               device=image.device)
    return _fit_plane_irls(image, mask, f_scale, iters)


def remove_negative_duplicates(ks, atol_scale="min"):
    """Drop negative duplicates from a list of 2-vectors (host numpy):
    each vector is turned so its x-coordinate (or y where x == 0) is not
    negative, then near-duplicates go; atol_scale="norm" selects the
    GPA module's norm-based tolerance."""
    ks = np.asarray(ks)
    if ks.shape[0] == 0:
        return ks
    nonneg = np.where(np.sign(ks[:, [0]]) != 0,
                      np.sign(ks[:, [0]]) * ks,
                      np.sign(ks[:, [1]]) * ks)
    if atol_scale == "norm":
        atol = 1e-5 * np.linalg.norm(nonneg, axis=1).mean()
    else:
        atol = 1e-3 * np.min(np.abs(nonneg), axis=1).mean()
    npks = [nonneg[0]]
    for k in nonneg[1:]:
        if not np.any(np.all(np.isclose(k, npks, atol=atol), axis=1)):
            npks.append(k)
    return np.array(npks)


def standardize_ks(kvecs):
    """The three k-vectors of a lattice closest to zero angle, sorted by
    angle (host numpy)."""
    newvecs = remove_negative_duplicates(np.asarray(kvecs))
    newvecs = np.concatenate([newvecs, -newvecs], axis=0)
    angles = np.arctan2(*newvecs.T[::-1])
    ind = np.argsort(np.abs(angles))[:3]
    ind = ind[np.argsort(angles[ind])]
    return newvecs[ind]
