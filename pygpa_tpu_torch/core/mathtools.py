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
    (..., 3). Leading axes are fitted in one batch: on the card in float32
    by ops.fit's kernel, elsewhere by its twin (ops.fit.fit_plane)."""
    from ..ops import fit    # at the call: the ops package imports this
    return fit.fit_plane(as_tensor(image), None, f_scale, iters)


def fit_plane_masked(image, verbose=False, mask=False, iters=60,
                     f_scale=1.0):
    """fit_plane over the pixels where `mask` (boolean) holds."""
    image = as_tensor(image)
    if mask is False:
        mask = None
    elif mask is not None:
        mask = torch.as_tensor(as_tensor(mask), dtype=torch.bool,
                               device=image.device)
    from ..ops import fit
    return fit.fit_plane(image, mask, f_scale, iters)


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
