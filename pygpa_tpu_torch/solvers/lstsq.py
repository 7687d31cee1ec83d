"""Per-pixel weighted least squares, closed form (counterpart of
pygpa_tpu/solvers/lstsq.py)."""
import torch


def weighted_lstsq_stack(b, K, w, rcond_eps=0.0):
    """Solve min_x ||w * (K @ x - b)|| independently per trailing
    position via the 2x2 weighted normal equations.

    b : (d, ...) right-hand sides; K : (d, 2) design matrix
    (2*pi*kvecs); w : (d, ...) weights. Returns x : (2, ...).
    A nonzero rcond_eps is added to the normal equations' determinant.
    Degenerate systems (all weights zero) give 0/0 = nan, as in the
    reference."""
    K = torch.as_tensor(K, dtype=b.dtype, device=b.device)
    ww = w * w
    shape = (K.shape[0],) + (1,) * (b.ndim - 1)
    k0 = K[:, 0].reshape(shape)
    k1 = K[:, 1].reshape(shape)
    a00 = (ww * k0 * k0).sum(0)
    a01 = (ww * k0 * k1).sum(0)
    a11 = (ww * k1 * k1).sum(0)
    r0 = (ww * k0 * b).sum(0)
    r1 = (ww * k1 * b).sum(0)
    det = a00 * a11 - a01 * a01
    if rcond_eps:
        det = det + rcond_eps
    x0 = (a11 * r0 - a01 * r1) / det
    x1 = (a00 * r1 - a01 * r0) / det
    return torch.stack([x0, x1])
