"""Kerelsky-style moire parameter fits: twist theta, strain angle psi,
heterostrain epsilon and lattice angle xi (degrees) from measured
k-vectors or a J field (counterpart of pygpa_tpu/props/kerelsky.py).

The optimizer is the reference's box-projected Levenberg-Marquardt: 60
fixed iterations of Marquardt-damped normal equations, a step kept only
if it lowers the cost (damping x0.33, else x5, clipped to [1e-12,
1e12]). Here it runs a batch of problems at once (a multi-start bank, or
every pixel of a field): the residuals are written for one parameter
vector, their Jacobians come from torch.func.jacfwd under
torch.func.vmap, each step is one batched torch.linalg.solve_ex, and the
loop makes no host sync. The 2x2 products are written out elementwise,
so no TF32 can enter them. The multi-start banks and the host decisions
around them (the zero-cost test c > 1e-20, the nudged restarts in their
order, the cost <= 0.3 gate, reference="symmetric") are the reference's.

Dtype: the reference casts its starts to JAX's default float (float64
with x64 enabled, float32 on the TPU). The port has no such switch: the
single fits (Kerelsky, Kerelsky_plus, Kerelsky_Jac and Kerelsky_J's
reference fit), which take and return numpy, run in float64; the field
fit (iterate_J_leastsq, Kerelsky_J's per-pixel fits) runs in the dtype
of its JacA0s and refest (float32 in run_all.py's config 5f).

Device: every fit takes `device`, None meaning the card
(core.entry_device); tests pass "cpu". A single fit is a few thousand
small launches on the card.

Reference: Kerelsky et al., Nature 572, 95 (2019), Suppl. Note 1.
"""
import math

import numpy as np
import torch

from ..config import DEFAULTS
from ..core import entry_device, entry_tensor
from ..core.mathtools import as_tensor, periodic_average, periodic_difference
from ..gpa.kgeometry import calc_diff_from_isotropic
from ..lattices.generate import generate_ks
from ..lattices.transformations import DEFAULT_POISSON, a_0_to_r_k
from .jacobians import double_strain_decomp, twist_matrix

ITERS = 60
_INF = math.inf
_LOWER4 = (0.0, -_INF, 0.0, -_INF)
_UPPER4 = (_INF,) * 4
# the multi-start bank around an estimate: xi shifted by -90/0/+90
# degrees, psi by 0/90
_SHIFTS = tuple((0.0, dpsi, 0.0, dxi) for dxi in (-90.0, 0.0, 90.0)
                for dpsi in (0.0, 90.0))


# ------------------------------------------------- tensor forms of the model

def _mm(a, b):
    """a @ b over the last two axes, summed elementwise (broadcasting)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _rot(angle):
    """Rotation matrices (..., 2, 2) of a tensor of angles in radians."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def _strain(epsilon, delta=DEFAULT_POISSON):
    """k-space uniaxial strain diag(1 / (1 + eps), 1 / (1 - delta eps))."""
    z = torch.zeros_like(epsilon)
    return torch.stack([torch.stack([1.0 / (1.0 + epsilon), z], -1),
                        torch.stack([z, 1.0 / (1.0 - delta * epsilon)], -1)],
                       -2)


def _transform(theta, psi, epsilon):
    """V(psi)^T D(epsilon) V(psi) W(theta), angles in degrees."""
    V = _rot(torch.deg2rad(psi))
    return _mm(_mm(_mm(V.transpose(-1, -2), _strain(epsilon)), V),
               _rot(torch.deg2rad(theta)))


def _unit_ks(xi):
    """generate_ks(1.0, xi)[:3] of a tensor angle xi (degrees): three unit
    vectors 60 degrees apart."""
    off = torch.arange(3, dtype=torch.float64, device=xi.device) * 2 \
        * math.pi / 6
    a = torch.deg2rad(xi)[..., None] + off.to(xi.dtype)
    return torch.stack([torch.cos(a), torch.sin(a)], -1)


def moire_amplitudes(theta, psi, epsilon, a_0=DEFAULTS.a_0):
    """|ks1 - ks2| (3,) of a twisted, strained bilayer of lattice
    constant a_0: ks1 = generate_ks(a_0_to_r_k(a_0), 0)[:3], ks2 its
    image under V^T D V W (angles in degrees). Tensors in, a tensor out
    (in theta's dtype and device; Python numbers give float64)."""
    theta = as_tensor(theta)
    psi, epsilon = (v if torch.is_tensor(v) else torch.tensor(
        v, dtype=theta.dtype, device=theta.device) for v in (psi, epsilon))
    ks1 = torch.as_tensor(generate_ks(a_0_to_r_k(a_0), 0.0)[:3],
                          device=theta.device).to(theta.dtype)
    d = ks1 - _mm(ks1, _transform(theta, psi, epsilon).transpose(-1, -2))
    return torch.sqrt((d * d).sum(-1))


# The residuals take each parameter as a 1-element slice of x: under
# torch.func.jacfwd, a Python number combined with a 0-dim slice gives a
# float64 tangent whatever x's dtype.

def _amplitudes_resid(x, knorms, a_0):
    """Kerelsky residual: the amplitudes' misfit over their mean."""
    return ((moire_amplitudes(x[0:1], x[1:2], x[2:3], a_0) - knorms)
            / knorms.mean()).reshape(-1)


def _moire_diffs_resid(x, lkvecs, nmperpixel):
    """Kerelsky_plus residual: the measured moire ks against ks2 - ks1."""
    ks1 = _unit_ks(x[3:4])
    ks2 = _mm(ks1, _transform(x[0:1], x[1:2], x[2:3]).transpose(-1, -2))
    return (lkvecs / nmperpixel - (ks2 - ks1)).reshape(-1) * 1000


def Jac_fit_diff(x, JacA0):
    """Kerelsky_Jac residual of x = (theta, psi, epsilon, xi) against the
    k-space Jacobian JacA0 (2, 2): V^T D V W(theta + xi) - W(xi) - JacA0,
    flattened, times 1000."""
    theta, psi, epsilon, xi = x[0:1], x[1:2], x[2:3], x[3:4]
    M = _transform(theta + xi, psi, epsilon)
    return (M - _rot(torch.deg2rad(xi)) - JacA0).reshape(-1) * 1000


# ---------------------------------------------------------------- LM core

def _lm_solve(residual_fn, x0, lower, upper, data=(), iters=ITERS):
    """Box-projected Levenberg-Marquardt on a batch: minimizes 0.5
    ||r_b(x_b)||^2 for each row b of x0 (B, p), residual_fn(x (p,),
    *data_b) -> (k,) with data's tensors batched along axis 0. Returns
    (x (B, p), cost (B,)) in x0's dtype (scipy's cost convention)."""
    def with_aux(x, *d):
        r = residual_fn(x, *d)
        return r, r

    jac = torch.func.vmap(torch.func.jacfwd(with_aux, has_aux=True))
    res = torch.func.vmap(residual_fn)

    def cost(x):
        r = res(x, *data)
        return 0.5 * (r * r).sum(-1)

    B, p = x0.shape
    lo = torch.tensor(lower, dtype=x0.dtype, device=x0.device)
    hi = torch.tensor(upper, dtype=x0.dtype, device=x0.device)
    eye = 1e-12 * torch.eye(p, dtype=x0.dtype, device=x0.device)
    x = torch.clamp(x0, lo, hi)
    lam = torch.full((B,), 1e-3, dtype=x0.dtype, device=x0.device)
    c = cost(x)
    for _ in range(iters):
        Jm, r = jac(x, *data)                                   # (B, k, p)
        g = (Jm * r[..., None]).sum(-2)
        H = (Jm[..., :, :, None] * Jm[..., :, None, :]).sum(-3)
        D = torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) + eye
        dx = torch.linalg.solve_ex(H + lam[:, None, None] * D,
                                   -g[..., None])[0][..., 0]
        xn = torch.clamp(x + dx, lo, hi)
        cn = cost(xn)
        accept = cn < c
        x = torch.where(accept[:, None], xn, x)
        c = torch.where(accept, cn, c)
        lam = torch.clamp(torch.where(accept, lam * 0.33, lam * 5.0),
                          1e-12, 1e12)
    return x, c


def _multistart(residual_fn, ests, data):
    """The 6-start bank around each estimate (E, 4), all E x 6 problems
    in one LM batch (data batched along E): the lowest-cost fit of each
    bank (first on ties), (E, 4) and (E,)."""
    E = ests.shape[0]
    S = len(_SHIFTS)
    shifts = torch.tensor(_SHIFTS, dtype=ests.dtype, device=ests.device)
    starts = (ests[:, None, :] + shifts[None]).reshape(E * S, 4)
    data = tuple(d.repeat_interleave(S, dim=0) for d in data)
    xs, cs = _lm_solve(residual_fn, starts, _LOWER4, _UPPER4, data)
    xs, cs = xs.reshape(E, S, 4), cs.reshape(E, S)
    i = torch.argmin(cs, dim=1)
    e = torch.arange(E, device=ests.device)
    return xs[e, i], cs[e, i]


def _as64(x, dev):
    return torch.as_tensor(np.asarray(x, np.float64), device=dev)


def _fit_moire_diffs(est, lkvecs, nmperpixel, dev):
    x, c = _multistart(
        lambda p, lk: _moire_diffs_resid(p, lk, nmperpixel),
        _as64(est, dev)[None], (_as64(lkvecs, dev)[None],))
    return x[0].cpu().numpy(), float(c[0])


def _fit_jac_bank(ests, JacA0, dev):
    """Each estimate's 6-start bank against one JacA0, in one LM batch:
    (x (E, 4), cost (E,)) as numpy."""
    ests = _as64(ests, dev)
    J = _as64(JacA0, dev).expand(ests.shape[0], 2, 2)
    x, c = _multistart(Jac_fit_diff, ests, (J,))
    return x.cpu().numpy(), c.cpu().numpy()


# ------------------------------------------------------------ public API

def Kerelsky(kvecs, nmperpixel=1.0, a_0=DEFAULTS.a_0, device=None):
    """Fit (theta, psi, epsilon) to the measured |k| amplitudes (a start
    at psi = 0, then one at psi = 90 unless the first reaches zero
    cost). Returns numpy (3,)."""
    dev = entry_device(device)
    knorms = np.linalg.norm(np.asarray(kvecs, np.float64), axis=1) \
        * nmperpixel
    kn = _as64(knorms, dev)[None]

    def fit(est):
        x, c = _lm_solve(lambda p, k: _amplitudes_resid(p, k, a_0),
                         _as64(est, dev)[None], (0.0, -_INF, 0.0),
                         (_INF,) * 3, (kn,))
        return x[0].cpu().numpy(), float(c[0])

    x, c = fit([0.01, 0.0, 0.0])
    if c > 1e-20:
        x2, c2 = fit([0.01, 90.0, 0.0])
        if c2 < c:
            x, c = x2, c2
    return x


def _sorted_lkvecs(kvecs, r_k0, sort):
    """kvecs / r_k0, in the order of their angles' periodic distance from
    the mean angle when sort != 0 (ascending for sort > 0)."""
    kvecs = np.asarray(kvecs, np.float64)
    angles = np.arctan2(*kvecs.T[::-1])
    lkvecs = kvecs / r_k0
    if sort != 0:
        order = np.argsort(sort * np.asarray(periodic_difference(
            angles, periodic_average(angles))))
        lkvecs = lkvecs[order]
    return lkvecs


def Kerelsky_plus(kvecs, nmperpixel=1.0, a_0=DEFAULTS.a_0, reference=None,
                  debug=False, sort=0, device=None):
    """Fit (theta, psi, epsilon, xi) so that the generated moire ks match
    `kvecs`, with the reference's restarts (psi = 90, then a nudge off
    the bounds the fit sits on) and its cost <= 0.3 gate: NaNs when no
    start passes it. reference="symmetric" adds theta / 2 to xi.
    Returns numpy (4,)."""
    dev = entry_device(device)
    lkvecs = _sorted_lkvecs(kvecs, a_0_to_r_k(a_0), sort)
    est = np.array([0.01, 0.0, 0.0,
                    (np.rad2deg(np.arctan2(lkvecs[0, 1], lkvecs[0, 0]))
                     - 90) % 360])
    x, c = _fit_moire_diffs(est, lkvecs, nmperpixel, dev)
    if debug:
        print(est, x, c, sep="\n")
    if c > 1e-20:
        est2 = est.copy()
        est2[1] = 90.0
        x2, c2 = _fit_moire_diffs(est2, lkvecs, nmperpixel, dev)
        if c2 < c:
            x, c = x2, c2
    if c > 1e-20:
        lower = np.asarray(_LOWER4)
        active = (x <= lower + 1e-12) & np.isfinite(lower)
        x3, c3 = _fit_moire_diffs(x + 1e-2 * active, lkvecs, nmperpixel,
                                  dev)
        if c3 < c:
            x, c = x3, c3
    params = np.asarray(x, dtype=float)
    if not (np.isfinite(c) and c <= 0.3):
        params = np.full(4, np.nan)
    if reference == "symmetric":
        params[3] = params[3] + params[0] / 2
    return params


def _jac_a0(kvecs, nmperpixel, a_0, sort):
    """(lkvecs, A0): the k-vectors in units of the lattice's r_k (times
    nmperpixel), and the least-squares A0 with lkvecs = k0s @ A0^T."""
    lkvecs = _sorted_lkvecs(kvecs, a_0_to_r_k(a_0) * nmperpixel, sort)
    k0s = generate_ks(1.0, 0.0)[:3]
    return lkvecs, np.linalg.lstsq(k0s, lkvecs, rcond=None)[0].T


def _jac_est(lkvecs):
    return np.array([0.01, 0.0, 0.0,
                     np.rad2deg(np.arctan2(lkvecs[0, 1], lkvecs[0, 0]))
                     % 360])


def Kerelsky_Jac(kvecs, nmperpixel=1.0, a_0=DEFAULTS.a_0, reference=None,
                 debug=False, sort=0, device=None):
    """Fit (theta, psi, epsilon, xi) to the k-space Jacobian JacA0 with
    kvecs = k0s @ JacA0^T. Unless the first bank reaches zero cost, a
    restart bank (psi = 90, and starts inside epsilon > 0 at psi 0, 45,
    -45, 90) runs in one batch and the first of its fits to reach zero
    cost, in that order, wins. Returns numpy (4,)."""
    dev = entry_device(device)
    lkvecs, JacA0 = _jac_a0(kvecs, nmperpixel, a_0, sort)
    est = _jac_est(lkvecs)
    xs, cs = _fit_jac_bank(est[None], JacA0, dev)
    x, c = xs[0], cs[0]
    if c > 1e-20:
        ests = []
        for nudge in ((None, 90.0), (1e-3, None), (1e-3, 45.0),
                      (1e-3, -45.0), (1e-3, 90.0)):
            est2 = est.copy()
            if nudge[0] is not None:
                est2[2] = nudge[0]
            if nudge[1] is not None:
                est2[1] = nudge[1]
            ests.append(est2)
        xs, cs = _fit_jac_bank(np.stack(ests), JacA0, dev)
        for x2, c2 in zip(xs, cs):
            if c2 < c:
                x, c = x2, c2
            if c <= 1e-20:
                break
    if debug:
        print(x, c)
    params = np.asarray(x, dtype=float)
    if reference == "symmetric":
        params[3] = params[3] + params[0] / 2
    return params


def _field_fit(JacA0s, refest):
    """Every pixel's two-start LM against its JacA0 (..., 2, 2): starts at
    refest and at refest + (0, 90, 0, 0), all in one batch; the second
    fit wins where the first's cost is above 1e-5 and the second's lower.
    Returns (..., 4)."""
    flat = JacA0s.reshape(-1, 2, 2)
    B = flat.shape[0]
    alt = refest + torch.tensor([0.0, 90.0, 0.0, 0.0], dtype=refest.dtype,
                                device=refest.device)
    starts = torch.cat([refest.expand(B, 4), alt.expand(B, 4)])
    x, c = _lm_solve(Jac_fit_diff, starts, _LOWER4, _UPPER4,
                     (torch.cat([flat, flat]),))
    use2 = (c[:B] > 1e-5) & (c[B:] < c[:B])
    out = torch.where(use2[:, None], x[B:], x[:B])
    return out.reshape(JacA0s.shape[:-2] + (4,))


def iterate_J_leastsq(JacA0s, refest, lq_kwargs=None, device=None):
    """Per-pixel Kerelsky fits (theta, psi, epsilon, xi) over a JacA0
    field (..., 2, 2), each a two-start LM from refest (4,), in one batch
    on `device` (None: the card), in the promoted dtype of JacA0s and
    refest. Returns (..., 4). lq_kwargs, the reference's scipy options,
    is accepted and unused."""
    JacA0s = entry_tensor(JacA0s, device)
    refest = entry_tensor(refest, device)
    dt = torch.promote_types(JacA0s.dtype, refest.dtype)
    return _field_fit(JacA0s.to(dt), refest.to(dt))


def Kerelsky_J(J, kvecs, nmperpixel=1.0, a_0=DEFAULTS.a_0, reference=None,
               debug=False, sort=0, lq_kwargs=None, device=None):
    """Field version: the reference fit of A0 from kvecs (float64, a
    psi = 90 restart unless it reaches zero cost), then every pixel's fit
    of JacA0 = A0 + A0 @ J for a (..., 2, 2) J field, in J's dtype, from
    that reference. Returns (X (..., 4) on `device`, refest numpy (4,))."""
    dev = entry_device(device)
    lkvecs, A0 = _jac_a0(kvecs, nmperpixel, a_0, sort)
    J = entry_tensor(J, device)
    A0t = torch.as_tensor(A0, device=dev).to(J.dtype)
    JacA0 = A0t + _mm(A0t, J)
    est = _jac_est(lkvecs)
    xs, cs = _fit_jac_bank(est[None], A0, dev)
    x, c = xs[0], cs[0]
    if c > 1e-20:
        est2 = est.copy()
        est2[1] = 90.0
        xs, cs = _fit_jac_bank(est2[None], A0, dev)
        if cs[0] < c:
            x, c = xs[0], cs[0]
    if debug:
        print(x, c)
    refest = np.asarray(x, dtype=float)
    X = _field_fit(JacA0, torch.as_tensor(refest, device=dev).to(J.dtype))
    return X, refest


def moire_props_from_Jac_2_Kerelsky(kvecs, Jac, nmperpixel, a_0=DEFAULTS.a_0,
                                    decomposition=None, device=None):
    """The isotropic part of kvecs fitted by Kerelsky_plus, then the
    double-strain decomposition of Jac @ B(theta_iso): (props, iso_props);
    Jac moves to entry_device(device), where props stay."""
    kvecs = as_tensor(np.asarray(kvecs, np.float64))
    dks = calc_diff_from_isotropic(kvecs)
    iso_props = Kerelsky_plus((kvecs + dks).numpy(), nmperpixel, a_0,
                              device=device)
    Jac = entry_tensor(Jac, device)
    B0 = twist_matrix(iso_props[0]).to(Jac.device, Jac.dtype)
    return double_strain_decomp(_mm(Jac, B0)), iso_props
