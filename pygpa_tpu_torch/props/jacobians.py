"""Per-pixel Jacobian algebra (counterpart of
pygpa_tpu/props/jacobians.py): J = grad(u) fields -> local lattice
properties (twist angle, anisotropy direction and magnitude, scale,
heterostrain).

Everything is elementwise torch on the tensors it is given (their dtype,
their device), with the 2x2 SVD in closed form: svd2x2 returns the
symmetric-Householder left factor LAPACK gives for generic 2x2 inputs,
on which the sign fixing of props_from_Jac relies. Large fields stay in
component planes (props_from_planes, props_from_u). The k-vector
helpers (get_initial_props, kvecs2J) work on the small k-vector set;
kvecs2J's 3x2 least squares runs on the host in float64 numpy."""
import math

import numpy as np
import torch

from ..config import DEFAULTS
from ..core.mathtools import (as_tensor, periodic_average,
                              periodic_difference, standardize_ks,
                              wrap_to_pi)
from ..gpa.kgeometry import calc_diff_from_isotropic, f2angle
from ..lattices.generate import generate_ks
from ..ops.wfr import _np_gradient_2d
from ..solvers.lstsq import weighted_lstsq_stack


def _eye(like):
    return torch.eye(2, dtype=like.dtype, device=like.device)


def _with_row(props, i, fn):
    """props with row i replaced by fn(row i)."""
    out = props.clone()
    out[i] = fn(out[i])
    return out


def svd2x2_planes(a, b, c, d):
    """Closed-form 2x2 SVD on separate component planes (a = A00, b =
    A01, c = A10, d = A11). Returns ((u00, u01, u10, u11), (s0, s1),
    (v00, v01, v10, v11)), all elementwise."""
    E = (a + d) * 0.5
    F = (a - d) * 0.5
    G = (c + b) * 0.5
    H = (c - b) * 0.5
    Q = torch.hypot(E, H)
    R = torch.hypot(F, G)
    sx = Q + R
    det = a * d - b * c
    sy = torch.where(sx > 0, det / torch.where(sx > 0, sx, 1.0), 0.0)
    a1 = torch.atan2(G, F)
    a2 = torch.atan2(H, E)
    theta_u = (a2 + a1) * 0.5
    theta_v = (a1 - a2) * 0.5
    cu, su = torch.cos(theta_u), torch.sin(theta_u)
    cv, sv = torch.cos(theta_v), torch.sin(theta_v)
    sgn = torch.where(sy < 0, -1.0, 1.0).to(sx.dtype)
    u = (cu, su, su, -cu)
    vh = (cv, sv, sgn * sv, -sgn * cv)
    return u, (sx, torch.abs(sy)), vh


def _props_core(a, b, c, d, refangle=0.0, refscale=1.0, diff=False,
                phys=False, poisson_ratio=DEFAULTS.poisson_ratio):
    """The sign-fixed SVD decomposition on component planes: (angle,
    anisotropy angle, scale, anisotropy) stacked on a new leading
    axis."""
    (u00, u01, u10, u11), (s0, s1), (v00, v01, v10, v11) = \
        svd2x2_planes(a, b, c, d)
    # signs = sign(diag(u)); v <- column-scaled; u <- (signs*u)^T
    g0 = torch.sign(u00)
    g1 = torch.sign(u11)
    w00, w01 = g0 * v00, g1 * v01
    w10, w11 = g0 * v10, g1 * v11
    t00, t01 = g0 * u00, g0 * u10   # transposed, column-scaled u
    t10, t11 = g1 * u01, g1 * u11
    # u_p = (u_new @ v_new)^T ; need [0,0] and [1,0] of u_p
    up00 = t00 * w00 + t01 * w10
    up10 = t00 * w01 + t01 * w11   # (u@v)[0,1] -> transposed [1,0]
    angle = torch.rad2deg(torch.atan2(up10, up00))
    aniangle = torch.rad2deg(torch.atan2(t10, t00))
    if phys:
        delta = poisson_ratio
        fourth = (s0 - s1) / (s0 + delta * s1)
        if diff:
            aniangle = aniangle + 90
            alpha = s0 / (1 + fourth)
        else:
            alpha = s1 * (1 + fourth)
    else:
        fourth = s0 / s1
        if diff:
            aniangle = aniangle + 90
            alpha = s0
        else:
            alpha = s1
    aniangle = aniangle % 180
    return torch.stack(torch.broadcast_tensors(
        angle + refangle, aniangle, alpha * refscale, fourth))


def props_from_planes(J00, J01, J10, J11, refangle=0.0, refscale=1.0,
                      diff=False, decomposition=None,
                      poisson_ratio=DEFAULTS.poisson_ratio, jac=False):
    """props_from_Jac on component planes. With jac=False the planes are
    J (I is added here)."""
    eye = 0.0 if jac else 1.0
    return _props_core(J00 + eye, J01, J10, J11 + eye,
                       refangle=refangle, refscale=refscale, diff=diff,
                       phys=(decomposition == "physical"),
                       poisson_ratio=poisson_ratio)


def svd2x2(A):
    """Closed-form SVD of a (..., 2, 2) stack: (u, s, vh) with s
    descending and u in the symmetric Householder form [[c, s], [s, -c]]
    numpy.linalg.svd (LAPACK) gives for generic 2x2 inputs."""
    A = as_tensor(A)
    (u00, u01, u10, u11), (sx, sy), (v00, v01, v10, v11) = svd2x2_planes(
        A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1])
    u = torch.stack([torch.stack([u00, u01], -1),
                     torch.stack([u10, u11], -1)], -2)
    vh = torch.stack([torch.stack([v00, v01], -1),
                      torch.stack([v10, v11], -1)], -2)
    return u, torch.stack([sx, sy], -1), vh


def props_from_Jac(Jac, refangle=0.0, refscale=1.0, diff=False):
    """Local lattice properties from a (stack of) 2x2 Jacobian(s):
    [angle (deg), anisotropy angle (deg, mod 180), scale alpha,
    anisotropy kappa] stacked on a new leading axis."""
    Jac = as_tensor(Jac)
    return _props_core(Jac[..., 0, 0], Jac[..., 0, 1],
                       Jac[..., 1, 0], Jac[..., 1, 1],
                       refangle=refangle, refscale=refscale, diff=diff)


def phys_props_from_Jac(Jac, refangle=0.0, refscale=1.0, diff=False,
                        poisson_ratio=DEFAULTS.poisson_ratio):
    """Physical (heterostrain) decomposition: [angle, strain angle,
    alpha, epsilon]."""
    Jac = as_tensor(Jac)
    return _props_core(Jac[..., 0, 0], Jac[..., 0, 1],
                       Jac[..., 1, 0], Jac[..., 1, 1],
                       refangle=refangle, refscale=refscale, diff=diff,
                       phys=True, poisson_ratio=poisson_ratio)


def props_from_J(J, refangle=0.0, refscale=1.0):
    """props_from_Jac of J + I."""
    J = as_tensor(J)
    return props_from_Jac(J + _eye(J), refangle=refangle, refscale=refscale)


def props_from_J_old(J):
    """The legacy decomposition: [moire angle, anisotropy angle,
    sqrt(s0 s1), s0 / s1]."""
    u, s, v = svd2x2(J)
    angle = u @ v
    moireangle = torch.rad2deg(torch.atan2(angle[..., 1, 0],
                                           angle[..., 0, 0]))
    aniangle = torch.rad2deg(torch.atan2(v[..., 1, 0], v[..., 0, 0])) % 180
    return [moireangle, aniangle, torch.sqrt(s[..., 0] * s[..., 1]),
            s[..., 0] / s[..., 1]]


def u2J_planes(U, nmperpixel):
    """u2J in component planes: (J00, J01, J10, J11) with J[c, d] =
    d(-U_c)/d(x_d) / nmperpixel."""
    gx, gy = _np_gradient_2d(-as_tensor(U))
    return (gx[0] / nmperpixel, gy[0] / nmperpixel,
            gx[1] / nmperpixel, gy[1] / nmperpixel)


def props_from_u(U, nmperpixel, refangle=0.0, refscale=1.0, diff=False,
                 decomposition=None):
    """Local properties directly from a displacement field (2, N, M),
    in component planes."""
    J00, J01, J10, J11 = u2J_planes(U, nmperpixel)
    return props_from_planes(J00, J01, J10, J11, refangle=refangle,
                             refscale=refscale, diff=diff,
                             decomposition=decomposition)


def u2J(U, nmperpixel):
    """J (= -grad u) field (N, M, 2, 2) from a displacement field
    (2, N, M)."""
    gx, gy = _np_gradient_2d(-as_tensor(U))
    return torch.movedim(torch.stack([gx, gy], dim=-1) / nmperpixel, 0, -2)


def u2Jac(U, nmperpixel):
    """I + u2J."""
    J = u2J(U, nmperpixel)
    return _eye(J) + J


def phases2J(kvecs, phases, weights, nmperpixel):
    """J from wrapped phases (G, N, M) via per-pixel gradients and the
    weighted lstsq along kvecs (G, 2)."""
    phases = as_tensor(phases)
    K = 2 * math.pi * as_tensor(kvecs).to(phases.device, phases.dtype)
    gx, gy = _np_gradient_2d(phases)
    dbdx = wrap_to_pi(gx * 2) / 2 / nmperpixel
    dbdy = wrap_to_pi(gy * 2) / 2 / nmperpixel
    dudx = weighted_lstsq_stack(dbdx, K, weights)
    dudy = weighted_lstsq_stack(dbdy, K, weights)
    return torch.movedim(-torch.stack([dudx, dudy], dim=-1), 0, -2)


def phases2Jac(kvecs, phases, weights, nmperpixel):
    """I + phases2J."""
    J = phases2J(kvecs, phases, weights, nmperpixel)
    return _eye(J) + J


def phasegradient2J(kvecs, grads, weights, nmperpixel, iso_ref=True,
                    sort=0):
    """J directly from the WFR per-pixel phase gradients (G, N, M, 2):
    the gradients are rebased to the isotropic reference lattice
    (calc_diff_from_isotropic) before the per-pixel lstsq, which
    counters reference-vector boundary artefacts."""
    grads = as_tensor(grads)
    kvecs = as_tensor(kvecs).to(grads.device, grads.dtype)
    angles = torch.atan2(kvecs[:, 1], kvecs[:, 0])
    if sort == 0:
        lkvecs = kvecs
        order = torch.arange(kvecs.shape[0], device=kvecs.device)
    else:
        order = torch.argsort(sort * periodic_difference(
            angles, periodic_average(angles)), stable=True)
        lkvecs = kvecs[order]
    if iso_ref:
        dks = calc_diff_from_isotropic(lkvecs)
        K = 2 * math.pi * (lkvecs + dks)
        iso_grads = wrap_to_pi(grads[order]
                               - 2 * math.pi * dks[:, None, None, :])
    else:
        K = 2 * math.pi * kvecs
        iso_grads = grads
    dudx = weighted_lstsq_stack(iso_grads[..., 0], K, weights)
    dudy = weighted_lstsq_stack(iso_grads[..., 1], K, weights)
    return torch.movedim(torch.stack([dudx, dudy], dim=-1) / nmperpixel,
                         0, -2)


def phasegradient2Jac(kvecs, grads, weights, nmperpixel):
    """I + phasegradient2J."""
    J = phasegradient2J(kvecs, grads, weights, nmperpixel)
    return _eye(J) + J


def get_initial_props(ks, standardize=False):
    """(mean |k|, reference angle in degrees snapped to the hexagonal
    sector of the first k, symmetry) of a k-vector set."""
    kvecs = as_tensor(standardize_ks(ks) if standardize else ks)
    symmetry = 2 * kvecs.shape[0]
    r_k = torch.linalg.norm(kvecs, dim=1).mean()
    theta_0 = torch.rad2deg(periodic_average(
        torch.atan2(kvecs[:, 1], kvecs[:, 0]), 2 * math.pi / symmetry))
    hexa = torch.arange(-180, 180, 60, device=kvecs.device)
    first_angle = torch.rad2deg(torch.atan2(kvecs[0, 1], kvecs[0, 0]))
    diffind = torch.argmin(torch.abs(theta_0 + hexa - first_angle))
    return r_k, theta_0 + hexa[diffind], symmetry


def get_ref_prop_dict(ks):
    """{'refangle': theta_0, 'refscale': r_k} of a k-vector set."""
    r_k, theta_0, _ = get_initial_props(ks)
    return {"refangle": theta_0, "refscale": r_k}


def kvecs2J(ks, standardize=True):
    """J mapping the isotropic reference lattice onto `ks`: the 3x2 least
    squares krefs J^T = ks - krefs, in float64 on the host, returned in
    the k-vectors' dtype."""
    like = as_tensor(ks)
    kvecs = np.asarray(standardize_ks(np.asarray(like.cpu())) if standardize
                       else like.cpu(), np.float64)
    r_k, theta_0, symmetry = get_initial_props(kvecs)
    krefs = generate_ks(float(r_k), float(theta_0), sym=symmetry)[:3]
    if standardize:
        krefs = standardize_ks(krefs)
    J = np.linalg.lstsq(krefs, kvecs - krefs, rcond=None)[0]
    return torch.as_tensor(J.T, device=like.device).to(like.dtype)


def kvecs2Jac(ks, standardize=True):
    """kvecs2J + I."""
    J = kvecs2J(ks, standardize=standardize)
    return J + _eye(J)


def _J0(theta_iso, like):
    """The twist-difference matrix [[cos t - 1, -sin t], [sin t,
    cos t - 1]] for t = theta_iso degrees, in `like`'s dtype and device."""
    t = torch.deg2rad(as_tensor(theta_iso).to(like.device, like.dtype))
    c, s = torch.cos(t), torch.sin(t)
    return torch.stack([torch.stack([c - 1, -s]), torch.stack([s, c - 1])])


def J_2_J_diff(J, theta_iso):
    """Map a moire J to the layer-difference J: J @ J0(theta_iso)."""
    J = as_tensor(J)
    return J @ _J0(theta_iso, J)


def Jac_2_Jac_diff(Jac, theta_iso):
    """I + J_2_J_diff(Jac - I, theta_iso)."""
    Jac = as_tensor(Jac)
    return _eye(Jac) + J_2_J_diff(Jac - _eye(Jac), theta_iso)


def u_moire_2_u_diff(u, theta_iso):
    """u (..., 2) of the moire to that of the layer difference:
    u @ J0(theta_iso)."""
    u = as_tensor(u)
    return u @ _J0(theta_iso, u)


def Jac_diff_from_phasegradient(kvecs, grads, weights, nmperpixel,
                                a_0=DEFAULTS.a_0):
    """The layer-difference Jacobian from WFR phase gradients."""
    J = phasegradient2J(kvecs, grads, weights, nmperpixel)
    r_k, _, _ = get_initial_props(kvecs)
    theta_iso = f2angle(r_k, nmperpixel=nmperpixel, a_0=a_0)
    return _eye(J) + J_2_J_diff(J, theta_iso)


def calc_props_from_phasegradient(kvecs, grads, weights, nmperpixel):
    """Local property maps (4, N, M) from WFR phase gradients (G, N, M,
    2) and weights (G, N, M): [angle + theta_0, anisotropy angle, scale,
    anisotropy]."""
    Jac = phasegradient2Jac(kvecs, grads, weights, nmperpixel)
    _, theta_0, _ = get_initial_props(kvecs)
    return _with_row(props_from_Jac(Jac), 0, lambda p: p + theta_0)


def calc_props_from_phases(kvecs, phases, weights, nmperpixel):
    """Local property maps from wrapped phases."""
    Jac = phases2Jac(kvecs, phases, weights, nmperpixel)
    _, theta_0, _ = get_initial_props(kvecs)
    return _with_row(props_from_Jac(Jac), 0, lambda p: p + theta_0)


def calc_eps_from_phasegradient(kvecs, grads, weights, nmperpixel):
    """Local lower-bound heterostrain from WFR phase gradients."""
    Jac_diff = Jac_diff_from_phasegradient(kvecs, grads, weights,
                                           nmperpixel)
    kappa = props_from_Jac(Jac_diff)[3]
    delta = DEFAULTS.poisson_ratio
    return (kappa - 1) / (1 + delta * kappa)


def calc_props_from_phasegradient2(kvecs, grads, weights, nmperpixel,
                                   a_0=DEFAULTS.a_0):
    """Uniaxial-strain properties from phase gradients."""
    kvecs = as_tensor(kvecs)
    iso = kvecs + calc_diff_from_isotropic(kvecs)
    theta_iso = f2angle(torch.linalg.norm(iso, dim=1),
                        nmperpixel=nmperpixel).mean()
    xi_iso = (torch.rad2deg(torch.atan2(iso[..., 1], iso[..., 0]))
              % 60).mean()
    J = phasegradient2J(kvecs, grads, weights, nmperpixel)
    props = props_from_J(J_2_J_diff(J, theta_iso))
    props = _with_row(props, 2, lambda p: p * theta_iso)
    return _with_row(props, 0, lambda p: p + xi_iso)


def calc_props_from_kvecs4(ks, decomposition=None, standardize=False):
    """Lattice properties directly from the k-vectors: [angle,
    anisotropy angle, scale, anisotropy] (decomposition="physical":
    heterostrain epsilon in place of the anisotropy)."""
    Jac = kvecs2Jac(ks, standardize=standardize)
    r_k, theta_0, _ = get_initial_props(ks, standardize=standardize)
    if decomposition == "physical":
        props = phys_props_from_Jac(Jac, diff=True)
    else:
        props = props_from_Jac(Jac, diff=True)
    props = _with_row(props, 0, lambda p: p + theta_0)
    return _with_row(props, 2, lambda p: p * r_k)


def moire_props_from_Jac(kvecs, Jac, nmperpixel, a_0=DEFAULTS.a_0,
                         decomposition=None):
    """Moire properties from a Jacobian (field) and the k-vectors."""
    r_k, _, _ = get_initial_props(kvecs)
    theta_iso = f2angle(r_k, nmperpixel=nmperpixel, a_0=a_0)
    Jac_moire = Jac_2_Jac_diff(Jac, theta_iso)
    if decomposition == "physical":
        props = phys_props_from_Jac(Jac_moire)
    else:
        props = props_from_Jac(Jac_moire)
    props = _with_row(props, 0, lambda p: p + theta_iso)
    return _with_row(props, 1, lambda p: p + (-theta_iso / 2))


def calc_moire_props_from_kvecs(ks, nmperpixel=3.7, a_0=DEFAULTS.a_0,
                                decomposition="physical"):
    """Moire properties directly from the k-vectors."""
    Jac = kvecs2Jac(ks, standardize=False)
    return moire_props_from_Jac(as_tensor(ks), Jac, nmperpixel, a_0,
                                decomposition)


def moire_props_from_phasegradient(kvecs, grads, weights, nmperpixel,
                                   a_0=DEFAULTS.a_0, decomposition=None):
    """Moire properties from WFR phase gradients."""
    Jac = phasegradient2Jac(kvecs, grads, weights, nmperpixel)
    return moire_props_from_Jac(kvecs, Jac, nmperpixel, a_0, decomposition)


def twist_matrix(angle):
    """B(theta) = R(theta/2) - R(-theta/2), the k-space twist difference
    matrix; angle in degrees."""
    ha = torch.deg2rad(as_tensor(angle) / 2)
    c, s = torch.cos(ha), torch.sin(ha)
    return (torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
            - torch.stack([torch.stack([c, s]), torch.stack([-s, c])]))


def calc_abcd(J, delta=DEFAULTS.poisson_ratio):
    """Symmetric/antisymmetric decomposition (a, b, c, d) of J."""
    J = as_tensor(J)
    a = (J[..., 0, 0] + J[..., 1, 1]) / (1 - delta)
    b = (J[..., 0, 1] + J[..., 1, 0]) / (1 + delta)
    c = (J[..., 1, 0] - J[..., 0, 1]) / (1 - delta)
    d = (J[..., 1, 1] - J[..., 0, 0]) / (1 + delta)
    return a, b, c, d


def double_strain_decomp(Jac, delta=DEFAULTS.poisson_ratio):
    """Analytical double-strain decomposition (untested in the
    reference, ported as it is): [2 phi (deg), theta (deg), epsa,
    epsb]."""
    a, b, c, d = calc_abcd(Jac, delta=delta)
    bd = b * b + d * d
    alpha = 4 / (1 - delta)
    ca = c * c / (alpha * alpha)
    c0 = bd * (1 + ca * (1 - 2 * torch.sqrt(bd) / alpha))
    c1 = -ca * (1 - 2 * torch.sqrt(bd) / alpha)
    btemp = bd + a * a * (1 - c1)
    epsminus = torch.sqrt(0.5 * (btemp + torch.sqrt(btemp ** 2
                                                    + 4 * a * a * c0)))
    epsplussquare = c0
    for _ in range(2):
        epsplussquare = c0 + c1 * epsminus * epsminus
        epsminussquare = ((bd + a * a) + torch.sqrt(
            (bd + a * a) ** 2 + a * a * epsplussquare)) / 2
        epsminus = torch.sqrt(epsminussquare)
    epsplus = torch.sqrt(epsplussquare)
    phi = torch.arcsin(c / (alpha + epsplus))
    epsr = torch.tan(phi) * epsminus / epsplus
    theta = 0.5 * torch.arctan((b - d * epsr) / (b * epsr + d))
    epsa = 0.5 * (epsplus + epsminus)
    epsb = 0.5 * (epsplus - epsminus)
    return torch.stack(torch.broadcast_tensors(
        2 * torch.rad2deg(phi), torch.rad2deg(theta), epsa, epsb))
