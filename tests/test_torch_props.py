"""The port's property extraction (pygpa_tpu_torch.props and the k-vector
helpers under it: core.mathtools, lattices.transformations,
gpa.kgeometry, solvers.lstsq) against pygpa_tpu on the CPU: every
function in float64 on the same seeded inputs, the chain wfr2_grad_opt
-> calc_props_from_phasegradient on a strained lattice, and hypothesis
round trips mirroring tests/test_props.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import pygpa_tpu.core.mathtools as jmt
import pygpa_tpu.gpa.kgeometry as jkg
import pygpa_tpu.lattices.transformations as jtr
import pygpa_tpu.props as jpe
import pygpa_tpu.solvers.lstsq as jls
from pygpa_tpu import gpa as jgpa
from pygpa_tpu.lattices import generate_ks, hexlattice_gen
import pygpa_tpu_torch.core.mathtools as tmt
import pygpa_tpu_torch.gpa.kgeometry as tkg
import pygpa_tpu_torch.lattices.transformations as ttr
import pygpa_tpu_torch.props as tpe
import pygpa_tpu_torch.solvers.lstsq as tls
from pygpa_tpu_torch.gpa import api as tapi

torch.set_num_threads(2)

RNG = np.random.default_rng(2024)
KS = np.asarray(generate_ks(0.05, 10.0, kappa=1.02, psi=25.0))[:3]
KS6 = np.asarray(generate_ks(0.05, 10.0, kappa=1.02, psi=25.0))
JAC = np.eye(2) + 0.05 * RNG.normal(size=(4, 5, 2, 2))
PLANES = tuple(JAC[..., i, j] for i in range(2) for j in range(2))
U = 0.3 * RNG.normal(size=(2, 9, 11)).cumsum(axis=1)
PHASES = 2 * np.pi * np.einsum("kc,cnm->knm", KS, U) + 0.1 * RNG.normal(
    size=(3, 9, 11))
GRADS = 2 * np.pi * KS[:, None, None, :] + 0.02 * RNG.normal(
    size=(3, 9, 11, 2))
WEIGHTS = RNG.uniform(0.5, 1.5, size=(3, 9, 11))
ANGLES = RNG.uniform(-np.pi, np.pi, size=7)

# name -> fn(module namespace, convert) on the shared inputs; each case
# runs through both packages
CASES = {
    "svd2x2": lambda p, c: p.svd2x2(c(JAC)),
    "svd2x2_planes": lambda p, c: p.svd2x2_planes(*map(c, PLANES)),
    "props_from_Jac": lambda p, c: p.props_from_Jac(c(JAC), 3.0, 2.0),
    "props_from_Jac_diff": lambda p, c: p.props_from_Jac(c(JAC), diff=True),
    "phys_props_from_Jac": lambda p, c: p.phys_props_from_Jac(c(JAC)),
    "phys_props_from_Jac_diff": lambda p, c: p.phys_props_from_Jac(
        c(JAC), diff=True),
    "props_from_J": lambda p, c: p.props_from_J(c(JAC - np.eye(2)), 1.0, 2.0),
    "props_from_J_old": lambda p, c: p.props_from_J_old(c(JAC)),
    "props_from_planes": lambda p, c: p.props_from_planes(
        *map(c, PLANES), decomposition="physical", jac=True),
    "u2J": lambda p, c: p.u2J(c(U), 0.7),
    "u2J_planes": lambda p, c: p.u2J_planes(c(U), 0.7),
    "u2Jac": lambda p, c: p.u2Jac(c(U), 0.7),
    "props_from_u": lambda p, c: p.props_from_u(c(U), 0.7),
    "phases2J": lambda p, c: p.phases2J(c(KS), c(PHASES), c(WEIGHTS), 0.7),
    "phases2Jac": lambda p, c: p.phases2Jac(c(KS), c(PHASES), c(WEIGHTS),
                                            0.7),
    "phasegradient2J": lambda p, c: p.phasegradient2J(
        c(KS), c(GRADS), c(WEIGHTS), 0.7),
    "phasegradient2J_sorted": lambda p, c: p.phasegradient2J(
        c(KS), c(GRADS), c(WEIGHTS), 0.7, sort=1),
    "phasegradient2J_no_iso": lambda p, c: p.phasegradient2J(
        c(KS), c(GRADS), c(WEIGHTS), 0.7, iso_ref=False),
    "phasegradient2Jac": lambda p, c: p.phasegradient2Jac(
        c(KS), c(GRADS), c(WEIGHTS), 0.7),
    "get_initial_props": lambda p, c: p.get_initial_props(c(KS)),
    "get_initial_props_standardized": lambda p, c: p.get_initial_props(
        KS6, standardize=True),
    "get_ref_prop_dict": lambda p, c: tuple(p.get_ref_prop_dict(
        c(KS)).values()),
    "kvecs2J": lambda p, c: p.kvecs2J(c(KS), standardize=False),
    "kvecs2J_standardized": lambda p, c: p.kvecs2J(KS6),
    "kvecs2Jac": lambda p, c: p.kvecs2Jac(c(KS), standardize=False),
    "J_2_J_diff": lambda p, c: p.J_2_J_diff(c(JAC - np.eye(2)), 1.3),
    "Jac_2_Jac_diff": lambda p, c: p.Jac_2_Jac_diff(c(JAC), 1.3),
    "u_moire_2_u_diff": lambda p, c: p.u_moire_2_u_diff(
        c(np.moveaxis(U, 0, -1)), 1.3),
    "Jac_diff_from_phasegradient": lambda p, c: p.Jac_diff_from_phasegradient(
        c(KS), c(GRADS), c(WEIGHTS), 0.7),
    "calc_props_from_phasegradient": lambda p, c:
        p.calc_props_from_phasegradient(c(KS), c(GRADS), c(WEIGHTS), 0.7),
    "calc_props_from_phases": lambda p, c: p.calc_props_from_phases(
        c(KS), c(PHASES), c(WEIGHTS), 0.7),
    "calc_eps_from_phasegradient": lambda p, c:
        p.calc_eps_from_phasegradient(c(KS), c(GRADS), c(WEIGHTS), 0.7),
    "calc_props_from_phasegradient2": lambda p, c:
        p.calc_props_from_phasegradient2(c(KS), c(GRADS), c(WEIGHTS), 0.7),
    "calc_props_from_kvecs4": lambda p, c: p.calc_props_from_kvecs4(c(KS)),
    "calc_props_from_kvecs4_physical": lambda p, c:
        p.calc_props_from_kvecs4(c(KS), decomposition="physical"),
    "moire_props_from_Jac": lambda p, c: p.moire_props_from_Jac(
        c(KS), c(JAC), 0.7, decomposition="physical"),
    "calc_moire_props_from_kvecs": lambda p, c:
        p.calc_moire_props_from_kvecs(c(KS - KS[[1, 2, 0]] * 0.98)),
    "moire_props_from_phasegradient": lambda p, c:
        p.moire_props_from_phasegradient(c(KS), c(GRADS), c(WEIGHTS), 0.7),
    "twist_matrix": lambda p, c: p.twist_matrix(1.7),
    "calc_abcd": lambda p, c: p.calc_abcd(c(JAC - np.eye(2))),
    "double_strain_decomp": lambda p, c: p.double_strain_decomp(
        c(np.asarray(jpe.twist_matrix(2.0)) + np.diag([0.01, 0.005]))),
}


HELPERS = {
    "periodic_average": lambda m, c: m.mt.periodic_average(
        c(ANGLES), period=2 * np.pi / 6),
    "periodic_average_axis": lambda m, c: m.mt.periodic_average(
        c(ANGLES.reshape(1, 7)), axis=1),
    "periodic_difference": lambda m, c: m.mt.periodic_difference(
        c(ANGLES), c(ANGLES[::-1]), period=np.pi),
    "remove_negative_duplicates": lambda m, c:
        m.mt.remove_negative_duplicates(np.concatenate([KS6, -KS6])),
    "standardize_ks": lambda m, c: m.mt.standardize_ks(KS6[::-1]),
    "wrap_to_pi": lambda m, c: m.mt.wrap_to_pi(c(7 * ANGLES)),
    "rotate": lambda m, c: m.tr.rotate(c(KS), 0.4),
    "scaling_matrix": lambda m, c: m.tr.scaling_matrix(1.3),
    "strain_matrix": lambda m, c: m.tr.strain_matrix(0.02, axis=1),
    "a_0_to_r_k": lambda m, c: m.tr.a_0_to_r_k(0.246),
    "r_k_to_a_0": lambda m, c: m.tr.r_k_to_a_0(0.1),
    "epsilon_to_kappa": lambda m, c: m.tr.epsilon_to_kappa(0.1, 0.02),
    "kappa_to_epsilon": lambda m, c: m.tr.kappa_to_epsilon(1.02),
    "apply_transformation_matrix": lambda m, c:
        m.tr.apply_transformation_matrix(c(KS), jtr.strain_matrix(0.03)),
    "average_lattice_vector": lambda m, c: m.kg.average_lattice_vector(
        c(KS6)),
    "calc_diff_from_isotropic": lambda m, c: m.kg.calc_diff_from_isotropic(
        c(KS)),
    "ratio2angle": lambda m, c: m.kg.ratio2angle(c(np.array([0.01, 0.3]))),
    "f2angle": lambda m, c: m.kg.f2angle(c(np.array([0.02, 0.05])), 0.5),
    "weighted_lstsq_stack": lambda m, c: m.ls.weighted_lstsq_stack(
        c(PHASES), c(2 * np.pi * KS), c(WEIGHTS)),
    "weighted_lstsq_stack_rcond": lambda m, c: m.ls.weighted_lstsq_stack(
        c(PHASES), c(2 * np.pi * KS), c(WEIGHTS), rcond_eps=1e-3),
}


class _Mods:
    def __init__(self, mt, tr, kg, ls):
        self.mt, self.tr, self.kg, self.ls = mt, tr, kg, ls


def _tensor(a):
    return torch.from_numpy(np.array(a))


def _flat(x):
    """Every array in a (nested) result, as float64 numpy."""
    if isinstance(x, (tuple, list)):
        return [a for e in x for a in _flat(e)]
    if isinstance(x, dict):
        return _flat(list(x.values()))
    if isinstance(x, torch.Tensor):
        return [x.numpy().astype(np.float64)]
    return [np.asarray(x, np.float64)]


def _assert_same(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", sorted(CASES))
def test_jacobians_match_reference(name):
    """Each function of props/jacobians.py in float64 on the same inputs
    (Jacobian fields (4, 5, 2, 2), a displacement field (2, 9, 11), three
    peaks' phases, gradients and weights): within 1e-9 of the
    reference."""
    want = CASES[name](jpe, jnp.asarray)
    got = CASES[name](tpe, _tensor)
    _assert_same(got, want)


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_kvector_helpers_match_reference(name):
    """The helpers props builds on (core.mathtools, lattices
    .transformations, gpa.kgeometry, solvers.lstsq) in float64: within
    1e-9 of the reference."""
    want = HELPERS[name](_Mods(jmt, jtr, jkg, jls), jnp.asarray)
    got = HELPERS[name](_Mods(tmt, ttr, tkg, tls), _tensor)
    _assert_same(got, want)


def test_props_keep_dtype_and_device():
    """float32 planes stay float32 (the card's working type) when the
    k-vector set is float64 numpy: the k-vectors take the planes' type,
    as under the reference's float32 default; the maps then agree with
    the reference's float64 chain to float32 rounding."""
    grads = torch.from_numpy(GRADS.astype(np.float32))
    weights = torch.from_numpy(WEIGHTS.astype(np.float32))
    out = tpe.calc_props_from_phasegradient(KS, grads, weights, 1.0)
    assert out.dtype == torch.float32 and out.shape == (4, 9, 11)
    want = np.asarray(jpe.calc_props_from_phasegradient(
        jnp.asarray(KS), jnp.asarray(GRADS), jnp.asarray(WEIGHTS), 1.0))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-4)


def test_props_chain_on_strained_lattice():
    """tests/test_props_e2e.py's chain on its strained lattice (r_k 0.08,
    theta 16, kappa 1.02, psi 25, 256^2, float64): wfr2_grad_opt per peak,
    then calc_props_from_phasegradient. The maps on the 64-px interior
    are constant (std < 0.05 deg, < 1e-3) and give theta within 0.1 deg
    (mod 60), kappa within 2e-3 and the anisotropy angle within 2 deg of
    psi + 90 (mod 180), the bounds of that test; and they equal the
    reference's chain within 1e-9."""
    r_k, theta, kappa, psi = 0.08, 16.0, 1.02, 25.0
    img = np.asarray(hexlattice_gen(r_k, theta, order=1, size=256,
                                    kappa=kappa, psi=psi, dtype=np.float64))
    ks = np.asarray(generate_ks(r_k, theta, kappa=kappa, psi=psi))[:3]
    img0 = img - img.mean()
    knorms = np.linalg.norm(ks, axis=1)
    kw = knorms.mean() / 2.5
    sigma = int(np.ceil(1 / knorms.min()))
    gs = [tapi.wfr2_grad_opt(img0, sigma, pk[0], pk[1], kw, kw / 3,
                             device="cpu") for pk in ks]
    grads = torch.stack([g["grad"] for g in gs])
    weights = torch.stack([g["lockin"].abs() for g in gs])
    props = tpe.calc_props_from_phasegradient(ks, grads, weights, 1.0)
    p = props.numpy()
    c = np.s_[64:-64, 64:-64]
    assert p[0][c].std() < 0.05 and p[3][c].std() < 1e-3
    assert abs(_pd(p[0][c].mean(), theta, 60)) < 0.1
    assert abs(p[3][c].mean() - kappa) < 2e-3
    assert abs(_pd(p[1][c].mean(), psi + 90, 180)) < 2.0
    jg = [jgpa.wfr2_grad_opt(img0, sigma, pk[0], pk[1], kw, kw / 3)
          for pk in ks]
    want = np.asarray(jpe.calc_props_from_phasegradient(
        jnp.asarray(ks), jnp.stack([g["grad"] for g in jg]),
        jnp.stack([jnp.abs(g["lockin"]) for g in jg]), nmperpixel=1.0))
    np.testing.assert_allclose(p, want, rtol=1e-9, atol=1e-9)


def _pd(x, y, period):
    return float(tmt.periodic_difference(torch.as_tensor(x), y,
                                         period=period))


@settings(deadline=None, max_examples=30)
@given(theta=st.floats(0.0, 360.0),
       psi=st.floats(-90.0, 90.0),
       kappa=st.floats(1.0 + 1e-7, 1e4, exclude_min=True),
       a=st.floats(1e-10, 1e10, exclude_min=True))
def test_props_from_J_round_trip(theta, psi, kappa, a):
    """tests/test_props.py's round trip for the port: a Jacobian built as
    V^T D(kappa a, a) V W(theta) gives back theta, psi, a and kappa."""
    W = ttr.rotation_matrix(np.deg2rad(theta))
    V = ttr.rotation_matrix(np.deg2rad(psi))
    D = ttr.scaling_matrix(kappa) * a
    props = tpe.props_from_Jac(torch.from_numpy(V.T @ D @ V @ W)).numpy()
    assert np.isclose(_pd(props[0], theta, 360), 0, atol=1e-6)
    assert np.isclose(_pd(props[1], psi, 180), 0, atol=1e-5)
    assert np.isclose(props[2], a) and np.isclose(props[3], kappa)


@settings(deadline=None, max_examples=30)
@given(theta=st.floats(-180.0 + 1e-3, 180.0),
       psi=st.floats(-90.0, 90.0),
       kappa=st.floats(1.0 + 1e-7, 1e3, exclude_min=True),
       a=st.floats(1e-9, 1e9, exclude_min=True))
def test_calc_props_from_kvecs_round_trip(theta, psi, kappa, a):
    """The README's calc_props_from_kvecs4 recovers generate_ks's theta
    (mod 60), psi (mod 180), r_k and kappa (tests/test_props.py)."""
    kvecs = np.asarray(generate_ks(a, theta, kappa=kappa, psi=psi))[:3]
    props = tpe.calc_props_from_kvecs4(torch.from_numpy(np.array(kvecs)))
    props = props.numpy()
    assert np.isclose(_pd(props[0], theta, 60), 0, atol=1e-3)
    assert np.isclose(_pd(props[1], psi, 180), 0, atol=1e-2)
    assert np.isclose(props[2], a) and np.isclose(props[3], kappa)


@settings(deadline=None, max_examples=30)
@given(theta=st.floats(1e-2, 60 - 1e-2, exclude_min=True),
       psi=st.floats(-90.0, 90.0),
       kappa=st.floats(1.0 + 1e-7, 1.1, exclude_min=True),
       a=st.floats(1e-9, 1e9, exclude_min=True))
def test_kvecs2Jac_maps_the_reference_lattice(theta, psi, kappa, a):
    """kvecs2Jac (its 3x2 lstsq in float64 on the host) maps the
    isotropic reference lattice onto the k-vectors (tests/test_props.py)."""
    ks = np.asarray(generate_ks(a, theta, kappa=kappa, psi=psi))[:3]
    kt = torch.from_numpy(np.array(ks))
    Jac = tpe.kvecs2Jac(kt, standardize=False).numpy()
    r_kl, theta_0, symmetry = tpe.get_initial_props(kt)
    krefs = np.asarray(generate_ks(float(r_kl), float(theta_0),
                                   sym=int(symmetry)))[:-1]
    d = np.linalg.norm((krefs @ Jac.T)[None] - ks[:, None], axis=-1).min(1)
    assert np.allclose(d / float(r_kl), 0, atol=1e-3)
