"""The port's Kerelsky fits (pygpa_tpu_torch.props.kerelsky, device="cpu")
against pygpa_tpu.props.kerelsky on the CPU, on the same moire
k-vectors and J fields, plus tests/test_kerelsky.py's round-trip gates
on the port. The single fits run in float64 in both packages (x64 is on
in the tests); the field fits in the dtype they are given.

Fits that reach zero cost from several starts of the multi-start bank
are equal solutions, and which of them has the lowest cost is a matter
of rounding: the parameters are compared with the angles modulo their
periods (psi 180 degrees, xi 360), as tests/test_kerelsky.py compares
them with the truth."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.props as jp
import pygpa_tpu.props.kerelsky as jk
from pygpa_tpu.lattices import generate_ks
from pygpa_tpu.lattices.transformations import a_0_to_r_k, epsilon_to_kappa
import pygpa_tpu_torch.props as tp
import pygpa_tpu_torch.props.kerelsky as tk

torch.set_num_threads(2)
# (theta, psi, epsilon, a, xi) inside tests/test_kerelsky.py's ranges
PARAMS = [(2.0, 15.0, 0.01, 0.246, 5.0), (1.5, 30.0, 0.02, 0.246, 10.0),
          (0.5, -60.0, 1e-3, 1.0, -30.0), (30.0, -20.0, 0.08, 10.0, -75.0)]


def _moire_ks(theta, psi, epsilon, a, xi):
    """tests/test_kerelsky.py's moire k-vectors."""
    ks1 = np.asarray(generate_ks(float(a_0_to_r_k(a)), xi, kappa=1,
                                 psi=psi))
    r_k2, kappa = [float(z) for z in
                   epsilon_to_kappa(float(a_0_to_r_k(a)), epsilon)]
    ks2 = np.asarray(generate_ks(r_k2, xi + theta, kappa=kappa, psi=psi))
    return ks2[:3] - ks1[:3]


def pdiff(x, y, period):
    return (np.asarray(x) - np.asarray(y) + period / 2) % period - period / 2


def _same_params(got, want, tol=1e-6):
    """theta and epsilon within tol, psi and xi within tol modulo 180
    and 360 degrees."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert abs(got[0] - want[0]) < tol
    assert abs(got[2] - want[2]) < tol
    assert abs(pdiff(got[1], want[1], 180)) < tol
    if len(got) > 3:
        assert abs(pdiff(got[3], want[3], 360)) < tol


def _round_trip(props, theta, psi, epsilon, xi):
    """tests/test_kerelsky.py's round-trip gates."""
    assert np.isclose(pdiff(abs(props[0]), theta, 60), 0, atol=1e-2)
    assert np.isclose(pdiff(props[1], psi, 180), 0, atol=1e-2)
    assert np.isclose(props[2], epsilon, rtol=1e-3, atol=1e-6)
    assert np.isclose(pdiff(props[3], xi, 360), 0, atol=1e-2)


def test_moire_amplitudes_match():
    """|ks1 - ks2| within 1e-12 of the reference's, and a tensor of
    parameters broadcasting to a (B, 3) batch."""
    want = np.asarray(jp.moire_amplitudes(2.0, 15.0, 0.01))
    got = tp.moire_amplitudes(2.0, 15.0, 0.01)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    th = torch.tensor([2.0, 3.0], dtype=torch.float64)
    batch = tp.moire_amplitudes(th, torch.full((2,), 15.0,
                                               dtype=torch.float64),
                                torch.full((2,), 0.01, dtype=torch.float64))
    assert tuple(batch.shape) == (2, 3)
    np.testing.assert_allclose(batch[0].numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lm_solve_matches(dtype):
    """_lm_solve on one Kerelsky_Jac residual from a start off the
    solution: the fit and its cost within 1e-8 of the reference's in
    float64 (relative to max(1, |x|)); in float32 the fit within 1e-3 of
    the float64 one and its cost below 1e-6 (60 iterations from
    (0.01, 0, 0, xi0))."""
    _, A0 = jk._jac_a0(_moire_ks(*PARAMS[1]), 1.0, 0.246, 0)
    x0 = np.array([0.01, 10.0, 0.0, 5.0])
    xj, cj = jk._lm_solve(lambda p: jk.Jac_fit_diff(p, jnp.asarray(A0)),
                          jnp.asarray(x0), jk._LOWER4, jk._UPPER4)
    xt, ct = tk._lm_solve(tk.Jac_fit_diff,
                          torch.tensor(x0, dtype=dtype)[None], tk._LOWER4,
                          tk._UPPER4, (torch.tensor(A0, dtype=dtype)[None],))
    assert xt.dtype == ct.dtype == dtype
    xj, xt = np.asarray(xj), xt[0].double().numpy()
    if dtype == torch.float64:
        assert np.abs(xt - xj).max() <= 1e-8 * max(1.0, np.abs(xj).max())
        assert abs(float(ct[0]) - float(cj)) <= 1e-8 * max(1.0, float(cj))
    else:
        assert np.abs(xt - xj).max() < 1e-3
        assert float(ct[0]) < 1e-6


@pytest.fixture(scope="module")
def reference_fits():
    """The reference's three single fits on every PARAMS set."""
    out = {}
    for i, p in enumerate(PARAMS):
        mks = _moire_ks(*p)
        out[("Kerelsky", i)] = jp.Kerelsky(mks, a_0=p[3])
        out[("Kerelsky_plus", i)] = jp.Kerelsky_plus(mks, nmperpixel=1,
                                                     a_0=p[3])
        out[("Kerelsky_Jac", i)] = jp.Kerelsky_Jac(mks, nmperpixel=1,
                                                   a_0=p[3])
    return out


@pytest.mark.parametrize("i", range(len(PARAMS)))
@pytest.mark.parametrize("name", ["Kerelsky_plus", "Kerelsky_Jac"])
def test_single_fits_match(reference_fits, name, i):
    """Kerelsky_plus and Kerelsky_Jac: numpy float64 (4,), within 1e-6 of
    the reference's fit (angles modulo their periods) and through
    tests/test_kerelsky.py's round-trip gates, as is the reference's."""
    theta, psi, epsilon, a, xi = PARAMS[i]
    got = getattr(tp, name)(_moire_ks(*PARAMS[i]), nmperpixel=1, a_0=a,
                            device="cpu")
    want = np.asarray(reference_fits[(name, i)])
    assert isinstance(got, np.ndarray) and got.shape == (4,)
    _same_params(got, want)
    _round_trip(want, theta, psi, epsilon, xi)
    _round_trip(got, theta, psi, epsilon, xi)


@pytest.mark.parametrize("i", range(len(PARAMS)))
def test_amplitude_fit_matches(reference_fits, i):
    """Kerelsky (the |k| amplitudes alone): within 1e-6 of the
    reference's fit, and tests/test_kerelsky.py's amplitude gates
    (|theta| within 5e-2 degrees, epsilon within 1e-3)."""
    theta, psi, epsilon, a, xi = PARAMS[i]
    got = tp.Kerelsky(_moire_ks(*PARAMS[i]), a_0=a, device="cpu")
    assert got.shape == (3,)
    _same_params(got, reference_fits[("Kerelsky", i)])
    assert np.isclose(abs(got[0]), theta, atol=5e-2)
    assert np.isclose(got[2], epsilon, atol=1e-3)


def test_symmetric_reference_and_the_gate():
    """reference="symmetric" adds theta / 2 to xi in both fits; k-vectors
    that no start fits within the cost gate give NaNs, as the
    reference's."""
    mks = _moire_ks(*PARAMS[0])
    for name in ("Kerelsky_plus", "Kerelsky_Jac"):
        plain = getattr(tp, name)(mks, device="cpu")
        sym = getattr(tp, name)(mks, reference="symmetric", device="cpu")
        assert abs(sym[3] - plain[3] - plain[0] / 2) < 1e-12
    bad = np.array([[0.3, 0.0], [0.0, 0.01], [-0.5, -0.5]])
    want = np.asarray(jp.Kerelsky_plus(bad))
    got = tp.Kerelsky_plus(bad, device="cpu")
    assert np.isnan(want).all() and np.isnan(got).all()


def _field(A0, n=8):
    """run_all.py config 5f's field: A0 plus a 1e-3 sin/cos perturbation,
    (n, n, 2, 2)."""
    xg, yg = np.meshgrid(np.linspace(0, 2 * np.pi, n),
                         np.linspace(0, 2 * np.pi, n), indexing="ij")
    pert = 1e-3 * np.stack([np.sin(xg), np.cos(yg), np.sin(xg + yg),
                            np.cos(xg - yg)], -1).reshape(n, n, 2, 2)
    return A0[None, None] + pert


def test_iterate_J_leastsq_matches():
    """The per-pixel field fit on config 5f's perturbed field at 8 x 8,
    from the same refest: float64 within 1e-6 of the reference's; the
    port's float32 fit (float32 out) within 1e-3 degrees of its float64
    one in theta, psi and xi, epsilon within 1e-5."""
    mks = _moire_ks(*PARAMS[1])
    refest = np.asarray(jp.Kerelsky_Jac(mks))
    _, A0 = jk._jac_a0(mks, 1.0, 0.246, 0)
    J = _field(A0)
    want = np.asarray(jp.iterate_J_leastsq(jnp.asarray(J),
                                           jnp.asarray(refest)))
    got = tp.iterate_J_leastsq(J, refest, device="cpu")
    assert got.dtype == torch.float64 and tuple(got.shape) == (8, 8, 4)
    assert np.abs(got.numpy() - want).max() < 1e-6
    g32 = tp.iterate_J_leastsq(J.astype(np.float32),
                               refest.astype(np.float32), device="cpu")
    assert g32.dtype == torch.float32
    d = np.abs(g32.double().numpy() - got.numpy())
    assert d[..., [0, 1, 3]].max() < 1e-3
    assert d[..., 2].max() < 1e-5


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kerelsky_J_matches(dtype):
    """Kerelsky_J on a seeded (4, 5) J field: refest within 1e-6 of the
    reference's; X (in J's dtype) within 1e-6 of the reference's in
    float64, and the float32 X within 1e-3 degrees of the port's float64
    X (epsilon 1e-5)."""
    mks = _moire_ks(*PARAMS[1])
    J = 1e-3 * np.random.default_rng(0).normal(size=(4, 5, 2, 2))
    Xj, rj = jp.Kerelsky_J(jnp.asarray(J), mks)
    X64, r64 = tp.Kerelsky_J(J, mks, device="cpu")
    _same_params(r64, np.asarray(rj))
    assert np.abs(X64.numpy() - np.asarray(Xj)).max() < 1e-6
    if dtype == np.float32:
        X, r = tp.Kerelsky_J(J.astype(dtype), mks, device="cpu")
        assert X.dtype == torch.float32
        np.testing.assert_array_equal(r, r64)
        d = np.abs(X.double().numpy() - X64.numpy())
        assert d[..., [0, 1, 3]].max() < 1e-3
        assert d[..., 2].max() < 1e-5


def test_kerelsky_J_constant_field():
    """tests/test_kerelsky.py's field case on the port: a zero J field
    fits to refest at every pixel (1e-4), and refest round-trips theta
    and epsilon."""
    X, refest = tp.Kerelsky_J(np.zeros((4, 5, 2, 2)),
                              _moire_ks(1.5, 30.0, 0.02, 0.246, 10.0),
                              nmperpixel=1, a_0=0.246, device="cpu")
    X = X.numpy()
    assert X.shape == (4, 5, 4)
    for i in range(4):
        assert np.allclose(X[..., i], refest[i], atol=1e-4)
    assert np.isclose(pdiff(abs(refest[0]), 1.5, 60), 0, atol=1e-2)
    assert np.isclose(refest[2], 0.02, rtol=1e-2)


def test_moire_props_from_Jac_2_Kerelsky_matches():
    """The isotropic fit's theta and epsilon within 1e-6 of the
    reference's and xi modulo 360 (at epsilon = 0 psi is not
    determined), and the double-strain props of Jac @ B(theta) within
    1e-9 of the reference's largest value (NaNs where the reference's
    are)."""
    kvecs = _moire_ks(*PARAMS[0]) * np.array([1.002, 0.999])
    Jac = 1e-3 * np.random.default_rng(1).normal(size=(3, 4, 2, 2))
    pj, ij = jp.moire_props_from_Jac_2_Kerelsky(kvecs, jnp.asarray(Jac), 1.0)
    pt, it = tp.moire_props_from_Jac_2_Kerelsky(kvecs, Jac, 1.0,
                                                device="cpu")
    assert abs(it[0] - ij[0]) < 1e-6 and abs(it[2] - ij[2]) < 1e-6
    assert abs(pdiff(it[3], ij[3], 360)) < 1e-6
    pj, pt = np.asarray(pj), pt.numpy()
    assert pt.shape == pj.shape
    np.testing.assert_array_equal(np.isnan(pt), np.isnan(pj))
    assert np.nanmax(np.abs(pt - pj)) <= 1e-9 * np.nanmax(np.abs(pj))
