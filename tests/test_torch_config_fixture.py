"""pygpa_tpu_torch against pygpa_tpu on the CPU: configuration, the
lattice fixture and the elementwise / Fourier / lstsq building blocks.
Inputs are made with numpy and handed to both packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch

import pygpa_tpu.config as jcfg
import pygpa_tpu.core.fourier as jfourier
import pygpa_tpu.core.mathtools as jmath
import pygpa_tpu.lattices as jlat
import pygpa_tpu.lattices.transformations as jtrans
import pygpa_tpu.solvers.lstsq as jlstsq
import pygpa_tpu_torch.config as tcfg
import pygpa_tpu_torch.core.fourier as tfourier
import pygpa_tpu_torch.core.mathtools as tmath
import pygpa_tpu_torch.lattices as tlat
import pygpa_tpu_torch.solvers.lstsq as tlstsq

torch.set_num_threads(2)


def test_defaults_equal_field_by_field():
    jf = {f.name for f in dataclasses.fields(jcfg.GPAConfig)}
    tf = {f.name for f in dataclasses.fields(tcfg.GPAConfig)}
    assert jf == tf
    assert dataclasses.asdict(jcfg.DEFAULTS) == dataclasses.asdict(
        tcfg.DEFAULTS)


@pytest.mark.parametrize("r_k,theta,kappa,psi", [
    (0.02, 5.0, 1.005, 10.0), (0.1, 7.0, 1.0, 0.0), (0.12, 33.0, 1.1, -20.)])
def test_generate_ks_and_anisotropy(r_k, theta, kappa, psi):
    np.testing.assert_allclose(
        tlat.anisotropy_matrix(kappa, psi),
        np.asarray(jtrans.anisotropy_matrix(kappa, psi)), atol=1e-15)
    want = np.asarray(jlat.generate_ks(r_k, theta, kappa=kappa, psi=psi))
    got = tlat.generate_ks(r_k, theta, kappa=kappa, psi=psi)
    assert got.shape == want.shape == (7, 2)
    np.testing.assert_allclose(got, want, atol=1e-15)


def _gauss_shift(size, amp):
    S = size // 2
    xp, yp = np.meshgrid(np.arange(-S, S), np.arange(-S, S), indexing="ij")
    xs = amp * xp * np.exp(-0.5 * ((xp / (2 * S / 8)) ** 2
                                   + 1.2 * (yp / (2 * S / 6)) ** 2))
    return np.stack((xs, np.zeros_like(xs)))


@pytest.mark.parametrize("shifted", [False, True])
def test_hexlattice_fixture_matches(shifted):
    """The bench fixture's generator at 256^2: float64 renders agree to
    rounding; the float32 port (rendered in float64, cast once) agrees
    with the reference's float32 render within atol 1e-4 (the
    reference's own float32 phase rounding at |k.r| ~ 100 rad)."""
    size, args = 256, (0.12, 5.0)
    kw = dict(order=2, size=size, kappa=1.005, psi=10.0)
    shift = _gauss_shift(size, 0.1).astype(np.float32) if shifted else None
    j64 = np.asarray(jlat.hexlattice_gen(*args, shift=shift,
                                         dtype=np.float64, **kw))
    t64 = tlat.hexlattice_gen(*args, shift=shift, dtype=torch.float64,
                              **kw).numpy()
    np.testing.assert_allclose(t64, j64, atol=1e-9)
    j32 = np.asarray(jlat.hexlattice_gen(*args, shift=shift,
                                         dtype=jnp.float32, **kw))
    t32 = tlat.hexlattice_gen(*args, shift=shift, dtype=torch.float32,
                              **kw)
    assert t32.dtype == torch.float32 and j32.dtype == np.float32
    np.testing.assert_allclose(t32.numpy(), j32, atol=1e-4)


@pytest.mark.parametrize("shifted", [False, True])
def test_anylattice_fixture_matches(shifted):
    """anylattice_gen with the reference's default amplitudes (ones),
    called as the reference is, with no device (the CPU): float64 renders
    agree to rounding (atol 1e-9), the float32 render (float64, cast
    once) with the reference's float32 render within atol 1e-4, as in
    test_hexlattice_fixture_matches, and order_amplitudes=None renders
    the bits of explicit ones."""
    size = 64
    ks = np.concatenate([tlat.generate_ks(0.12, 5.0, kappa=1.005,
                                          psi=10.0)[:3],
                         [[0.05, -0.21], [0.3, 0.07]]])
    shift = _gauss_shift(size, 0.1).astype(np.float32) if shifted else None
    t64 = tlat.anylattice_gen(ks, size=size, shift=shift,
                              dtype=torch.float64)
    j64 = np.asarray(jlat.anylattice_gen(ks, size=size, shift=shift,
                                         dtype=np.float64))
    assert t64.dtype == torch.float64 and t64.device.type == "cpu"
    np.testing.assert_allclose(t64.numpy(), j64, atol=1e-9)
    t32 = tlat.anylattice_gen(ks, size=size, shift=shift)
    j32 = np.asarray(jlat.anylattice_gen(ks, size=size, shift=shift,
                                         dtype=np.float32))
    assert t32.dtype == torch.float32 and j32.dtype == np.float32
    np.testing.assert_allclose(t32.numpy(), j32, atol=1e-4)
    ones = tlat.anylattice_gen(ks, np.ones(len(ks)), size=size, shift=shift)
    assert torch.equal(t32, ones)


def test_lattices_export_the_references_transformations():
    """pygpa_tpu_torch.lattices exports every name pygpa_tpu.lattices
    does, and the transformations give the reference's values."""
    names = ("rotation_matrix", "rotate", "scaling_matrix", "strain_matrix",
             "a_0_to_r_k", "r_k_to_a_0", "epsilon_to_kappa",
             "kappa_to_epsilon", "apply_transformation_matrix",
             "anisotropy_matrix", "generate_ks", "hexlattice_gen",
             "anylattice_gen")
    for name in names:
        assert callable(getattr(jlat, name)) and name in tlat.__all__
    vecs = np.random.default_rng(4).normal(size=(5, 2))
    M = tlat.strain_matrix(0.02, axis=1) @ tlat.scaling_matrix(1.01)
    pairs = [
        (tlat.rotation_matrix(0.3), jlat.rotation_matrix(0.3)),
        (tlat.rotate(vecs, 0.7).numpy(), jlat.rotate(vecs, 0.7)),
        (M, np.asarray(jlat.strain_matrix(0.02, axis=1))
         @ np.asarray(jlat.scaling_matrix(1.01))),
        (tlat.apply_transformation_matrix(vecs, M).numpy(),
         jlat.apply_transformation_matrix(vecs, jnp.asarray(M))),
        (tlat.a_0_to_r_k(2.46), jlat.a_0_to_r_k(2.46)),
        (tlat.r_k_to_a_0(0.12), jlat.r_k_to_a_0(0.12)),
        (tlat.epsilon_to_kappa(0.1, 0.01), jlat.epsilon_to_kappa(0.1, 0.01)),
        (tlat.kappa_to_epsilon(1.01), jlat.kappa_to_epsilon(1.01))]
    for got, want in pairs:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                                   atol=1e-15)


def test_wrap_to_pi_matches():
    x = np.random.default_rng(0).normal(scale=20, size=(64, 64))
    x = x.astype(np.float32)
    np.testing.assert_allclose(
        tmath.wrap_to_pi(torch.from_numpy(x)).numpy(),
        np.asarray(jmath.wrap_to_pi(jnp.asarray(x))), atol=2e-6)


def test_weighted_lstsq_stack_matches():
    rng = np.random.default_rng(1)
    b = rng.normal(size=(3, 40, 50)).astype(np.float32)
    w = rng.uniform(0.1, 2.0, size=(3, 40, 50)).astype(np.float32)
    K = (2 * np.pi * np.asarray(jlat.generate_ks(0.1, 7.0))[:3]).astype(
        np.float32)
    want = np.asarray(jlstsq.weighted_lstsq_stack(
        jnp.asarray(b), jnp.asarray(K), jnp.asarray(w)))
    got = tlstsq.weighted_lstsq_stack(torch.from_numpy(b), K,
                                      torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 64), (48, 80)])
def test_dct_pair_matches_scipy(shape):
    x = np.random.default_rng(2).normal(size=(2,) + shape)
    y = tfourier.dct2n(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, scipy.fft.dctn(x, axes=(-2, -1)),
                               rtol=1e-10, atol=1e-9)
    back = tfourier.idct2n(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(back, x, atol=1e-10)


def test_fourier_filters_match():
    shape, sigma = (96, 80), 6.0
    np.testing.assert_allclose(
        tfourier.fourier_gaussian_multiplier(shape, sigma).numpy(),
        np.asarray(jfourier.fourier_gaussian_multiplier(shape, sigma,
                                                        jnp.float32)),
        rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        tfourier.laplacian_transfer(shape).numpy(),
        np.asarray(jfourier.laplacian_transfer(shape, jnp.float32)),
        atol=1e-5)
    img = np.random.default_rng(3).normal(size=(2,) + shape).astype(
        np.float32)
    H = np.array(jfourier.fourier_gaussian_multiplier(shape, sigma,
                                                        jnp.float32))
    want = np.asarray(jfourier.wiener_deconvolve(jnp.asarray(img),
                                                 jnp.asarray(H), 50.0))
    got = tfourier.wiener_deconvolve(torch.from_numpy(img),
                                     torch.from_numpy(H), 50.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
