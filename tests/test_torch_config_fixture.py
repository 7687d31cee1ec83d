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
