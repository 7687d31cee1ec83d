"""The port's single-pass DCT (pygpa_tpu_torch.ops.dct, plain twins on
the CPU) against pygpa_tpu.ops.pallas_dct2 in interpret mode and
scipy.fft, the kernel's factor tables against scipy through a numpy
emulation of the kernel's arithmetic, and the dct2n/idct2n route
against the reference's _pallas_dct_ok gate."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.fft import dct as sdct
from scipy.fft import idct as sidct

import pygpa_tpu.core.fourier as JF
from pygpa_tpu.ops import pallas_dct2 as JD
from pygpa_tpu_torch.core import fourier as TF
from pygpa_tpu_torch.ops import _build
from pygpa_tpu_torch.ops import dct as TD

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [1024, 2048])
def test_twins_match_interpret_kernel_and_scipy(n):
    """Float64 (the conftest enables x64), as tests/test_core.py holds
    the Pallas kernels to scipy: forward to 1e-9, inverse to 1e-11."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, n))
    y = sdct(x, type=2, axis=-1)
    got = TD.dct_lane(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, y, atol=1e-9)
    np.testing.assert_allclose(got, np.asarray(JD.dct_lane(
        jnp.asarray(x), interpret=True)), atol=1e-9)
    back = TD.idct_lane(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(back, x, atol=1e-11)
    np.testing.assert_allclose(back, np.asarray(JD.idct_lane(
        jnp.asarray(y), interpret=True)), atol=1e-11)
    x2 = rng.normal(size=(n, 136))
    y2 = sdct(x2, type=2, axis=0)
    got = TD.dct_sub(torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(got, y2, atol=1e-9)
    np.testing.assert_allclose(got, np.asarray(JD.dct_sub(
        jnp.asarray(x2), interpret=True)), atol=1e-9)
    back = TD.idct_sub(torch.from_numpy(y2)).numpy()
    np.testing.assert_allclose(back, x2, atol=1e-11)
    np.testing.assert_allclose(back, np.asarray(JD.idct_sub(
        jnp.asarray(y2), interpret=True)), atol=1e-11)


def test_float32_twins_match_scipy():
    """The float32 twins (what the kernels are held to on the card)
    within 1e-5 normwise of the float64 transform."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 2048)).astype(np.float32)
    for fn, ref in ((TD.dct_lane, sdct(x.astype(np.float64), axis=-1)),
                    (TD.idct_lane, sidct(x.astype(np.float64), axis=-1))):
        got = fn(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def _kernel_form(x, n, inverse):
    """numpy float64 emulation of csrc/dct.cu's arithmetic along the last
    axis: input scaling, stage A over the q digit, the V twiddle, stage
    B over the 128 digit, the factor 2."""
    A, V, B = TD.factor_tables(n, inverse)
    xin = np.array(x, np.float64)
    if inverse:
        xin = xin / (2 * n)
        xin[..., 0] *= 0.5
    X = xin.reshape(x.shape[:-1] + (n // 128, 128))           # [t][b]
    H = np.einsum("at,...tb->...ab", A, X) * V
    return 2 * np.einsum("sb,...ab->...sa", B, H).real.reshape(x.shape)


@pytest.mark.parametrize("n", TD.SIZES)
def test_factor_tables_reproduce_scipy(n):
    x = np.random.default_rng(n).normal(size=(2, n))
    for inverse, ref in ((False, sdct(x, type=2, axis=-1)),
                         (True, sidct(x, type=2, axis=-1))):
        got = _kernel_form(x, n, inverse)
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_route_matches_reference_gate(monkeypatch):
    """dct2n/idct2n send an axis to the kernels exactly where the
    reference's _pallas_dct_ok would on its accelerator (read as the
    card), in float32; float64 stays on the FFT twins."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for n in (512, 1024, 2048, 4096, 8192, 4100, 16384):
        assert TF.dct_kernel_ok(n, torch.float32) == JF._pallas_dct_ok(n), n
        assert not TF.dct_kernel_ok(n, torch.float64)


def test_dct2n_pair_on_the_route_sizes():
    """A (2, 4096, 128) float32 stack: the lane axis stays on the twin
    (128 < 4096), axis -2 is a kernel-route axis (the twin on the CPU);
    the pair matches scipy's dctn/idctn."""
    from scipy.fft import dctn, idctn
    x = np.random.default_rng(5).normal(size=(2, 4096, 128))
    x32 = torch.from_numpy(x.astype(np.float32))
    _build.launches.clear()
    y = TF.dct2n(x32)
    ref = dctn(x, axes=(-2, -1))
    assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    back = TF.idct2n(torch.from_numpy(ref.astype(np.float32))).numpy()
    assert np.abs(back - idctn(ref, axes=(-2, -1))).max() <= 1e-5 * np.abs(
        x).max()
    assert sum(_build.launches.values()) == 0


def test_kernel_wrappers_refuse_other_devices():
    meta = torch.empty((2, 4096), device="meta")
    for fn in (TD.dct_lane, TD.idct_lane, TD.dct_sub, TD.idct_sub):
        with pytest.raises(ValueError, match="device"):
            fn(meta)
