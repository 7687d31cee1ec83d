"""Windowed Fourier Filtering of the port (gpa.wff, device="cpu") against
pygpa_tpu.gpa.wff on the CPU, on the same seeded numpy images, and the
reference's own denoising gates (tests/test_imagetools.py) on the
port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpa_tpu.gpa.wff import _gabor_spectrum as j_gabor, wff as j_wff
import pygpa_tpu_torch.gpa as tgpa
from pygpa_tpu_torch.gpa.wff import _gabor_spectrum as t_gabor

torch.set_num_threads(2)


def _fringes(n, m, noise, seed):
    """cos(0.6 x + 0.5 y) plus seeded Gaussian noise of std `noise`."""
    xx, yy = np.meshgrid(np.arange(n), np.arange(m), indexing="ij")
    clean = np.cos(0.6 * xx + 0.5 * yy)
    return clean, clean + noise * np.random.default_rng(seed).normal(
        size=clean.shape)


@pytest.mark.parametrize("shape,sigma,wx,wy", [((96, 96), 5, 0.4, -0.3),
                                               ((96, 128), 8, -0.55, 0.9)])
def test_gabor_spectrum_matches(shape, sigma, wx, wy):
    """The embedded, rolled wavelet's DFT in float64 within 1e-10 of the
    reference's largest value."""
    want = np.asarray(j_gabor(shape, sigma, wx, wy, jnp.complex128))
    got = t_gabor(shape, sigma, torch.tensor(wx, dtype=torch.float64),
                  torch.tensor(wy, dtype=torch.float64),
                  torch.complex128).numpy()
    assert got.shape == shape
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-5)])
def test_wff_matches(dtype, tol):
    """wff at 96 x 128 (sigma 8, thresholds 1 and 3, the 0.3..0.9 rad/px
    grid) in the image's dtype, within tol of the reference's peak: 1e-10
    in float64, 1e-5 in float32."""
    _, noisy = _fringes(96, 128, 1.0, 7)
    img = noisy.astype(dtype)
    want = np.asarray(j_wff(jnp.asarray(img), sigma=8, threshold=[1.0, 3.0],
                            wl=0.3, wu=0.9))
    got = tgpa.wff(img, 8, [1.0, 3.0], 0.3, 0.9, device="cpu")
    assert got.dtype == torch.from_numpy(img).dtype
    assert tuple(got.shape) == (2, 96, 128)
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


def test_wff_denoises_fringes():
    """tests/test_imagetools.py's gates on the port: correlation with the
    clean fringes above 0.97 on the 16-px interior, and above the noisy
    input's."""
    clean, noisy = _fringes(128, 128, 1.0, 2)
    out = tgpa.wff(noisy, sigma=8, threshold=[3.0], wl=0.3, wu=0.9,
                   device="cpu")[0].numpy()
    sl = np.s_[16:-16, 16:-16]
    c0 = np.corrcoef(noisy[sl].ravel(), clean[sl].ravel())[0, 1]
    c1 = np.corrcoef(out[sl].ravel(), clean[sl].ravel())[0, 1]
    assert c1 > 0.97
    assert c1 > c0
