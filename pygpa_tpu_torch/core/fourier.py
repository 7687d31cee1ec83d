"""Fourier-domain building blocks (counterpart of a subset of
pygpa_tpu/core/fourier.py): the scipy-convention DCT-II pair the plain
CG twin uses as its preconditioner, and the Gaussian multiplier,
Laplacian transfer and Wiener filter of gaussian_deconvolve. All run on
torch.fft."""
import math

import numpy as np
import torch


def _fftfreq(n, dtype, device):
    # float64 on the host, then one cast (jnp.fft.fftfreq(n).astype)
    return torch.as_tensor(np.fft.fftfreq(n), device=device).to(dtype)


def fourier_gaussian_multiplier(shape, sigma, dtype=torch.float32,
                                device=None):
    """Fourier-domain Gaussian window exp(-2 pi^2 sigma^2 |f|^2) on an
    fft2 grid (scipy.ndimage.fourier_gaussian's multiplier)."""
    fx = _fftfreq(shape[0], dtype, device)
    fy = _fftfreq(shape[1], dtype, device)
    arg = fx[:, None] ** 2 + fy[None, :] ** 2
    s2 = torch.tensor(2.0 * np.pi ** 2, dtype=dtype, device=device) \
        * torch.tensor(float(sigma), dtype=dtype, device=device) ** 2
    return torch.exp(-s2 * arg)


def laplacian_transfer(shape, dtype=torch.float32, device=None):
    """DFT transfer of the periodic 5-point Laplacian (centre 4,
    neighbours -1), skimage.restoration.uft.laplacian's convention."""
    fx = _fftfreq(shape[0], dtype, device)
    fy = _fftfreq(shape[1], dtype, device)
    lap = (2 * torch.cos(2 * math.pi * fx)[:, None]
           + 2 * torch.cos(2 * math.pi * fy)[None, :] - 4.0)
    return -lap


def wiener_deconvolve(image, transfer, balance):
    """Tikhonov-regularized Wiener deconvolution with the Laplacian
    regularizer: IFFT[H / (H^2 + balance L^2) FFT(y)] for a real
    transfer H (skimage.restoration.wiener's estimator)."""
    L = laplacian_transfer(image.shape[-2:], image.dtype, image.device)
    H = transfer
    filt = H / (H * H + balance * L * L)
    return torch.fft.ifft2(torch.fft.fft2(image) * filt).real


def _dct2_last(x):
    """Unnormalized DCT-II along the last axis (scipy.fft.dct,
    norm=None) by Makhoul's single-FFT permutation."""
    n = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    k = torch.arange(n, dtype=x.dtype, device=x.device)
    w = torch.polar(torch.ones_like(k), -math.pi * k / (2 * n))
    return 2 * (torch.fft.fft(v) * w).real


def _idct2_last(y):
    """Exact inverse of _dct2_last (scipy.fft.idct, type 2,
    norm=None)."""
    n = y.shape[-1]
    k = torch.arange(n, dtype=y.dtype, device=y.device)
    ynk = torch.cat([torch.zeros_like(y[..., :1]), y[..., 1:].flip(-1)],
                    dim=-1)
    G = torch.complex(y, -ynk) * 0.5
    F = G * torch.polar(torch.ones_like(k), math.pi * k / (2 * n))
    v = torch.fft.ifft(F).real
    half = (n + 1) // 2
    x = torch.empty_like(y)
    x[..., ::2] = v[..., :half]
    x[..., 1::2] = v[..., half:].flip(-1)
    return x


def dct2n(x):
    """2D DCT-II over the last two axes (scipy.fft.dctn, norm=None)."""
    x = _dct2_last(x)
    return _dct2_last(x.transpose(-1, -2)).transpose(-1, -2)


def idct2n(x):
    """2D inverse DCT-II over the last two axes (scipy.fft.idctn)."""
    x = _idct2_last(x.transpose(-1, -2)).transpose(-1, -2)
    return _idct2_last(x)
