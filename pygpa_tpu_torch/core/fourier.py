"""Fourier-domain building blocks (counterpart of a subset of
pygpa_tpu/core/fourier.py): the scipy-convention 2D DCT-II pair of the
unwrap's Poisson preconditioner (routed per axis to the ops.dct kernels
as the reference routes to its Pallas DCT), and the Gaussian
multiplier, Laplacian transfer and Wiener filter of
gaussian_deconvolve, on torch.fft."""
import math

import numpy as np
import torch

from ..ops import dct as _dct


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


def dct_kernel_ok(n, dtype):
    """The reference's _pallas_dct_ok gate, read for the card: an axis of
    length n >= 4096 that the single-pass DCT kernels take, in float32
    (smaller axes ran faster on the XLA transforms on the TPU; the port
    keeps the same split)."""
    return n >= 4096 and _dct.supported(n) and dtype == torch.float32


def dct2n(x):
    """2D DCT-II over the last two axes (scipy.fft.dctn, norm=None): the
    lane axis first, then axis -2, each on the ops.dct kernel where
    dct_kernel_ok holds (one launch per axis, a shared-memory FFT of n/2
    complex points per line; csrc/dct.cu) and on the FFT twin
    otherwise."""
    lane = _dct.dct_lane if dct_kernel_ok(x.shape[-1], x.dtype) \
        else _dct.dct_lane_plain
    sub = _dct.dct_sub if dct_kernel_ok(x.shape[-2], x.dtype) \
        else _dct.dct_sub_plain
    return sub(lane(x))


def idct2n(x):
    """2D inverse DCT-II over the last two axes (scipy.fft.idctn), in
    the reference's order: axis -2 first, then the lane axis."""
    sub = _dct.idct_sub if dct_kernel_ok(x.shape[-2], x.dtype) \
        else _dct.idct_sub_plain
    lane = _dct.idct_lane if dct_kernel_ok(x.shape[-1], x.dtype) \
        else _dct.idct_lane_plain
    return lane(sub(x))
