"""Fourier-domain building blocks (counterpart of
pygpa_tpu/core/fourier.py without its TPU matmul FFT): the
scipy-convention DCT-II pair of the unwrap's Poisson preconditioner
(routed per axis to the ops.dct kernels as the reference routes to its
Pallas DCT; the 1-D forms along the last axis are the kernels' Makhoul
twins), the Gaussian multiplier, Laplacian transfer and Wiener filter of
gaussian_deconvolve, the Moisan periodic-plus-smooth decomposition and
FFT smoothing of peak detection, and fftbounds (host numpy), on
torch.fft."""
import math

import numpy as np
import torch

from .mathtools import as_tensor


def _fftfreq(n, dtype, device):
    """np.fft.fftfreq(n).astype(dtype) built on `device`: the integer bins
    times 1 / n in float64 (numpy's own arithmetic), then one cast, so
    the bits are numpy's and nothing is copied from the host (a copy to
    the card waits for its stream)."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    k = torch.where(k < (n + 1) // 2, k, k - n)
    return (k * (1.0 / n)).to(dtype)


def _real_dtype(dtype):
    return dtype.to_real() if dtype.is_complex else dtype


def _gauss_s2(sigma, dtype):
    """2 pi^2 sigma^2 rounded as in `dtype` (2 pi^2 and sigma each
    rounded, then the square and the product), as a Python float that
    the dtype holds exactly."""
    t = np.float32 if dtype == torch.float32 else np.float64
    return float(t(2.0 * np.pi ** 2) * t(float(sigma)) ** 2)


def fourier_gaussian_multiplier(shape, sigma, dtype=torch.float32,
                                device=None, shift=(0.0, 0.0)):
    """Fourier-domain Gaussian window exp(-2 pi^2 sigma^2 |f + shift|^2)
    on an fft2 grid (scipy.ndimage.fourier_gaussian's multiplier at
    shift 0), built on `device`. The frequencies are cast to `dtype`
    before the shift is added, so a float64 tensor shift gives a float64
    window, as JAX promotes a float64 k-vector (lockin_from_spectrum)."""
    sdt = dtype
    for s in shift:
        if isinstance(s, torch.Tensor):
            sdt = torch.promote_types(sdt, s.dtype)
    fx = _fftfreq(shape[0], dtype, device).to(sdt) + shift[0]
    fy = _fftfreq(shape[1], dtype, device).to(sdt) + shift[1]
    arg = fx[:, None] ** 2 + fy[None, :] ** 2
    return torch.exp(-_gauss_s2(sigma, dtype) * arg)


def laplacian_transfer(shape, dtype=torch.float32, device=None):
    """DFT transfer of the periodic 5-point Laplacian (centre 4,
    neighbours -1), skimage.restoration.uft.laplacian's convention,
    built on `device`."""
    fx = _fftfreq(shape[0], dtype, device)
    fy = _fftfreq(shape[1], dtype, device)
    lap = (2 * torch.cos(2 * math.pi * fx)[:, None]
           + 2 * torch.cos(2 * math.pi * fy)[None, :] - 4.0)
    return -lap


def wiener_filter(transfer, laplacian, balance):
    """The Wiener estimator's Fourier filter H / (H^2 + balance L^2) for a
    real transfer H and the Laplacian regularizer's transfer L
    (skimage.restoration.wiener's)."""
    H, L = transfer, laplacian
    return H / (H * H + balance * L * L)


def wiener_deconvolve(image, transfer, balance):
    """Tikhonov-regularized Wiener deconvolution with the Laplacian
    regularizer: IFFT[H / (H^2 + balance L^2) FFT(y)] for a real
    transfer H (skimage.restoration.wiener's estimator)."""
    L = laplacian_transfer(image.shape[-2:], image.dtype, image.device)
    filt = wiener_filter(transfer, L, balance)
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


def dct2_1d(x):
    """Unnormalized DCT-II along the last axis (scipy.fft.dct, norm=None),
    any length: the Makhoul twin of the ops.dct lane kernel."""
    return _dct.dct_lane_plain(x)


def idct2_1d(y):
    """Exact inverse of dct2_1d (scipy.fft.idct, type 2, norm=None)."""
    return _dct.idct_lane_plain(y)


def moisan_per(image, inverse_dft=True):
    """Moisan periodic-plus-smooth decomposition image = p + s (over the
    last two axes): the smooth component solves a discrete Laplace
    equation driven by the boundary jumps, so p's DFT lacks the cross
    that non-periodic borders leave, and Bragg peaks stand clean. With
    inverse_dft=False returns (p_dft, s_dft), else (p, s).

    L. Moisan, "Periodic plus smooth image decomposition", J. Math.
    Imaging Vis. 39, 161-179 (2011)."""
    image = as_tensor(image)
    m, n = image.shape[-2:]
    dt, dev = _real_dtype(image.dtype), image.device
    arg_m = torch.as_tensor(2 * np.pi * np.fft.fftfreq(m), device=dev).to(dt)
    arg_n = torch.as_tensor(2 * np.pi * np.fft.fftfreq(n), device=dev).to(dt)
    cos_m, sin_m = torch.cos(arg_m), torch.sin(arg_m)
    cos_n, sin_n = torch.cos(arg_n), torch.sin(arg_n)
    # the boundary image's DFT: along axis -2 from the first and last
    # rows' jump, along axis -1 from the first and last columns'
    w1 = image[..., -1, :] - image[..., 0, :]
    v_dft = torch.fft.fft(w1)[..., None, :] \
        * torch.complex(1.0 - cos_m, -sin_m)[:, None]
    w2 = image[..., :, -1] - image[..., :, 0]
    v_dft = v_dft + torch.fft.fft(w2)[..., :, None] \
        * torch.complex(1.0 - cos_n, -sin_n)[None, :]
    denom = 2.0 * (cos_m[:, None] + cos_n[None, :] - 2.0)
    denom[0, 0] = 1.0
    s_dft = v_dft / denom
    s_dft[..., 0, 0] = 0.0
    p_dft = torch.fft.fft2(image) - s_dft
    if inverse_dft:
        return torch.fft.ifft2(p_dft).real, torch.fft.ifft2(s_dft).real
    return p_dft, s_dft


def gaussian_filter_fft(image, sigma):
    """Gaussian smoothing of the last two axes by Fourier multiplication
    (circular boundary; the peak finder's near-periodic spectra)."""
    image = as_tensor(image)
    mult = fourier_gaussian_multiplier(image.shape[-2:], sigma,
                                       _real_dtype(image.dtype), image.device)
    return torch.fft.ifft2(torch.fft.fft2(image) * mult).real


def fftbounds(n, d=1):
    """Frequency bin edges for pcolormesh-style plotting (host numpy)."""
    r = np.fft.fftshift(np.fft.fftfreq(n, d))
    return np.append(r, r[-1] + 1 / (n * d))


# imported last: the ops package's own init imports this module's
# helpers (ops.lockin, ops.wfr), so it must find them defined
from ..ops import dct as _dct  # noqa: E402
