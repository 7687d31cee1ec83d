"""Windowed Fourier Filtering, Kemao-style fringe denoising (counterpart
of pygpa_tpu/gpa/wff.py).

A bank of Gabor wavelets over an (wx, wy) frequency grid: each
wavelet's coefficients are the image convolved with it, those of
magnitude at or above a threshold are kept and convolved with it again,
and the bank's results are summed. Each convolution is a product with
the wavelet's spectrum on the image's shared spectrum, so boundaries are
circular (scipy's reflect convolution in the reference package differs
only in a rim, tests/test_parity_deviations.py).

Reference: Kemao, Opt. Lasers Eng. 45, 304 (2007),
https://doi.org/10.1016/j.optlaseng.2005.10.012
"""
import math

import numpy as np
import torch

from ..core import entry_tensor


def _gabor_spectrum(shape, sigma, wx, wy, cdtype, device=None):
    """DFT of the Gabor wavelet w(r) exp(i (wx x + wy y)) on the (2s)^2
    grid x = -s..s-1 (s = round(2 sigma)), embedded at offset 0 and
    rolled so that offset 0 lands at index 0: multiplying a spectrum by
    it convolves circularly."""
    s = int(round(2 * sigma))
    n, m = shape
    rdt = torch.empty((), dtype=cdtype).real.dtype
    x = torch.arange(-s, s, dtype=rdt, device=device)
    g1 = torch.exp(-x ** 2 / (2 * sigma ** 2))
    w = g1[:, None] * g1[None, :]
    w = w / torch.sqrt((w ** 2).sum())
    ph = (wx * x[:, None] + wy * x[None, :]).to(rdt)
    kern = torch.zeros((n, m), dtype=cdtype, device=device)
    kern[:2 * s, :2 * s] = w * torch.complex(torch.cos(ph), torch.sin(ph))
    return torch.fft.fft2(torch.roll(kern, (-s, -s), dims=(0, 1)))


def wff(image, sigma, threshold, wl, wu, verbose=False, device=None):
    """Windowed Fourier Filtering of `image` with Gaussian window width
    `sigma`: for each frequency of the (wl..wu, step 1/sigma rad/px)^2
    grid, the Gabor coefficients of magnitude >= threshold[i] are kept
    and re-synthesized. Returns a (len(threshold), N, M) stack in the
    image's dtype (complex128 spectra for float64, complex64 otherwise),
    on `device` (None: the card)."""
    image = entry_tensor(image, device)
    thresholds = torch.as_tensor(np.asarray(threshold, np.float64),
                                 device=image.device).to(image.dtype)
    wi = 1.0 / sigma
    ws = np.arange(wl, wu + wi / 2, wi)
    wgrid = torch.as_tensor(
        np.stack(np.meshgrid(ws, ws, indexing="ij"), -1).reshape(-1, 2),
        device=image.device).to(image.dtype)
    cdt = torch.complex128 if image.dtype == torch.float64 \
        else torch.complex64
    F = torch.fft.fft2(image).to(cdt)
    gs = torch.zeros((thresholds.shape[0],) + tuple(image.shape),
                     dtype=image.dtype, device=image.device)
    for wx, wy in wgrid:
        K = _gabor_spectrum(image.shape, sigma, wx, wy, cdt, image.device)
        sf = torch.fft.ifft2(F * K)
        keep = sf.abs()[None] >= thresholds[:, None, None]
        sfi = torch.where(keep, sf[None], torch.zeros((), dtype=cdt,
                                                      device=image.device))
        gs = gs + torch.fft.ifft2(torch.fft.fft2(sfi) * K).real
    return gs * (wi * wi / (4 * math.pi ** 2))
