"""Spatial lock-in, the core GPA operation (counterpart of
pygpa_tpu/ops/lockin.py).

lockin_k(r) = IFFT[ G_sigma(q) FFT[ I(r) e^{2 pi i k.r} ] ](r): multiply
by a reference plane wave, low-pass with a Gaussian of width sigma,
transform back. The angle of the result is the geometric phase of the
lattice component at k, its magnitude the local amplitude.
lockin_from_spectrum is the shifted-Gaussian form
IFFT[ FFT[I](q) G_sigma(q + k) ](r), which reuses one spectrum for many
k-vectors (the lock-in demodulated by k).

A k-vector's dtype takes part in the arithmetic as in JAX with float64
enabled: a float64 (numpy or Python) k-vector puts the plane wave's
phase, 2 pi (x kx + y ky), in float64 before it is cast to the image's
dtype, so a float32 lock-in keeps its phase accurate on large images.
"""
import math

import numpy as np
import torch

from ..core import entry_tensor
from ..core.fourier import _real_dtype, fourier_gaussian_multiplier


def _complex_dtype(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _kvec(kvec, device):
    """kvec as a tensor on `device`, in the dtype JAX would give it:
    a tensor's own, a numpy array's, float64 for Python numbers."""
    if not isinstance(kvec, torch.Tensor):
        a = np.array(kvec)
        kvec = torch.from_numpy(a if a.dtype.kind in "fc"
                                else a.astype(np.float64))
    return kvec.to(device)


def plane_wave(shape, kvec, dtype=torch.float32, sign=1.0, device=None):
    """exp(sign * 2 pi i (x kx + y ky)) on the (n, m) pixel grid: the
    phase in the promoted dtype of `dtype` and kvec's, cast to `dtype`,
    then cos and sin."""
    kvec = _kvec(kvec, device)
    pdt = torch.promote_types(dtype, kvec.dtype)
    x = torch.arange(shape[0], device=device).to(pdt)[:, None]
    y = torch.arange(shape[1], device=device).to(pdt)[None, :]
    ph = (2 * math.pi * (x * kvec[0] + y * kvec[1]) * sign).to(dtype)
    return torch.complex(torch.cos(ph), torch.sin(ph)).to(
        _complex_dtype(dtype))


def gpa_lockin(image, kvec, sigma=22.0, device=None):
    """Spatial lock-in of `image` (n, m) at the reference vector kvec
    (kx, ky) in cycles per pixel. The image moves to `device` (None: the
    card; "cpu" for the plain route)."""
    image = entry_tensor(image, device)
    mult = plane_wave(image.shape, kvec, image.dtype, device=image.device)
    X = torch.fft.fft2(image * mult)
    G = fourier_gaussian_multiplier(image.shape, sigma, image.dtype,
                                    image.device)
    return torch.fft.ifft2(G * X)


def gpa_lockin_batch(image, kvecs, sigma=22.0, device=None):
    """Lock-in at each k-vector of kvecs (K, 2): (K, n, m), each slice
    gpa_lockin's result for that k, bit for bit."""
    image = entry_tensor(image, device)
    kvecs = _kvec(kvecs, image.device)
    return torch.stack([gpa_lockin(image, k, sigma, device=image.device)
                        for k in kvecs])


def lockin_from_spectrum(spectrum, kvec, sigma, rebase=None):
    """Lock-in from a precomputed image spectrum (n, m):
    IFFT[ spectrum(q) G_sigma(q + kvec) ], demodulated by kvec; with
    `rebase`, multiplied by the plane wave of rebase (the caller's
    e^{2 pi i k_ref . r})."""
    rdt = _real_dtype(spectrum.dtype)
    k = _kvec(kvec, spectrum.device)
    G = fourier_gaussian_multiplier(spectrum.shape, sigma, rdt,
                                    spectrum.device, shift=(k[0], k[1]))
    out = torch.fft.ifft2(spectrum * G.to(spectrum.dtype))
    if rebase is not None:
        out = out * plane_wave(spectrum.shape, rebase, rdt,
                               device=spectrum.device)
    return out
