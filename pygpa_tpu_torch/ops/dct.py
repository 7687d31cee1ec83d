"""Single-pass DCT-II and its exact inverse along one axis (scipy.fft
dct/idct, type 2, norm=None) for n in {1024, 2048, 4096, 8192}.

Replaces the TPU kernels ``pygpa_tpu/ops/pallas_dct2.py``
``_fwd_lane_kernel`` (axis -1: ``dct_lane``, ``idct_lane``) and
``_fwd_sub_kernel`` (axis -2: ``dct_sub``, ``idct_sub``). The exact-CG
unwrap's preconditioner ``idct2n(dct2n(r) / eigenvalues)`` runs here on
large images (core.fourier routes an axis here where the reference's
``_pallas_dct_ok`` would: n >= 4096).

Method (``csrc/dct.cu``): the DCT matrix factorises over the digit
splits j = j2*128 + j1, k = k2*128 + k1 as Re[2 U V W] (q = n/128), so a
transform is a q-deep and a 128-deep complex contraction with a
pointwise twiddle between them; one kernel form serves both directions
through the factor tables built here (float64 from integer angles
reduced mod 4n, then float32). The axis -2 kernel never transposes the
array. Launch counts: "dct_lane" and "dct_sub", both directions.

The plain twins are Makhoul's single-FFT DCT pair on torch.fft; a CPU
tensor runs the twin, a CUDA tensor the kernel (or raises).
"""
import functools
import math

import numpy as np
import torch

from . import _build

SIZES = (1024, 2048, 4096, 8192)
_L = 128


def supported(n):
    """Axis lengths the kernels take (128 / q must be an even integer)."""
    return n in SIZES


def dct_lane_plain(x):
    """Plain twin: unnormalized DCT-II along the last axis
    (scipy.fft.dct, norm=None) by Makhoul's single-FFT permutation."""
    n = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    k = torch.arange(n, dtype=x.dtype, device=x.device)
    w = torch.polar(torch.ones_like(k), -math.pi * k / (2 * n))
    return 2 * (torch.fft.fft(v) * w).real


def idct_lane_plain(y):
    """Plain twin: exact inverse of dct_lane_plain (scipy.fft.idct,
    type 2, norm=None)."""
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


def dct_sub_plain(x):
    return dct_lane_plain(x.transpose(-1, -2)).transpose(-1, -2)


def idct_sub_plain(y):
    return idct_lane_plain(y.transpose(-1, -2)).transpose(-1, -2)


def factor_tables(n, inverse):
    """(A (128, q), V (128, 128), B (q, 128)) complex128 factor tables of
    the kernel form out[s*128 + a] = 2 Re sum_b B[s, b] V[a, b]
    sum_t A[a, t] in[t*128 + b] (see csrc/dct.cu). Every angle is
    pi N / (2n) with the integer N reduced mod 4n before the float64
    cos/sin."""
    q = n // _L
    four_n = 4 * n
    r = np.arange(_L, dtype=np.int64)
    t = np.arange(q, dtype=np.int64)

    def tw(N):
        ang = (N % four_n).astype(np.float64) * (np.pi / (2 * n))
        return np.cos(ang) + 1j * np.sin(ang)

    U = tw(_L * np.outer(t, 2 * r + 1))      # (k2, j1)
    V = tw(np.outer(r, 2 * r + 1))           # (k1, j1)
    W = tw(2 * _L * np.outer(r, t))          # (k1, j2)
    if inverse:
        return U.T, V.T, W.T
    return W, V, U


@functools.lru_cache(maxsize=16)
def _device_tables(n, inverse, device):
    """The factor tables as interleaved (re, im) float32 tensors on
    `device`."""
    out = []
    for a in factor_tables(n, inverse):
        ri = np.stack([a.real, a.imag], -1).astype(np.float32)
        out.append(torch.from_numpy(np.ascontiguousarray(ri)).to(device))
    return tuple(out)


def _launch(x, axis, inverse):
    if x.device.type != "cuda":
        raise ValueError(f"dct: unsupported device {x.device}")
    if x.dim() < -axis or x.dtype != torch.float32 \
            or not supported(x.shape[axis]):
        raise ValueError(f"dct kernel needs a float32 tensor whose axis "
                         f"{axis} has a length in {SIZES} (got "
                         f"{x.dtype} {tuple(x.shape)})")
    n = x.shape[axis]
    x = x.contiguous()
    y = torch.empty_like(x)
    A, V, B = _device_tables(n, inverse, x.device)
    scale, half0 = (1.0 / (2 * n), 1) if inverse else (1.0, 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if axis == -1:
            fn = _build.bind("dct_lane", "pppppiifip")
            code = fn(x.data_ptr(), y.data_ptr(), A.data_ptr(),
                      V.data_ptr(), B.data_ptr(), x.numel() // n, n, scale,
                      half0, stream)
        else:
            m = x.shape[-1]
            fn = _build.bind("dct_sub", "pppppiiifip")
            code = fn(x.data_ptr(), y.data_ptr(), A.data_ptr(),
                      V.data_ptr(), B.data_ptr(), x.numel() // (n * m), n, m,
                      scale, half0, stream)
    name = "dct_lane" if axis == -1 else "dct_sub"
    _build.check(code, name)
    _build.launches[name] += 1
    return y


def dct_lane(x):
    """DCT-II along axis -1 (scipy.fft.dct type 2, norm=None)."""
    if x.device.type == "cpu":
        return dct_lane_plain(x)
    return _launch(x, -1, False)


def idct_lane(y):
    """Inverse of dct_lane (scipy.fft.idct type 2, norm=None)."""
    if y.device.type == "cpu":
        return idct_lane_plain(y)
    return _launch(y, -1, True)


def dct_sub(x):
    """DCT-II along axis -2."""
    if x.device.type == "cpu":
        return dct_sub_plain(x)
    return _launch(x, -2, False)


def idct_sub(y):
    """Inverse of dct_sub."""
    if y.device.type == "cpu":
        return idct_sub_plain(y)
    return _launch(y, -2, True)
