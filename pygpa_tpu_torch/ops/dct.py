"""Single-pass DCT-II and its exact inverse along one axis (scipy.fft
dct/idct, type 2, norm=None) for n in {1024, 2048, 4096, 8192}.

Replaces the TPU kernels ``pygpa_tpu/ops/pallas_dct2.py``
``_fwd_lane_kernel`` (axis -1: ``dct_lane``, ``idct_lane``) and
``_fwd_sub_kernel`` (axis -2: ``dct_sub``, ``idct_sub``). core.fourier's
2D pair routes an axis here where the reference's ``_pallas_dct_ok``
would (n >= 4096): the row-sharded solver's pencil DCT, the unweighted
multigrid's Poisson solve, the torch CG loop (float64 aside) and the
early-stopping kernel's solves off its FFT sides. The early-stopping
kernel's FFT route (csrc/cg_unwrap.cu) runs the same passes inside its
own launches, so the eager paths launch no dct_lane or dct_sub; at its
even sides that are not powers of two it runs a chirp-z pass of the same
frame (``csrc/cg_unwrap_czt.cu`` czt_kernel, tables
:func:`bluestein_tables`).

Method (``csrc/dct.cu``): Makhoul's DCT through a real FFT of the
permuted line, done as a complex FFT of n/2 points in shared memory
(radix-8/16 Stockham passes, ``RADICES``) with the permutation in the
load and the real-FFT split and post-twiddle in the store; the inverse
is its mirror image. Each element is read from and written to device
memory once; the axis -1 kernel moves each row 16 bytes at a time, the
axis -2 kernel works on strips of adjacent columns and never
transposes. The twiddles are one table per (n, direction)
(``kernel_tables``: float64 from integer angles reduced mod 4n, then
float32). Launch counts: "dct_lane" and "dct_sub", both directions.

The plain twins are Makhoul's single-FFT DCT pair on torch.fft; a CPU
tensor runs the twin, a CUDA tensor the kernel (or raises).
"""
import functools
import math

import numpy as np
import torch

from . import _build

SIZES = (1024, 2048, 4096, 8192)


def supported(n):
    """Axis lengths the kernels take."""
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


# radices of the kernels' Stockham passes, in order, per n / 2 (as
# csrc/dct_fft.cuh's Plan; the CPU tests emulate the passes from it);
# n / 2 = 64, 128, 256 are the multigrid CG's sides 128, 256, 512
# (ops/cg.py), which reach the passes through csrc/cg.cu only
RADICES = {64: (8, 8), 128: (16, 8), 256: (16, 16), 512: (8, 8, 8),
           1024: (16, 8, 8), 2048: (16, 16, 8), 4096: (16, 16, 16)}


def kernel_tables(n, inverse):
    """The kernels' complex128 twiddle tables for a line of n (N = n/2),
    s = -1 forward and +1 inverse: tw[m] = e^(2 pi i s m / N) (m < N,
    the FFT), w[k] = e^(i pi s k / 2n) (k <= N; divided by 2n for the
    inverse) and A[k] = e^(2 pi i s k / n) (k <= N/2). Every angle is
    pi M / (2n) with the integer M reduced mod 4n before the float64
    cos/sin."""
    N = n // 2
    s = 1.0 if inverse else -1.0

    def root(M):
        ang = (M % (4 * n)).astype(np.float64) * (np.pi / (2 * n))
        return np.cos(ang) + 1j * s * np.sin(ang)

    tw = root(8 * np.arange(N))
    w = root(np.arange(N + 1))
    if inverse:
        w = w / (2 * n)
    return tw, w, root(4 * np.arange(N // 2 + 1))


def czt_length(n):
    """L of the chirp-z pass over a line of even n: the power of two >=
    n - 1 (= 2N - 1, N = n / 2)."""
    return 1 << (n - 2).bit_length()


# L = L1 x L2 of the chirp-z pass's four-step FFT_L (csrc/cg_unwrap_czt.cu
# CztSplit): L2 threads a line, each holding up to L1 complex values
CZT_SPLIT = {256: (16, 16), 512: (32, 16), 1024: (32, 32), 2048: (64, 32),
             4096: (64, 64)}


def bluestein_tables(n, inverse):
    """The chirp-z pass's complex128 tables for a line of even n whose
    N = n/2 has no Stockham plan (csrc/cg_unwrap_czt.cu czt_kernel), s =
    -1 forward and +1 inverse, L = czt_length(n) = L1 L2 (CZT_SPLIT), in
    the order the kernel reads them: the four-step FFT_L's twiddles twA
    [k1 L2 + m2] = e^(-2 pi i k1 m2 / L) (k1 < L1, m2 < L2) and twC[j2 L1
    + k1] = e^(-2 pi i j2 k1 / L) (j2 < L2; both directions: the kernel's
    inverse FFT_L is a conjugated forward one), Bh = FFT_L(b) / L of b =
    conj(c) laid out circularly (b_j at j and L - j, zero between N and
    L - N; natural order, read at k1 + L1 k2), the chirp c[m] = e^(i pi s
    m^2 / N) (m < N), and kernel_tables' w (N + 1) and A (N/2 + 1).
    Angles come from integers before the float64 cos/sin (products
    reduced mod L, m^2 mod 2N for the chirp); Bh is a float64 FFT of that
    chirp."""
    N = n // 2
    L = czt_length(n)
    L1, L2 = CZT_SPLIT[L]
    s = 1.0 if inverse else -1.0

    def root(M):
        ang = (M % L).astype(np.float64) * (2 * np.pi / L)
        return np.cos(ang) - 1j * np.sin(ang)

    k1 = np.arange(L1, dtype=np.int64)
    twA = root(np.outer(k1, np.arange(L2))).ravel()
    twC = root(np.outer(np.arange(L2), k1)).ravel()
    m = np.arange(N, dtype=np.int64)
    ang = ((m * m) % (2 * N)).astype(np.float64) * (np.pi / N)
    c = np.cos(ang) + 1j * s * np.sin(ang)
    b = np.zeros(L, complex)
    b[:N] = np.conj(c)
    b[L - N + 1:] = np.conj(c[1:])[::-1]
    _, w, A = kernel_tables(n, inverse)
    return twA, twC, np.fft.fft(b) / L, c, w, A


@functools.lru_cache(maxsize=32)
def _device_table(n, inverse, device):
    """The kernels' table at n as interleaved (re, im) float32 on
    `device`: kernel_tables' tw, w and A one after the other where n / 2
    has a Stockham plan, else bluestein_tables' twA, twC, Bh, c, w and
    A."""
    tables = kernel_tables if n // 2 in RADICES else bluestein_tables
    t = np.concatenate(tables(n, inverse))
    ri = np.stack([t.real, t.imag], -1).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(ri)).to(device)


def _launch(x, axis, inverse):
    """Launch the kernel along `axis` (-1 or -2)."""
    if x.device.type != "cuda":
        raise ValueError(f"dct: unsupported device {x.device}")
    if x.dim() < -axis or x.dtype != torch.float32 \
            or not supported(x.shape[axis]):
        raise ValueError(f"dct kernel needs a float32 tensor whose axis "
                         f"{axis} has a length in {SIZES} (got "
                         f"{x.dtype} {tuple(x.shape)})")
    n = x.shape[axis]
    x = x.contiguous()
    if x.data_ptr() % 16:     # the lane kernel moves 16 bytes at a time
        x = x.clone()
    y = torch.empty_like(x)
    tab = _device_table(n, bool(inverse), x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if axis == -1:
            fn = _build.bind("dct_lane", "pppiiip")
            code = fn(x.data_ptr(), y.data_ptr(), tab.data_ptr(),
                      x.numel() // n, n, int(inverse), stream)
        else:
            m = x.shape[-1]
            fn = _build.bind("dct_sub", "pppiiiip")
            code = fn(x.data_ptr(), y.data_ptr(), tab.data_ptr(),
                      x.numel() // (n * m), n, m, int(inverse), stream)
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
