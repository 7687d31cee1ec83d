"""The yardstick of the kernels' roofline shares: published H100 peaks and
the work of each kernel's algorithm at the shapes of a call.

The peaks and `bound`, `zoom_bounds`, `chain_bytes` and `dct_ops` are
frozen copies of chip_smoke.py's roofline arithmetic (which states them
against NVIDIA's H100 SXM data sheet at 700 W); `grouped_sweep_work`
counts the grouped banded sweep's work from its plan, whatever design
the kernels use.
"""
import numpy as np

# published H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s,
# float32 FLOP/s outside the tensor cores, dense TF32 FLOP/s on them
HBM_BYTES_S, FP32_FLOP_S, TF32_FLOP_S = 3.35e12, 67e12, 495e12


def bound(nbytes, ops):
    """(least ms, what sets it): the larger of nbytes over the HBM rate
    and ops float32 operations over the float32 peak."""
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, float(ops) / FP32_FLOP_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def zoom_bounds(nbytes, flops1, flops2):
    """(FP32-FMA bound ms, 3xTF32 bound ms) of a zoom sweep: stage 1 in
    float32 FMA either way; stage 2 in float32 FMA, or three times over at
    the dense TF32 rate; each no less than nbytes over the HBM rate."""
    t_b = nbytes / HBM_BYTES_S * 1e3
    fp32 = (flops1 + flops2) / FP32_FLOP_S * 1e3
    tc = (flops1 / FP32_FLOP_S + 3 * flops2 / TF32_FLOP_S) * 1e3
    return max(t_b, fp32), max(t_b, tc)


def chain_bytes(B, n, m, I=1):
    """Bytes one FFT-route CG iteration moves: the four DCT passes (2, 2,
    2 and 3 planes of (B, n, m)), the p/stencil kernel and the phi/r
    kernel, each launch's planes read and written once."""
    plane, ww = 4 * B * n * m, 4 * I * n * m
    return (2 + 2 + 2 + 3) * plane + 4 * plane + 2 * ww + 6 * plane


def dct_ops(n, lines):
    """Operations of `lines` DCTs of length n through a half-length
    complex FFT: 2.5 n log2 n each."""
    return 2.5 * n * np.log2(n) * lines


def grouped_sweep_work(B, G, P, H, n, m, W0, Wb):
    """(operations, bytes) of one grouped banded sweep call with its uv
    emission, for B images of (n, m), G peaks of P candidates, windows
    (G, H, W0, Wb): stage 1's complex products 8 B G P n W0 Wb and stage
    2's 8 B G P n m Wb; each input read once (the windows, the Gaussian
    factors, the DFT bases) and each output written once (dudx, dudy,
    wnorm: five float32 planes an image)."""
    ops = 8.0 * B * G * P * n * Wb * (W0 + m)
    nbytes = 4.0 * (2 * B * G * H * W0 * Wb + G * P * (W0 + Wb)
                    + 2 * G * n * W0 + 2 * G * m * Wb + 5 * B * n * m)
    return ops, nbytes


def tensor_core_bound_ms(ops, nbytes):
    """The least ms of work done at the card's dense TF32 rate (its
    fastest for float32 inputs) or moved at its HBM rate."""
    return max(ops / TF32_FLOP_S, nbytes / HBM_BYTES_S) * 1e3
