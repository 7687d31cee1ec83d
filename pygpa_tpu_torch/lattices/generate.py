"""Synthetic lattice rendering (counterpart of
pygpa_tpu/lattices/generate.py: generate_ks, anylattice_gen and
hexlattice_gen).

The k-geometry is host float64 numpy. The image is rendered in float64
on the requested device and cast to the requested dtype at the end, so
a float32 fixture carries one rounding only."""
import numpy as np
import torch

from .transformations import anisotropy_matrix


def generate_ks(r_k, theta, kappa=1.0, psi=0.0, sym=6):
    """k-vectors of a (kappa, psi)-anisotropic lattice: magnitude `r_k`
    (unit cells / pixel), rotation `theta` and anisotropy direction
    `psi` in degrees. Returns (sym+1, 2) float64: the sym rotated
    vectors followed by the zero vector, as latticegen does."""
    angles = np.deg2rad(float(theta)) + np.arange(sym) * 2 * np.pi / sym
    ks = float(r_k) * np.stack([np.cos(angles), np.sin(angles)], -1)
    ks = ks @ anisotropy_matrix(kappa, psi).T
    return np.concatenate([ks, np.zeros((1, 2))])


def _shell_vectors(order):
    """Integer reciprocal-lattice combinations n1*k1 + n2*k2 of the unit
    hexagonal basis, one per +/- pair, for the first `order` shells.
    Returns (coeffs (P, 2) int, amplitudes (P,))."""
    k1 = np.array([1.0, 0.0])
    k2 = np.array([np.cos(np.pi / 3), np.sin(np.pi / 3)])
    seen = {}
    for n1 in range(-order * 2, order * 2 + 1):
        for n2 in range(-order * 2, order * 2 + 1):
            if n1 == 0 and n2 == 0:
                continue
            key = (n1, n2) if (n1 > 0 or (n1 == 0 and n2 > 0)) \
                else (-n1, -n2)
            seen[key] = np.linalg.norm(key[0] * k1 + key[1] * k2)
    norms = sorted(set(round(v, 9) for v in seen.values()))
    shells = norms[:order]
    coeffs, amps = [], []
    for (n1, n2), norm in seen.items():
        r = round(norm, 9)
        if r in shells:
            coeffs.append((n1, n2))
            # factor 2: each representative stands for the +/- pair
            amps.append(2.0 * 0.4 ** shells.index(r))
    return np.array(coeffs, np.int64), np.array(amps)


def anylattice_gen(ks, order_amplitudes=None, size=500, shift=None,
                   dtype=torch.float32, device=None):
    """Render sum_i a_i cos(2 pi k_i . (r + u(r))) on a centred grid;
    `ks` is (P, 2), the amplitudes a_i default to ones and `shift` is an
    optional (2, N, M) displacement field u."""
    ks = np.asarray(ks, np.float64)
    if order_amplitudes is None:
        order_amplitudes = np.ones(len(ks))
    shape = (size, size) if np.isscalar(size) else tuple(size)
    n, m = shape
    f64 = torch.float64
    x = (torch.arange(n, dtype=f64, device=device) - n // 2)[:, None]
    y = (torch.arange(m, dtype=f64, device=device) - m // 2)[None, :]
    if shift is not None:
        shift = torch.as_tensor(shift, device=device).to(f64)
        x = x + shift[0]
        y = y + shift[1]
    acc = torch.zeros((n, m), dtype=f64, device=device)
    for k, a in zip(ks, np.asarray(order_amplitudes, np.float64)):
        acc += float(a) * torch.cos(2 * np.pi * (float(k[0]) * x
                                                 + float(k[1]) * y))
    return acc.to(dtype)


def hexlattice_gen(r_k, theta, order=1, size=500, kappa=1.0, psi=0.0,
                   shift=None, dtype=torch.float32, device=None):
    """Hexagonal lattice image with `order` reciprocal shells,
    anisotropy (kappa, psi) and optional displacement field `shift`
    (2, N, M)."""
    coeffs, amps = _shell_vectors(order)
    base = generate_ks(r_k, theta, kappa=kappa, psi=psi, sym=6)
    ks = coeffs[:, :1] * base[0][None, :] + coeffs[:, 1:] * base[1][None, :]
    return anylattice_gen(ks, amps, size=size, shift=shift, dtype=dtype,
                          device=device)
