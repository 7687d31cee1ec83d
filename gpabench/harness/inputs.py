"""The benchmark's inputs, made from --seed on the device: lattice images
of a configuration, each displaced by a seeded smooth field and carrying
seeded noise, and the 16384^2 GPAM mosaic file.

The lattice renderer, the field and the GPAM writer are frozen copies of
the program's own (its lattices.generate hexlattice_gen and generate_ks,
chip_smoke.py's bench_field, data.write_mosaic) in plain torch and numpy,
so that the inputs do not move with the program.
"""
import os
import tempfile

import numpy as np
import torch

F64 = torch.float64


# -- frozen from pygpa_tpu_torch/lattices/generate.py and
#    lattices/transformations.py (generate_ks, _shell_vectors,
#    hexlattice_gen; anisotropy_matrix)

def anisotropy_matrix(kappa, psi):
    """k-space anisotropy V(psi)^T diag(1/kappa, 1) V(psi), psi in deg."""
    a = np.deg2rad(psi)
    V = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return V.T @ np.diag([1.0 / kappa, 1.0]) @ V


def generate_ks(r_k, theta, kappa=1.0, psi=0.0, sym=6):
    """The sym rotated k-vectors of a (kappa, psi)-anisotropic lattice
    and the zero vector, (sym + 1, 2) float64."""
    angles = np.deg2rad(float(theta)) + np.arange(sym) * 2 * np.pi / sym
    ks = float(r_k) * np.stack([np.cos(angles), np.sin(angles)], -1)
    ks = ks @ anisotropy_matrix(kappa, psi).T
    return np.concatenate([ks, np.zeros((1, 2))])


def shell_vectors(order):
    """Integer combinations n1 k1 + n2 k2 of the hexagonal basis, one per
    +/- pair, of the first `order` shells, and their amplitudes (2 x
    0.4^shell)."""
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
    shells = sorted(set(round(v, 9) for v in seen.values()))[:order]
    coeffs, amps = [], []
    for (n1, n2), norm in seen.items():
        r = round(norm, 9)
        if r in shells:
            coeffs.append((n1, n2))
            amps.append(2.0 * 0.4 ** shells.index(r))
    return np.array(coeffs, np.int64), np.array(amps)


def lattice_waves(lattice):
    """(k-vectors (P, 2), amplitudes (P,)) of a configuration's lattice
    {"r_k", "theta_deg", "kappa", "psi_deg", "order"}."""
    coeffs, amps = shell_vectors(int(lattice["order"]))
    base = generate_ks(lattice["r_k"], lattice["theta_deg"],
                       kappa=lattice["kappa"], psi=lattice["psi_deg"])
    ks = coeffs[:, :1] * base[0][None, :] + coeffs[:, 1:] * base[1][None, :]
    return ks, amps


def primary_ks(lattice, count=3):
    """The first `count` primary k-vectors of the lattice (float64)."""
    return generate_ks(lattice["r_k"], lattice["theta_deg"],
                       kappa=lattice["kappa"], psi=lattice["psi_deg"])[:count]


def render(lattice, x, y):
    """sum_i a_i cos(2 pi k_i . (x, y)) at positions x, y (float64)."""
    ks, amps = lattice_waves(lattice)
    acc = torch.zeros(torch.broadcast_shapes(x.shape, y.shape), dtype=F64,
                      device=x.device)
    for k, a in zip(ks, amps):
        acc += float(a) * torch.cos(2 * np.pi * (float(k[0]) * x
                                                 + float(k[1]) * y))
    return acc


# -- frozen from chip_smoke.py's bench_field: u_x = a x exp(-(x/wx)^2/2
#    - 1.2 (y/wy)^2/2), u_y = 0, here about a seeded centre with a seeded
#    amplitude and widths

def bump_field(size, centre, widths, amp, device):
    """The bench field's family (2, size, size), float64."""
    S = size // 2
    x = torch.arange(-S, size - S, dtype=F64, device=device)[:, None] \
        - centre[0]
    y = torch.arange(-S, size - S, dtype=F64, device=device)[None, :] \
        - centre[1]
    ux = amp * x * torch.exp(-0.5 * ((x / widths[0]) ** 2
                                     + 1.2 * (y / widths[1]) ** 2))
    return torch.stack([ux, torch.zeros_like(ux)])


def field_params(rng, size, spec, count):
    """`count` frames' field parameters from the traffic's ranges: each
    amplitude and width at its own stratum of the range (the same set of
    sizes from every seed), in a seeded order, and a seeded centre."""
    lo, hi = spec["amplitude"]
    c = spec["centre_frac"] * size
    w0, w1 = spec["width_frac"]
    strata = (np.arange(count) + 0.5) / count
    amp = lo + (hi - lo) * rng.permutation(strata)
    wa = w0 + (w1 - w0) * rng.permutation(strata)
    wb = w0 + (w1 - w0) * rng.permutation(strata)
    return [dict(centre=(rng.uniform(-c, c), rng.uniform(-c, c)),
                 widths=(wa[i] * size, wb[i] * size), amp=amp[i])
            for i in range(count)]


def device_generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def frame(lattice, size, params, noise, gen, device):
    """One float32 frame (size, size): the lattice displaced by the field
    (sampled at r + u), plus Gaussian noise of std `noise`; and its field
    u (2, size, size) float32."""
    u = bump_field(size, params["centre"], params["widths"], params["amp"],
                   device)
    S = size // 2
    x = torch.arange(-S, size - S, dtype=F64, device=device)[:, None] + u[0]
    y = torch.arange(-S, size - S, dtype=F64, device=device)[None, :] + u[1]
    img = render(lattice, x, y)
    img += noise * torch.randn(img.shape, generator=gen, dtype=F64,
                               device=device)
    return img.to(torch.float32), u.to(torch.float32)


def frame_pool(lattice, size, count, traffic, seed, device):
    """`count` distinct frames (count, size, size) float32 on the device
    and each one's field parameters, from the seed."""
    rng = np.random.default_rng(seed)
    gen = device_generator(seed, device)
    params = field_params(rng, size, traffic["field"], count)
    frames = [frame(lattice, size, p, traffic["noise"], gen, device)[0]
              for p in params]
    return torch.stack(frames), params


# -- the mosaic: one seeded field over the whole file, so that every tile
#    carries a displacement; written with a frozen copy of the program's
#    data.write_mosaic (GPAM: b"GPAM", uint32 dtype code, uint64 rows,
#    uint64 columns, 8 reserved bytes, row-major pixels)

GPAM_CODES = {np.dtype(np.uint16): 1}


def write_gpam(path, array):
    array = np.ascontiguousarray(array)
    with open(path, "wb") as f:
        f.write(b"GPAM")
        f.write(np.uint32(GPAM_CODES[array.dtype]).tobytes())
        f.write(np.uint64(array.shape[0]).tobytes())
        f.write(np.uint64(array.shape[1]).tobytes())
        f.write(np.uint64(0).tobytes())
        array.tofile(f)


def mosaic_field(x, y, p):
    """u (2, ...) of the mosaic's sinusoidal field at x, y (px)."""
    a, L = p["amp"], p["period"]
    sx = 2 * np.pi * (x / L + p["phase"][0])
    sy = 2 * np.pi * (y / L + p["phase"][1])
    return (a * torch.sin(sx) * torch.cos(sy),
            a * torch.cos(sx) * torch.sin(sy))


def write_mosaic(lattice, side, spec, seed, device, rows=1024):
    """Render the seeded mosaic (side, side) as uint16 on the device, a
    block of rows at a time, and write it as a GPAM file under the
    process's temporary directory. Returns (path, field parameters)."""
    rng = np.random.default_rng([seed, 1])
    gen = device_generator(seed + 1, device)
    p = dict(amp=rng.uniform(*spec["amplitude"]),
             period=rng.uniform(*spec["period"]),
             phase=(rng.uniform(), rng.uniform()))
    out = np.empty((side, side), np.uint16)
    S = side // 2
    y = torch.arange(-S, side - S, dtype=F64, device=device)[None, :]
    for r0 in range(0, side, rows):
        x = torch.arange(r0 - S, min(r0 + rows, side) - S, dtype=F64,
                         device=device)[:, None]
        u0, u1 = mosaic_field(x, y, p)
        img = render(lattice, x + u0, y + u1)
        img += spec["noise"] * torch.randn(img.shape, generator=gen,
                                           dtype=F64, device=device)
        q = torch.clamp(torch.round(spec["offset"] + spec["scale"] * img),
                        0, 65535)
        out[r0:r0 + x.shape[0]] = q.to(torch.int32).cpu().numpy() \
            .astype(np.uint16)
    fd, path = tempfile.mkstemp(prefix="gpabench_mosaic_", suffix=".gpam",
                                dir=tempfile.gettempdir())
    os.close(fd)
    write_gpam(path, out)
    return path, p
