"""Plain local lattice properties of a displacement field, and plain
tiles of a GPAM mosaic file.

Properties: the Jacobian I + J with J = grad(-u) (numpy.gradient's
differences: central inside, one-sided at the edges), and its polar
decomposition: the twist angle is the rotation's angle in degrees,
atan2(J10 - J01, 2 + J00 + J11); the singular values s0 >= s1 give the
scale alpha = s1 and the anisotropy kappa = s0 / s1.

Tiles: the file's pixels (a 32-byte header: b"GPAM", a uint32 dtype code,
uint64 rows and columns, 8 bytes reserved), a tile the block at its
origin, less its mean, in float64.

Nothing here imports the program under test.
"""
import numpy as np
import torch

from .gpa import F64
from .precision import Store

GPAM_DTYPES = {0: np.uint8, 1: np.uint16, 2: np.float32, 3: np.float64}


def gradient(a):
    """numpy.gradient of a (..., n, m) along its last two axes."""
    def along(x, dim):
        x = x.movedim(dim, -1)
        g = torch.cat([x[..., 1:2] - x[..., 0:1],
                       (x[..., 2:] - x[..., :-2]) / 2,
                       x[..., -1:] - x[..., -2:-1]], -1)
        return g.movedim(-1, dim)
    return along(a, -2), along(a, -1)


def props(u, store=Store()):
    """(twist deg, alpha, kappa), each (n, m), of u (2, n, m) in px."""
    u = store(torch.as_tensor(u).to(F64))
    g0, g1 = gradient(-u)
    a, b = 1 + g0[0], g1[0]
    c, d = g0[1], 1 + g1[1]
    twist = torch.rad2deg(torch.atan2(c - b, a + d))
    # singular values of [[a, b], [c, d]]
    q = torch.hypot((a + d) / 2, (c - b) / 2)
    r = torch.hypot((a - d) / 2, (c + b) / 2)
    s0, s1 = q + r, (q - r).abs()
    return store(twist), store(s1), store(s0 / s1)


def read_header(path):
    with open(path, "rb") as f:
        head = f.read(32)
    if head[:4] != b"GPAM":
        raise ValueError(f"{path}: not a GPAM file")
    code = int(np.frombuffer(head[4:8], np.uint32)[0])
    rows, cols = (int(v) for v in np.frombuffer(head[8:24], np.uint64))
    return np.dtype(GPAM_DTYPES[code]), (rows, cols)


def tile(path, origin, size, store=Store()):
    """The tile (size, size) at origin (row, column), less its mean,
    float64 on the host."""
    dtype, shape = read_header(path)
    mm = np.memmap(path, dtype=dtype, mode="r", offset=32, shape=shape)
    t = np.asarray(mm[origin[0]:origin[0] + size,
                      origin[1]:origin[1] + size], np.float64)
    del mm
    t = torch.as_tensor(t - t.mean())
    return store(t).numpy()
