"""k-vector geometry (counterpart of pygpa_tpu/gpa/kgeometry.py): the
isotropic reference lattice of a k-vector set and the twist angle of a
moire line frequency. Tensors (or array-likes) in, tensors out, in
their dtype and on their device."""
import math

import torch

from ..config import DEFAULTS
from ..core.mathtools import as_tensor, periodic_average
from ..lattices.transformations import rotate


def average_lattice_vector(ks, symmetry=6):
    """Mean lattice vector: the circular-mean angle (period
    2 pi / symmetry) at the mean magnitude."""
    ks = as_tensor(ks)
    dt = periodic_average(torch.atan2(ks[:, 1], ks[:, 0]),
                          period=2 * math.pi / symmetry)
    r = torch.linalg.norm(ks, dim=1).mean()
    return r * torch.stack([torch.cos(dt), torch.sin(dt)])


def calc_diff_from_isotropic(ani_ks, symmetry=6):
    """Per-vector corrections dks such that ani_ks + dks is isotropic
    (all |k| equal, angles 2 pi / symmetry apart): each vector's nearest
    vector of the isotropic set, less the vector."""
    ani_ks = as_tensor(ani_ks)
    k_hex = average_lattice_vector(ani_ks, symmetry=symmetry)
    ks_hex = torch.stack([rotate(k_hex, i * 2 * math.pi / symmetry)
                          for i in range(symmetry)])
    alldiffs = ks_hex[None, :, :] - ani_ks[:, None, :]
    argmins = torch.argmin(torch.linalg.norm(alldiffs, dim=-1), dim=1)
    return alldiffs[torch.arange(alldiffs.shape[0]), argmins]


def ratio2angle(R):
    """Twist angle (degrees) for unit-cell size ratio R:
    theta = 2 asin(R / 2)."""
    return torch.rad2deg(2 * torch.arcsin(as_tensor(R) / 2))


def f2angle(f, nmperpixel=1.0, a_0=DEFAULTS.a_0):
    """Twist angle (degrees) for moire line frequency f (unit cells per
    pixel) on a lattice of constant a_0 nm."""
    ref_linespacing = 0.5 * math.sqrt(3.0) * a_0
    linespacing = nmperpixel / as_tensor(f)
    return ratio2angle(ref_linespacing / linespacing)
