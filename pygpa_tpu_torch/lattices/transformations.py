"""2x2 lattice transformation matrices (counterpart of
pygpa_tpu/lattices/transformations.py). Vectors are rows and matrices
act as ``vecs @ M.T``. The matrices are host float64 numpy; rotate and
apply_transformation_matrix take tensors (or array-likes) and keep
their dtype and device; the scalar relations work on floats, arrays and
tensors alike."""
import math

import numpy as np
import torch

from ..core.mathtools import as_tensor

DEFAULT_POISSON = 0.16


def rotation_matrix(angle):
    """Counter-clockwise rotation matrix [[c, -s], [s, c]] for `angle`
    in radians."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s], [s, c]], np.float64)


def _apply(vecs, matrix):
    """vecs @ matrix.T, the matrix cast to the vectors' dtype and device."""
    vecs = as_tensor(vecs)
    M = torch.from_numpy(np.array(matrix)).to(vecs.device, vecs.dtype)
    return vecs @ M.T


def rotate(vecs, angle):
    """Rotate row-vector(s) counter-clockwise by `angle` radians."""
    return _apply(vecs, rotation_matrix(float(angle)))


def scaling_matrix(kappa, dims=2):
    """diag(kappa, 1, ..., 1)."""
    d = np.ones(dims)
    d[0] = kappa
    return np.diag(d)


def anisotropy_matrix(kappa, psi):
    """k-space anisotropy V(psi)^T diag(1/kappa, 1) V(psi), psi in
    degrees."""
    V = rotation_matrix(np.deg2rad(psi))
    D = np.diag([1.0 / kappa, 1.0])
    return V.T @ D @ V


def strain_matrix(epsilon, delta=DEFAULT_POISSON, axis=0):
    """k-space transform of real-space uniaxial strain `epsilon` along
    `axis` with Poisson contraction delta*epsilon perpendicular."""
    d = np.array([1.0 / (1.0 + epsilon), 1.0 / (1.0 - delta * epsilon)])
    if axis == 1:
        d = d[::-1]
    return np.diag(d)


def a_0_to_r_k(a_0):
    """Lattice constant -> hexagonal lattice k-magnitude (unit cells per
    pixel): r_k = 2 / (sqrt(3) a_0)."""
    return 2.0 / (math.sqrt(3.0) * a_0)


def r_k_to_a_0(r_k):
    """Inverse of a_0_to_r_k."""
    return 2.0 / (math.sqrt(3.0) * r_k)


def epsilon_to_kappa(r_k, epsilon, delta=DEFAULT_POISSON):
    """(r_k, heterostrain epsilon) -> the (r_k', kappa) anisotropy
    parametrization generate_ks takes."""
    return r_k / (1.0 - delta * epsilon), \
        (1.0 + epsilon) / (1.0 - delta * epsilon)


def kappa_to_epsilon(kappa, delta=DEFAULT_POISSON):
    """Inverse relation: epsilon = (kappa - 1) / (1 + delta kappa)."""
    return (kappa - 1.0) / (1.0 + delta * kappa)


def apply_transformation_matrix(vecs, matrix):
    """Apply a 2x2 transform to row-vector(s): vecs @ matrix.T."""
    return _apply(vecs, matrix)
