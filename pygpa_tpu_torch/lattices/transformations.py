"""2x2 lattice transformation matrices (counterpart of
pygpa_tpu/lattices/transformations.py, the subset the bench fixture
needs). Host-side float64 numpy: vectors are rows and matrices act as
``vecs @ M.T``."""
import numpy as np


def rotation_matrix(angle):
    """Counter-clockwise rotation matrix [[c, -s], [s, c]] for `angle`
    in radians."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s], [s, c]], np.float64)


def anisotropy_matrix(kappa, psi):
    """k-space anisotropy V(psi)^T diag(1/kappa, 1) V(psi), psi in
    degrees."""
    V = rotation_matrix(np.deg2rad(psi))
    D = np.diag([1.0 / kappa, 1.0])
    return V.T @ D @ V
