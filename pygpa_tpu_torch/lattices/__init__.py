"""Synthetic lattice rendering (the bench fixture)."""
from .generate import generate_ks, hexlattice_gen
from .transformations import anisotropy_matrix, rotation_matrix

__all__ = ["generate_ks", "hexlattice_gen", "anisotropy_matrix",
           "rotation_matrix"]
