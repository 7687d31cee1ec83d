"""Synthetic lattice rendering (the bench fixture) and 2x2 lattice
transformations."""
from .generate import anylattice_gen, generate_ks, hexlattice_gen
from .transformations import (
    a_0_to_r_k, anisotropy_matrix, apply_transformation_matrix,
    epsilon_to_kappa, kappa_to_epsilon, r_k_to_a_0, rotate, rotation_matrix,
    scaling_matrix, strain_matrix)

__all__ = ["anylattice_gen", "generate_ks", "hexlattice_gen",
           "a_0_to_r_k", "anisotropy_matrix", "apply_transformation_matrix",
           "epsilon_to_kappa", "kappa_to_epsilon", "r_k_to_a_0", "rotate",
           "rotation_matrix", "scaling_matrix", "strain_matrix"]
