"""Per-pixel least squares and the weighted phase unwrap (exact CG and
multigrid)."""
from .lstsq import weighted_lstsq_stack  # noqa: F401
from .unwrap import (  # noqa: F401
    phase_unwrap, phase_unwrap_mg, phase_unwrap_prediff, solve_poisson,
    phase_unwrap_ref, phase_unwrap_ref_prediff, solvePoisson,
    solvePoisson_precomped, precomp_Poissonscaling, applyQ,
)
