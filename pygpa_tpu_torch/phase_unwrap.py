"""pyGPA module-path compatibility (counterpart of
pygpa_tpu/phase_unwrap.py): `import pygpa_tpu_torch.phase_unwrap as pu`
exposes the function surface of pyGPA's phase_unwrap."""
from .solvers.unwrap import (  # noqa: F401
    phase_unwrap, phase_unwrap_mg, phase_unwrap_prediff,
    phase_unwrap_ref, phase_unwrap_ref_prediff, solvePoisson,
    solvePoisson_precomped, precomp_Poissonscaling, applyQ, _wrapToPi,
)
