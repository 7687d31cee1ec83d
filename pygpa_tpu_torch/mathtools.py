"""pyGPA module-path compatibility (counterpart of
pygpa_tpu/mathtools.py): `from pygpa_tpu_torch.mathtools import
wrapToPi, ...` exposes the function surface of pyGPA's mathtools."""
from .core.mathtools import (  # noqa: F401
    wrap_to_pi, wrapToPi, periodic_average, periodic_difference,
    fit_plane, fit_plane_masked, lfit_func, lfit_func_mask,
    remove_negative_duplicates, standardize_ks,
)
