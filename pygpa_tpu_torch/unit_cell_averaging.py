"""pyGPA module-path compatibility (counterpart of
pygpa_tpu/unit_cell_averaging.py): `import
pygpa_tpu_torch.unit_cell_averaging as uc` exposes the function surface
of pyGPA's unit_cell_averaging."""
from .ucell.averaging import (  # noqa: F401
    forward_transform, backward_transform, cart_in_uc, float_overlap,
    calc_ucell_parameters, unit_cell_average, expand_unitcell,
    add_to_position,
)
