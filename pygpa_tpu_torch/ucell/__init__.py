"""Unit-cell averaging (drizzle) and re-expansion."""
from .averaging import (  # noqa: F401
    forward_transform, backward_transform, cart_in_uc, float_overlap,
    calc_ucell_parameters, unit_cell_average, expand_unitcell,
    add_to_position,
)
