"""pyGPA module-path compatibility (counterpart of
pygpa_tpu/property_extract.py): `import
pygpa_tpu_torch.property_extract as pe` exposes the function surface of
pyGPA's property_extract."""
from .props.jacobians import (  # noqa: F401
    u2J, u2Jac, phases2J, phases2Jac, phasegradient2J,
    phasegradient2Jac, kvecs2J, kvecs2Jac, props_from_Jac,
    phys_props_from_Jac, props_from_J, props_from_J_old,
    calc_props_from_phasegradient, calc_props_from_phases,
    calc_eps_from_phasegradient, Jac_2_Jac_diff, J_2_J_diff,
    u_moire_2_u_diff, Jac_diff_from_phasegradient,
    calc_props_from_phasegradient2, calc_props_from_kvecs4,
    calc_moire_props_from_kvecs, moire_props_from_phasegradient,
    moire_props_from_Jac, get_initial_props, get_ref_prop_dict,
    calc_abcd, double_strain_decomp, twist_matrix, svd2x2,
)
from .props.kerelsky import (  # noqa: F401
    moire_amplitudes, Kerelsky, Kerelsky_plus, Kerelsky_Jac, Kerelsky_J,
    iterate_J_leastsq, moire_props_from_Jac_2_Kerelsky, Jac_fit_diff,
)
