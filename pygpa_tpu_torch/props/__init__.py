"""Local lattice property extraction: per-pixel Jacobian algebra (twist
angle, anisotropy, heterostrain) and Kerelsky-style moire parameter
fits; counterpart of pygpa_tpu/props."""
from .jacobians import (  # noqa: F401
    J_2_J_diff, Jac_2_Jac_diff, Jac_diff_from_phasegradient, calc_abcd,
    calc_eps_from_phasegradient, calc_moire_props_from_kvecs,
    calc_props_from_kvecs4, calc_props_from_phasegradient,
    calc_props_from_phasegradient2, calc_props_from_phases,
    double_strain_decomp, get_initial_props, get_ref_prop_dict, kvecs2J,
    kvecs2Jac, moire_props_from_Jac, moire_props_from_phasegradient,
    phasegradient2J, phasegradient2Jac, phases2J, phases2Jac,
    phys_props_from_Jac, props_from_J, props_from_J_old, props_from_Jac,
    props_from_planes, props_from_u, svd2x2, svd2x2_planes, twist_matrix,
    u2J, u2J_planes, u2Jac, u_moire_2_u_diff,
)
from .kerelsky import (  # noqa: F401
    Kerelsky, Kerelsky_J, Kerelsky_Jac, Kerelsky_plus, iterate_J_leastsq,
    moire_amplitudes, moire_props_from_Jac_2_Kerelsky,
)
