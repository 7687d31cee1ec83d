"""Geometric phase analysis: lock-in, WFR variants (wfr4's k-continuity
scan included), peak detection, displacement-field reconstruction,
undistortion and windowed Fourier filtering, under the reference's names
(all of pygpa_tpu.gpa)."""
from .api import (  # noqa: F401
    GPA, optGPA, vecGPA,
    wfr, wfr2, wfr3, wfr4, optwfr2,
    wfr2_only_lockin, wfr2_only_lockin_vec,
    wfr2_grad, wfr2_grad_opt, wfr2_grad_vec,
    generate_klists,
)
from .reconstruct import (  # noqa: F401
    reconstruct_u_inv, reconstruct_u_inv_from_phases,
    reconstruct_u_inv_from_demod, myweighed_lstsq, fit_delta_k,
    iterate_GPA, refine_ks,
)
from .pipeline import (  # noqa: F401
    extract_displacement_field, gaussian_deconvolve,
    invert_u, invert_u_overlap, undistort_image,
)
from .peaks import (  # noqa: F401
    extract_primary_ks, select_closest_to_triangle, smallest_sum,
    remove_negative_duplicates,
)
from .kgeometry import (  # noqa: F401
    average_lattice_vector, calc_diff_from_isotropic, ratio2angle, f2angle,
)
from .wff import wff  # noqa: F401
