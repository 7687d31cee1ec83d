"""pyGPA module-path compatibility (counterpart of
pygpa_tpu/geometric_phase_analysis.py): `import
pygpa_tpu_torch.geometric_phase_analysis as GPA` exposes the function
surface of pyGPA's geometric_phase_analysis, backed by the port."""
from .gpa.api import (  # noqa: F401
    GPA, optGPA, vecGPA, wfr, wfr2, wfr3, wfr4, optwfr2,
    wfr2_only_lockin, wfr2_only_lockin_vec, wfr2_grad, wfr2_grad_opt,
    wfr2_grad_vec, generate_klists,
)
from .gpa.reconstruct import (  # noqa: F401
    reconstruct_u_inv, reconstruct_u_inv_from_phases,
    reconstruct_u_inv_from_demod, myweighed_lstsq, fit_delta_k,
    iterate_GPA, refine_ks,
)
from .gpa.pipeline import (  # noqa: F401
    extract_displacement_field, make_displacement_extractor,
    gaussian_deconvolve, invert_u, invert_u_overlap, undistort_image,
)
from .gpa.peaks import (  # noqa: F401
    extract_primary_ks, select_closest_to_triangle, smallest_sum,
    remove_negative_duplicates, _decrease_threshold,
)
from .gpa.kgeometry import (  # noqa: F401
    average_lattice_vector, calc_diff_from_isotropic, ratio2angle,
    f2angle,
)
from .gpa.wff import wff  # noqa: F401
from .gpa.prep import prep_image  # noqa: F401
