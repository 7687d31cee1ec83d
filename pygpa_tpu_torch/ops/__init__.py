"""Hand-written CUDA kernels behind device-dispatching wrappers, the
host-side sweep planning around them, the spatial lock-in and the peak
mask."""
from .lockin import gpa_lockin, gpa_lockin_batch  # noqa: F401
from .wfr import wfr_sweep  # noqa: F401
from .peaks import local_max_mask  # noqa: F401
