"""pygpa_tpu_torch — Geometric Phase Analysis on PyTorch and CUDA.

The PyTorch port of ``pygpa_tpu`` (all but the multi-device part of
parallel and ops.kernel_smoke so far), for NVIDIA Hopper cards
(sm_90a). The layout mirrors ``pygpa_tpu`` (``config``, ``core``,
``lattices``, ``ops``, ``solvers``, ``gpa``, ``props``, ``ucell``,
``parallel``, ``data``, ``io``, ``imagetools``, ``viz``, ``tpugpa`` and
the pyGPA module-path shims ``geometric_phase_analysis``,
``phase_unwrap``, ``property_extract``, ``unit_cell_averaging``,
``mathtools``) so each module's counterpart is found by name. The
package imports torch and numpy only (viz imports matplotlib inside its
functions).

Every kernel the JAX package wrote in Pallas for the TPU is a CUDA C++
kernel here (``csrc/*.cu``, built with nvcc at first use by
``ops._build``). Each sits behind a wrapper in ``ops/`` with a plain
PyTorch twin: a CPU tensor goes to the twin, a CUDA tensor to the
kernel.

The entry points run on the card: with ``device=None`` (the default)
they move numpy arrays and CPU tensors to ``"cuda"``, and raise where
torch has no CUDA; ``device="cpu"`` asks for the plain route. The
README's quick start, from a raw image::

    import pygpa_tpu_torch as gt
    ks, _ = gt.gpa.extract_primary_ks(image)        # Bragg peaks
    ks = gt.gpa.refine_ks(image, ks)                # sub-grid ks
    u = gt.gpa.extract_displacement_field(image, ks)
    flat = gt.gpa.undistort_image(image, u)
    props = gt.props.calc_props_from_kvecs4(ks)
    cell = gt.ucell.unit_cell_average(image, ks[:2], u=u, z=2)
    fn = gt.gpa.pipeline.make_displacement_extractor(image.shape, ks)
    u = fn(image)
    us = fn(stack)                  # (B, n, m) -> (B, 2, n, m)
    us = gt.parallel.extract_displacement_field_batch(stack, ks)

A mosaic on disk goes through the same extractor in stacks of tiles
(``gt.data.MosaicTiles(path).batches(tile, batch_size)``), and
``gt.io.save_checkpoint`` keeps the results.

Importing the package builds nothing: the kernels are compiled at their
first launch (``ops._build``).
"""

__version__ = "0.1.0"

from . import core  # noqa: E402,F401
from . import lattices  # noqa: E402,F401
from . import solvers  # noqa: E402,F401
from . import ops  # noqa: E402,F401
from . import gpa  # noqa: E402,F401
from . import props  # noqa: E402,F401
from . import ucell  # noqa: E402,F401
from . import parallel  # noqa: E402,F401
from . import data  # noqa: E402,F401
from . import io  # noqa: E402,F401
from . import imagetools  # noqa: E402,F401
# pyGPA module-path compatibility surface
from . import mathtools  # noqa: E402,F401
from . import geometric_phase_analysis  # noqa: E402,F401
from . import phase_unwrap  # noqa: E402,F401
from . import property_extract  # noqa: E402,F401
from . import unit_cell_averaging  # noqa: E402,F401
from . import tpugpa  # noqa: E402,F401
