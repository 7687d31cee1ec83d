"""pygpa_tpu_torch — Geometric Phase Analysis on PyTorch and CUDA.

The PyTorch port of ``pygpa_tpu``'s displacement extraction (the eager
``extract_displacement_field`` and the ``make_displacement_extractor``
factory), for NVIDIA Hopper cards (sm_90a). The layout mirrors ``pygpa_tpu``
(``config``, ``core``, ``lattices``, ``ops``, ``solvers``, ``gpa``) so
each module's counterpart is found by name. The package imports torch
and numpy only.

Every kernel the JAX package wrote in Pallas for the TPU is a CUDA C++
kernel here (``csrc/*.cu``, built with nvcc at first use by
``ops._build``). Each sits behind a wrapper in ``ops/`` with a plain
PyTorch twin: a CPU tensor goes to the twin, a CUDA tensor to the
kernel.

The entry points run on the card: with ``device=None`` (the default)
they move numpy arrays and CPU tensors to ``"cuda"``, and raise where
torch has no CUDA; ``device="cpu"`` asks for the plain route::

    from pygpa_tpu_torch.gpa import pipeline
    from pygpa_tpu_torch import ucell
    u = pipeline.extract_displacement_field(image, ks[:3])  # on the card
    fn = pipeline.make_displacement_extractor(image.shape, ks[:3])
    u = fn(image)
    flat = pipeline.undistort_image(image, u)
    cell = ucell.unit_cell_average(image, ks[:2], u=u, z=2)
    back = ucell.expand_unitcell(cell, ks[:2], image.shape, z=2, u=u)
"""

__version__ = "0.1.0"
