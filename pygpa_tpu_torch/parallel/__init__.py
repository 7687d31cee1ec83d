"""Multi-device scaling (counterpart of pygpa_tpu/parallel) on
torch.distributed, SPMD: every rank of the world calls the same
function on a DeviceMesh (make_mesh).

- image stacks / mosaic tiles: the batch axis sharded over the mesh
  (extract_displacement_field_batch(mesh=...)), or one card's stack
  call without a mesh;
- the WFR candidate sweep of one image: the candidate grid sharded over
  the ranks, the winners combined by an argmax tree of all_reduce MAX /
  MIN / SUM (wfr_sweep_sharded);
- single images too large for one card: row-sharded end to end, the
  pencil FFT and DCT (all_to_all), the row-sharded zoom sweep on the zoom
  kernel, the per-pixel lstsq and the row-sharded multigrid or CG unwrap
  (extract_displacement_field_sharded). No rank holds a whole plane.

Sharded results are DTensors (Shard on the sharded axis over the mesh
dimension, Replicate() on the others; .full_tensor() gathers one).
"""
from .mesh import make_mesh, batch_sharding  # noqa: F401
from .sharded import (  # noqa: F401
    extract_displacement_field_batch, wfr_sweep_sharded,
)
from .fft import (  # noqa: F401
    fft2_sharded, ifft2_sharded, wfr_sweep_spatial,
)
from .unwrap import (  # noqa: F401
    dct2n_sharded, idct2n_sharded, phase_unwrap_prediff_sharded,
    reconstruct_u_inv_from_demod_sharded,
    extract_displacement_field_sharded,
)
