"""Batch pipelines (counterpart of pygpa_tpu/parallel, its single-card
part so far).

extract_displacement_field_batch runs the eager pipeline on a stack of
images on one card in one call (the launches of one image). The
reference's device meshes, batch sharding, the candidate-sharded WFR
sweep, the pencil FFT and the row-sharded unwrap (make_mesh,
batch_sharding, wfr_sweep_sharded, parallel/fft.py, parallel/unwrap.py)
wait for the multi-device half of ROADMAP queue 1 item 8; a mesh passed
here raises NotImplementedError.
"""
from .sharded import extract_displacement_field_batch  # noqa: F401
