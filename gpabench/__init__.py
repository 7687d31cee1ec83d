"""The benchmark of pygpa_tpu_torch on one CUDA card (see run.py)."""
