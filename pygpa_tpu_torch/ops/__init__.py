"""Hand-written CUDA kernels behind device-dispatching wrappers, and the
host-side sweep planning around them."""
