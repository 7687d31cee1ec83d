"""Storage precision of the plain reference.

The reference computes in float64. Its control runs the same code with
every stage's result stored in bfloat16 (computed in float64, then
rounded to bfloat16, the way a bfloat16 pipeline with float32
accumulation holds its tensors): the precision below the float32 that
the configurations state.
"""
import torch


class Store:
    """Rounds a stage's result to the storage precision: identity for
    the reference ("float64"), bfloat16 for the control ("bfloat16")."""

    def __init__(self, name="float64"):
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"unknown storage precision {name!r}")
        self.name = name

    def __call__(self, x):
        if self.name == "float64" or not torch.is_tensor(x):
            return x
        if x.is_complex():
            return torch.complex(self(x.real), self(x.imag))
        return x.to(torch.bfloat16).to(x.dtype)

    def ks(self, ks):
        """A host (G, 2) k-vector array stored in this precision."""
        import numpy as np
        return self(torch.as_tensor(np.asarray(ks, np.float64))).numpy()
