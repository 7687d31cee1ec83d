"""Batch pipelines on one card (counterpart of the single-device part of
pygpa_tpu/parallel/sharded.py)."""
import numpy as np
import torch

from ..core import entry_tensor
from ..gpa.pipeline import extract_displacement_field


def extract_displacement_field_batch(images, kvecs, mesh=None,
                                     axis="batch", device=None, **kwargs):
    """Displacement fields (B, 2, n, m) of a stack of images (B, n, m):
    extract_displacement_field(image, kvecs, **kwargs) on each image,
    stacked (pygpa_tpu.parallel.extract_displacement_field_batch vmaps
    the same eager function, so each image's field is the one the eager
    call gives). The eager path's per-peak zoom sweep has no image axis
    yet, so this is a loop over the images, each through its own
    launches (ROADMAP queue 1 item 11). For one launch per stage over a
    stack, use make_displacement_extractor's run on it.

    The stack moves to `device` (None: the card; "cpu" for the plain
    route). `mesh` and `axis` are the reference's batch sharding over a
    device mesh, which the multi-device half of ROADMAP queue 1 item 8
    ports: a mesh raises NotImplementedError."""
    if mesh is not None:
        raise NotImplementedError(
            "extract_displacement_field_batch: sharding the batch over a "
            "device mesh is not ported yet (ROADMAP queue 1 item 8, its "
            "multi-device half); pass mesh=None for one card")
    images = entry_tensor(images, device)
    if images.dim() != 3:
        raise ValueError("images must be a stack (B, n, m), got "
                         f"{tuple(images.shape)}")
    kvecs = np.asarray(kvecs)
    return torch.stack([extract_displacement_field(im, kvecs,
                                                   device=images.device,
                                                   **kwargs)
                        for im in images])
