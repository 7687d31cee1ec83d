"""Batch pipelines on one card (counterpart of the single-device part of
pygpa_tpu/parallel/sharded.py)."""
import numpy as np
import torch

from ..core import entry_tensor
from ..gpa.pipeline import extract_displacement_field

# Peak device bytes that one more image adds to an eager call on a stack,
# per pixel of a float32 image: 264 on an H100 80GB HBM3 at 700 W
# (chip_smoke.py phase 16a: four 4096^2 tiles in one call peak at 18.77
# GiB, one at 6.39 GiB), rounded up. Scaled by the itemsize for float64.
EAGER_BYTES_PER_PIXEL = 288


def images_per_call(shape, itemsize, free_bytes):
    """How many images of `shape` (n, m) with `itemsize`-byte values one
    eager call may take so that its estimated peak fits `free_bytes`:
    EAGER_BYTES_PER_PIXEL a pixel an image, one image's worth held back
    for the call's fixed part (the plan's bases, the FFT workspace); at
    least 1."""
    per = EAGER_BYTES_PER_PIXEL * int(shape[0]) * int(shape[1]) * itemsize
    return max(1, int(free_bytes) * 4 // per - 1)


def _cap(images):
    """The most images of the stack one call takes on its device: the
    whole stack off the card, images_per_call on it."""
    if images.device.type != "cuda":
        return images.shape[0]
    free, _ = torch.cuda.mem_get_info(images.device)
    # with what PyTorch's allocator holds unused
    free += (torch.cuda.memory_reserved(images.device)
             - torch.cuda.memory_allocated(images.device))
    return images_per_call(images.shape[-2:], images.element_size(), free)


def extract_displacement_field_batch(images, kvecs, mesh=None,
                                     axis="batch", device=None, **kwargs):
    """Displacement fields (B, 2, n, m) of a stack of images (B, n, m):
    extract_displacement_field(images, kvecs, **kwargs) on the stack
    (pygpa_tpu.parallel.extract_displacement_field_batch vmaps the same
    eager function, so each image's field is the one the eager call
    gives): one fft2, one zoom sweep per peak and the reconstruction on
    every image at once, as many launches as one image (with a
    `wfr_func`, a loop over the images).

    The call's peak device memory grows with B (about
    EAGER_BYTES_PER_PIXEL bytes a pixel an image in float32, twice that
    in float64: 4.5 GiB a 4096^2 image). On the card a stack whose
    estimate passes the free memory (images_per_call) goes in equal
    chunks of whole images, one call each: 16 float32 4096^2 images
    take two calls of 8 on an 80 GB card.

    The stack moves to `device` (None: the card; "cpu" for the plain
    route, one call). `mesh` and `axis` are the reference's batch
    sharding over a device mesh, which the multi-device half of ROADMAP
    queue 1 item 8 ports: a mesh raises NotImplementedError."""
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
    B = images.shape[0]
    calls = -(-B // _cap(images))
    size = -(-B // calls)
    outs = [extract_displacement_field(images[i:i + size], kvecs,
                                       device=images.device, **kwargs)
            for i in range(0, B, size)]
    if len(outs) == 1:
        return outs[0]
    if not kwargs.get("return_gs"):
        return torch.cat(outs)
    return torch.cat([o[0] for o in outs]), [
        {k: torch.cat([o[1][p][k] for o in outs]) for k in outs[0][1][p]}
        for p in range(len(kvecs))]
