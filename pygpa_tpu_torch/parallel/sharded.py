"""Sharded GPA pipelines (counterpart of pygpa_tpu/parallel/sharded.py).

Two axes of parallelism, composable on one mesh (every rank of the
torch.distributed world calling the same function):

- batch: a stack of images (mosaic tiles, time series) is sharded over
  the mesh's batch axis; each rank runs the whole per-image pipeline on
  its images (the single-card stack call), no cross-image communication.
  Without a mesh the stack runs on one card in one call (the launches
  of one image), or in chunks of whole images where it would not fit.
- candidates: the WFR candidate grid of one image is split across the
  ranks; each sweeps its slice against the (replicated) spectrum, and
  the per-pixel winners combine in the reference's argmax tree of
  all_reduce MAX / MIN / SUM.
"""
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..core import entry_tensor, host_to_device
from ..gpa.pipeline import extract_displacement_field
from ..ops.wfr import (_grad_rebase, _real_dtype, _rebased,
                       _wfr_sweep_chunked)
from .mesh import axis_info, local_block, mesh_device, sharded

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


def wfr_sweep_sharded(image, wlist, kref, sigma, mesh, axis="batch",
                      with_grad=False, chunk=8):
    """WFR sweep of one image (n, m) with the candidate grid sharded over
    the mesh dimension `axis` (every rank holding the whole image).

    The bank (P, 2) is padded with 1e3 candidates (zero passband) to a
    multiple of the axis size D; rank r sweeps candidates [r P/D, (r+1)
    P/D) with the full-FFT sweep (ops.wfr._wfr_sweep_chunked) on the
    replicated spectrum, and the winners combine in the reference's
    argmax tree: all_reduce MAX of |M|^2, then MIN of the rank claiming
    it (so the lowest global candidate wins ties, the reference's
    sequential first max), then SUM of the winner's lock-in, index and
    gradient. Returns ops.wfr.wfr_sweep's dict (every rank the same
    tensors): 'lockin' rebased to kref, 'w' (2, n, m) and, with
    with_grad, 'grad' (n, m, 2)."""
    group, rank, world = axis_info(mesh, axis)
    if isinstance(image, DTensor):
        image = image.full_tensor()
    image = entry_tensor(image, mesh_device(mesh))
    wl_h = np.asarray(wlist)
    pad = (-wl_h.shape[0]) % world
    wl = np.concatenate([wl_h, np.full((pad, 2), 1e3, wl_h.dtype)])
    per = wl.shape[0] // world
    spectrum = torch.fft.fft2(image - image.mean())
    absq, lockin, idx, grad = _wfr_sweep_chunked(
        spectrum, wl[rank * per:(rank + 1) * per], float(sigma),
        int(min(chunk, per)), with_grad)
    gmax = absq.clone()
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    claim = torch.where(absq == gmax, rank, world).to(torch.int32)
    dist.all_reduce(claim, op=dist.ReduceOp.MIN, group=group)
    mine = claim == rank
    lockin = torch.where(mine, lockin, torch.zeros((), dtype=lockin.dtype,
                                                   device=lockin.device))
    dist.all_reduce(torch.view_as_real(lockin), op=dist.ReduceOp.SUM,
                    group=group)
    idx = torch.where(mine, idx + rank * per, 0).to(torch.int64)
    dist.all_reduce(idx, op=dist.ReduceOp.SUM, group=group)
    rdt = _real_dtype(spectrum)
    k = host_to_device(np.asarray(kref, np.float64), image.device, rdt)
    w = host_to_device(wl, image.device, rdt)
    out = {"lockin": _rebased(lockin, k), "w": w[idx].movedim(-1, -3)}
    if with_grad:
        grad = torch.where(mine[..., None], grad, 0.0)
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=group)
        out["grad"] = _grad_rebase(grad, k)
    return out


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
    route, one call). With a `mesh` (a DeviceMesh, every rank calling)
    the batch is sharded over its dimension `axis`: `images` is the full
    stack or a DTensor sharded on axis 0 that way, B splits evenly, each
    rank runs its B/D images through the call above on the mesh's device
    (`device`, if given, must be that device's type), and the result is
    a DTensor sharded on the batch axis (with return_gs, each g-dict
    array too)."""
    if mesh is not None:
        if not isinstance(mesh, DeviceMesh):
            raise TypeError("mesh must be a torch.distributed DeviceMesh "
                            f"(gt.parallel.make_mesh), got {type(mesh)}")
        dev = mesh_device(mesh)
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"device {device!r} differs from the mesh's "
                             f"{mesh.device_type!r}")
        local = local_block(images, mesh, axis, 0)
        out = extract_displacement_field_batch(local, kvecs, device=dev,
                                               **kwargs)
        if not kwargs.get("return_gs"):
            return sharded(out, mesh, axis, 0)
        return sharded(out[0], mesh, axis, 0), [
            {k: sharded(v, mesh, axis, 0) for k, v in g.items()}
            for g in out[1]]
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
