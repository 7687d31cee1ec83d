"""Distributed 2D FFT and the row-sharded WFR sweep (counterpart of
pygpa_tpu/parallel/fft.py).

For single images whose planes are too large for one card, the image
stays ROW-SHARDED over the mesh axis: rank r holds rows [r n/D, (r+1)
n/D) of every (n, m) plane.

- fft2_sharded / ifft2_sharded: the pencil decomposition. Each rank
  FFTs its whole local rows along the minor axis, one all_to_all
  re-pencils the array column-sharded (n, m/D), the major axis is FFT'd
  locally and a second all_to_all restores row sharding. No rank ever
  holds the whole array.
- wfr_sweep_spatial: the zoom-window WFR sweep with the OUTPUT rows
  sharded. Only the ranks that own rows of the small (W0, W1) spectrum
  window contribute them, summed to every rank (all_reduce), and each
  rank then sweeps its own row block of every candidate through the zoom
  sweep kernel (ops.zoom_sweep: the block's rows of the row basis A0 are
  the output rows, and the kernel's tournament is the reference's strict
  first max from zero), or its plain twin off the kernel's gate and on
  the CPU.

Collectives on complex data run on torch.view_as_real views, as the
reference psums real and imaginary parts apart.
"""
import numpy as np
import torch
import torch.distributed as dist

from ..ops import zoom_sweep as _zoom
from ..ops.sweep import TILE
from ..ops.wfr import _plan_zoom, _real_dtype, _window_operands
from .mesh import axis_info, local_block, sharded


def all_to_all(x, group, world, split, concat):
    """Split x along axis `split` into `world` equal chunks, send chunk j
    to rank j of `group`, and concatenate the chunks received along axis
    `concat` in rank order (jax.lax.all_to_all(..., tiled=True))."""
    split %= x.dim()
    concat %= x.dim()
    s = x.shape[split] // world
    xs = x.unflatten(split, (world, s)).movedim(split, 0).contiguous()
    real = torch.view_as_real(xs) if xs.is_complex() else xs
    out = torch.empty_like(real)
    dist.all_to_all_single(out, real, group=group)
    if xs.is_complex():
        out = torch.view_as_complex(out)
    return out.movedim(0, concat).flatten(concat, concat + 1)


def all_reduce_sum(t, group):
    """t summed over `group`, in place (complex t through its real
    view); returns t."""
    dist.all_reduce(torch.view_as_real(t) if t.is_complex() else t,
                    op=dist.ReduceOp.SUM, group=group)
    return t


def check_divisible(shape, world, what):
    """Raise unless both trailing axes split evenly over `world` ranks
    (the reference's assertion)."""
    n, m = shape[-2:]
    if n % world or m % world:
        raise ValueError(f"{what} needs both axes divisible by the mesh "
                         f"axis size {world}, got {n} x {m}")


def fft2_local(x, group, world, inverse=False):
    """The pencil (i)FFT of this rank's row block (..., n/D, m) of a
    complex plane; returns its row block of the transform."""
    f = torch.fft.ifft if inverse else torch.fft.fft
    x = f(x, dim=-1)
    xt = all_to_all(x, group, world, split=-1, concat=-2)   # (..., n, m/D)
    xt = f(xt, dim=-2)
    return all_to_all(xt, group, world, split=-2, concat=-1)


def spectrum_local(img, group, world):
    """The pencil fft2 of this rank's row block (r, m) of an image less
    the image's global mean: its row block of the spectrum."""
    mean = all_reduce_sum(img.sum(), group) / (img.numel() * world)
    return fft2_local((img - mean).to(torch.promote_types(
        img.dtype, torch.complex64)), group, world)


def fft2_sharded(image, mesh, axis="batch", inverse=False):
    """2D (i)FFT of a row-sharded image (..., n, m) on the mesh; returns
    the row-sharded transform (a complex DTensor, Shard on the row axis
    over `axis`). The input may be real (forward) or complex, a full
    tensor or a DTensor sharded that way."""
    group, _, world = axis_info(mesh, axis)
    ndim = image.dim() if isinstance(image, torch.Tensor) \
        else np.ndim(image)
    x = local_block(image, mesh, axis, ndim - 2)
    check_divisible((x.shape[-2] * world, x.shape[-1]), world,
                    "fft2_sharded")
    x = x.to(torch.promote_types(x.dtype, torch.complex64))
    return sharded(fft2_local(x, group, world, inverse), mesh, axis,
                   ndim - 2)


def ifft2_sharded(spectrum, mesh, axis="batch"):
    """The inverse of fft2_sharded."""
    return fft2_sharded(spectrum, mesh, axis=axis, inverse=True)


def zoom_rows_kernel_ok(rdt, rows, m):
    """The zoom kernel's gate for a row block, read as the single-card
    route reads it (ops.wfr._kernel_route, zoom_sweep._check): float32,
    the block's rows and the columns multiples of 64 (the zoom windows
    are multiples of 64 by construction)."""
    return rdt == torch.float32 and rows % TILE == 0 and m % TILE == 0


def sweep_rows_local(spec_local, wlist, sigma, shape, group, rank, world,
                     chunk=8):
    """The row-sharded zoom sweep on this rank's row block of a spectrum:
    (best_absq, best_r, best_i, best_idx) planes of its rows. The window
    rows are summed from their owners to every rank; the block's rows
    of the row basis make the block's output rows."""
    n, m = shape
    wl = np.asarray(wlist)
    plan = _plan_zoom((n, m), wl, float(sigma))
    if plan is None:
        raise ValueError("window too large for the zoom sweep")
    idx0, idx1 = plan
    rows_per = n // world
    # the window rows this rank owns, at their local indices
    mine = np.nonzero(idx0 // rows_per == rank)[0]
    dev = spec_local.device
    S = torch.zeros((idx0.size, idx1.size), dtype=spec_local.dtype,
                    device=dev)
    if mine.size:
        loc = torch.as_tensor(idx0[mine] % rows_per, device=dev)
        S[torch.as_tensor(mine, device=dev)] = spec_local.index_select(
            -2, loc).index_select(-1, torch.as_tensor(idx1.astype(np.int64),
                                                      device=dev))
    all_reduce_sum(S, group)
    r0 = rank * rows_per
    ops, _ = _window_operands(S, (n, m), wl, idx0, idx1, float(sigma),
                              rows=(r0, r0 + rows_per))
    if zoom_rows_kernel_ok(_real_dtype(S), rows_per, m):
        # the module attribute, so a check can wrap the kernel's wrapper
        return _zoom.zoom_sweep(*ops)
    return _zoom.zoom_sweep_plain(*ops, chunk=int(chunk))


def wfr_sweep_spatial(image, wlist, kref, sigma, mesh, axis="batch",
                      chunk=8, spectrum=None):
    """WFR zoom sweep of ONE image (n, m) with the image and output rows
    sharded over the mesh axis, for images whose planes are too large
    to hold whole on one card.

    The spectrum comes from the pencil FFT (staying sharded; pass
    `spectrum`, a row-sharded DTensor or full tensor, to reuse one);
    every rank gets the small (W0, W1) bandpass window and sweeps its
    own row block of all candidates. Returns row-sharded DTensors
    {"lockin" (complex, demodulated), "absq", "idx"}, matching
    ops.wfr.wfr_sweep(..., rebase=False, return_absq=True) and its
    winner index. kref is unused (the demodulated lock-in), as in the
    reference."""
    del kref
    group, rank, world = axis_info(mesh, axis)
    if spectrum is None:
        img = local_block(image, mesh, axis, 0)
        check_divisible((img.shape[0] * world, img.shape[1]), world,
                        "wfr_sweep_spatial")
        spec = spectrum_local(img, group, world)
    else:
        spec = local_block(spectrum, mesh, axis, 0)
    shape = (spec.shape[0] * world, spec.shape[1])
    ba, br, bi, bx = sweep_rows_local(spec, wlist, sigma, shape, group,
                                      rank, world, chunk)[:4]
    return {"lockin": sharded(torch.complex(br, bi), mesh, axis, 0),
            "absq": sharded(ba, mesh, axis, 0),
            "idx": sharded(bx, mesh, axis, 0)}
