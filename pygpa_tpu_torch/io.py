"""Checkpointing of pipeline intermediates (counterpart of
pygpa_tpu/io.py).

For large mosaic campaigns the per-image intermediates (phases,
weights, u, k-vectors) can be persisted and property extraction resumed
without re-running the sweeps. save_checkpoint / load_checkpoint write
and read a plain .npz, the same files the JAX package's pair reads and
writes. save_tensors / load_tensors keep a dict of tensors with
torch.save / torch.load(weights_only=True); save_checkpoint_orbax /
restore_checkpoint_orbax are the same pair under the names of the
reference's orbax pair, so an import switched from pygpa_tpu.io keeps
working (a flat dict of tensors or arrays in place of its pytree; orbax
is not used).
"""
import os

import numpy as np
import torch


def _host(v):
    """A numpy array of a tensor on any device, or of an array-like."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _parent(path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def save_checkpoint(path, **arrays):
    """Save named arrays (tensors on any device, or numpy arrays) to
    `path` (.npz, compressed), as pygpa_tpu.io.save_checkpoint does."""
    host = {k: _host(v) for k, v in arrays.items()}
    _parent(path)
    np.savez_compressed(path, **host)


def load_checkpoint(path, device_put=False):
    """Load a checkpoint dict: numpy arrays on the host, or with
    `device_put` tensors on the card (raises where torch has no CUDA)."""
    with np.load(path) as f:
        out = {k: f[k] for k in f.files}
    if device_put:
        out = {k: torch.as_tensor(v, device="cuda") for k, v in out.items()}
    return out


def save_tensors(path, tree):
    """Save a dict of tensors (any device) or arrays with torch.save, the
    tensors moved to the host first; the counterpart of
    pygpa_tpu.io.save_checkpoint_orbax."""
    host = {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v)))
            for k, v in tree.items()}
    _parent(path)
    torch.save(host, os.path.abspath(path))


def load_tensors(path, device=None):
    """Load a dict saved by save_tensors with torch.load(weights_only=True)
    (plain tensors only, no code runs), its tensors on `device` (None:
    the host); the counterpart of pygpa_tpu.io.restore_checkpoint_orbax."""
    return torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)


def save_checkpoint_orbax(path, tree):
    """pygpa_tpu.io.save_checkpoint_orbax's name for :func:`save_tensors`:
    `tree` is a flat dict of tensors (any device) or arrays."""
    save_tensors(path, tree)


def restore_checkpoint_orbax(path, abstract_tree=None):
    """pygpa_tpu.io.restore_checkpoint_orbax's name for
    :func:`load_tensors`: the dict saved by save_checkpoint_orbax, its
    tensors on the host; a given `abstract_tree` (a dict of the same
    keys) places each tensor on the device of its entry, where that
    entry is a tensor, as orbax restores into the shardings it is
    given."""
    out = load_tensors(path)
    if abstract_tree is None:
        return out
    return {k: v.to(abstract_tree[k].device)
            if isinstance(abstract_tree.get(k), torch.Tensor) else v
            for k, v in out.items()}
