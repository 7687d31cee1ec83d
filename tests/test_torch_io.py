"""The port's checkpoints (pygpa_tpu_torch.io) on the CPU: the npz pair's
round trip, npz checkpoints crossing between the two packages both
ways, the torch.save pair's round trip, and device_put=True raising
where torch has no CUDA."""
import numpy as np
import pytest
import torch

from pygpa_tpu import io as jio
from pygpa_tpu_torch import io as tio

torch.set_num_threads(2)


def _arrays():
    g = np.random.default_rng(0)
    return {"phases": g.normal(size=(3, 16, 16)),
            "u": g.normal(size=(2, 2, 16, 16)).astype(np.float32),
            "kvecs": np.array([[0.1, 0.0], [0.05, 0.08], [-0.05, 0.08]])}


def test_npz_roundtrip(tmp_path):
    """Tensors and numpy arrays saved together come back as numpy arrays
    with their dtypes and bits."""
    arrs = _arrays()
    path = str(tmp_path / "sub" / "ckpt.npz")
    tio.save_checkpoint(path, phases=torch.from_numpy(arrs["phases"]),
                        u=torch.from_numpy(arrs["u"]), kvecs=arrs["kvecs"])
    out = tio.load_checkpoint(path)
    assert set(out) == set(arrs)
    for k, v in arrs.items():
        assert isinstance(out[k], np.ndarray) and out[k].dtype == v.dtype
        np.testing.assert_array_equal(out[k], v)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer):
    """A checkpoint either package writes, the other reads with equal
    bits."""
    import jax.numpy as jnp
    arrs = _arrays()
    path = str(tmp_path / "ckpt.npz")
    if writer == "port":
        tio.save_checkpoint(path, **{k: torch.from_numpy(v)
                                     for k, v in arrs.items()})
        out = jio.load_checkpoint(path)
    else:
        jio.save_checkpoint(path, **{k: jnp.asarray(v)
                                     for k, v in arrs.items()})
        out = tio.load_checkpoint(path)
    assert set(out) == set(arrs)
    for k, v in arrs.items():
        np.testing.assert_array_equal(np.asarray(out[k]), v)


def test_tensor_pair_roundtrip(tmp_path):
    """save_tensors / load_tensors (torch.save, torch.load with
    weights_only=True): a dict of tensors and arrays comes back as
    tensors with equal bits."""
    arrs = _arrays()
    path = str(tmp_path / "state.pt")
    tio.save_tensors(path, {"u": torch.from_numpy(arrs["u"]),
                            "kvecs": arrs["kvecs"]})
    out = tio.load_tensors(path)
    assert set(out) == {"u", "kvecs"}
    assert all(isinstance(v, torch.Tensor) for v in out.values())
    assert torch.equal(out["u"], torch.from_numpy(arrs["u"]))
    assert torch.equal(out["kvecs"], torch.from_numpy(arrs["kvecs"]))


def test_device_put_needs_cuda(tmp_path):
    """load_checkpoint(device_put=True) puts tensors on the card; where
    torch has no CUDA it raises rather than leaving them on the host."""
    path = str(tmp_path / "ckpt.npz")
    tio.save_checkpoint(path, kvecs=_arrays()["kvecs"])
    if torch.cuda.is_available():
        out = tio.load_checkpoint(path, device_put=True)
        assert out["kvecs"].device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tio.load_checkpoint(path, device_put=True)
