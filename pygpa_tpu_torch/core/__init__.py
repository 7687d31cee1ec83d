"""Core numerics: the device rule of the entry points, math utilities,
Fourier tooling and interpolation."""
import numpy as np
import torch


def entry_device(device):
    """The device an entry point works on: `device` as given, the card
    ("cuda") when it is None. Its inputs move there, so without a card
    the default raises instead of running on the CPU; device="cpu" asks
    for the plain route."""
    return torch.device("cuda" if device is None else device)


def entry_tensor(x, device):
    """An entry point's input (numpy, array-like or tensor) as a tensor on
    entry_device(device), keeping its dtype."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, device=entry_device(device))


def host_to_device(a, device, dtype=None):
    """A host array (numpy or array-like) as a tensor on `device`, cast to
    `dtype` on the host first (IEEE rounding, the bits a cast on the card
    gives). To the card it goes from pinned memory without blocking, so
    the host does not wait for the stream (a copy from pageable memory
    does); the pinned buffer is held until the copy has run."""
    t = torch.from_numpy(np.array(a))     # a writable host copy
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device) if device is not None else t.device
    if device.type != "cuda" or not torch.cuda.is_available():
        return t.to(device)     # without a card: torch's own CUDA error
    return t.pin_memory().to(device, non_blocking=True)


# after entry_device: the ops modules these import take it from here
from . import mathtools  # noqa: E402,F401
from . import fourier  # noqa: E402,F401
from . import interp  # noqa: E402,F401
