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


# after entry_device: the ops modules these import take it from here
from . import mathtools  # noqa: E402,F401
from . import fourier  # noqa: E402,F401
from . import interp  # noqa: E402,F401
