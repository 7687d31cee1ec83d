"""Elementwise maths and Fourier building blocks, and the device rule
of the entry points."""
import torch


def entry_device(device):
    """The device an entry point works on: `device` as given, the card
    ("cuda") when it is None. Its inputs move there, so without a card
    the default raises instead of running on the CPU; device="cpu" asks
    for the plain route."""
    return torch.device("cuda" if device is None else device)
