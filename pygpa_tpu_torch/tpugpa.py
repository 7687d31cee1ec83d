"""The cuGPA mirror (counterpart of pygpa_tpu/tpugpa.py).

pyGPA ships a CuPy mirror of its lock-in and WFR path (cuGPA) that
users pass into the pipeline through the wfr_func seam. The port is
already on the card, so these are thin aliases with cuGPA's names and
signatures, the single-precision variant included, letting a cuGPA user
switch by changing one import. They run on the port's ops.lockin
.gpa_lockin, gpa.api's candidate grid and ops.wfr.wfr_sweep: on the
card, float32 images with sides that are multiples of 128 go through
the zoom sweep kernel and, for the gradients, its gradient emission.
Results are tensors on the device (cuGPA's .get() host copy is
.cpu().numpy()). Each takes `device`: None means the card, "cpu" the
plain route.
"""
import numpy as np
import torch

from .core import entry_tensor as _entry_tensor
from .gpa.api import _wgrid
from .ops.lockin import gpa_lockin
from .ops.wfr import wfr_sweep


def tpuGPA(image, kvec, sigma=22, device=None):
    """Spatial lock-in; mirror of cuGPA.cuGPA."""
    return gpa_lockin(image, np.asarray(kvec), sigma, device=device)


# pyGPA names the module function after the backend
cuGPA = tpuGPA


def wfr2_grad_opt(image, sigma, kx, ky, kw, kstep, grad=None, device=None):
    """WFR sweep with phase gradients; mirror of cuGPA.wfr2_grad_opt."""
    return wfr_sweep(_entry_tensor(image, device), _wgrid(kx, ky, kw, kstep),
                     (kx, ky), sigma, with_grad=True)


def wfr2_grad_single(image, sigma, kx, ky, kw, kstep, grad=None,
                     device=None):
    """Single-precision WFR sweep; mirror of cuGPA.wfr2_grad_single:
    float32 whatever the input's dtype."""
    image = _entry_tensor(image, device).to(torch.float32)
    g = wfr_sweep(image, _wgrid(kx, ky, kw, kstep).astype("float32"),
                  (kx, ky), sigma, with_grad=True)
    return {"lockin": g["lockin"], "grad": g["grad"]}


def wfr2_only_lockin(image, sigma, kvec, kw, kstep, device=None):
    """Lock-in-only sweep; mirror of cuGPA.wfr2_only_lockin (cuGPA's
    kvec-pair signature)."""
    kx, ky = kvec
    return wfr_sweep(_entry_tensor(image, device), _wgrid(kx, ky, kw, kstep),
                     (kx, ky), sigma, with_w=False)["lockin"]


def wfr2_only_grad(image, sigma, kvec, kw, kstep, grad=None, device=None):
    """Gradient-only sweep; mirror of cuGPA.wfr2_only_grad."""
    kx, ky = kvec
    return wfr_sweep(_entry_tensor(image, device), _wgrid(kx, ky, kw, kstep),
                     (kx, ky), sigma, with_grad=True, with_w=False)["grad"]
