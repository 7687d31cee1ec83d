"""The reference's GPA / WFR function names (counterpart of
pygpa_tpu/gpa/api.py). GPA, optGPA and vecGPA are the spatial lock-in
(ops.lockin). The WFR variants are thin wrappers over one
sweep (ops.wfr.wfr_sweep: on the card the zoom kernel, with its
gradient emission for the *_grad names; for wfr4 the k-continuity
scan); the *_vec variants are the same sweep, kept as aliases.
Candidate grids are built on the host with np.arange, row-major in
(wx, wy), as the reference iterates them, so ties break the same way.

Each wrapper takes the image (numpy or a tensor) and `device`: None
means the card, "cpu" the plain route (core.entry_device)."""
import numpy as np
import torch

from ..core import entry_tensor
from ..ops.lockin import gpa_lockin, gpa_lockin_batch
from ..ops.wfr import wfr_sweep


def GPA(image, kx, ky, sigma=22, device=None):
    """Spatial lock-in of `image` at (kx, ky)."""
    return gpa_lockin(image, (kx, ky), sigma, device=device)


def optGPA(image, kvec, sigma=22, device=None):
    """Spatial lock-in, kvec as a pair."""
    return gpa_lockin(image, kvec, sigma, device=device)


def vecGPA(image, kvecs, sigma=22, device=None):
    """Lock-in at each of kvecs (K, 2): (K, n, m)."""
    return gpa_lockin_batch(image, kvecs, sigma, device=device)


def _wgrid(kx, ky, kw, kstep):
    """Row-major (wx outer, wy inner) candidate grid around (kx, ky)."""
    wxs = np.arange(kx - kw, kx + kw, kstep)
    wys = np.arange(ky - kw, ky + kw, kstep)
    wx, wy = np.meshgrid(wxs, wys, indexing="ij")
    return np.stack([wx.ravel(), wy.ravel()], axis=-1)


def wfr(image, sigma, kx, ky, kw, kstep, device=None):
    """Adaptive GPA: the winning candidates wx, wy and the rebased
    lock-in's phase and magnitude r."""
    g = wfr_sweep(entry_tensor(image, device), _wgrid(kx, ky, kw, kstep),
                  (kx, ky), sigma)
    return {"wx": g["w"][0], "wy": g["w"][1],
            "phase": torch.angle(g["lockin"]), "r": torch.abs(g["lockin"])}


def wfr2(image, sigma, kx, ky, kw, kstep, device=None):
    """Adaptive GPA: the winning k-field 'w' (2, N, M) and the complex
    lock-in rebased to (kx, ky)."""
    return wfr_sweep(entry_tensor(image, device), _wgrid(kx, ky, kw, kstep),
                     (kx, ky), sigma)


# the reference's optwfr2 computes wfr2's values with fewer operations
optwfr2 = wfr2


def wfr3(image, sigma, klist, kref, device=None):
    """Sweep an explicit k-list, rebased to kref."""
    return wfr_sweep(entry_tensor(image, device), np.asarray(klist),
                     np.asarray(kref), sigma)


def wfr4(image, sigma, klist, kref, dk, device=None):
    """wfr3 with the k-continuity constraint: a candidate takes a pixel
    only within 2 sqrt(2) dk of the pixel's current winner."""
    return wfr_sweep(entry_tensor(image, device), np.asarray(klist),
                     np.asarray(kref), sigma, continuity_dk=dk)


def wfr2_only_lockin(image, sigma, kx, ky, kw, kstep, device=None):
    """The rebased lock-in alone."""
    return wfr2(image, sigma, kx, ky, kw, kstep, device=device)["lockin"]


# the reference's dask-vectorized variant: the same sweep
wfr2_only_lockin_vec = wfr2_only_lockin


def wfr2_grad_opt(image, sigma, kx, ky, kw, kstep, device=None):
    """The sweep with the winner's phase gradient 'grad' (N, M, 2),
    rebased to (kx, ky)."""
    return wfr_sweep(entry_tensor(image, device), _wgrid(kx, ky, kw, kstep),
                     (kx, ky), sigma, with_grad=True)


# wfr2_grad and wfr2_grad_vec compute the same result (np.gradient and a
# final wrap) in the reference; one sweep here
wfr2_grad = wfr2_grad_opt
wfr2_grad_vec = wfr2_grad_opt


def generate_klists(pks, dk=None, kmax=1.9, kmin=0.2, sort_list=False):
    """Voronoi-restricted annulus k-lists for wfr3/wfr4 (host numpy:
    data-dependent shapes)."""
    pks = np.asarray(pks)
    doubleks = np.concatenate([pks, -pks])
    kmax = np.linalg.norm(pks, axis=1).max() * kmax
    kmin = np.linalg.norm(pks, axis=1).max() * kmin
    if dk is None:
        dk = np.linalg.norm(pks, axis=1).mean() / 10
    kk = np.mgrid[-kmax:kmax:0.005, -kmax:kmax:0.005]
    dists = ((np.moveaxis(kk[..., None], 0, -1) - doubleks) ** 2).sum(axis=-1)
    r = (kk ** 2).sum(axis=0)
    kmask0 = (r < kmax ** 2) & (r > kmin ** 2)
    klists = []
    for i, pk in enumerate(pks):
        kmask = kmask0 & (dists.min(axis=-1) == dists[..., i])
        klist = kk[:, kmask].T
        if sort_list:
            ampl = np.linalg.norm(klist - pks[i], axis=1)
            klist = klist[np.argsort(ampl.reshape((-1)))]
        klists.append(klist)
    return klists
