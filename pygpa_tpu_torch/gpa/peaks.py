"""Primary k-vector (Bragg or moire peak) detection (counterpart of
pygpa_tpu/gpa/peaks.py).

The dense part runs on the device, once per detection attempt: mean
subtraction, the Moisan periodic component's |FFT|, Gaussian (or DoG)
smoothing, the local-maximum mask, the pix_norm_range annulus, the top
_MAX_PEAKS candidates and their 3x3 neighbourhoods, packed into one
(K, 13) record that crosses to the host in one copy. The small,
data-dependent rest stays on the host, as in the reference: coordinate
lists, de-duplication, the recursive threshold and sigma adaptation and
the sub-bin refinement.

Candidates are ordered by value, descending, and by flat index among
equal values (jax.lax.top_k's order), so the card and the CPU hand the
host the same list: |FFT| of a real image is symmetric, every peak has a
partner of (nearly) equal value, and the first of the two is the one
de-duplication keeps.
"""
from itertools import combinations

import numpy as np
import torch

from ..core import entry_tensor
from ..core.fourier import gaussian_filter_fft, moisan_per
from ..core.mathtools import remove_negative_duplicates as _rnd
from ..ops.peaks import local_max_mask

_MAX_PEAKS = 128
# columns of a candidate record: value, row, column, the 3x3
# neighbourhood (row-major), valid flag
RECORD = 13


def remove_negative_duplicates(ks):
    """The GPA module's variant: norm-scaled tolerance."""
    return _rnd(ks, atol_scale="norm")


def smallest_sum(ks):
    """Smallest +/- sum of 3 k-vectors: how close the triplet comes to a
    closed triangle (nan unless there are exactly 3)."""
    if len(ks) != 3:
        return np.nan
    M = np.ones((3, 3)) - 2 * np.eye(3)
    sums = M @ np.asarray(ks)
    return sums[np.argmin(np.linalg.norm(sums, axis=1))]


def select_closest_to_triangle(ks):
    """The 3 of ks that come closest to a closed triangle."""
    combis = list(combinations(np.asarray(ks), 3))
    sums = [np.linalg.norm(smallest_sum(c)) for c in combis]
    return np.array(combis[int(np.argmin(sums))])


def _peak_image(image, sigma, dog):
    """The smoothed |FFT| (fftshifted) of the mean-free image's periodic
    component; with dog, less its sigma-50 smoothing."""
    image = image - image.mean()
    pd, _ = moisan_per(image, inverse_dft=False)
    fftim = torch.abs(torch.fft.fftshift(pd))
    smooth = gaussian_filter_fft(fftim, sigma)
    if dog:
        smooth = smooth - gaussian_filter_fft(fftim, 50.0)
    return smooth


def _peak_candidates(image, sigma, threshold, rlo, rhi, dog):
    """One detection attempt on the device: the (K, RECORD) candidate
    record of the top K = min(_MAX_PEAKS, n m) local maxima above
    threshold * max inside the annulus rlo < r < rhi (pixels from the
    spectrum's centre); rows past the last maximum hold -inf values and
    a zero valid flag."""
    smooth = _peak_image(image, sigma, dog)
    dt, dev = smooth.dtype, smooth.device
    mask = local_max_mask(smooth, torch.tensor(float(threshold), dtype=dt,
                                               device=dev))
    n, m = smooth.shape
    ri = (torch.arange(n, device=dev).to(dt) - n // 2)[:, None]
    rj = (torch.arange(m, device=dev).to(dt) - m // 2)[None, :]
    r2 = ri * ri + rj * rj
    mask = mask & (r2 > float(rlo) ** 2) & (r2 < float(rhi) ** 2)
    vals = torch.where(mask, smooth,
                       torch.tensor(-np.inf, dtype=dt, device=dev))
    k = min(_MAX_PEAKS, vals.numel())
    top, idx = torch.topk(vals.reshape(-1), k)
    # jax.lax.top_k's order: value descending, then flat index ascending
    order = torch.argsort(idx)
    top, idx = top[order], idx[order]
    order = torch.argsort(top, descending=True, stable=True)
    top, idx = top[order], idx[order]
    ii, jj = idx // m, idx % m
    si = torch.clamp(ii - 1, 0, n - 3)
    sj = torch.clamp(jj - 1, 0, m - 3)
    d = torch.arange(3, device=dev)
    flat = (si[:, None, None] + d[None, :, None]) * m \
        + (sj[:, None, None] + d[None, None, :])
    neigh = smooth.reshape(-1)[flat].reshape(k, 9)
    valid = torch.isfinite(top).to(dt)
    return torch.cat([top[:, None], ii[:, None].to(dt), jj[:, None].to(dt),
                      neigh, valid[:, None]], 1)


def _decrease_threshold(t):
    """The threshold adaptation schedule."""
    if t > 0.001:
        if t >= 0.2:
            t = t - 0.1
        else:
            t = t / 2
    return t


def _subpixel_refine(neigh, cindices, shape):
    """Quadratic sub-bin refinement of peak positions from their (K, 3,
    3) neighbourhoods (host numpy): the vertex of the parabola through
    the peak's column and row, clipped to half a bin; border peaks keep
    their integer position along the axis they touch."""
    neigh = np.asarray(neigh, np.float64)
    ii = cindices[:, 0]
    jj = cindices[:, 1]
    n, m = shape
    interior_i = (ii > 0) & (ii < n - 1)
    interior_j = (jj > 0) & (jj < m - 1)
    # the window was clip-shifted at the borders: the peak sits at
    # (ii - start_i, jj - start_j), not necessarily at (1, 1)
    ci = ii - np.clip(ii - 1, 0, n - 3)
    cj = jj - np.clip(jj - 1, 0, m - 3)
    k = np.arange(len(ii))
    col = neigh[k, :, cj]
    row = neigh[k, ci, :]
    den_i = col[:, 0] - 2 * col[:, 1] + col[:, 2]
    den_j = row[:, 0] - 2 * row[:, 1] + row[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        di = np.clip(0.5 * (col[:, 0] - col[:, 2]) / den_i, -0.5, 0.5)
        dj = np.clip(0.5 * (row[:, 0] - row[:, 2]) / den_j, -0.5, 0.5)
    di = np.where(interior_i & (den_i < 0), di, 0.0)
    dj = np.where(interior_j & (den_j < 0), dj, 0.0)
    return np.stack([ii + di, jj + dj], axis=-1)


def extract_primary_ks(image, plot=False, threshold=0.7,
                       pix_norm_range=(2, 200), sigma=1, NMPERPIXEL=1.0,
                       DoG=True, subpixel=False, device=None):
    """The primary k-vectors of a lattice image from its smoothed Fourier
    magnitude, adapting threshold and sigma recursively until (ideally)
    three primary ks emerge. Returns (primary_ks (N, 2), all_ks (N+M,
    2)) as numpy arrays. The image moves to `device` (None: the card;
    "cpu" for the plain route); each attempt copies one candidate record
    to the host. plot=True draws the smoothed spectrum with all and
    primary ks (viz.fftplot) beside the image (matplotlib)."""
    image = entry_tensor(image, device)
    rec = _peak_candidates(image, sigma, threshold, pix_norm_range[0],
                           pix_norm_range[1], bool(DoG)).cpu().numpy()
    valid_h = rec[:, RECORD - 1] > 0.5
    vals_h = rec[valid_h, 0]               # descending (top_k order)
    cindices = rec[valid_h, 1:3].astype(np.int64)
    neigh_h = rec[valid_h, 3:12].reshape(-1, 3, 3)

    kxs = np.fft.fftshift(np.fft.fftfreq(image.shape[0]))
    kys = np.fft.fftshift(np.fft.fftfreq(image.shape[1]))
    center = np.array(image.shape) // 2
    coords = cindices - center
    norms = np.linalg.norm(coords, axis=1) if len(coords) else np.zeros(0)
    selection = (norms < pix_norm_range[1]) & (norms > pix_norm_range[0])
    cindices = cindices[selection]
    coords = coords[selection]
    vals_h = vals_h[selection]
    neigh_h = neigh_h[selection]

    if subpixel and len(cindices):
        pos = _subpixel_refine(neigh_h, cindices, image.shape)
        all_ks = np.stack(
            [(pos[:, 0] - image.shape[0] // 2) / image.shape[0],
             (pos[:, 1] - image.shape[1] // 2) / image.shape[1]], -1)
    elif len(cindices):
        all_ks = np.array([kxs[cindices.T[0]], kys[cindices.T[1]]]).T
    else:
        all_ks = np.zeros((0, 2))
    all_ks = remove_negative_duplicates(all_ks)

    def again(threshold, sigma):
        return extract_primary_ks(
            image, plot=False, threshold=threshold, sigma=sigma,
            pix_norm_range=pix_norm_range, DoG=DoG, subpixel=subpixel,
            device=image.device)

    newparams = False
    if len(all_ks) < 3:
        newparams = True
        if len(all_ks) == 0:
            if threshold > _decrease_threshold(threshold):
                threshold = _decrease_threshold(threshold)
            else:
                print("No ks found at minimum threshold!")
                newparams = False
        else:
            coordsminlength = np.linalg.norm(coords, axis=1).min()
            peakvals = vals_h.max()
            if coordsminlength < 5 * sigma:
                sigma = coordsminlength / 6
            elif threshold > 0.2 * peakvals:
                threshold = 0.2 * peakvals
            elif threshold > _decrease_threshold(threshold):
                threshold = _decrease_threshold(threshold)
            else:
                print("Can't find enough ks!")
                newparams = False
        if newparams:
            primary_ks, all_ks = again(threshold, sigma)
        else:
            primary_ks = all_ks.copy()

    if not newparams:
        primary_ks = all_ks.copy()

    if len(primary_ks) != 3:
        if len(primary_ks) > 3:
            primary_ks = select_closest_to_triangle(all_ks)
        elif len(all_ks) > 6:
            primary_ks = select_closest_to_triangle(all_ks)
        elif threshold > _decrease_threshold(threshold) and not newparams:
            threshold = _decrease_threshold(threshold)
            primary_ks, all_ks = again(threshold, sigma)
        else:
            primary_ks = all_ks.copy()

    if plot:
        import matplotlib.pyplot as plt

        from ..viz import fftplot
        smooth_h = _peak_image(image, sigma, bool(DoG)).cpu().numpy()
        _, ax = plt.subplots(ncols=2, figsize=[12, 8])
        fftplot(smooth_h, d=NMPERPIXEL, ax=ax[0], pcolormesh=False,
                origin="lower")
        ax[0].scatter(*(all_ks / NMPERPIXEL).T, color="red", alpha=0.2, s=50)
        ax[0].scatter(*(np.asarray(primary_ks) / NMPERPIXEL).T,
                      color="black", alpha=0.7, s=50, marker="x")
        ax[1].imshow(image.cpu().numpy().T, origin="lower")
    return primary_ks, all_ks
