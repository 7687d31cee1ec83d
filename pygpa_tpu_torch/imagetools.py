"""Image preprocessing utilities (counterpart of pygpa_tpu/imagetools.py).

The dense filters (Gaussian homogenization, per-axis homogenization,
mask generation) run on the device with torch (their FFTs on
core.fourier.gaussian_filter_fft and torch.fft); the NaN trimming and
the mask culling stay numpy on the host, because their output shapes
depend on the data. The plotting helpers live in viz (matplotlib
imported inside them) and are re-exported here, as the reference
does.

The public device functions take `device`: None means the card
(core.entry_device), "cpu" the plain route; their inputs move there.
"""
import numpy as np
import torch
import torch.nn.functional as F

from .core import entry_tensor
from .core.fourier import fftbounds, gaussian_filter_fft  # noqa: F401
from .core.interp import no_tf32
from .core.mathtools import as_tensor


def _host(x):
    """A numpy array of a tensor on any device, or of an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _gaussian_filter_reflect(image, sigma):
    """Gaussian smoothing with reflect boundary handling (close to
    scipy.ndimage.gaussian_filter): reflect-pad by 4 sigma (at most one
    less than the shorter side, which reflect padding needs), FFT-smooth,
    crop."""
    image = as_tensor(image)
    r = min(int(4 * sigma), min(image.shape) - 1)
    padded = F.pad(image[None], (r, r, r, r), mode="reflect")[0]
    return gaussian_filter_fft(padded, sigma)[r:-r, r:-r]


def gauss_homogenize2(image, mask, sigma, nan_scale=None, device=None):
    """Divide the image by its masked Gaussian-smoothed background: the
    smoothed masked image over the smoothed mask (NaN, where the mask's
    smoothing is 0, replaced by nan_scale when given)."""
    image = entry_tensor(image, device)
    mask = entry_tensor(mask, image.device).to(torch.bool)
    VV = _gaussian_filter_reflect(torch.where(mask, image, 0.0), sigma)
    VV = VV / _gaussian_filter_reflect(mask.to(image.dtype), sigma)
    if nan_scale is not None:
        VV = torch.nan_to_num(VV, nan=float(nan_scale))
    return image / VV


def gauss_homogenize3(image, mask, sigma, device=None):
    """gauss_homogenize2 with NaN backgrounds taken as 1."""
    return gauss_homogenize2(image, mask, sigma, nan_scale=1, device=device)


def _nanmedian(x, axis, keepdims=False):
    """jnp.nanmedian along `axis`: the median of the non-NaN values, for
    an even count the mean of the two middle ones ((lo + hi) * 0.5;
    torch.nanmedian returns the lower one), NaN where all are NaN."""
    s = torch.sort(x, dim=axis).values            # NaN sorts last
    cnt = (~torch.isnan(x)).sum(dim=axis, keepdim=True)
    lo = torch.clamp((cnt - 1) // 2, min=0)
    hi = torch.clamp(cnt // 2, min=0)
    out = (s.gather(axis, lo) + s.gather(axis, hi)) * 0.5
    return out if keepdims else out.squeeze(axis)


def _convolve_same(a, v):
    """np.convolve(a, v, mode="same") for 1-D a, v of equal length L: the
    full convolution's entries (L - 1) // 2 onwards, in a's dtype (TF32
    off)."""
    L = a.shape[0]
    with no_tf32():
        full = F.conv1d(a[None, None], v.flip(0)[None, None],
                        padding=L - 1)[0, 0]
    o = (L - 1) // 2
    return full[o:o + L]


def homogenize_per_axis(image, sigma=200, mask=None, reducfunc=_nanmedian,
                        device=None):
    """Divide out per-axis smoothed profiles: along rows, then columns,
    the profile reducfunc(image, axis, keepdims=True) (the NaN-median;
    masked-out pixels as NaN), reflect-padded and convolved with a
    normalized Gaussian of `sigma`, scaled to its maximum."""
    res = entry_tensor(image, device)
    if mask is not None:
        mask = entry_tensor(mask, res.device).to(torch.bool)
    for axis in (0, 1):
        data = res if mask is None else torch.where(mask, res, torch.nan)
        profile = reducfunc(data, axis=axis, keepdims=True)
        prof = profile.reshape(-1)
        r = min(int(4 * sigma), prof.shape[0] - 1)
        prof = F.pad(prof[None], (r, r), mode="reflect")[0]
        L = prof.shape[0]
        x = torch.arange(L, dtype=torch.float64, device=res.device) - L // 2
        k = torch.exp(-0.5 * x ** 2 / sigma ** 2)
        k = (k / k.sum()).to(prof.dtype)
        sm = _convolve_same(prof, k)[r:-r]
        sm = sm.reshape(profile.shape)
        res = res / (sm / sm.max())
    return res


def _nan_rows_cols(image):
    """Per-(row, column) NaN count of a 2D(+channels) image: NaN entries
    are counted per channel."""
    nan = np.isnan(_host(image))
    if nan.ndim >= 3:
        nan = nan.sum(axis=tuple(range(2, nan.ndim)))
    return nan.astype(np.int64)


def trim_nans(image):
    """Drop rows and columns where any single channel is all-NaN along
    the full row or column (all() along the axis first, then any() over
    the channels, RGBA ignoring alpha). Host numpy (data-dependent
    shape)."""
    image = _host(image)
    nan = np.isnan(image)
    xmask = nan.all(axis=1)        # (N, ...channels)
    ymask = nan.all(axis=0)
    if nan.ndim >= 3:
        if nan.shape[-1] == 4:
            xmask = xmask[..., :3]
            ymask = ymask[..., :3]
        xmask = xmask.any(axis=tuple(range(1, xmask.ndim)))
        ymask = ymask.any(axis=tuple(range(1, ymask.ndim)))
    return image[~xmask][:, ~ymask]


def trim_nans2(image, return_lims=False):
    """Peel NaN-containing border rows and columns greedily (the side
    with more border NaNs first), keeping as much area as possible. Host
    numpy: the live window [x0, x1) x [y0, y1) is tracked against NaN
    prefix sums, so each peel costs O(1) after one pass. With
    return_lims also the window [[x0, x1], [y0, y1]]."""
    image = _host(image)
    nan = _nan_rows_cols(image)
    # prefix[i, j] = NaN count in row i, cols [0, j) / col j, rows [0, i)
    row_pre = np.pad(np.cumsum(nan, axis=1), ((0, 0), (1, 0)))
    col_pre = np.pad(np.cumsum(nan, axis=0), ((1, 0), (0, 0)))
    x0, x1 = 0, image.shape[0]
    y0, y1 = 0, image.shape[1]

    def row_count(i):
        return row_pre[i, y1] - row_pre[i, y0]

    def col_count(j):
        return col_pre[x1, j] - col_pre[x0, j]

    while True:
        r_top, r_bot = row_count(x0), row_count(x1 - 1)
        c_left, c_right = col_count(y0), col_count(y1 - 1)
        if r_top + r_bot + c_left + c_right == 0:
            break
        if r_top + r_bot > c_left + c_right:
            x0 += r_top > 0
            x1 -= r_bot > 0
        else:
            y0 += c_left > 0
            y1 -= c_right > 0
    trimmed = image[x0:x1, y0:y1]
    if return_lims:
        return trimmed, np.array([[x0, x1], [y0, y1]])
    return trimmed


def generate_mask(dataset, mask_value, r=20, device=None):
    """Mask (n, m) of the pixels never equal to mask_value in any image of
    the stack dataset (B, n, m), eroded by a disk of radius r: a pixel
    survives where no masked-out pixel lies within r (the border counts
    as masked out, as scipy's binary_erosion's border_value=0). The
    erosion is a float32 FFT convolution with the disk, thresholded at
    0.5 (its values lie near whole counts)."""
    dataset = entry_tensor(dataset, device)
    dev = dataset.device
    mask = ~(dataset == mask_value).any(dim=0)
    n, m = mask.shape
    inv = 1.0 - mask.to(torch.float32)
    inv = F.pad(inv, (r + 1,) * 4, mode="constant", value=1.0)
    yy = torch.arange(-r, r + 1, device=dev)[:, None]
    xx = torch.arange(-r, r + 1, device=dev)[None, :]
    disk = ((xx ** 2 + yy ** 2) <= r ** 2).to(torch.float32)
    kern = torch.zeros(inv.shape, dtype=torch.float32, device=dev)
    kern[: 2 * r + 1, : 2 * r + 1] = disk
    kern = torch.roll(kern, (-r, -r), dims=(0, 1))
    conv = torch.fft.ifft2(torch.fft.fft2(inv) * torch.fft.fft2(kern)).real
    eroded = conv[r + 1: r + 1 + n, r + 1: r + 1 + m] < 0.5
    return eroded & mask


def cull_by_mask(data, mask):
    """Crop a (stack of) image(s) (..., n, m) to the bounding box of the
    mask's nonzero rows and columns. Host numpy."""
    data = _host(data)
    mask = _host(mask)
    alive_r = mask.any(axis=1)
    alive_c = mask.any(axis=0)
    x0 = int(alive_r.argmax())
    x1 = len(alive_r) - int(alive_r[::-1].argmax())
    y0 = int(alive_c.argmax())
    y1 = len(alive_c) - int(alive_c[::-1].argmax())
    return data[..., x0:x1, y0:y1]


# the plotting and colour-map helpers live in viz (no compute); exported
# here as the reference's imagetools does
from .viz import fftplot, indicate_k, to_KovesiRGB  # noqa: E402,F401
