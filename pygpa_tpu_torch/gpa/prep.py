"""Image preparation for GPA (counterpart of pygpa_tpu/gpa/prep.py: the
reference's deprecated prep_image), kept for API parity."""
import numpy as np
import torch

from ..core import entry_device
from ..imagetools import (_gaussian_filter_reflect, _host, gauss_homogenize2,
                          trim_nans2)


def prep_image(original, vlims=None, edges=None, device=None):
    """DEPRECATED (as in the reference): clip, trim and double-homogenize
    an image for GPA. The quantiles, the crop (`edges`, or the NaN trim
    of the zero border) and the clip run on the host (data-dependent
    shapes); both homogenizations run on `device` (None: the card; "cpu"
    for the plain route). Returns (deformed (tensor on the device, mean
    zero), xx, yy (numpy index grids of the trimmed shape))."""
    dev = entry_device(device)
    original = _host(original)
    if vlims is None:
        vlims = np.quantile(original, [0.08, 0.999])
    if edges is not None:
        original = original[edges[0, 0]:edges[0, 1],
                            edges[1, 0]:edges[1, 1]]
    else:
        original = trim_nans2(np.where(original == 0, np.nan, original))
    original = np.clip(original, *vlims)
    mask = np.logical_and(original > np.quantile(original, 0.01),
                          original < np.quantile(original, 0.99))
    img = torch.as_tensor(original, device=dev)
    deformed1 = gauss_homogenize2(img, mask, sigma=5, device=dev)
    mask2 = _gaussian_filter_reflect(deformed1, 5.0) > 0.995
    deformed2 = gauss_homogenize2(img, mask2, sigma=65, device=dev)
    deformed = deformed2 - deformed2.mean()
    xx, yy = np.meshgrid(np.arange(original.shape[0]),
                         np.arange(original.shape[1]), indexing="ij")
    return deformed, xx, yy
