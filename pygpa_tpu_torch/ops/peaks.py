"""Local-maximum detection for Bragg-peak finding (counterpart of
pygpa_tpu/ops/peaks.py; skimage.feature.peak_local_max(min_distance=1,
exclude_border=True) semantics as one boolean mask on the device)."""
import torch
import torch.nn.functional as F


def local_max_mask(image, threshold_rel, min_distance=1):
    """Boolean mask of the pixels of `image` (n, m) that equal the maximum
    of their (2 min_distance + 1)^2 neighbourhood (F.max_pool2d, which
    pads with -inf as the reference's reduce_window does), exceed
    threshold_rel * max(image) and lie min_distance or more pixels from
    the border."""
    k = 2 * int(min_distance) + 1
    neigh = F.max_pool2d(image[None, None], k, stride=1,
                         padding=int(min_distance))[0, 0]
    mask = (image == neigh) & (image > threshold_rel * image.max())
    n, m = image.shape
    md = int(min_distance)
    ii = torch.arange(n, device=image.device)[:, None]
    jj = torch.arange(m, device=image.device)[None, :]
    border = (ii >= md) & (ii < n - md) & (jj >= md) & (jj < m - md)
    return mask & border
