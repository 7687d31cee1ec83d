"""Visualization helpers (counterpart of pygpa_tpu/viz.py), kept out of
the compute path: numpy on the host, matplotlib imported inside the
functions only, so importing the package never needs matplotlib (the
machine with the card may have none).

to_KovesiRGB maps a 3-channel image onto P. Kovesi's isoluminant RGB
basis; fftplot draws an fftshifted spectrum on physical frequency axes;
indicate_k draws the k-vector constellation. Tensors (any device) are
taken as well as arrays.
"""
import numpy as np
import torch

from .core.fourier import fftbounds


def _host(x):
    """A numpy array of a tensor on any device, or of an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_KovesiRGB(image):
    """Map a 3-channel image onto P. Kovesi's isoluminant RGB basis
    (arXiv:1509.03700). Accepts (..., 3); returns (..., 3) float RGB
    (numpy)."""
    # rows = contribution of each input channel to (R, G, B)
    basis = np.array([(0.90, 0.17, 0.00),
                      (0.00, 0.50, 0.00),
                      (0.10, 0.33, 1.00)])
    return np.einsum("...i,ij->...j", _host(image), basis)


def _fft_axes_1d(shape, d):
    """Shifted frequency bin edges per image axis."""
    return tuple(fftbounds(n, d) for n in shape)


def fftplot(fftim, d=1, pcolormesh=True, contour=False, levels=None,
            **kwargs):
    """Render an fftshifted spectrum with physical frequency axes.

    The image's first axis is drawn along x (the array is shown
    transposed), with equal aspect. Pass ax= to draw into an existing
    axis; other kwargs forward to the matplotlib call. Returns the
    artist."""
    import matplotlib.pyplot as plt

    fftim = _host(fftim)
    xe, ye = _fft_axes_1d(fftim.shape[:2], d)
    origin = kwargs.pop("origin", "upper")
    ax = kwargs.pop("ax", None) or plt.subplots()[1]

    if pcolormesh:
        artist = ax.pcolormesh(*np.meshgrid(xe, ye, indexing="xy"),
                               fftim.T, **kwargs)
    else:
        ye_ordered = ye[::-1] if origin == "upper" else ye
        extent = (xe[0], xe[-1], ye_ordered[0], ye_ordered[-1])
        artist = ax.imshow(fftim.T, extent=extent, origin=origin,
                           **kwargs)
        if contour:
            ax.contour(fftim.T, extent=extent, colors="white",
                       alpha=0.3, levels=levels)
    ax.set_aspect("equal")
    return artist


def indicate_k(pks, i, ax=None, inset=True, size="25%", origin="upper",
               s=10, colors=("red", "gray")):
    """Draw the k-vector constellation (+-pks and the origin) and
    highlight and arrow the i-th one (or each of several). Returns the
    axis drawn into (an inset axis when inset=True)."""
    import matplotlib.pyplot as plt
    from mpl_toolkits.axes_grid1.inset_locator import inset_axes

    ks = np.array(_host(pks), dtype=float)
    if origin == "upper":
        ks = ks * (1, -1)

    ax = ax or plt.gca()
    if inset:
        ax = inset_axes(ax, width=size, height=size, loc=2)
        ax.tick_params(labelleft=False, labelbottom=False,
                       direction="in", length=0)
        for spine in ax.spines.values():
            spine.set_color("None")
        ax.patch.set_alpha(0.0)

    constellation = np.vstack([ks, -ks, np.zeros((1, 2))])
    ax.scatter(constellation[:, 0], constellation[:, 1],
               color=colors[1], s=s)
    highlight = np.atleast_1d(np.asarray(i))
    ax.scatter(ks[highlight, 0], ks[highlight, 1], color=colors[0],
               s=3 * s)
    arrow_kw = {} if highlight.size > 1 else {"color": "black"}
    for j in highlight:
        ax.arrow(0, 0, ks[j, 0], ks[j, 1], length_includes_head=True,
                 **arrow_kw)
    ax.set_aspect("equal")
    return ax
