"""The port's imagetools, gpa.prep and viz on the CPU against
pygpa_tpu's: the device filters (Gaussian and per-axis homogenization,
the reflect-padded Gaussian, the eroded mask) on seeded images, the
host NaN trims and mask culling, prep_image at 256^2, the Kovesi colour
map exactly, fftplot and indicate_k on matplotlib's Agg backend (axis
extents equal to the reference's), and extract_primary_ks(plot=True)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpa_tpu import imagetools as jit_
from pygpa_tpu.gpa import peaks as jpeaks
from pygpa_tpu.gpa import prep as jprep
from pygpa_tpu.lattices import hexlattice_gen
from pygpa_tpu_torch import imagetools as tit
from pygpa_tpu_torch import viz as tviz
from pygpa_tpu_torch.gpa import peaks as tpeaks
from pygpa_tpu_torch.gpa import prep as tprep

torch.set_num_threads(2)


def _lit(n=96, m=112, seed=0):
    """A lattice (r_k 0.1, theta 5 deg) under a multiplicative
    illumination ramp, plus seeded noise; float64."""
    base = np.asarray(hexlattice_gen(0.1, 5.0, 1, size=max(n, m),
                                     dtype=np.float64))[:n, :m] + 5
    ramp = np.linspace(0.5, 2.0, n)[:, None] * np.linspace(1.2, 0.8, m)
    g = np.random.default_rng(seed)
    return base * ramp + 0.05 * g.normal(size=(n, m))


def _mask(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape) > 0.3


@pytest.mark.parametrize("shape,sigma", [((96, 112), 3.0), ((40, 56), 20.0)])
def test_gaussian_filter_reflect_matches(shape, sigma):
    """The reflect-padded Gaussian; at sigma 20 the pad is clamped to one
    less than the shorter side (40 - 1), as the reference clamps it."""
    img = _lit(*shape)
    want = np.asarray(jit_._gaussian_filter_reflect(jnp.asarray(img), sigma))
    got = tit._gaussian_filter_reflect(torch.from_numpy(img), sigma)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("fn", ["gauss_homogenize2", "gauss_homogenize3"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gauss_homogenize_matches(fn, dtype):
    """Both homogenizations on a masked lit lattice, float64 (rtol 1e-9:
    inside gauss_homogenize3's 12-column False block the smoothed mask
    falls to ~0.2 and its division lifts the FFTs' rounding) and
    float32 (rtol 1e-5); gauss_homogenize3 also with an all-False mask,
    whose 0 / 0 background becomes 1 and gives the image back."""
    img = _lit().astype(dtype)
    mask = _mask(img.shape, 1)
    if fn == "gauss_homogenize3":
        mask[:, :12] = False
        empty = np.zeros_like(mask)
        np.testing.assert_array_equal(
            tit.gauss_homogenize3(img, empty, 8, device="cpu").numpy(),
            np.asarray(jit_.gauss_homogenize3(jnp.asarray(img),
                                              jnp.asarray(empty), 8)))
    want = np.asarray(getattr(jit_, fn)(jnp.asarray(img), jnp.asarray(mask),
                                        8))
    got = getattr(tit, fn)(img, mask, 8, device="cpu").numpy()
    assert got.dtype == dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    rtol = 1e-9 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("n,m", [(64, 96), (65, 97)])
@pytest.mark.parametrize("masked", [False, True])
def test_homogenize_per_axis_matches(n, m, masked):
    """homogenize_per_axis at even and odd sides (the 'same' convolution's
    centring, the reflect pad clamped below the profile's length at sigma
    40), with and without a mask; the mask leaves an even count of valid
    pixels in some rows and columns, where the NaN-median averages the
    two middle values."""
    img = _lit(n, m, seed=n)
    mask = _mask((n, m), 2) if masked else None
    if masked:
        mask[0, :] = True
        mask[0, 1] = False          # row 0: m - 1 valid values
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jit_.homogenize_per_axis(jnp.asarray(img), sigma=40,
                                               mask=jm))
    got = tit.homogenize_per_axis(img, sigma=40, mask=mask,
                                  device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_nanmedian_even_count_averages():
    """The NaN-median of an even count is the mean of its two middle
    values (jnp.nanmedian), not the lower one (torch.nanmedian); an
    all-NaN line gives NaN."""
    g = np.random.default_rng(3)
    x = g.normal(size=(6, 8))
    x[g.uniform(size=x.shape) < 0.3] = np.nan
    x[4] = np.nan
    for axis in (0, 1):
        want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=axis,
                                        keepdims=True))
        got = tit._nanmedian(torch.from_numpy(x), axis, keepdims=True)
        np.testing.assert_array_equal(got.numpy(), want)
    assert float(tit._nanmedian(torch.tensor([1.0, 4.0, 2.0, 8.0]), 0)) == 3.0


def _nan_bordered(seed):
    g = np.random.default_rng(seed)
    img = g.uniform(1, 2, size=(40, 50))
    img[:3] = np.nan
    img[:, -2:] = np.nan
    img[-1, ::3] = np.nan
    img[:, 0][g.uniform(size=40) < 0.2] = np.nan
    img[20, 20 + seed] = np.nan                # interior: stays
    return img


@pytest.mark.parametrize("seed", [4, 5])
def test_nan_trims_match(seed):
    """trim_nans and trim_nans2 (with its limits) on NaN-bordered images,
    2-D and with channels (RGBA with an all-NaN alpha: trim_nans ignores
    it), equal to the reference's."""
    img = _nan_bordered(seed)
    rgb = np.stack([img, img, np.roll(img, 1, 0)], -1)
    rgba = np.concatenate([rgb, np.full_like(img, np.nan)[..., None]], -1)
    np.testing.assert_array_equal(tit.trim_nans(rgba), jit_.trim_nans(rgba))
    for im in (img, rgb):
        np.testing.assert_array_equal(tit.trim_nans(im), jit_.trim_nans(im))
        got, lims = tit.trim_nans2(im, return_lims=True)
        want, wl = jit_.trim_nans2(im, return_lims=True)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(lims, wl)
    np.testing.assert_array_equal(tit._nan_rows_cols(rgb),
                                  jit_._nan_rows_cols(rgb))
    assert np.isnan(tit.trim_nans2(img)).sum() >= 1


@pytest.mark.parametrize("r", [3, 7])
def test_generate_mask_and_cull_match(r):
    """generate_mask on a seeded stack with masked-out blocks and pixels
    (float32 FFT erosion thresholded at 0.5), equal to the reference's
    mask; cull_by_mask crops alike."""
    g = np.random.default_rng(r)
    data = g.uniform(0, 1, size=(3, 80, 72))
    data[1, 10:20, 30:45] = -1
    data[2][g.uniform(size=(80, 72)) < 0.002] = -1
    want = np.asarray(jit_.generate_mask(jnp.asarray(data), -1, r=r))
    got = tit.generate_mask(data, -1, r=r, device="cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.2 < want.mean() < 0.95
    np.testing.assert_array_equal(tit.cull_by_mask(data, got),
                                  jit_.cull_by_mask(data, want))


def test_prep_image_matches():
    """prep_image at 256^2 on a lit lattice with a zero border (trimmed
    as NaN by trim_nans2): the deformed image within 1e-10 of the
    reference's largest value, and the index grids equal."""
    img = _lit(256, 256, seed=6) + 1
    img[:5] = 0
    img[:, -3:] = 0
    want, wxx, wyy = jprep.prep_image(img)
    got, xx, yy = tprep.prep_image(img, device="cpu")
    want = np.asarray(want)
    assert got.shape == want.shape and got.shape[0] == 251
    assert got.shape[1] < 253
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    np.testing.assert_array_equal(xx, wxx)
    np.testing.assert_array_equal(yy, wyy)


def test_to_kovesi_rgb_exact():
    """The Kovesi colour map, bit for bit, from numpy and from a tensor."""
    img = np.random.default_rng(7).uniform(size=(5, 6, 3))
    want = np.asarray(jit_.to_KovesiRGB(img))
    np.testing.assert_array_equal(tit.to_KovesiRGB(img), want)
    np.testing.assert_array_equal(tviz.to_KovesiRGB(torch.from_numpy(img)),
                                  want)


def test_fftplot_and_indicate_k_extents():
    """fftplot (pcolormesh and imshow with contours, both origins) and
    indicate_k (inset and not, one and several highlighted ks) on the Agg
    backend: the same axis limits, image extents and mesh shapes as the
    reference's drawings."""
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    spec = np.abs(np.fft.fftshift(np.fft.fft2(_lit(48, 40))))
    ks = np.array([[0.1, 0.02], [-0.03, 0.12], [0.07, -0.1]])

    def draw(mod):
        out = []
        for kw in ({"pcolormesh": True}, {"pcolormesh": False,
                                          "contour": True, "levels": 3},
                   {"pcolormesh": False, "origin": "lower"}):
            _, ax = plt.subplots()
            art = mod.fftplot(spec, d=0.5, ax=ax, **kw)
            ext = art.get_extent() if hasattr(art, "get_extent") else \
                np.asarray(art.get_coordinates()).shape
            out.append((ax.get_xlim(), ax.get_ylim(), tuple(ext)))
            plt.close("all")
        for i, inset in ((1, True), ([0, 2], False)):
            _, ax = plt.subplots()
            a = mod.indicate_k(ks, i, ax=ax, inset=inset)
            out.append((a.get_xlim(), a.get_ylim(), len(a.collections)))
            plt.close("all")
        return out

    got, want = draw(tviz), draw(jit_)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g[2] == w[2]
        np.testing.assert_allclose(g[:2], w[:2], rtol=1e-12)
    assert tit.fftplot is tviz.fftplot and tit.indicate_k is tviz.indicate_k


def test_extract_primary_ks_plots():
    """extract_primary_ks(plot=True) draws (no NotImplementedError) and
    returns what plot=False does; the reference's draws the same two
    panels."""
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    img = np.asarray(hexlattice_gen(0.08, 7.0, 1, size=128,
                                    dtype=np.float64))
    pk, ak = tpeaks.extract_primary_ks(img, plot=True, DoG=False,
                                       device="cpu")
    fig = plt.gcf()
    assert len(fig.axes) == 2
    assert len(fig.axes[0].collections) == 2 and fig.axes[1].images
    plt.close("all")
    p0, a0 = tpeaks.extract_primary_ks(img, DoG=False, device="cpu")
    np.testing.assert_array_equal(pk, p0)
    np.testing.assert_array_equal(ak, a0)
    jpeaks.extract_primary_ks(img, plot=True, DoG=False)
    assert len(plt.gcf().axes) == 2
    plt.close("all")
