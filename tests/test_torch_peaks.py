"""The port's Bragg-peak detection (pygpa_tpu_torch.gpa.peaks,
ops.peaks) and its Fourier helpers (core.fourier moisan_per,
gaussian_filter_fft, fftbounds, dct2_1d / idct2_1d) against pygpa_tpu
on the CPU. Inputs are numpy arrays from a seed or the reference's own
lattice fixtures; k-vector sets are compared canonicalized (each
vector's sign made positive as remove_negative_duplicates makes it,
rows sorted), since the order of a peak and its mirror partner is
rounding's choice."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.gpa as jgpa
import pygpa_tpu.gpa.peaks as jpeaks
from pygpa_tpu.core import fourier as jfourier
from pygpa_tpu.lattices import anylattice_gen, generate_ks, hexlattice_gen
from pygpa_tpu.ops import peaks as jops_peaks
import pygpa_tpu_torch.gpa.peaks as tpeaks
from pygpa_tpu_torch.core import fourier as tfourier
from pygpa_tpu_torch.ops import peaks as tops_peaks

torch.set_num_threads(2)


def canon(ks):
    """k-vectors with a non-negative x (y where x is 0), rows sorted."""
    ks = np.asarray(ks, np.float64)
    if len(ks) == 0:
        return ks
    c = np.where(np.sign(ks[:, [0]]) != 0, np.sign(ks[:, [0]]) * ks,
                 np.sign(ks[:, [1]]) * ks)
    return c[np.lexsort(c.T[::-1])]


def same_set(a, b, atol):
    a, b = canon(a), canon(b)
    assert a.shape == b.shape, (a, b)
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# -- local maxima -----------------------------------------------------------

def _plateaus():
    img = np.zeros((20, 24))
    img[5:8, 5:8] = 1.0          # a plateau: every pixel equals its max
    img[0, 3] = 2.0              # maxima on the border
    img[19, 23] = 2.0
    img[10, 12] = 1.5
    img[10, 13] = 1.5            # two equal neighbours
    return img


@pytest.mark.parametrize("case", ["random64x48", "random33x50", "plateaus",
                                  "md2"])
def test_local_max_mask_matches(case):
    rng = np.random.default_rng(3)
    md = 1
    if case == "plateaus":
        img, thr = _plateaus(), 0.1
    elif case == "md2":
        img, thr, md = rng.normal(size=(40, 36)), 0.2, 2
    else:
        n, m = (64, 48) if case == "random64x48" else (33, 50)
        img, thr = rng.normal(size=(n, m)), 0.3
    want = np.asarray(jops_peaks.local_max_mask(jnp.asarray(img), thr,
                                                min_distance=md))
    got = tops_peaks.local_max_mask(torch.from_numpy(img), thr,
                                    min_distance=md).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any()


# -- Fourier helpers --------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 48), (33, 50)])
@pytest.mark.parametrize("inverse_dft", [True, False])
def test_moisan_per_matches(shape, inverse_dft):
    img = np.random.default_rng(4).normal(size=shape)
    want = jfourier.moisan_per(jnp.asarray(img), inverse_dft=inverse_dft)
    got = tfourier.moisan_per(torch.from_numpy(img), inverse_dft=inverse_dft)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-12 * np.abs(w).max())
    # p + s is the image
    if inverse_dft:
        np.testing.assert_allclose((got[0] + got[1]).numpy(), img,
                                   atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gaussian_filter_fft_matches(dtype):
    img = np.random.default_rng(5).normal(size=(40, 52)).astype(dtype)
    want = np.asarray(jfourier.gaussian_filter_fft(jnp.asarray(img), 2.3))
    got = tfourier.gaussian_filter_fft(torch.from_numpy(img), 2.3)
    assert got.dtype == torch.from_numpy(img).dtype
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("n", [7, 8, 63, 64])
def test_dct2_1d_pair_matches(n):
    x = np.random.default_rng(n).normal(size=(3, n))
    for name in ("dct2_1d", "idct2_1d"):
        want = np.asarray(getattr(jfourier, name)(jnp.asarray(x)))
        got = getattr(tfourier, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    back = tfourier.idct2_1d(tfourier.dct2_1d(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(back, x, atol=1e-12)


@pytest.mark.parametrize("n,d", [(8, 1.0), (9, 0.5), (128, 2.0)])
def test_fftbounds_matches(n, d):
    np.testing.assert_array_equal(tfourier.fftbounds(n, d),
                                  jfourier.fftbounds(n, d))


# -- the device part and the host recursion ---------------------------------

def _hex(r_k, theta, psi, kappa, size=128, order=1):
    return np.asarray(hexlattice_gen(r_k, theta, order=order, size=size,
                                     kappa=kappa, psi=psi, dtype=np.float64))


def test_peak_candidates_record_matches():
    """One attempt's record (value, row, column, 3x3 neighbourhood, valid)
    equals the reference's top-K outputs, in the same order."""
    img = _hex(0.1, 10.0, 0.0, 1.05)
    tv, ii, jj, neigh, valid = jpeaks._peak_candidates(
        jnp.asarray(img), jnp.asarray(1.0), jnp.asarray(0.3),
        jnp.asarray(2.0), jnp.asarray(200.0), False)
    rec = tpeaks._peak_candidates(torch.from_numpy(img), 1.0, 0.3, 2, 200,
                                  False).numpy()
    assert rec.shape == (tpeaks._MAX_PEAKS, tpeaks.RECORD)
    v = np.asarray(valid) > 0.5
    assert v.sum() >= 6
    np.testing.assert_array_equal(rec[:, 12] > 0.5, v)
    np.testing.assert_allclose(rec[v, 0], np.asarray(tv)[v], rtol=1e-12)
    np.testing.assert_array_equal(rec[v, 1], np.asarray(ii)[v])
    np.testing.assert_array_equal(rec[v, 2], np.asarray(jj)[v])
    np.testing.assert_allclose(rec[v, 3:12].reshape(-1, 3, 3),
                               np.asarray(neigh)[v], rtol=1e-12)


LATTICES = [(0.1, 10.0, 0.0, 1.05), (0.05, 37.0, 20.0, 1.3),
            (0.2, 5.0, -40.0, 1.7), (0.03, 50.0, 80.0, 1.01)]


@pytest.mark.parametrize("lattice", LATTICES, ids=lambda p: f"rk{p[0]}")
@pytest.mark.parametrize("dog,subpixel", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_extract_primary_ks_matches(lattice, dog, subpixel):
    """The reference's fixture of tests/test_peaks.py (order 1, 128^2,
    float64): the same canonical primary and candidate sets (atol
    1e-12), and the reference's gates: each true k within 1.5/size of a
    detected one, 0.5/size with the sub-bin refinement (DoG off)."""
    r_k, theta, psi, kappa = lattice
    size = 128
    img = _hex(r_k, theta, psi, kappa, size)
    want = jgpa.extract_primary_ks(img, DoG=dog, subpixel=subpixel)
    got = tpeaks.extract_primary_ks(img, DoG=dog, subpixel=subpixel,
                                    device="cpu")
    assert all(isinstance(g, np.ndarray) for g in got)
    same_set(got[0], want[0], 1e-12)
    same_set(got[1], want[1], 1e-12)
    ori = np.asarray(generate_ks(r_k, theta, kappa=kappa, psi=psi))[:-1]
    both = np.concatenate([got[0], -got[0]])
    d = np.linalg.norm(both[None] - ori[:3, None], axis=-1).min(axis=1)
    gate = 0.5 / size if subpixel and not dog else 1.5 / size
    assert np.all(d < gate), d * size


def _count_attempts(monkeypatch, mod):
    orig = mod._peak_candidates
    seen = []

    def spy(*a, **k):
        seen.append(a[2])
        return orig(*a, **k)

    monkeypatch.setattr(mod, "_peak_candidates", spy)
    return seen


@pytest.mark.parametrize("case", ["threshold0.95", "two_ks"])
def test_extract_primary_ks_recursion(monkeypatch, case, capsys):
    """Through the recursion: an anisotropic lattice at threshold 0.95
    (too few peaks pass, the threshold falls) and a lattice of two
    k-vectors (len(all_ks) < 3 at every threshold). The port makes the
    reference's attempts at the reference's thresholds, prints what it
    prints, and returns the same sets."""
    if case == "two_ks":
        ks = np.array([[0.1, 0.02], [-0.03, 0.12]])
        img = np.asarray(anylattice_gen(ks, size=128, dtype=np.float64))
        kw = dict(DoG=False)
    else:
        img = _hex(0.08, 20.0, 30.0, 1.7)
        kw = dict(DoG=False, threshold=0.95)
    seen_j = _count_attempts(monkeypatch, jpeaks)
    seen_t = _count_attempts(monkeypatch, tpeaks)
    want = jgpa.extract_primary_ks(img, **kw)
    out_j = capsys.readouterr().out
    got = tpeaks.extract_primary_ks(img, device="cpu", **kw)
    assert capsys.readouterr().out == out_j
    assert len(seen_t) == len(seen_j) > 1
    np.testing.assert_allclose([float(t) for t in seen_t],
                               [float(t) for t in seen_j], rtol=1e-7)
    same_set(got[0], want[0], 1e-12)
    same_set(got[1], want[1], 1e-12)


def test_extract_primary_ks_plot_names_its_item():
    """plot=True, once refused until viz was ported (ROADMAP queue 1 item
    7), now draws the two panels (viz.fftplot of the smoothed spectrum,
    the image) and returns what plot=False does, even where no k is
    found."""
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    img = np.zeros((16, 16))
    got = tpeaks.extract_primary_ks(img, plot=True, device="cpu")
    assert len(plt.gcf().axes) == 2
    plt.close("all")
    want = tpeaks.extract_primary_ks(img, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_subpixel_and_refine_ks(testset_gaussian):
    """tests/test_peaks.py's sub-bin and refine_ks check on the reference's
    500^2 fixture: the sub-bin ks within 0.5/size, the refined ks within
    0.15/size of the truth, and both equal to the reference's (atol
    1e-12)."""
    from pygpa_tpu_torch.gpa import reconstruct as trec
    original, _, _, ori_ks = testset_gaussian
    size = original.shape[0]
    pks, _ = tpeaks.extract_primary_ks(original, DoG=False, subpixel=True,
                                       device="cpu")
    pks_j, _ = jgpa.extract_primary_ks(original, DoG=False, subpixel=True)
    same_set(pks, pks_j, 1e-12)
    d_sub = np.linalg.norm(np.concatenate([pks, -pks])[None]
                           - ori_ks[:3][:, None], axis=-1).min(axis=1)
    assert np.all(d_sub < 0.5 / size)
    tri = tpeaks.select_closest_to_triangle(pks)
    signs = np.sign(np.einsum("kc,kc->k", tri, ori_ks[:3]))
    pks3 = tri * signs[:, None]
    refined = trec.refine_ks(original, pks3, device="cpu")
    assert isinstance(refined, np.ndarray)
    d_ref = np.linalg.norm(refined - ori_ks[:3], axis=-1)
    assert np.all(d_ref < 0.15 / size), d_ref * size
    want = jgpa.refine_ks(jnp.asarray(original), pks3)
    np.testing.assert_allclose(refined, want, rtol=0, atol=1e-12)


def test_small_host_helpers_match():
    rng = np.random.default_rng(6)
    ks = np.asarray(generate_ks(0.1, 10.0))[:3]
    noise = np.array([[0.3, 0.31], [0.02, 0.33]])
    cand = np.concatenate([ks, noise, rng.normal(size=(3, 2)) * 0.2])
    np.testing.assert_array_equal(tpeaks.select_closest_to_triangle(cand),
                                  jgpa.select_closest_to_triangle(cand))
    np.testing.assert_array_equal(tpeaks.smallest_sum(ks),
                                  jgpa.smallest_sum(ks))
    assert np.linalg.norm(tpeaks.smallest_sum(ks)) < 1e-12
    assert np.isnan(tpeaks.smallest_sum(ks[:2]))
    dup = np.concatenate([ks, -ks * (1 + 1e-7), [[0.0, -0.2]], noise])
    np.testing.assert_array_equal(tpeaks.remove_negative_duplicates(dup),
                                  jgpa.remove_negative_duplicates(dup))
    assert len(tpeaks.remove_negative_duplicates(dup)) == 6
