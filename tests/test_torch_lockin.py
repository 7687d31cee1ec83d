"""The port's spatial lock-in (ops.lockin, gpa.api GPA / optGPA /
vecGPA), its robust plane fit (core.mathtools fit_plane,
fit_plane_masked, lfit_func, lfit_func_mask) and the reconstruction and
k refinement around them (gpa.reconstruct reconstruct_u_inv,
myweighed_lstsq, fit_delta_k, iterate_GPA) against pygpa_tpu on the CPU.
Inputs are numpy arrays from a seed or the reference's 500^2 fixture.
Tolerances: float64 within 1e-10 of the output's largest magnitude,
float32 within 1e-5 of it, unless a test says otherwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.gpa as jgpa
from pygpa_tpu.core import mathtools as jmath
from pygpa_tpu.gpa import api as japi
from pygpa_tpu.ops import lockin as jlock
from pygpa_tpu_torch.core import mathtools as tmath
from pygpa_tpu_torch.gpa import api as tapi
from pygpa_tpu_torch.gpa import reconstruct as trec
from pygpa_tpu_torch.ops import lockin as tlock

torch.set_num_threads(2)
TDT = {np.float64: torch.float64, np.float32: torch.float32}


def close(got, want, dtype=np.float64):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1e-10 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _image(dtype, shape=(96, 80)):
    rng = np.random.default_rng(7)
    x, y = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                       indexing="ij")
    img = np.cos(2 * np.pi * (0.11 * x - 0.07 * y)) \
        + 0.3 * rng.normal(size=shape)
    return img.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kvec", [(0.11, -0.07), np.array([0.11, -0.07]),
                                  np.array([0.11, -0.07], np.float32)],
                         ids=["python", "f64", "f32"])
def test_plane_wave_matches(dtype, kvec):
    """The phase runs in the dtype JAX promotes to (float64 for a float64
    or Python k), then is cast to the image's dtype."""
    want = jlock.plane_wave((512, 512), jnp.asarray(kvec), dtype)
    got = tlock.plane_wave((512, 512), kvec, TDT[dtype])
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gpa_lockin_and_batch_match(dtype):
    img = _image(dtype)
    k = np.array([0.11, -0.07])
    close(tlock.gpa_lockin(img, k, 6.0, device="cpu"),
          jlock.gpa_lockin(jnp.asarray(img), k, 6.0), dtype)
    ks = np.array([k, [0.05, 0.13], [-0.2, 0.01]])
    got = tlock.gpa_lockin_batch(img, ks, 6.0, device="cpu")
    close(got, jlock.gpa_lockin_batch(jnp.asarray(img), ks, 6.0), dtype)
    # each slice is gpa_lockin's result, bit for bit
    for g, kk in zip(got, ks):
        assert torch.equal(g, tlock.gpa_lockin(img, kk, 6.0, device="cpu"))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rebase", [False, True])
def test_lockin_from_spectrum_matches(dtype, rebase):
    img = _image(dtype)
    k = np.array([0.11, -0.07])
    spec = np.fft.fft2(img).astype(np.complex128 if dtype == np.float64
                                   else np.complex64)
    rb = np.array([0.1, -0.05]) if rebase else None
    want = jlock.lockin_from_spectrum(jnp.asarray(spec), k, 6.0, rebase=rb)
    got = tlock.lockin_from_spectrum(torch.from_numpy(spec), k, 6.0,
                                     rebase=rb)
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gpa_api_lockin_names_match(dtype):
    img = _image(dtype)
    ks = np.array([[0.11, -0.07], [0.05, 0.13]])
    close(tapi.GPA(img, 0.11, -0.07, 6, device="cpu"),
          japi.GPA(jnp.asarray(img), 0.11, -0.07, 6), dtype)
    close(tapi.optGPA(img, ks[1], 6, device="cpu"),
          japi.optGPA(jnp.asarray(img), ks[1], 6), dtype)
    v = tapi.vecGPA(img, ks, 6, device="cpu")
    close(v, japi.vecGPA(jnp.asarray(img), ks, 6), dtype)
    assert torch.equal(v[1], tapi.optGPA(img, ks[1], 6, device="cpu"))
    assert torch.equal(tapi.GPA(img, 0.11, -0.07, 6, device="cpu"),
                       tapi.optGPA(img, (0.11, -0.07), 6, device="cpu"))


def _planes(dtype, n=3):
    rng = np.random.default_rng(8)
    xx, yy = np.meshgrid(np.arange(48), np.arange(40), indexing="ij")
    out = []
    for i in range(n):
        p = (0.3 + i) * xx - 0.7 * yy + 2 * i + rng.normal(size=xx.shape)
        p[3:6, 3:9] += 25      # outliers the Huber loss discounts
        out.append(p)
    return np.stack(out).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("masked", [False, True])
def test_fit_plane_matches(dtype, masked):
    """fit_plane[_masked] within rtol 1e-8 of the reference's in float64.
    In float32 the uncentred normal equations lose digits to rounding
    (the reference's own float32 fit of these planes lies up to 7e-5 of
    the largest coefficient from its float64 fit), so the float32 fit is
    held to the reference's float64 fit of the same data, within 1e-5 of
    its largest coefficient. A batch of planes is fitted in one call."""
    planes = _planes(dtype)
    mask = np.random.default_rng(9).uniform(size=planes.shape[1:]) > 0.3
    got = (tmath.fit_plane_masked(torch.from_numpy(planes), mask=mask)
           if masked else tmath.fit_plane(torch.from_numpy(planes)))
    assert got.shape == (3, 3) and got.dtype == TDT[dtype]
    for g, p in zip(got.numpy(), planes):
        p = jnp.asarray(p.astype(np.float64))
        want = np.asarray(jmath.fit_plane_masked(p, mask=mask)
                          if masked else jmath.fit_plane(p))
        if dtype == np.float64:
            np.testing.assert_allclose(g, want, rtol=1e-8)
        else:
            np.testing.assert_allclose(g, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())


def test_lfit_funcs_match():
    p = _planes(np.float64, 1)[0]
    xx, yy = np.meshgrid(np.arange(48), np.arange(40), indexing="ij")
    x = (0.3, -0.7, 1.5)
    mask = p > p.mean()
    np.testing.assert_allclose(tmath.lfit_func(x, p, xx, yy).numpy(),
                               np.asarray(jmath.lfit_func(x, p, xx, yy)),
                               atol=1e-12)
    np.testing.assert_allclose(
        tmath.lfit_func_mask(x, p, xx, yy, mask).numpy(),
        np.asarray(jmath.lfit_func_mask(x, p, xx, yy, mask)), atol=1e-12)


def test_fit_delta_k_matches():
    planes = _planes(np.float64)
    got = trec.fit_delta_k(torch.from_numpy(planes)).numpy()
    want = np.stack([np.asarray(jgpa.fit_delta_k(jnp.asarray(p)))
                     for p in planes])
    np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.mark.parametrize("use_only_ks", [None, (0, 2)])
@pytest.mark.parametrize("weighted", [False, True])
def test_reconstruct_u_inv_matches(use_only_ks, weighted):
    rng = np.random.default_rng(10)
    ks = np.array([[0.1, 0.02], [-0.03, 0.12], [0.07, -0.1]])
    b = rng.normal(size=(3, 40, 36))
    w = rng.uniform(0.1, 1.0, size=b.shape) if weighted else None
    want = np.asarray(jgpa.reconstruct_u_inv(
        ks, jnp.asarray(b), None if w is None else jnp.asarray(w),
        use_only_ks=use_only_ks))
    got = trec.reconstruct_u_inv(ks, torch.from_numpy(b),
                                 None if w is None else torch.from_numpy(w),
                                 use_only_ks=use_only_ks)
    close(got, want)


def test_myweighed_lstsq_matches():
    rng = np.random.default_rng(11)
    K = 2 * np.pi * np.array([[0.1, 0.02], [-0.03, 0.12], [0.07, -0.1]])
    b = rng.normal(size=(3, 20, 24))
    w = rng.uniform(0.1, 1.0, size=b.shape)
    want = np.asarray(jgpa.myweighed_lstsq(jnp.asarray(b), K, jnp.asarray(w)))
    close(trec.myweighed_lstsq(torch.from_numpy(b), K, torch.from_numpy(w)),
          want)


def test_iterate_gpa_matches(testset_gaussian):
    """tests/test_pipeline.py's iterate_GPA setting (the reference's 500^2
    fixture, ks offset by (0.002, -0.001)): the corrections within 1e-6
    of the reference's, the weights and unwrapped phases within 1e-10 of
    their largest value, and the reference's gate (the correction
    cancels at least 65% of the offset)."""
    original, _, _, ori_ks = testset_gaussian
    ks = ori_ks[:3]
    offset = np.array([0.002, -0.001])
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    prs, w, corr = trec.iterate_GPA(original, ks + offset, sigma,
                                    device="cpu")
    prs_j, w_j, corr_j = jgpa.iterate_GPA(jnp.asarray(original),
                                          ks + offset, sigma)
    assert isinstance(corr, torch.Tensor) and corr.shape == (3, 2)
    np.testing.assert_allclose(corr.numpy(), np.asarray(corr_j), rtol=0,
                               atol=1e-6)
    close(w, w_j)
    close(prs, prs_j)
    assert np.all(np.linalg.norm(corr.numpy() + offset, axis=1)
                  < 0.35 * np.linalg.norm(offset))
