"""The exact reconstruction path of pygpa_tpu_torch on the CPU against
pygpa_tpu: the early-stopping CG unwrap (phase_unwrap,
phase_unwrap_prediff), the eager extract_displacement_field, the
factory at unwrap_coarse=None, the per-peak factory route, the 500^2
testset at the reference's tolerances, and the multigrid's CG routing
(the reference's _cg_kernel_ok gate)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.solvers.unwrap as JU
from pygpa_tpu.gpa import pipeline as jpipe
from pygpa_tpu.lattices import generate_ks, hexlattice_gen
import pygpa_tpu_torch.solvers.unwrap as TU
from pygpa_tpu_torch.gpa import pipeline as tpipe
from pygpa_tpu_torch.ops import _build

from test_torch_unwrap import _close, _problem

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-12)])
def test_phase_unwrap_prediff_matches_reference(dtype, rtol):
    """The two components as the port's batch and the reference's vmap:
    same solution and the same iteration count per component."""
    dx, dy, w = (a.astype(dtype) for a in _problem(256, 3))
    want, kw = jax.vmap(lambda a, b: JU.phase_unwrap_prediff(
        a, b, jnp.asarray(w), kmax=10, return_iters=True))(
            jnp.asarray(dx), jnp.asarray(dy))
    got, kg = TU.phase_unwrap_prediff(
        torch.from_numpy(dx), torch.from_numpy(dy), torch.from_numpy(w),
        kmax=10, return_iters=True)
    assert got.shape == (2, 256, 256) and got.dtype == torch.from_numpy(
        dx).dtype
    _close(got.numpy(), want, rtol)
    np.testing.assert_array_equal(kg.numpy(), np.asarray(kw))


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-4),
                                        (np.float64, 1e-7)])
def test_phase_unwrap_matches_reference(dtype, rtol):
    """Wrapped phase images with per-image weights, run to the
    early stop (kmax 100); the components stop after different
    iteration counts, which both packages report alike."""
    rng = np.random.default_rng(9)
    x = np.linspace(-1, 1, 256)
    X, Y = np.meshgrid(x, x, indexing="ij")
    psi = np.stack([8 * np.exp(-(X ** 2 + Y ** 2) / 0.2), 6 * X * Y + 3 * X])
    psi = np.angle(np.exp(1j * (psi + 0.05 * rng.normal(size=psi.shape))))
    w = rng.uniform(0.2, 1.0, size=psi.shape)
    psi, w = psi.astype(dtype), w.astype(dtype)
    want, kw = jax.vmap(lambda p, q: JU.phase_unwrap(
        p, q, kmax=100, return_iters=True))(jnp.asarray(psi), jnp.asarray(w))
    got, kg = TU.phase_unwrap(torch.from_numpy(psi), torch.from_numpy(w),
                              kmax=100, return_iters=True)
    np.testing.assert_array_equal(kg.numpy(), np.asarray(kw))
    assert kg.numpy().min() < 100
    _close(got.numpy(), want, rtol)


def test_unwrap_stops_at_once_on_a_zero_residual():
    z = torch.zeros((2, 64, 63), dtype=torch.float64)
    zy = torch.zeros((2, 63, 64), dtype=torch.float64)
    phi, k = TU.phase_unwrap_prediff(z, zy, torch.ones((64, 64),
                                                       dtype=torch.float64),
                                     return_iters=True)
    assert (k == 0).all() and (phi == 0).all()


def _lattice(size):
    r_k, theta = 0.1, 7.0
    img = np.array(hexlattice_gen(r_k, theta, order=1, size=size,
                                  dtype=jnp.float32))
    return img, np.array(generate_ks(r_k, theta))[:3]


def test_extract_displacement_field_matches_reference():
    """The eager path at 256^2 float32: the port's zoom sweep (twin) and
    exact CG against the reference's XLA route, interior within 1e-3
    px (tests/test_lockin_wfr.py's bound); return_gs hands back the
    per-peak sweeps."""
    img, ks = _lattice(256)
    want = np.asarray(jpipe.extract_displacement_field(jnp.asarray(img), ks))
    got, gs = tpipe.extract_displacement_field(torch.from_numpy(img), ks,
                                               return_gs=True, device="cpu")
    assert got.shape == (2, 256, 256) and got.dtype == torch.float32
    assert len(gs) == 3 and gs[0]["w"].shape == (2, 256, 256)
    got = got.numpy()
    assert np.isfinite(got).all()
    b = 8
    assert np.abs(got - want)[:, b:-b, b:-b].max() < 1e-3


def test_eager_banks_follow_the_kvector_dtype(monkeypatch):
    """The bench's k-vectors in float32 (as bench.py's generate_ks gives
    them) make candidate banks of 42, 49 and 36 in the reference's
    eager path (np.arange endpoints in float32); the port keeps the
    k-vectors' dtype and builds the same banks, while float64 k-vectors
    give 36 each."""
    ks32 = np.array([[0.019829239696264267, 0.0017598043195903301],
                     [0.008427001535892487, 0.018130626529455185],
                     [-0.011402237229049206, 0.01637081988155842]],
                    np.float32)
    for ks, want in ((ks32, [42, 49, 36]),
                     (ks32.astype(np.float64), [36, 36, 36])):
        seen = []
        monkeypatch.setattr(tpipe, "wfr_sweep", lambda img0, wl, *a, **k:
                            seen.append(len(wl)) or {"lockin": torch.ones(
                                img0.shape, dtype=torch.complex64)})
        tpipe.extract_displacement_field(torch.zeros((128, 128)), ks,
                                         device="cpu")
        assert seen == want


def test_wfr_func_seam():
    """A plug-in sweep replaces the built-in one: handing the port its
    own wfr_sweep through the seam gives the default result."""
    img, ks = _lattice(128)
    kw_seen = []

    def sweep(img0, sigma, kx, ky, kw, kstep):
        kw_seen.append((kw, kstep))
        wxs = np.arange(kx - kw, kx + kw, kstep)
        wys = np.arange(ky - kw, ky + kw, kstep)
        wx, wy = np.meshgrid(wxs, wys, indexing="ij")
        wl = np.stack([wx.ravel(), wy.ravel()], -1)
        return tpipe.wfr_sweep(img0, wl, np.array([kx, ky]), sigma)

    t = torch.from_numpy(img)
    got = tpipe.extract_displacement_field(t, ks, wfr_func=sweep,
                                           device="cpu")
    want = tpipe.extract_displacement_field(t, ks, device="cpu")
    assert len(kw_seen) == 3
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_factory_exact_cg_matches_reference():
    """make_displacement_extractor at its defaults (unwrap_coarse=None):
    the port's grouped uv sweep (twin), then the exact CG, against the
    reference factory's CPU route (per-peak sweeps, the same exact CG);
    within 1e-3 px on the interior."""
    img, ks = _lattice(256)
    want = np.asarray(jpipe.make_displacement_extractor(
        (256, 256), ks, chunk=4)(jnp.asarray(img)))
    fn = tpipe.make_displacement_extractor((256, 256), ks, chunk=4,
                                           device="cpu")
    assert fn.plan is not None
    got = fn(torch.from_numpy(img)).numpy()
    b = 8
    assert np.abs(got - want)[:, b:-b, b:-b].max() < 1e-3


def test_factory_per_peak_route_matches_reference():
    """A 192 x 256 image (not a multiple of 128 on one side): the grouped
    plan refuses, so both factories run the per-peak phase/weight sweeps
    (plain route), then the multigrid unwrap."""
    img, ks = _lattice(256)
    img = img[:192]
    want = np.asarray(jpipe.make_displacement_extractor(
        img.shape, ks, unwrap_coarse=4)(jnp.asarray(img)))
    fn = tpipe.make_displacement_extractor(img.shape, ks, unwrap_coarse=4,
                                           device="cpu")
    assert fn.plan is None
    got = fn(torch.from_numpy(img)).numpy()
    b = 8
    assert np.abs(got - want)[:, b:-b, b:-b].max() < 1e-3


def test_displacement_field_testset(testset_gaussian, gaussiandeform):
    """The reference's pipeline tolerances on the 500^2 testset
    (tests/test_pipeline.py): noisy < 0.9 px, deconvolved < 0.05 px."""
    original, deformed, noise, ori_ks = testset_gaussian
    u = -tpipe.extract_displacement_field(deformed + noise, ori_ks[:3],
                                          device="cpu").numpy()
    assert u.shape == gaussiandeform.shape and u.dtype == np.float64
    assert np.all(np.abs(u - gaussiandeform)[:, 20:-20, 20:-20] < 0.9)
    u2 = -tpipe.extract_displacement_field(deformed, ori_ks[:3],
                                           deconvolve=True,
                                           device="cpu").numpy()
    assert np.all(np.abs(u2 - gaussiandeform)[:, 20:-20, 20:-20] < 0.05)


def test_factory_matches_eager(testset_gaussian):
    """The float64 factory (demodulated per-peak route, exact CG) equals
    the eager (rebased) path to 1e-9, as in tests/test_pipeline.py."""
    original, deformed, noise, ori_ks = testset_gaussian
    ks = ori_ks[:3]
    fn = tpipe.make_displacement_extractor(deformed.shape, ks,
                                           dtype=torch.float64, device="cpu")
    u_fact = fn(deformed).numpy()
    u_eager = tpipe.extract_displacement_field(deformed, ks,
                                               device="cpu").numpy()
    assert np.allclose(u_fact, u_eager, atol=1e-9)


def test_cg_route_matches_reference_gate(monkeypatch):
    """The multigrid's CG solves go to the ops.cg kernel exactly where
    the reference's _cg_kernel_ok sends them to its Pallas kernel (its
    accelerator read as the card): float32, sides multiples of 128 and
    at most 1024."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    shapes = [(256, 256), (288, 288), (1024, 1024), (2048, 2048),
              (1024, 1152), (128, 384), (144, 144)]
    for shape in shapes:
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.float64, jnp.float64)):
            assert TU.cg_kernel_ok(shape, tdt) == JU._cg_kernel_ok(
                shape, jdt), (shape, tdt)
    assert TU.cg_kernel_ok((2, 1024, 1024), torch.float32)


def test_multigrid_early_stopping_levels_match_reference(monkeypatch):
    """576^2 with unwrap_coarse=4: the 144^2 coarse level, the 288^2 mid
    level and the 144^2 V-branch correction are not multiples of 128, so
    every solve takes the early-stopping loop (the CG kernel's wrapper
    is never called) and matches the reference within 1e-4."""
    dx, dy, w = _problem(576, 7)
    calls = []
    monkeypatch.setattr(TU._cg, "cg_poisson",
                        lambda *a: calls.append(a) or None)
    wj = jnp.asarray(w)
    want = jax.vmap(lambda a, b: JU.phase_unwrap_prediff_mg(
        a, b, wj, kmax=6, coarse=4,
        precision=jax.lax.Precision.HIGHEST))(jnp.asarray(dx),
                                              jnp.asarray(dy))
    got = TU.phase_unwrap_prediff_mg(torch.from_numpy(dx),
                                     torch.from_numpy(dy),
                                     torch.from_numpy(w), kmax=6, coarse=4)
    assert calls == []
    _close(got.numpy(), want, 1e-4)


def test_exact_path_runs_no_kernel_on_the_cpu():
    img, ks = _lattice(128)
    _build.launches.clear()
    tpipe.extract_displacement_field(torch.from_numpy(img), ks, device="cpu")
    assert sum(_build.launches.values()) == 0
