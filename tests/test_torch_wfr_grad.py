"""The port's winner phase-gradient sweeps on the CPU against
pygpa_tpu: the zoom sweep's gradient emission and the grouped sweep's
phase/weight and gradient emissions (plain twins here) against the
reference's Pallas kernels in interpret mode, wfr_sweep(with_grad=True)
and wfr_sweep_phase_weight_multi(with_grad=True) on each of their routes,
the analytic gradient against a central difference of the wrapped phase,
and the gpa.api wrappers. The reference's sweep contractions run at
HIGHEST: the port computes in full float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.ops.pallas_sweep as ps
import pygpa_tpu.ops.wfr as W
from pygpa_tpu.gpa import api as japi
from pygpa_tpu.lattices import generate_ks, hexlattice_gen
import pygpa_tpu_torch.ops.wfr as TW
from pygpa_tpu_torch.gpa import api as tapi
from pygpa_tpu_torch.ops import _build
from pygpa_tpu_torch.ops import zoom_sweep as TZ

from test_torch_sweep import _grid_fixture

torch.set_num_threads(2)


@pytest.fixture
def kernels(monkeypatch):
    """The reference on its kernel routes off the TPU: both Pallas sweeps
    in interpret mode at HIGHEST, as tests/test_lockin_wfr.py runs them;
    the jit caches are cleared so the patches are traced."""
    jax.clear_caches()
    monkeypatch.setattr(W, "_use_pallas_sweep", lambda: True)
    monkeypatch.setattr(W, "_ZOOM_PRECISION", jax.lax.Precision.HIGHEST)
    for name in ("fused_zoom_sweep", "fused_zoom_sweep_grouped"):
        orig = getattr(ps, name)

        def interp(*a, _orig=orig, **kw):
            kw["interpret"] = True
            return _orig(*a, **kw)

        monkeypatch.setattr(ps, name, interp)
    yield
    jax.clear_caches()


def _mk(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_zoom_grad_twin_matches_interpret_kernel():
    """tests/test_lockin_wfr.py's gradient fixture (P = 5, W0 = W1 = 64,
    256 x 384, reference chunks of 3 so the gradient carry crosses a
    chunk boundary): winners agree on > 99.9% of the pixels, and there
    the twin's gradients lie within 3e-3 of the mean |gradient| of the
    kernel's (that test's bound against a float64 oracle); measured
    3e-5."""
    rng = np.random.default_rng(7)
    P, W0, W1, n, m = 5, 64, 64, 256, 384
    Sr, Si, S2r, S2i = (_mk(rng, W0, W1) for _ in range(4))
    gx = rng.uniform(0.2, 1, size=(P, W0)).astype(np.float32)
    gy = rng.uniform(0.2, 1, size=(P, W1)).astype(np.float32)
    A0c, A0s = _mk(rng, n, W0), _mk(rng, n, W0)
    A1c, A1s, A1yc, A1ys = (_mk(rng, m, W1) for _ in range(4))
    ops = (Sr, Si, gx, gy, A0c, A0s, A1c, A1s)
    gops = (S2r, S2i, A1yc, A1ys)
    ref = [np.asarray(a) for a in ps.fused_zoom_sweep(
        *map(jnp.asarray, ops), max_chunk=3, interpret=True,
        grad_ops=tuple(map(jnp.asarray, gops)))]
    got = [a.numpy() for a in TZ.zoom_sweep(
        *map(torch.from_numpy, ops),
        grad_ops=tuple(map(torch.from_numpy, gops)))]
    assert len(got) == 6
    same = got[3] == ref[3]
    assert same.mean() > 0.999
    for k in (4, 5):
        sc = np.abs(ref[k][same]).mean()
        np.testing.assert_allclose(got[k][same], ref[k][same], rtol=0,
                                   atol=3e-3 * sc)
    # with the phase/weight emission too: the gradients are the same
    both = TZ.zoom_sweep(*map(torch.from_numpy, ops), dr=8,
                         grad_ops=tuple(map(torch.from_numpy, gops)))
    assert len(both) == 8
    for a, b in zip(both[4:6], got[4:6]):
        np.testing.assert_array_equal(a.numpy(), b)


def _flip_tolerant(ph, ph_ref, grads, grads_ref):
    """tests/test_lockin_wfr.py's grouped-vs-single bounds: the phase
    within 1e-3 rad and the gradients within rtol 2e-3, atol 2e-5 rad/px
    on > 1 - 2e-4 of the pixels. The rest are near-tie winner flips
    between two summation orders; a flip to a neighbouring candidate
    can keep the phase within 1e-3 rad (one Bragg peak sets it) while
    its gradient moves by up to ~1e-3, so where the phases agree every
    gradient stays within 1e-2 rad/px (a sign, axis or band-ramp slip
    is 1e-2 and more)."""
    dphi = np.abs((ph - ph_ref + np.pi) % (2 * np.pi) - np.pi)
    bad = dphi >= 1e-3
    for g, r in zip(grads, grads_ref):
        d = np.abs(g - r)
        bad |= d > 2e-5 + 2e-3 * np.abs(r)
        assert d[dphi < 1e-3].max() < 1e-2
    assert bad.mean() < 2e-4, bad.mean()


@pytest.mark.parametrize("with_grad", [False, True])
@pytest.mark.parametrize("size,banded", [(128, False), (256, True)])
def test_grouped_emissions_match_interpret_kernel(kernels, size, banded,
                                                  with_grad):
    """The grouped route of wfr_sweep_phase_weight_multi, emission (a)
    (phases and weights) and (b) (with the rebased winner gradients),
    on 4x4 candidate grids, unbanded at 128^2 and banded at 256^2 (A1y
    cut to the base band, gy less each run's ramp slope):
    against the reference's grouped kernel in interpret mode. Weights
    within rtol 1e-5 (the kernel-vs-XLA bound); phases and gradients
    with the flip-tolerant bounds above."""
    img, ks, wlists, sigma, dr, gc = _grid_fixture(size)
    plan = TW.plan_sweep(img.shape, wlists, sigma, dr, gauss_cut=gc)
    assert plan is not None and (plan.col_groups is not None) == banded
    kw = dict(with_grad=True, krefs=ks) if with_grad else {}
    want = [np.asarray(a) for a in W.wfr_sweep_phase_weight_multi(
        jnp.asarray(img), wlists, sigma, dr, gauss_cut=gc, **kw)]
    _build.launches.clear()
    got = [a.numpy() for a in TW.wfr_sweep_phase_weight_multi(
        torch.from_numpy(img), wlists, sigma, dr, gauss_cut=gc, **kw)]
    assert sum(_build.launches.values()) == 0
    assert len(got) == len(want) == (3 if with_grad else 2)
    G, n, m = got[0].shape
    assert got[0].dtype == np.float32 and (G, n, m) == (3, size, size)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5,
                               atol=1e-7 * want[1].max())
    if with_grad:
        assert got[2].shape == (3, size, size, 2)
        assert np.isfinite(got[2]).all()
        _flip_tolerant(got[0], want[0], (got[2][..., 0], got[2][..., 1]),
                       (want[2][..., 0], want[2][..., 1]))
    else:
        _flip_tolerant(got[0], want[0], (), ())


def _float32_banks():
    """Config 2g's construction at 128^2 with float32 k-vectors: banks of
    unequal lengths, so the grouped gate fails and each peak runs its
    own zoom sweep with the gradient emission."""
    r_k, theta = 0.1, 7.0
    img = np.asarray(hexlattice_gen(r_k, theta, order=1, size=128,
                                    kappa=1.005, psi=10.0,
                                    dtype=jnp.float32))
    img = img - img.mean()
    ks = np.asarray(generate_ks(r_k, theta, kappa=1.005, psi=10.0),
                    np.float32)[:3]
    knorms = np.linalg.norm(ks, axis=1)
    kw = knorms.mean() / 2.5
    wlists = []
    for pk, div in zip(ks, (3, 3.5, 2.5)):
        step = kw / div
        wx, wy = np.meshgrid(np.arange(pk[0] - kw, pk[0] + kw, step),
                             np.arange(pk[1] - kw, pk[1] + kw, step),
                             indexing="ij")
        wlists.append(np.stack([wx.ravel(), wy.ravel()], -1))
    sigma = int(np.ceil(1 / knorms.min()))
    return img, ks, wlists, sigma


def test_multi_grad_per_peak_routes_match_reference(kernels):
    """wfr_sweep_phase_weight_multi(with_grad=True) off the grouped gate:
    banks of 36, 56 and 25 candidates (float32, the zoom kernel's
    analytic gradients; P = 56 runs past the reference's 48-candidate
    chunk) against the reference on its kernel route, with
    the flip-tolerant bounds; and in float64 (the plain route, np.gradient
    of each candidate's phase) against the reference's XLA route within
    1e-9 rad/px. Each peak's result equals wfr_sweep(with_grad=True,
    rebase=False) on the same spectrum."""
    img, ks, wlists, sigma = _float32_banks()
    assert [len(w) for w in wlists] == [36, 56, 25]
    dr = 2 * sigma
    assert TW.plan_sweep(img.shape, wlists, sigma, dr) is None
    want = [np.asarray(a) for a in W.wfr_sweep_phase_weight_multi(
        jnp.asarray(img), wlists, sigma, dr, with_grad=True, krefs=ks)]
    got = TW.wfr_sweep_phase_weight_multi(torch.from_numpy(img), wlists,
                                          sigma, dr, with_grad=True,
                                          krefs=ks)
    g = [a.numpy() for a in got]
    np.testing.assert_allclose(g[1], want[1], rtol=1e-4,
                               atol=1e-6 * want[1].max())
    _flip_tolerant(g[0], want[0], (g[2][..., 0], g[2][..., 1]),
                   (want[2][..., 0], want[2][..., 1]))
    spec = torch.fft.fft2(torch.from_numpy(img))
    one = TW.wfr_sweep(None, wlists[1], ks[1], sigma, with_grad=True,
                       with_w=False, spectrum=spec, rebase=False)
    np.testing.assert_array_equal(one["grad"].numpy(), g[2][1])
    # float64: the plain route on both sides
    img64 = img.astype(np.float64)
    ks64 = ks.astype(np.float64)
    want = [np.asarray(a) for a in W.wfr_sweep_phase_weight_multi(
        jnp.asarray(img64), wlists, sigma, dr, with_grad=True, krefs=ks64)]
    got = [a.numpy() for a in TW.wfr_sweep_phase_weight_multi(
        torch.from_numpy(img64), wlists, sigma, dr, with_grad=True,
        krefs=ks64)]
    assert got[2].dtype == np.float64
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9,
                               atol=1e-12 * want[1].max())
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-9)


def _single_peak(size, dtype):
    r_k, theta = 0.1, 7.0
    img = np.asarray(hexlattice_gen(r_k, theta, order=1, size=size,
                                    dtype=dtype))
    img = img - img.mean()
    ks = np.asarray(generate_ks(r_k, theta))[:3]
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    k = ks[0]
    wl = np.stack([a.ravel() for a in np.meshgrid(
        np.arange(k[0] - kw, k[0] + kw, kw / 3),
        np.arange(k[1] - kw, k[1] + kw, kw / 3), indexing="ij")], -1)
    return img, k, wl, sigma


@pytest.mark.parametrize("dtype,zoom,size", [(np.float64, "auto", 256),
                                             (np.float64, False, 128),
                                             (np.float32, "auto", 120)])
def test_wfr_sweep_grad_plain_routes_match_reference(dtype, zoom, size):
    """wfr_sweep(with_grad=True) on the reference's XLA routes, where
    both packages take np.gradient of each candidate's -angle(M) and keep
    the winner's: the plain zoom route (float64, and float32 at a side
    off the kernel's multiple of 128) and the full-FFT route (zoom=False).
    The rebased gradients within 1e-9 rad/px in float64 and 1e-4 in
    float32 where the winners agree (> 99.9% of the pixels)."""
    img, k, wl, sigma = _single_peak(size, dtype)
    want = W.wfr_sweep(jnp.asarray(img), wl, k, sigma, zoom=zoom,
                       with_grad=True)
    got = TW.wfr_sweep(torch.from_numpy(img), wl, k, sigma, zoom=zoom,
                       with_grad=True)
    gw, gg = np.asarray(want["grad"]), got["grad"].numpy()
    assert gg.shape == img.shape + (2,) and gg.dtype == img.dtype
    same = (got["w"].numpy() == np.asarray(want["w"])).all(0)
    assert same.mean() > 0.999
    tol = 1e-9 if dtype == np.float64 else 1e-4
    assert np.abs(gg - gw)[same].max() < tol
    # the rebase: wrap_to_pi(2 (g - 2 pi k)) / 2 lies in [-pi/2, pi/2)
    assert gg.min() >= -np.pi / 2 and gg.max() < np.pi / 2


def test_wfr_sweep_grad_kernel_route_matches_reference(kernels):
    """The zoom kernel route (float32, sides multiples of 128): the twin's
    analytic gradients against the reference's interpret kernel, with the
    flip-tolerant bounds."""
    img, k, wl, sigma = _single_peak(128, np.float32)
    want = W.wfr_sweep(jnp.asarray(img), wl, k, sigma, with_grad=True)
    got = TW.wfr_sweep(torch.from_numpy(img), wl, k, sigma, with_grad=True)
    same = (got["w"].numpy() == np.asarray(want["w"])).all(0)
    assert same.mean() > 1 - 2e-4
    np.testing.assert_allclose(got["grad"].numpy()[same],
                               np.asarray(want["grad"])[same], rtol=2e-3,
                               atol=2e-5)


def test_analytic_gradient_matches_central_difference():
    """tests/test_parity_deviations.py's check for the port: the zoom
    route's analytic gradients (float32, the kernel's twin) against the
    float64 plain route's np.gradient of the wrapped winner phase, on the
    5 sigma interior where the winners agree: max < 1e-4 rad/px, p99 <
    2e-5. A break of sign, 2 pi, axis or the rebase trips it."""
    r_k, theta, size = 0.15, 13.0, 256
    img = np.asarray(hexlattice_gen(r_k, theta, order=1, size=size,
                                    dtype=np.float64))
    img = img - img.mean()
    ks = np.asarray(generate_ks(r_k, theta))[:3]
    k = ks[0]
    knorms = np.linalg.norm(ks, axis=1)
    kw = knorms.mean() / 2.5
    sigma = int(np.ceil(1 / knorms.min()))
    wx, wy = np.meshgrid(np.arange(k[0] - kw, k[0] + kw, kw / 3),
                         np.arange(k[1] - kw, k[1] + kw, kw / 3),
                         indexing="ij")
    wl = np.stack([wx.ravel(), wy.ravel()], -1)
    fd = TW.wfr_sweep(torch.from_numpy(img), wl, k, sigma, with_grad=True)
    an = TW.wfr_sweep(torch.from_numpy(img.astype(np.float32)), wl, k,
                      sigma, with_grad=True)
    b = 5 * sigma
    sl = np.s_[b:-b, b:-b]
    same = np.abs(an["w"].numpy() - fd["w"].numpy()).max(0) < kw / 6
    mask = same[sl]
    delta = np.abs(an["grad"].numpy()[sl].astype(np.float64)
                   - fd["grad"].numpy()[sl])[mask]
    assert mask.mean() > 0.98
    assert delta.max() < 1e-4, delta.max()
    assert np.percentile(delta, 99) < 2e-5


def test_api_wrappers_match_reference():
    """gpa.api's WFR names against the reference's on a float64 128^2
    lattice (the plain routes on both sides): lock-ins within 1e-9 of
    their peak, winning candidates equal, wfr2_grad_opt's gradients
    within 1e-9 rad/px; generate_klists identical; the spatial lock-in
    names within 1e-9 of their peak; wfr4 (dk 0.01) with the reference's
    winners and its lock-in within 1e-9 of the peak."""
    img, k, wl, sigma = _single_peak(128, np.float64)
    kw = np.linalg.norm(k) / 2.5
    args = (sigma, k[0], k[1], kw, kw / 3)
    for name in ("wfr2", "optwfr2", "wfr2_grad_opt", "wfr2_grad",
                 "wfr2_grad_vec"):
        want = getattr(japi, name)(jnp.asarray(img), *args)
        got = getattr(tapi, name)(img, *args, device="cpu")
        lw = np.asarray(want["lockin"])
        assert np.abs(got["lockin"].numpy() - lw).max() <= 1e-9 * np.abs(
            lw).max()
        np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
        if "grad" in name:
            np.testing.assert_allclose(got["grad"].numpy(),
                                       np.asarray(want["grad"]), atol=1e-9)
    w1 = japi.wfr(jnp.asarray(img), *args)
    w2 = tapi.wfr(img, *args, device="cpu")
    np.testing.assert_array_equal(w2["wx"].numpy(), np.asarray(w1["wx"]))
    np.testing.assert_allclose(w2["r"].numpy(), np.asarray(w1["r"]),
                               rtol=1e-9, atol=1e-12)
    for name in ("wfr2_only_lockin", "wfr2_only_lockin_vec"):
        lw = np.asarray(getattr(japi, name)(jnp.asarray(img), *args))
        lg = getattr(tapi, name)(img, *args, device="cpu").numpy()
        assert np.abs(lg - lw).max() <= 1e-9 * np.abs(lw).max()
    ks = np.asarray(generate_ks(0.1, 7.0))[:3]
    kl_j = japi.generate_klists(ks, sort_list=True)
    kl_t = tapi.generate_klists(ks, sort_list=True)
    for a, b in zip(kl_t, kl_j):
        np.testing.assert_array_equal(a, np.asarray(b))
    klist = kl_t[0][:30]
    want = japi.wfr3(jnp.asarray(img), sigma, klist, ks[0])
    got = tapi.wfr3(img, sigma, klist, ks[0], device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    for name, a in (("GPA", (img, 0.1, 0.0)), ("optGPA", (img, ks[0])),
                    ("vecGPA", (img, ks))):
        lw = np.asarray(getattr(japi, name)(*a, sigma))
        lg = getattr(tapi, name)(*a, sigma, device="cpu").numpy()
        assert lg.shape == lw.shape
        assert np.abs(lg - lw).max() <= 1e-9 * np.abs(lw).max()
    want = japi.wfr4(jnp.asarray(img), sigma, klist, ks[0], 0.01)
    got = tapi.wfr4(img, sigma, klist, ks[0], 0.01, device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    lw = np.asarray(want["lockin"])
    assert np.abs(got["lockin"].numpy() - lw).max() <= 1e-9 * np.abs(
        lw).max()
