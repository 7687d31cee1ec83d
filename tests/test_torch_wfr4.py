"""The wfr4 k-continuity scans of the port (ops.wfr.wfr_sweep with
continuity_dk, on the zoom window and with one inverse FFT a candidate,
and gpa.wfr4) against pygpa_tpu.ops.wfr on the CPU, on the same numpy
lattices. Near-tie winner flips are legitimate in float32 (the two
packages round the products differently), so the checks are
tests/test_lockin_wfr.py's flip-tolerant ones: winners agree on >= 99%
of the 5 sigma interior, and there the lock-in (relative to its largest
value) and the gradients (rad/px) agree within 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.ops.wfr as W
from pygpa_tpu import gpa as jgpa
from pygpa_tpu.lattices import generate_ks, hexlattice_gen
import pygpa_tpu_torch.gpa as tgpa
import pygpa_tpu_torch.ops.wfr as TW

torch.set_num_threads(2)
SIZE = 192


def _bank(k, kw, step):
    """Row-major (wx outer) candidates over k +- kw in steps of `step`."""
    return np.stack([a.ravel() for a in np.meshgrid(
        np.arange(k[0] - kw, k[0] + kw, step),
        np.arange(k[1] - kw, k[1] + kw, step), indexing="ij")], -1)


def _lattice(dtype):
    """r_k 0.1, theta 7 deg, order 1, with a Gaussian bump of u (3 px),
    mean-subtracted; the first k-vector, sigma, and the config 2g-style
    bank step kw / 3 (kw = mean |k| / 2.5)."""
    S = SIZE // 2
    xp, yp = np.meshgrid(np.arange(-S, S), np.arange(-S, S), indexing="ij")
    u = np.stack([3.0 * np.exp(-((xp / 40.) ** 2 + (yp / 30.) ** 2)),
                  np.zeros((SIZE, SIZE))])
    img = np.asarray(hexlattice_gen(0.1, 7.0, order=1, size=SIZE, shift=u,
                                    dtype=dtype))
    ks = np.asarray(generate_ks(0.1, 7.0))[:3]
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    return img - img.mean(), ks[0], sigma, kw


@pytest.fixture(scope="module")
def lattice32():
    return _lattice(jnp.float32)


def _agree(got, want, sigma, with_grad, lockin_tol, grad_tol, frac=0.99):
    """Winners equal on >= frac of the 5 sigma interior; there the
    lock-in within lockin_tol of its largest value and the gradients
    within grad_tol rad/px. Returns the agreeing fraction."""
    b = 5 * sigma
    sl = np.s_[b:-b, b:-b]
    wj = np.asarray(want["w"])
    wt = got["w"].numpy()
    assert wt.shape == wj.shape == (2, SIZE, SIZE)
    same = (wt == wj).all(0)[sl]
    assert same.mean() >= frac, same.mean()
    lj = np.asarray(want["lockin"])[sl][same]
    lt = got["lockin"].numpy()[sl][same]
    assert np.abs(lt - lj).max() <= lockin_tol * np.abs(lj).max()
    if with_grad:
        g = got["grad"].numpy()
        assert g.min() >= -np.pi / 2 and g.max() < np.pi / 2
        d = np.abs(g - np.asarray(want["grad"]))[sl][same]
        assert d.max() <= grad_tol, d.max()
    else:
        assert "grad" not in got
    return same.mean()


@pytest.mark.parametrize("zoom,with_grad", [("auto", False), ("auto", True),
                                            (False, False), (False, True)])
def test_continuity_scan_matches_reference(lattice32, zoom, with_grad):
    """Both forms of the scan (the zoom window: two DFT products a
    candidate, analytic gradients; zoom=False: one inverse FFT a
    candidate, np.gradient gradients) on a float32 192^2 lattice with a
    36-candidate bank and dk of one bank step: the flip-tolerant bounds
    (>= 99% winners, lock-in 1e-4 of its peak, gradients 1e-4 rad/px),
    float32 outputs, 'w' the winning candidates."""
    img, k, sigma, kw = lattice32
    wl = _bank(k, kw, kw / 3)
    # a window pays off, so "auto" takes the zoom form
    assert TW._plan_zoom(img.shape, wl, float(sigma)) is not None
    want = W.wfr_sweep(jnp.asarray(img), wl, k, sigma,
                       continuity_dk=kw / 3, with_grad=with_grad, zoom=zoom)
    got = TW.wfr_sweep(torch.from_numpy(img), wl, k, sigma,
                       continuity_dk=kw / 3, with_grad=with_grad, zoom=zoom,
                       with_w=False)
    assert got["lockin"].dtype == torch.complex64
    assert got["w"].dtype == torch.float32
    _agree(got, want, sigma, with_grad, 1e-4, 1e-4)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_continuity_binds_as_the_reference(dtype):
    """A wide bank (k +- 1.5 kw, 81 candidates) with dk of one step: the
    continuity gate keeps the scan from the unconstrained (wfr3) winner
    on part of the interior in both packages, and the port agrees with
    the reference as above (float32), or within 1e-9 of the lock-in's
    peak and 1e-9 rad/px with every winner equal (float64)."""
    img, k, sigma, kw = _lattice(dtype)
    step = kw / 3
    wl = _bank(k, 1.5 * kw, step)
    assert len(wl) == 81
    want = W.wfr_sweep(jnp.asarray(img), wl, k, sigma, continuity_dk=step,
                       with_grad=True)
    got = TW.wfr_sweep(torch.from_numpy(img), wl, k, sigma,
                       continuity_dk=step, with_grad=True)
    free = TW.wfr_sweep(torch.from_numpy(img), wl, k, sigma)
    b = 5 * sigma
    binds = (free["w"] != got["w"]).any(0)[b:-b, b:-b].double().mean()
    assert 0.01 < float(binds) < 1.0
    if dtype == jnp.float64:
        _agree(got, want, sigma, True, 1e-9, 1e-9, frac=1.0)
    else:
        _agree(got, want, sigma, True, 1e-4, 1e-4)


def test_zoom_form_matches_full_fft_form():
    """The port's two forms on tests/test_lockin_wfr.py's wfr4 fixture
    (192^2, r_k 0.15, float64, 40 candidates of generate_klists, dk
    0.01): winners agree on > 99.9% of the 5 sigma interior, the lock-in
    within 1e-6 there, the analytic and np.gradient gradients within
    5e-3 rad/px at the 99th percentile (the central difference's
    discretization error), as that test holds the reference's."""
    ks = np.asarray(generate_ks(0.15, 13.0))[:3]
    img = np.asarray(hexlattice_gen(0.15, 13.0, order=1, size=SIZE,
                                    dtype=np.float64))
    img = torch.from_numpy(img - img.mean())
    klist = np.asarray(tgpa.generate_klists(ks, dk=0.01)[0][:40])
    sigma = 10
    gz = TW.wfr_sweep(img, klist, ks[0], sigma, continuity_dk=0.01,
                      with_grad=True)
    gf = TW.wfr_sweep(img, klist, ks[0], sigma, continuity_dk=0.01,
                      with_grad=True, zoom=False)
    m = 5 * sigma
    sl = np.s_[m:-m, m:-m]
    same = (gz["w"].numpy()[:, m:-m, m:-m]
            == gf["w"].numpy()[:, m:-m, m:-m]).all(0)
    assert same.mean() > 0.999
    assert np.abs(gz["lockin"].numpy()[sl][same]
                  - gf["lockin"].numpy()[sl][same]).max() < 1e-6
    dgrad = np.abs(gz["grad"].numpy()[sl][same] - gf["grad"].numpy()[sl][same])
    assert np.quantile(dgrad, 0.99) < 5e-3


def test_wfr4_matches_reference():
    """gpa.wfr4 (device="cpu") against the reference's on
    tests/test_lockin_wfr.py's fixture: winners equal, lock-in within
    1e-9 of its peak (float64)."""
    ks = np.asarray(generate_ks(0.15, 13.0))[:3]
    img = np.asarray(hexlattice_gen(0.15, 13.0, order=1, size=SIZE,
                                    dtype=np.float64))
    img = img - img.mean()
    klist = np.asarray(jgpa.generate_klists(ks, dk=0.01)[0][:40])
    want = jgpa.wfr4(img, 10, klist, ks[0], dk=0.01)
    got = tgpa.wfr4(img, 10, klist, ks[0], 0.01, device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    lw = np.asarray(want["lockin"])
    assert np.abs(got["lockin"].numpy() - lw).max() <= 1e-9 * np.abs(lw).max()
