"""The port's single-peak zoom sweep (pygpa_tpu_torch.ops.zoom_sweep, the
plain twin on the CPU) against pygpa_tpu.ops.pallas_sweep
fused_zoom_sweep in interpret mode, and the per-peak WFR sweep route
(ops.wfr.wfr_sweep and friends) against pygpa_tpu.ops.wfr on the CPU.
The reference kernel runs at its default HIGHEST precision; the port
computes in float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.ops.wfr as W
from pygpa_tpu.lattices import generate_ks, hexlattice_gen
from pygpa_tpu.ops.pallas_sweep import fused_zoom_sweep
import pygpa_tpu_torch.ops.wfr as TW
from pygpa_tpu_torch.ops import _build
from pygpa_tpu_torch.ops import zoom_sweep as TZ

torch.set_num_threads(2)


def _operands(seed, P, W0, W1, n, m, glo=0.0):
    rng = np.random.default_rng(seed)
    ops = [rng.normal(size=(W0, W1)), rng.normal(size=(W0, W1)),
           rng.uniform(glo, 1, size=(P, W0)), rng.uniform(glo, 1, size=(P, W1)),
           rng.normal(size=(n, W0)), rng.normal(size=(n, W0)),
           rng.normal(size=(m, W1)), rng.normal(size=(m, W1))]
    return [a.astype(np.float32) for a in ops]


def test_twin_matches_interpret_kernel():
    """tests/test_lockin_wfr.py's kernel fixture: P = 5 candidates,
    W0 = W1 = 64, 256 x 384 pixels, reference chunks of 3 so its carries
    cross a chunk boundary; the port runs all candidates in one pass.
    Bounds as the reference's kernel-vs-einsum test: |M|^2 rtol 1e-4
    (atol 1e-2), Re/Im atol 1e-3, winner flips < 0.1% of pixels."""
    ops = _operands(0, 5, 64, 64, 256, 384)
    oa, orr, oi, ox = (np.asarray(a) for a in fused_zoom_sweep(
        *(jnp.asarray(a) for a in ops), max_chunk=3, interpret=True))
    ta, tr, ti, tx = (a.numpy() for a in TZ.zoom_sweep(
        *(torch.from_numpy(a) for a in ops)))
    assert tx.dtype == np.int32 and ta.shape == (256, 384)
    assert (tx != ox).mean() < 1e-3
    same = tx == ox
    assert np.allclose(ta[same], oa[same], rtol=1e-4, atol=1e-2)
    assert np.allclose(tr[same], orr[same], atol=1e-3)
    assert np.allclose(ti[same], oi[same], atol=1e-3)
    # the twin's chunking does not change the result
    for a, b in zip(TZ.zoom_sweep_plain(*(torch.from_numpy(a) for a in ops),
                                        chunk=2), (ta, tr, ti, tx)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_phase_weight_emission_matches_interpret_kernel():
    """The emitted phase and rim-masked weight (dr = 24) against the
    reference kernel's emission: atol 1e-5 / rtol 1e-5 (atol 1e-6), as
    tests/test_lockin_wfr.py holds that emission."""
    ops = _operands(3, 4, 64, 64, 256, 256, glo=0.2)
    dr = 24
    ref = fused_zoom_sweep(*(jnp.asarray(a) for a in ops), interpret=True,
                           emit_dr=(dr,))
    got = TZ.zoom_sweep(*(torch.from_numpy(a) for a in ops), dr=dr)
    assert len(got) == 6
    same = got[3].numpy() == np.asarray(ref[3])
    assert same.mean() > 0.999
    ph, w = got[4].numpy(), got[5].numpy()
    assert np.allclose(ph[same], np.asarray(ref[4])[same], atol=1e-5)
    assert np.allclose(w[same], np.asarray(ref[5])[same], rtol=1e-5,
                       atol=1e-6)
    # the rim factor: 1e-6 on the dr-pixel border, 1 + 1e-6 inside
    wa = np.sqrt(got[0].numpy())
    assert np.allclose(w[:dr], wa[:dr] * np.float32(1e-6), rtol=1e-6)
    assert np.allclose(w[dr:-dr, dr:-dr], wa[dr:-dr, dr:-dr]
                       * np.float32(1.0 + 1e-6), rtol=1e-6)


def test_tie_keeps_the_earlier_candidate():
    """Candidates 1 and 3 are identical, so they tie wherever they lead:
    the strict '>' keeps candidate 1, never 3, in one pass here and
    across the reference's chunk boundary (chunks of 2)."""
    ops = _operands(4, 4, 64, 64, 128, 128, glo=0.2)
    ops[2][3] = ops[2][1]
    ops[3][3] = ops[3][1]
    ref = np.asarray(fused_zoom_sweep(*(jnp.asarray(a) for a in ops),
                                      max_chunk=2, interpret=True)[3])
    got = TZ.zoom_sweep(*(torch.from_numpy(a) for a in ops))[3].numpy()
    assert (ref == 1).any() and not (ref == 3).any()
    assert (got == 1).any() and not (got == 3).any()
    assert (got == ref).mean() > 0.999


def _lattice(size=256, dtype=jnp.float32):
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


@pytest.mark.parametrize("zoom", ["auto", False])
def test_wfr_sweep_matches_reference(zoom):
    """wfr_sweep on the zoom route (the zoom twin here, the reference's
    XLA einsum route on the CPU) and on the full-FFT route: rebased
    lock-in within 1e-4 of its peak, winning candidates equal off
    near-ties."""
    img, k, wl, sigma = _lattice()
    want = W.wfr_sweep(jnp.asarray(img), wl, k, sigma, zoom=zoom,
                       return_absq=True)
    got = TW.wfr_sweep(torch.from_numpy(img), wl, k, sigma, zoom=zoom,
                       return_absq=True)
    lw = np.asarray(want["lockin"])
    lg = got["lockin"].numpy()
    assert lg.dtype == np.complex64 and lg.shape == img.shape
    assert np.abs(lg - lw).max() <= 1e-4 * np.abs(lw).max()
    assert (got["w"].numpy() != np.asarray(want["w"])).any(0).mean() < 1e-3
    np.testing.assert_allclose(got["absq"].numpy(), np.asarray(want["absq"]),
                               rtol=1e-3, atol=1e-6 * np.abs(lw).max() ** 2)


def test_phase_weight_routes_match_reference():
    """wfr_sweep_phase_weight (kernel-emit route: the twin here) and the
    per-peak wfr_sweep_phase_weight_multi (float64: the plain route)
    against the reference on the CPU; phases compared where the weight
    is above the rim floor."""
    img, k, wl, sigma = _lattice()
    dr = 2 * sigma
    ph0, w0 = (np.asarray(a) for a in W.wfr_sweep_phase_weight(
        jnp.asarray(img), wl, k, sigma, dr))
    ph1, w1 = (a.numpy() for a in TW.wfr_sweep_phase_weight(
        torch.from_numpy(img), wl, k, sigma, dr))
    live = w0 > 1e-3 * w0.max()
    np.testing.assert_allclose(w1, w0, rtol=1e-4, atol=1e-6 * w0.max())
    dph = np.angle(np.exp(1j * (ph1 - ph0)))
    assert np.abs(dph[live]).max() < 1e-4
    img64 = np.asarray(_lattice(dtype=jnp.float64)[0])
    wls = [wl, wl + 0.01]
    ph0, w0 = (np.asarray(a) for a in W.wfr_sweep_phase_weight_multi(
        jnp.asarray(img64), wls, sigma, dr))
    ph1, w1 = (a.numpy() for a in TW.wfr_sweep_phase_weight_multi(
        torch.from_numpy(img64), wls, sigma, dr))
    assert ph1.shape == (2,) + img.shape and ph1.dtype == np.float64
    np.testing.assert_allclose(w1, w0, rtol=1e-9, atol=1e-12 * w0.max())
    live = w0 > 1e-3 * w0.max()
    assert np.abs(np.angle(np.exp(1j * (ph1 - ph0)))[live]).max() < 1e-9


def test_multi_refuses_the_grouped_phase_weight_emission():
    img, k, wl, sigma = _lattice()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        TW.wfr_sweep_phase_weight_multi(torch.from_numpy(img), [wl] * 3,
                                        sigma, 2 * sigma)


def test_unported_sweep_options_raise():
    img, k, wl, sigma = _lattice(128)
    for kw in (dict(with_grad=True), dict(continuity_dk=0.01)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 "
                                                      "item 7"):
            TW.wfr_sweep(torch.from_numpy(img), wl, k, sigma, **kw)


def test_wrapper_dispatch():
    """A CPU tensor runs the twin and counts no launch; another device
    goes to the kernel path or raises."""
    ops = [torch.from_numpy(a) for a in _operands(6, 2, 64, 64, 64, 64)]
    _build.launches.clear()
    for a, b in zip(TZ.zoom_sweep(*ops), TZ.zoom_sweep_plain(*ops)):
        assert torch.equal(a, b)
    assert sum(_build.launches.values()) == 0
    with pytest.raises(ValueError, match="device"):
        TZ.zoom_sweep(*[a.to("meta") for a in ops])
