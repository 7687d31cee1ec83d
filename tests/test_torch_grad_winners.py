"""The gradient emissions' steps after the tournament, on the CPU through
their plain twins: the band flags (which candidates win a pixel of each
64-row band), stage 1 of the row-derivative window on the flagged
(band, candidate) pairs only, and the winner products; and the whole
decomposition against the sweeps' own twins (zoom_sweep_plain with
grad_ops, sweep_grad_plain) and against the reference's Pallas kernels
in interpret mode, banded and unbanded. Inputs are made with numpy
from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.ops.pallas_sweep as ps
import pygpa_tpu.ops.wfr as W
import pygpa_tpu_torch.ops.wfr as TW
from pygpa_tpu_torch.ops import _build
from pygpa_tpu_torch.ops import sweep as TS
from pygpa_tpu_torch.ops import zoom_sweep as TZ

from test_torch_cuda import _index_plane
from test_torch_sweep import _grid_fixture
from test_torch_wfr_grad import _flip_tolerant, kernels  # noqa: F401

torch.set_num_threads(2)


def _t(a, dt=np.float32):
    return torch.from_numpy(np.asarray(a, dt))


def _winner_sets(idx):
    """numpy: the set of candidates that win a pixel of each band."""
    G, n, _ = idx.shape
    return [[set(np.unique(idx[g, b * 64:(b + 1) * 64]).tolist())
             for b in range(n // 64)] for g in range(G)]


@pytest.mark.parametrize("G,n,m,P", [(1, 256, 384, 5), (3, 512, 256, 42),
                                     (2, 256, 512, 300)])
def test_band_flags_match_numpy_winner_sets(G, n, m, P):
    """band_winners on a CPU tensor: (G, n/64, P) int32, 1 exactly for
    the candidates of each band's numpy set of winners; the fixture has
    bands of several winners. No kernel launch is counted."""
    idx = _index_plane(G, n, m, P, 11 + P)
    before = dict(_build.launches)
    flags = TS.band_winners(torch.from_numpy(idx), P)
    assert dict(_build.launches) == before
    assert flags.shape == (G, n // 64, P) and flags.dtype == torch.int32
    sets = _winner_sets(idx)
    for g in range(G):
        for b in range(n // 64):
            assert set(np.flatnonzero(flags[g, b].numpy()).tolist()) \
                == sets[g][b]
    assert max(len(s) for row in sets for s in row) > 1


def _grouped(G, P, W0, Wb, n, m, seed, banded):
    """sweep_grad's operands made from a seed: DFT bases of consecutive
    bins, two band runs at offsets 0 and 64 (banded) or one, random
    windows, row-derivative windows and f1-scaled basis; dr 6."""
    g = np.random.default_rng(seed)
    a0 = TW._zoom_basis(n, (np.arange(W0) + 5) % n)
    a1 = TW._zoom_basis(m, (np.arange(Wb) + 3) % m)
    h = P // 2
    run = [[0] * h + [1] * (P - h)] * G if banded else [[0] * P] * G
    off = [[0] * h + [64] * (P - h)] * G if banded else [[0] * P] * G
    S = [_t(g.normal(size=(G, 2, W0, Wb))) for _ in range(4)]
    return (*S, _t(g.uniform(0.2, 1, size=(G, P, W0))),
            _t(g.uniform(0.2, 1, size=(G, P, Wb))),
            *(_t(np.stack([b.numpy()] * G)) for b in (*a0, *a1)),
            _t(g.normal(size=(G, m, Wb))), _t(g.normal(size=(G, m, Wb))),
            _t(run, np.int32), _t(off, np.int32), 6, banded)


def test_flagged_stage1_matches_full_on_flagged_rows():
    """stage1 with band flags on CPU tensors (the masked twin): the
    flagged (band, candidate) rows equal the full stage 1's, the others
    are 0 (never read); each candidate's rows are flagged in some bands
    and not in others."""
    a = _grouped(2, 6, 32, 64, 256, 192, 3, True)
    Sr, Si, gx, gy, A0c, A0s = a[0], a[1], a[4], a[5], a[6], a[7]
    run = a[12]
    g = np.random.default_rng(4)
    flags = _t(g.random((2, 4, 6)) < 0.4, np.int32)
    full = TS.stage1(Sr, Si, gx, gy, A0c, A0s, run)
    got = TS.stage1(Sr, Si, gx, gy, A0c, A0s, run, flags)
    rows = flags.permute(0, 2, 1).repeat_interleave(64, dim=2).bool()
    assert 0 < int(flags.sum()) < flags.numel()
    assert torch.equal(got[rows], full[rows])
    assert not got[~rows].any()


@pytest.mark.parametrize("banded", [True, False])
def test_winner_products_match_twin(banded):
    """The decomposition (sweep_grad_steps on CPU tensors: stage 1, the
    tournament that stores its winners, band flags, flagged Tx, winner
    products written over the winners' M planes) against
    sweep_grad_plain, which keeps every candidate's gradients: the phase
    and weight planes equal, the gradients within rtol 1e-5 and 1e-6 of
    their largest magnitude (the same float32 products, taken per band
    rather than per plane). The random operands give several winners a
    band and a tile."""
    a = _grouped(2, 7, 32, 128, 256, 320, 21 + banded, banded)
    want = TS.sweep_grad_plain(*a)
    got = TS.sweep_grad_steps(*a)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for k in (2, 3):
        np.testing.assert_allclose(
            got[k].numpy(), want[k].numpy(), rtol=1e-5,
            atol=1e-6 * float(want[k].abs().max()))
    T = TS.stage1(*a[:2], *a[4:8], a[12])
    idx = TS.stage2(T, a[8], a[9], a[13], 6, banded, winners=True)[4]
    tiles = idx.reshape(2, 4, 64, 5, 64).permute(0, 1, 3, 2, 4)
    assert max(len(torch.unique(t)) for t in tiles.reshape(-1, 4096)) > 1
    assert int(TS.band_winners(idx, 7).sum(-1).max()) > 1


def _zoom_steps(ops, gops):
    """The zoom gradient emission as its launches on CPU tensors: stage 1,
    the tournament (its twin), then the grouped sweep's gradient steps
    in the zoom sweep's layout."""
    Sr, Si, gx, gy, A0c, A0s, A1c, A1s = ops
    T = TZ.stage1(Sr, Si, gx, gy, A0c, A0s)
    out = TZ.zoom_sweep_plain(*ops)
    return out + TZ.winner_grads(T, out, gx, gy, A0c, A0s, A1c, A1s, gops)


def test_zoom_decomposition_matches_twin_and_interpret_kernel():
    """tests/test_lockin_wfr.py's gradient fixture (P = 5, W0 = W1 = 64,
    256 x 384): the decomposition's gradients against zoom_sweep_plain's
    (every candidate's gradients, the winner's kept; same winners:
    within rtol 1e-5 and 1e-6 of the largest magnitude) and against the
    reference's kernel in interpret mode (reference chunks of 3): winners
    agree on > 99.9% of the pixels, and there within 3e-3 of the mean
    |gradient| (test_zoom_grad_twin_matches_interpret_kernel's bound)."""
    rng = np.random.default_rng(7)
    P, W0, W1, n, m = 5, 64, 64, 256, 384
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    Sr, Si, S2r, S2i = (mk(W0, W1) for _ in range(4))
    gx = rng.uniform(0.2, 1, size=(P, W0)).astype(np.float32)
    gy = rng.uniform(0.2, 1, size=(P, W1)).astype(np.float32)
    A0c, A0s = mk(n, W0), mk(n, W0)
    A1c, A1s, A1yc, A1ys = (mk(m, W1) for _ in range(4))
    ops = (Sr, Si, gx, gy, A0c, A0s, A1c, A1s)
    gops = (S2r, S2i, A1yc, A1ys)
    got = [x.numpy() for x in _zoom_steps(tuple(map(torch.from_numpy, ops)),
                                          tuple(map(torch.from_numpy, gops)))]
    twin = [x.numpy() for x in TZ.zoom_sweep_plain(
        *map(torch.from_numpy, ops),
        grad_ops=tuple(map(torch.from_numpy, gops)))]
    np.testing.assert_array_equal(got[3], twin[3])
    for k in (4, 5):
        np.testing.assert_allclose(got[k], twin[k], rtol=1e-5,
                                   atol=1e-6 * np.abs(twin[k]).max())
    ref = [np.asarray(x) for x in ps.fused_zoom_sweep(
        *map(jnp.asarray, ops), max_chunk=3, interpret=True,
        grad_ops=tuple(map(jnp.asarray, gops)))]
    same = got[3] == ref[3]
    assert same.mean() > 0.999
    for k in (4, 5):
        sc = np.abs(ref[k][same]).mean()
        np.testing.assert_allclose(got[k][same], ref[k][same], rtol=0,
                                   atol=3e-3 * sc)


@pytest.mark.parametrize("size,banded", [(128, False), (256, True)])
def test_grouped_decomposition_matches_interpret_kernel(kernels, monkeypatch,
                                                        size, banded):
    """wfr_sweep_phase_weight_multi(with_grad=True) on its grouped route
    with emission (b) run as its launches (sweep_grad_steps on CPU
    tensors), on tests/test_lockin_wfr.py's 4x4 candidate grids,
    unbanded at 128^2 and banded at 256^2, against the reference's
    grouped kernel in interpret mode: weights within rtol 1e-5, phases
    and rebased gradients with the flip-tolerant bounds of
    test_grouped_emissions_match_interpret_kernel."""
    img, ks, wlists, sigma, dr, gc = _grid_fixture(size)
    plan = TW.plan_sweep(img.shape, wlists, sigma, dr, gauss_cut=gc)
    assert plan is not None and (plan.col_groups is not None) == banded
    calls = []

    def steps(*a):
        calls.append(a)
        return TS.sweep_grad_steps(*a)
    monkeypatch.setattr(TW._sweep, "sweep_grad", steps)
    kw = dict(with_grad=True, krefs=ks, gauss_cut=gc)
    want = [np.asarray(x) for x in W.wfr_sweep_phase_weight_multi(
        jnp.asarray(img), wlists, sigma, dr, **kw)]
    got = [x.numpy() for x in TW.wfr_sweep_phase_weight_multi(
        torch.from_numpy(img), wlists, sigma, dr, **kw)]
    assert len(calls) == 1
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5,
                               atol=1e-7 * want[1].max())
    assert got[2].shape == (3, size, size, 2) and np.isfinite(got[2]).all()
    _flip_tolerant(got[0], want[0], (got[2][..., 0], got[2][..., 1]),
                   (want[2][..., 0], want[2][..., 1]))
