"""The port's grouped banded uv sweep (pygpa_tpu_torch.ops.wfr /
ops.sweep, plain twin on the CPU) against pygpa_tpu.ops.wfr with the
Pallas kernel in interpret mode. The reference's contraction precision
is pinned to HIGHEST for the comparisons: the port computes in full
float32, while HIGH selects winners from a bf16 screen."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.ops.wfr as W
from pygpa_tpu.lattices import generate_ks, hexlattice_gen
from pygpa_tpu.ops.pallas_sweep import _wrap_pi
from pygpa_tpu.solvers.lstsq import weighted_lstsq_stack
import pygpa_tpu_torch.ops.sweep as TS
import pygpa_tpu_torch.ops.wfr as TW
from pygpa_tpu_torch.gpa.pipeline import candidate_banks, plan_from_numpy

torch.set_num_threads(2)


def _jax_host_plan(shape, wlists, sigma, dr, ks, gc):
    """The host plan pygpa_tpu.ops.wfr.wfr_sweep_phase_weight_multi
    derives on its grouped uv route, step for step."""
    plans = W._plan_zoom_multi(shape, wlists, float(sigma), gauss_cut=gc)
    wls = [np.asarray(w) for w in wlists]
    col_groups = None
    cg = W._plan_col_groups(wls, plans, shape[1], float(sigma),
                            gauss_cut=gc)
    if cg is not None:
        orders, groups, Wb = cg
        wls = [w[o] for w, o in zip(wls, orders)]
        col_groups = (int(Wb), groups)
    return plan_from_numpy(
        shape, sigma, dr, np.stack(wls), np.stack([p[0] for p in plans]),
        np.stack([p[1] for p in plans]), col_groups,
        tuple((float(k[0]), float(k[1])) for k in np.asarray(ks)))


def _assert_same_plan(a, b):
    assert a.shape == b.shape and a.sigma == b.sigma and a.dr == b.dr
    np.testing.assert_array_equal(a.wl, b.wl)
    np.testing.assert_array_equal(a.idx0s, b.idx0s)
    np.testing.assert_array_equal(a.idx1s, b.idx1s)
    assert a.col_groups == b.col_groups
    assert a.uv_ks == b.uv_ks


def _bench_banks():
    ks = np.asarray(generate_ks(0.02, 5.0, kappa=1.005, psi=10.0))[:3]
    return ks, candidate_banks(ks)


def _grid_fixture(size):
    """The banded fixture of tests/test_lockin_wfr.py (4x4 candidate
    grids, gauss_cut 10)."""
    r_k, theta, gc = 0.12, 5.0, 10.0
    img = np.asarray(hexlattice_gen(r_k, theta, order=1, size=size,
                                    dtype=jnp.float32))
    img = img - img.mean()
    ks = np.asarray(generate_ks(r_k, theta), np.float64)[:3]
    knorms = np.linalg.norm(ks, axis=1)
    kw = knorms.mean() / 2.5
    offs = (np.arange(4) - 1.5) * (2 * kw / 4)
    wx, wy = np.meshgrid(offs, offs, indexing="ij")
    grid = np.stack([wx.ravel(), wy.ravel()], -1)
    wlists = [k[None] + grid for k in ks]
    sigma = int(np.ceil(1 / knorms.min()))
    return img, ks, wlists, sigma, 2, gc


def _pipeline_fixture(size):
    """The pipeline's own banks on a 256^2 lattice whose window plan
    stays unbanded."""
    r_k, theta = 0.1, 7.0
    img = np.asarray(hexlattice_gen(r_k, theta, order=1, size=size,
                                    dtype=jnp.float32))
    img = img - img.mean()
    ks = np.asarray(generate_ks(r_k, theta))[:3]
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    return img, ks, candidate_banks(ks), sigma, 2 * sigma, 7.0


def test_bench_plan_identical():
    """The 4096^2 bench extractor's plan: both planners give the same
    windows, band runs and (wy-sorted) banks: sigma 51, dr 102,
    W0 = W1 = 192, Wb = 128, three runs of 12 candidates per peak."""
    ks, banks = _bench_banks()
    jbanks = []
    knorms = np.linalg.norm(ks, axis=1)
    kw = knorms.mean() / 2.5
    steps = kw / 3 * np.arange(6)
    for pk in ks:
        wx, wy = np.meshgrid(pk[0] - kw + steps, pk[1] - kw + steps,
                             indexing="ij")
        jbanks.append(np.asarray(jnp.asarray(
            np.stack([wx.ravel(), wy.ravel()], -1), jnp.float32)))
    for a, b in zip(banks, jbanks):
        np.testing.assert_array_equal(a, b)
    sigma = int(np.ceil(1 / knorms.min()))
    want = _jax_host_plan((4096, 4096), jbanks, sigma, 2 * sigma, ks, 7.0)
    got = TW.plan_sweep((4096, 4096), banks, sigma, 2 * sigma, ks,
                        gauss_cut=7.0)
    _assert_same_plan(got, want)
    assert (sigma, got.dr) == (51, 102)
    assert got.idx0s.shape == got.idx1s.shape == (3, 192)
    Wb, runs = got.col_groups
    assert Wb == 128 and all(len(r) == 3 and all(c == 12 for c, _ in r)
                             for r in runs)


@pytest.mark.parametrize("size", [256, 512])
def test_grid_fixture_plan_identical(size):
    img, ks, wlists, sigma, dr, gc = _grid_fixture(size)
    want = _jax_host_plan(img.shape, wlists, sigma, dr, ks, gc)
    got = TW.plan_sweep(img.shape, wlists, sigma, dr, ks, gauss_cut=gc)
    _assert_same_plan(got, want)
    assert got.col_groups is not None
    assert got.col_groups[0] < got.idx1s.shape[1]


def test_plan_refuses_unported_routes():
    """Where the reference leaves the grouped route (a side not a
    multiple of 128, unequal candidate counts, float64, P > 48) the
    grouped planner returns None and the per-peak route runs."""
    img, ks, wlists, sigma, dr, gc = _grid_fixture(256)
    assert TW.plan_sweep((250, 256), wlists, sigma, dr, ks,
                         gauss_cut=gc) is None
    assert TW.plan_sweep(img.shape, [wlists[0], wlists[1][:-1], wlists[2]],
                         sigma, dr, ks, gauss_cut=gc) is None
    assert TW.plan_sweep(img.shape, wlists, sigma, dr, ks, gauss_cut=gc,
                         dtype=torch.float64) is None
    big = [np.concatenate([w] * 4) for w in wlists]      # P = 64 > 48
    assert TW.plan_sweep(img.shape, big, sigma, dr, ks, gauss_cut=gc) is None
    assert TW.wfr_sweep_uv_multi(torch.zeros((250, 256)), wlists, sigma, dr,
                                 ks, gauss_cut=gc) is None


def test_zoom_basis_and_dft_windows_match():
    img, ks, wlists, sigma, dr, gc = _grid_fixture(256)
    plan = TW.plan_sweep(img.shape, wlists, sigma, dr, ks, gauss_cut=gc)
    n, m = img.shape
    for idx in (plan.idx0s[0], plan.idx1s[2]):
        jc, js = W._zoom_basis(n, jnp.asarray(idx), jnp.float32)
        tc, ts = TW._zoom_basis(n, idx)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    jr, ji = W._dft_windows(jnp.asarray(img), jnp.asarray(plan.idx0s),
                            jnp.asarray(plan.idx1s), jnp.float32)
    sw = TW.GroupedSweep(plan)
    tr, ti = TW._dft_windows(torch.from_numpy(img), sw.A0c_flat,
                             sw.A0s_flat, sw.A1c, sw.A1s)
    # rtol 1e-4 of the window's peak (bins far off the Bragg peak hold
    # ~0 and carry only the float32 summation noise of n*m terms)
    for got, want in ((tr, jr), (ti, ji)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_uv_epilogue_matches_reference_prologue():
    """The twin's uv epilogue on its own phase/weight planes equals the
    reference's XLA reconstruction prologue on the same planes."""
    img, ks, wlists, sigma, dr, gc = _grid_fixture(256)
    plan = TW.plan_sweep(img.shape, wlists, sigma, dr, ks, gauss_cut=gc)
    sw = TW.GroupedSweep(plan)
    Sr4, Si4 = sw.windows(torch.from_numpy(img))
    T = TS._stage1_plain(Sr4, Si4, sw.gx, sw.gy, sw.A0c, sw.A0s, sw.run)
    ph, wt = TS._stage2_plain(T, sw.A1cb, sw.A1sb, sw.off, dr, True)
    ux, uy, wn = TS._uv_plain(ph, wt, sw.kconst)
    ph, wt = jnp.asarray(ph.numpy()), jnp.asarray(wt.numpy())
    K = 2 * jnp.pi * jnp.asarray(ks, jnp.float32)
    dbdx = _wrap_pi(jnp.diff(ph, axis=2) + K[:, 1, None, None])
    dbdy = _wrap_pi(jnp.diff(ph, axis=1) + K[:, 0, None, None])
    dudx = np.asarray(weighted_lstsq_stack(dbdx, K, wt[:, :, :-1]))
    dudy = np.asarray(weighted_lstsq_stack(dbdy, K, wt[:, :-1, :]))
    np.testing.assert_allclose(wn.numpy(), np.asarray(jnp.linalg.norm(
        wt, axis=0)), rtol=1e-5, atol=1e-7)
    mx = np.asarray(wt[:, :, :-1]).min(0) > 1e-4
    my = np.asarray(wt[:, :-1, :]).min(0) > 1e-4
    assert np.abs((ux.numpy()[:, :, 1:] - dudx)[:, mx]).max() < 1e-4
    assert np.abs((uy.numpy()[:, 1:, :] - dudy)[:, my]).max() < 1e-4
    assert (ux[:, :, 0] == 0).all() and (uy[:, 0, :] == 0).all()


@pytest.fixture
def highest(monkeypatch):
    """Reference sweep contractions at HIGHEST; the jit caches are
    cleared so the patched module flag is traced, not a cached
    executable built under the old one."""
    jax.clear_caches()
    monkeypatch.setattr(W, "_ZOOM_PRECISION", jax.lax.Precision.HIGHEST)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("fixture,banded", [(_pipeline_fixture, False),
                                            (_grid_fixture, True)])
def test_sweep_twin_matches_interpret_kernel(highest, fixture, banded):
    img, ks, wlists, sigma, dr, gc = fixture(256)
    ref = W.wfr_sweep_uv_multi(jnp.asarray(img), wlists, sigma, dr, ks,
                               gauss_cut=gc, interpret=True)
    ux0, uy0, wn0 = (np.asarray(a) for a in ref)
    plan = TW.plan_sweep(img.shape, wlists, sigma, dr, ks, gauss_cut=gc)
    assert (plan.col_groups is not None) == banded
    ux1, uy1, wn1 = (a.numpy() for a in TW.wfr_sweep_uv_multi(
        torch.from_numpy(img), wlists, sigma, dr, ks, gauss_cut=gc))
    assert np.isfinite(ux1).all() and np.isfinite(uy1).all()
    # weight norm: rtol 1e-5 (test_lockin_wfr's kernel-vs-XLA bound)
    np.testing.assert_allclose(wn1, wn0, rtol=1e-5, atol=1e-7)
    # gradients: the two sweeps sum in different orders, so a near-tie
    # winner may flip at a few conditioned pixels (all peak weights
    # > 1e-4); the flip-tolerant bounds of the banded-vs-unbanded
    # kernel test hold, and off the flips the planes agree to 1e-4
    sw = TW.GroupedSweep(plan)
    Sr4, Si4 = sw.windows(torch.from_numpy(img))
    T = TS._stage1_plain(Sr4, Si4, sw.gx, sw.gy, sw.A0c, sw.A0s, sw.run)
    _, wt = TS._stage2_plain(T, sw.A1cb, sw.A1sb, sw.off, dr, sw.banded)
    wt = wt.numpy()
    mx = wt[:, :, :-1].min(0) > 1e-4
    my = wt[:, :-1, :].min(0) > 1e-4
    dx = np.abs(ux1 - ux0)[:, :, 1:]
    dy = np.abs(uy1 - uy0)[:, 1:, :]
    assert (dx[:, mx] > 1e-4).mean() < 1e-3
    assert (dy[:, my] > 1e-4).mean() < 1e-3
    assert np.percentile(dx, 99) < 1e-3 and np.percentile(dy, 99) < 1e-3
    assert (np.abs(wn1 - wn0) / (np.abs(wn0) + 1e-9)).max() < 5e-3


def _grouped_case(seed, G, P, W0, W1, Wb, n, m, dr=6):
    """Operands of a banded grouped uv sweep made from a seed: spectrum
    windows (G, W0, W1), Gaussian-like factors, the DFT bases of
    consecutive window bins, two band runs per group (offsets 0 and W1 -
    Wb), and the nominal k-vectors; returned as the arguments of the
    reference's fused_zoom_sweep_grouped (numpy) and of the port's
    sweep_uv (torch)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    Sr, Si = (rng.normal(size=(G, W0, W1)).astype(f32) for _ in range(2))
    gx = rng.uniform(0.2, 1.0, size=(G, P, W0)).astype(f32)
    gy = rng.uniform(0.2, 1.0, size=(G, P, W1)).astype(f32)
    i0 = (np.arange(W0) + 5) % n
    i1 = (np.arange(W1) + 3) % m
    A0c, A0s = (a.numpy() for a in TW._zoom_basis(n, i0))
    A1c, A1s = (a.numpy() for a in TW._zoom_basis(m, i1))
    A0c, A0s = np.stack([A0c] * G), np.stack([A0s] * G)
    A1c, A1s = np.stack([A1c] * G), np.stack([A1s] * G)
    runs = tuple(((P // 2, 0), (P - P // 2, W1 - Wb)) for _ in range(G))
    ks = rng.uniform(0.05, 0.2, size=(G, 2))
    ref = dict(args=(Sr, Si, gx, gy, A0c, A0s, A1c, A1s),
               uv_ks=tuple((2 * np.pi * a, 2 * np.pi * b) for a, b in ks),
               dr=dr, col_groups=(Wb, runs))
    T = torch.from_numpy
    band = [[(0, P // 2, 0), (1, P - P // 2, W1 - Wb)] for _ in range(G)]
    Sr4 = T(np.stack([[Sr[g, :, o:o + Wb] for _, _, o in band[g]]
                      for g in range(G)]).copy())
    Si4 = T(np.stack([[Si[g, :, o:o + Wb] for _, _, o in band[g]]
                      for g in range(G)]).copy())
    gyb = T(np.stack([np.concatenate(
        [gy[g, :P // 2, :Wb], gy[g, P // 2:, W1 - Wb:]]) for g in range(G)]))
    run = T(np.array([[0] * (P // 2) + [1] * (P - P // 2)] * G, np.int32))
    off = T(np.array([[0] * (P // 2) + [W1 - Wb] * (P - P // 2)] * G,
                     np.int32))
    kc = [[t0, t1, t0 * t0, t0 * t1, t1 * t1] for t0, t1 in ref["uv_ks"]]
    port = (Sr4, Si4, T(gx), gyb, T(A0c), T(A0s),
            T(A1c[:, :, :Wb].copy()), T(A1s[:, :, :Wb].copy()), run, off,
            torch.tensor(kc, dtype=torch.float64).float(), dr, True)
    return ref, port


def _emulated_sweep_uv(args):
    """csrc/sweep.cu's grouped sweep as its tensor cores compute stage 2
    (test_torch_zoom_sweep's emulation of sweep_tc.cuh: 3xTF32, each
    mma's sum truncated to float32, per 32 columns of Wb one chain of the
    hi.hi products and one of the two small ones, the chains' sums added
    in float32), with the twin's stage 1, the tournament taking candidate
    0 first, and the twin's epilogues."""
    from test_torch_zoom_sweep import _stage2_tensor_cores
    Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off, kc, dr, banded = args
    G, P = gx.shape[:2]
    n, m = A0c.shape[1], A1c.shape[1]
    T = TS._stage1_plain(Sr, Si, gx, gy, A0c, A0s, run).numpy()
    passes = (("lo", "hi"), ("hi", "lo"), ("hi", "hi"))
    jj = torch.arange(m)[None, :].float()
    phs, wts = [], []
    for g in range(G):
        Mr, Mi = _stage2_tensor_cores(T[g], A1c[g].numpy(), A1s[g].numpy(),
                                      passes, split=True)
        br, bi, bo = Mr[0], Mi[0], np.full(Mr.shape[1:], off[g, 0].item())
        for i in range(1, P):
            sel = Mr[i] * Mr[i] + Mi[i] * Mi[i] > br * br + bi * bi
            br, bi = np.where(sel, Mr[i], br), np.where(sel, Mi[i], bi)
            bo = np.where(sel, off[g, i].item(), bo)
        br, bi = torch.from_numpy(br), torch.from_numpy(bi)
        rr = torch.from_numpy(bo.astype(np.float32)) * jj
        rr = rr - m * torch.floor(rr * (1.0 / m))
        phs.append(TS.wrap_pi(torch.atan2(bi, br) + rr * (TS._TWO_PI / m)))
        wts.append(torch.sqrt(br * br + bi * bi)
                   * TS.rim_weights(n, m, dr, torch.float32))
    return TS._uv_plain(torch.stack(phs), torch.stack(wts), kc)


def _uv_distance(got, want):
    """chip_smoke.py check_sweep's numbers: the p99 of |dudx_s|, |dudy_s|
    off the carry column/row, and the maximum and p99 of the weight
    norm's relative difference."""
    ux, uy, wn = (np.asarray(a, np.float64) for a in got)
    vx, vy, vn = (np.asarray(a, np.float64) for a in want)
    rel = np.abs(wn - vn) / (np.abs(vn) + 1e-9)
    return {"dudx_p99": np.percentile(np.abs(ux - vx)[:, :, 1:], 99),
            "dudy_p99": np.percentile(np.abs(uy - vy)[:, 1:, :], 99),
            "wnorm_rel_max": rel.max(),
            "wnorm_rel_p99": np.percentile(rel, 99)}


SWEEP_F64_BOUNDS = {"dudx_p99": 1e-3, "dudy_p99": 1e-3,
                    "wnorm_rel_max": 5e-3, "wnorm_rel_p99": 5e-5}


@pytest.mark.parametrize("Wb", [128, 320])
def test_tensor_core_stage2_meets_the_float64_bounds(Wb):
    """The grouped stage 2's tensor-core arithmetic, emulated on a banded
    plan of two groups at 128^2 (Wb 128, and 320, past what the former
    SIMT kernel kept in shared memory), against the float64 twin: within
    chip_smoke.py check_sweep's bounds, and the float32 twin no nearer in
    the weight norm (the small products' own chain keeps the tensor
    cores' truncation off |M|; one chain for all three passes lies
    1.1-1.8x further than the twin). The gradients share the twin's
    float32 stage 1, which sets their distance: equal within 5%."""
    _, args = _grouped_case(30 + Wb, 2, 6, 64, Wb + 64, Wb, 128, 128)
    want = TS.sweep_uv_plain(*(a.double() if torch.is_tensor(a)
                               and a.is_floating_point() else a
                               for a in args))
    emu = _uv_distance(_emulated_sweep_uv(args), want)
    f32 = _uv_distance(TS.sweep_uv_plain(*args), want)
    assert all(emu[k] < b for k, b in SWEEP_F64_BOUNDS.items()), emu
    assert emu["wnorm_rel_max"] <= f32["wnorm_rel_max"], (emu, f32)
    assert emu["wnorm_rel_p99"] <= f32["wnorm_rel_p99"], (emu, f32)
    assert emu["dudx_p99"] <= 1.05 * f32["dudx_p99"], (emu, f32)
    assert emu["dudy_p99"] <= 1.05 * f32["dudy_p99"], (emu, f32)


def test_twin_past_256_columns_matches_interpret_kernel(highest):
    """The twin at Wb = 320 (a band the former kernel refused) against
    the reference's fused_zoom_sweep_grouped in interpret mode on the same
    operands, with the flip-tolerant bounds of tests/test_lockin_wfr.py's
    banded-vs-unbanded test (uv p99 < 1e-3, weight norm rel max <
    5e-3)."""
    from pygpa_tpu.ops.pallas_sweep import fused_zoom_sweep_grouped
    ref, args = _grouped_case(7, 2, 4, 64, 384, 320, 128, 128)
    want = fused_zoom_sweep_grouped(
        *(jnp.asarray(a) for a in ref["args"]), uv_ks=ref["uv_ks"],
        dr=ref["dr"], col_groups=ref["col_groups"], interpret=True)
    got = TS.sweep_uv(*args)
    d = _uv_distance(got, [np.asarray(a) for a in want])
    assert all(np.isfinite(a.numpy()).all() for a in got)
    assert d["dudx_p99"] < 1e-3 and d["dudy_p99"] < 1e-3, d
    assert d["wnorm_rel_max"] < 5e-3, d


def test_kernel_takes_the_planners_widths():
    """The grouped kernel's shape rule accepts every Wb that is a
    multiple of 64: config 1's lattice (r_k 0.1, theta 7 deg) at 2048^2
    plans an unbanded Wb = 448, which the former kernel refused (Wb <=
    256), and the bench's 4096^2 plan a banded Wb = 128."""
    ks = np.asarray(generate_ks(0.1, 7.0))[:3]
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    plan = TW.plan_sweep((2048, 2048), candidate_banks(ks), sigma,
                         2 * sigma, ks, gauss_cut=7.0)
    assert plan is not None and plan.col_groups is None
    P, W0, Wb = plan.wl.shape[1], plan.idx0s.shape[1], plan.idx1s.shape[1]
    assert Wb == 448
    assert TS.kernel_supported(2048, 2048, W0, Wb, P)
    bks, banks = _bench_banks()
    sig = int(np.ceil(1 / np.linalg.norm(bks, axis=1).min()))
    bench = TW.plan_sweep((4096, 4096), banks, sig, 2 * sig, bks,
                          gauss_cut=7.0)
    assert TS.kernel_supported(4096, 4096, 192, bench.col_groups[0], 36)
    for bad in ((2048, 2048, W0, Wb + 32, P), (2048, 2000, W0, Wb, P),
                (2048, 2048, W0 + 8, Wb, P), (2048, 2048, W0, Wb, 0)):
        assert not TS.kernel_supported(*bad)
