"""The port's multigrid unwrap and its kernels' plain twins
(pygpa_tpu_torch.solvers.unwrap, ops.vcycle, ops.cg) against
pygpa_tpu on the CPU, the Pallas kernels in interpret mode. Inputs are
float32 planes made with numpy from a seed; the two displacement
components are the port's batch axis and a vmap on the reference
side."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.solvers.unwrap as JU
from pygpa_tpu.ops import pallas_cg, pallas_vcycle
import pygpa_tpu_torch.solvers.unwrap as TU
from test_torch_cuda import _presmooth_np
from pygpa_tpu_torch import config as tcfg
from pygpa_tpu_torch.ops import cg as tcg
from pygpa_tpu_torch.ops import vcycle as tvc

torch.set_num_threads(2)
HIGHEST = jax.lax.Precision.HIGHEST


def _problem(n, seed=0, m=None):
    """Two components of wrapped-free phase gradients dx (2, n, m-1),
    dy (2, n-1, m) of a smooth field plus noise, and a lock-in-like
    weight (n, m) with the pipeline's 1e-6 rim floor (m = n unless
    given)."""
    m = n if m is None else m
    rng = np.random.default_rng(seed)
    X, Y = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, m),
                       indexing="ij")
    psi = np.stack([3 * np.exp(-(X ** 2 + 2 * Y ** 2) / 0.3) + X * Y,
                    2 * np.sin(2 * X + Y) + 0.5 * Y])
    dx = np.diff(psi, axis=-1) + 0.01 * rng.normal(size=(2, n, m - 1))
    dy = np.diff(psi, axis=-2) + 0.01 * rng.normal(size=(2, n - 1, m))
    w = 0.2 + np.exp(-(X ** 2 + Y ** 2)) + 0.1 * rng.uniform(size=(n, m))
    rim = np.full((n, m), 1e-6)
    d, e = n // 16, m // 16
    rim[d:-d, e:-e] += 1.0
    return (dx.astype(np.float32), dy.astype(np.float32),
            (w * rim).astype(np.float32))


def _aligned(dx, dy):
    return (np.concatenate([dx, np.zeros(dx.shape[:-1] + (1,), dx.dtype)],
                           -1),
            np.concatenate([dy, np.zeros(dy.shape[:-2] + (1, dy.shape[-1]),
                                         dy.dtype)], -2))


def _close(got, want, rtol):
    """max |got - want| <= rtol * max |want| (normwise relative: the
    stencils cancel, so a pointwise ratio is undefined where the
    result is near 0)."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
    assert err <= rtol, err


def test_presmooth_twin_matches_interpret_kernel():
    n, cr, omega = 256, 4, 0.8
    dx, dy, w = _problem(n, 1)
    dxp, dyp = _aligned(dx, dy)
    phi = np.random.default_rng(5).normal(size=(2, n, n)).astype(np.float32)
    got = tvc.presmooth(torch.from_numpy(phi), torch.from_numpy(dxp),
                        torch.from_numpy(dyp), torch.from_numpy(w), cr,
                        omega)
    for b in range(2):
        want = pallas_vcycle.presmooth(
            jnp.asarray(phi[b]), jnp.asarray(dxp[b]), jnp.asarray(dyp[b]),
            jnp.asarray(w), cr, omega, interpret=True)
        for g, wnt in zip((got[0][b], got[1][b], got[2], got[3][b]), want):
            _close(g.numpy(), wnt, 1e-5)


def test_applyq_twin_matches_interpret_kernel():
    n = 256
    _, _, w = _problem(n, 2)
    p = np.random.default_rng(6).normal(size=(2, n, n)).astype(np.float32)
    got = tvc.applyq(torch.from_numpy(p), torch.from_numpy(w)).numpy()
    for b in range(2):
        want = pallas_vcycle.applyq(jnp.asarray(p[b]), jnp.asarray(w),
                                    interpret=True)
        _close(got[b], want, 1e-5)


@pytest.mark.parametrize("n,m", [pytest.param(s, s, id=str(s))
                                 for s in (128, 256, 512)]
                         + [pytest.param(256, 128, id="256x128")])
def test_cg_twin_matches_interpret_kernel(n, m):
    """Square sides and (256, 128), whose two axes take plans of their
    own in the kernel."""
    dx, dy, w = _problem(n, 3, m)
    dxp, dyp = _aligned(dx, dy)
    rk, WWx, WWy = JU._residual_aligned(jnp.asarray(dxp), jnp.asarray(dyp),
                                        jnp.asarray(w))
    got = tcg.cg_poisson(torch.from_numpy(np.array(rk)),
                         torch.from_numpy(np.array(WWx)),
                         torch.from_numpy(np.array(WWy)), 6).numpy()
    for b in range(2):
        want = pallas_cg.cg_poisson(rk[b], WWx, WWy, 6, precision=HIGHEST,
                                    interpret=True)
        _close(got[b], want, 1e-4)


def test_cg_route_truth_table():
    """Every side the reference's kernel takes runs on the card: powers
    of two on the FFT-form DCT passes, the other multiples of 128 up to
    1024 on the dense DCT-matrix route."""
    for n in (128, 256, 512, 1024):
        assert tcg.supported(n, n) and tcg.fft_route(n, n)
    for n in (384, 640, 768, 896):
        assert tcg.supported(n, n) and not tcg.fft_route(n, n)
    assert tcg.fft_route(256, 128) and tcg.fft_route(128, 1024)
    assert tcg.supported(128, 384) and not tcg.fft_route(128, 384)
    assert tcg.supported(896, 512) and not tcg.fft_route(896, 512)
    for n, m in ((1152, 1152), (2048, 1024), (100, 128), (500, 500)):
        assert not tcg.supported(n, m) and not tcg.fft_route(n, m)


def test_resampling_helpers_match():
    a = np.random.default_rng(7).normal(size=(2, 64, 96)).astype(np.float32)
    np.testing.assert_array_equal(TU._avg_right(96, 24, 4).numpy(),
                                  np.asarray(JU._avg_right(96, 24, 4,
                                                           jnp.float32)))
    for mi, mo in ((24, 96), (96, 96), (32, 64)):
        np.testing.assert_allclose(
            TU._resize_right(mi, mo).numpy(),
            np.asarray(JU._resize_right(mi, mo, jnp.float32)), atol=1e-7)
    bm = TU.block_mean(torch.from_numpy(a), 16, 24, 4).numpy()
    np.testing.assert_allclose(
        bm, a.reshape(2, 16, 4, 24, 4).mean((2, 4)), rtol=1e-6, atol=1e-7)


def test_default_schedule():
    """The reference's default schedule: the 4096^2 bench skips the mid
    level ("auto", 2048 >= 1024) and its V-branch correction solves at
    4096 / 4 = 1024^2; smaller images keep one mid-level iteration."""
    assert tcfg.DEFAULTS.unwrap_mg_final == "v"
    assert TU.default_schedule(4096, 4096, 6, 4) == ((4, 6), (1, "v"))
    assert TU.default_schedule(512, 512, 6, 4) == ((4, 6), (2, 1), (1, "v"))
    assert TU.default_schedule(256, 256, 6, 2) == ((2, 6), (1, 3))


def test_v_branch_solves_at_a_quarter(monkeypatch):
    """The CG solves the 512^2 unwrap runs: coarse 128^2 (kmax 6), mid
    256^2 (kmax 1), V-branch correction at 512 / 4 = 128^2 (kmax 4)."""
    dx, dy, w = _problem(512, 4)
    seen = []
    orig = TU._cg.cg_poisson

    def spy(rk, WWx, WWy, kmax):
        seen.append(tuple(rk.shape) + (kmax,))
        return orig(rk, WWx, WWy, kmax)

    monkeypatch.setattr(TU._cg, "cg_poisson", spy)
    TU.phase_unwrap_prediff_mg(torch.from_numpy(dx), torch.from_numpy(dy),
                               torch.from_numpy(w), kmax=6, coarse=4)
    assert seen == [(2, 128, 128, 6), (2, 256, 256, 1), (2, 128, 128, 4)]


@pytest.fixture
def kernel_unwrap(monkeypatch):
    """The reference unwrap through its Pallas kernels (interpret mode
    off the TPU); jit caches cleared around the flag flips."""
    jax.clear_caches()
    monkeypatch.setattr(JU, "_PALLAS_CG", True)
    monkeypatch.setattr(JU, "_PALLAS_VCYCLE", True)
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("n", [256, 512])
def test_unwrap_mg_matches_reference(kernel_unwrap, n):
    dx, dy, w = _problem(n, n)
    wj = jnp.asarray(w)
    want = jax.vmap(lambda a, b: JU.phase_unwrap_prediff_mg(
        a, b, wj, kmax=6, coarse=4, precision=HIGHEST))(
            jnp.asarray(dx), jnp.asarray(dy))
    got = TU.phase_unwrap_prediff_mg(torch.from_numpy(dx),
                                     torch.from_numpy(dy),
                                     torch.from_numpy(w), kmax=6, coarse=4)
    assert got.shape == (2, n, n) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-4)


def _card_plane(shape, dtype=torch.float32):
    """A stand-in for a CUDA tensor of `shape` and `dtype`: what
    vcycle_kernel_ok reads (shape, dtype, device)."""
    import types
    return types.SimpleNamespace(shape=shape, dtype=dtype,
                                 device=torch.device("cuda"))


def test_vcycle_gate_truth_table():
    """vcycle_kernel_ok: CUDA float32 planes whose shape and coarse
    factor the kernels take (n % 16, m % 32, cr dividing 16); 500^2,
    float64 and CPU tensors go to the twins, as the reference's
    _vcycle_kernel_ok sends them to its XLA stencils."""
    ok = tvc.vcycle_kernel_ok
    w32 = _card_plane((512, 512))
    assert ok(_card_plane((2, 512, 512)), w32, 4)
    assert ok(_card_plane((2, 1024, 96)), _card_plane((1024, 96)), 16)
    for cr in (1, 2, 8, 16):
        assert ok(_card_plane((2, 512, 512)), w32, cr)
    for cr in (3, 32):
        assert not ok(_card_plane((2, 512, 512)), w32, cr)
    assert not ok(_card_plane((2, 500, 500)), _card_plane((500, 500)), 4)
    assert not ok(_card_plane((2, 512, 500)), _card_plane((512, 500)), 4)
    assert not ok(_card_plane((2, 512, 512), torch.float64),
                  _card_plane((512, 512), torch.float64), 4)
    cpu = torch.zeros((2, 512, 512))
    assert not ok(cpu, cpu[0], 4)


def test_unwrap_mg_at_500_takes_the_twins(monkeypatch):
    """phase_unwrap_prediff_mg at 500^2, routed as on the card (the gate
    read without its device condition): the V-branch never reaches the
    kernel wrappers, which would raise on a CUDA tensor of that shape,
    and the result matches the reference (XLA stencils there too)."""
    dx, dy, w = _problem(500, 11)
    monkeypatch.setattr(tvc, "vcycle_kernel_ok", lambda phi, w, cr: (
        phi.dtype == torch.float32 and tvc.supported(*phi.shape[-2:], cr)))

    def refuse(*a):
        raise AssertionError("V-branch kernel wrapper called at 500^2")

    monkeypatch.setattr(tvc, "presmooth", refuse)
    monkeypatch.setattr(tvc, "applyq", refuse)
    wj = jnp.asarray(w)
    want = jax.vmap(lambda a, b: JU.phase_unwrap_prediff_mg(
        a, b, wj, kmax=6, coarse=4, precision=HIGHEST))(
            jnp.asarray(dx), jnp.asarray(dy))
    got = TU.phase_unwrap_prediff_mg(torch.from_numpy(dx),
                                     torch.from_numpy(dy),
                                     torch.from_numpy(w), kmax=6, coarse=4)
    assert got.shape == (2, 500, 500)
    _close(got.numpy(), want, 1e-4)


def _presmooth_strips(phi, dxc, dyc, w, cr, omega, sms):
    """csrc/vcycle.cu presmooth_kernel's schedule in numpy float32, every
    block of a row strip side by side: thread s of column tile t owns
    column t * PRESMOOTH_TILE - 2 + s (wrapped), step k loads row k,
    publishes phi, WW and the x-neighbour values in double-buffered
    shared rows and writes row k - 2. Returns the four outputs (NaN
    where never written) and how often each output pixel was written."""
    f = np.float32
    B, n, m = phi.shape
    PT, PC = tvc.PRESMOOTH_THREADS, tvc.PRESMOOTH_TILE
    rows, (tiles, strips) = tvc.presmooth_tiling(n, m, sms)
    s = np.arange(PT)
    sl, sr = np.maximum(s - 1, 0), np.minimum(s + 1, PT - 1)
    j = (np.arange(tiles) * PC)[:, None] - 2 + s[None, :]
    gj = j % m
    lane = gj < m - 1
    out_col = (s >= 2) & (s < PC + 2) & (j < m)
    jo = j[out_col]
    outs = [np.full((B, n, m), np.nan, f), np.full((B, n, m), np.nan, f),
            np.full((n, m), np.nan, f), np.full((B, n // cr, m), np.nan, f)]
    hits = np.zeros((n, m), int)
    rhits = np.zeros((n // cr, m), int)
    z1, zb = np.zeros((tiles, PT), f), np.zeros((B, tiles, PT), f)
    for by in range(strips):
        r0, r1 = by * rows, min(by * rows + rows, n)
        WW1, wx1, wy2, di2 = z1.copy(), z1.copy(), z1.copy(), z1.copy()
        phi1, dy1, tx1, ty2, rk2, d2, qx2, qy3, acc = (
            zb.copy() for _ in range(9))
        s_tx, s_qx = np.zeros((2,) + zb.shape, f), np.zeros((2,) + zb.shape, f)
        s_wwx = np.zeros((2,) + z1.shape, f)
        grp, orow = 0, r0 // cr
        for k in range(r0 - 2, r1 + 2):
            gk, par = k % n, k & 1
            cw, cphi = w[gk][gj], phi[:, gk][:, gj]
            cdx, cdy = dxc[:, gk][:, gj], dyc[:, gk][:, gj]
            row1 = (k - 1) % n != n - 1
            WW = cw * cw
            wx0 = np.where(lane, np.fmin(WW, WW[:, sr]), f(0))
            wy1 = np.fmin(WW1, WW) if row1 else z1
            D = -(((wx1 + s_wwx[par ^ 1][:, sl]) + wy1) + wy2)
            di1 = np.where(np.abs(D) > f(1e-8),
                           f(omega) / np.where(D != 0, D, f(1)), f(0))
            s_wwx[par] = wx0
            tx0 = wx0 * (cdx - np.where(lane, cphi[..., sr] - cphi, f(0)))
            ty1 = wy1 * (dy1 - (cphi - phi1 if row1 else f(0)))
            rk1 = ((tx1 - s_tx[par ^ 1][..., sl]) + ty1) - ty2
            d1 = rk1 * di1
            s_tx[par] = tx0
            qx1 = wx1 * (d1[..., sr] - d1)
            qy2 = wy2 * (d1 - d2)
            q = ((qx2 - s_qx[par ^ 1][..., sl]) + qy2) - qy3
            s_qx[par] = qx1
            rv = rk2 - q
            i = k - 2
            if i >= r0:
                outs[0][:, i, jo] = rv[:, out_col]
                outs[1][:, i, jo] = d2[:, out_col]
                outs[2][i, jo] = di2[out_col]
                hits[i, jo] += 1
                acc = rv if grp == 0 else acc + rv
                if grp == cr - 1:
                    outs[3][:, orow, jo] = (acc / f(cr))[:, out_col]
                    rhits[orow, jo] += 1
                grp += 1
                if grp == cr:
                    grp, orow = 0, orow + 1
            qx2, qy3, rk2, d2, ty2, tx1 = qx1, qy2, rk1, d1, ty1, tx0
            phi1, dy1 = cphi, cdy
            WW1, wx1, wy2, di2 = WW, wx0, wy1, di1
    return outs, hits, rhits


@pytest.mark.parametrize("B,n,m,cr,sms", [(2, 48, 384, 4, 1),
                                          (1, 16, 32, 16, 132),
                                          (3, 64, 160, 2, 3),
                                          (2, 32, 96, 1, 132),
                                          (2, 48, 288, 8, 2)])
def test_presmooth_strip_schedule(B, n, m, cr, sms):
    """The presmooth kernel's column strips with their rolling rows,
    emulated in numpy at sizes that give partial column tiles and row
    strips, interior and edge tiles, several coarse factors and batch
    sizes: every output pixel (and rrow row) is written exactly once,
    bit for bit the whole-plane form of the same float32 operations,
    which lies within the kernel test's 1e-5 of the twin."""
    rng = np.random.default_rng(n + m + cr)
    phi, dxc, dyc = (rng.normal(size=(B, n, m)).astype(np.float32)
                     for _ in range(3))
    w = rng.uniform(0.05, 1.0, size=(n, m)).astype(np.float32)
    w[:2] = 1e-6
    outs, hits, rhits = _presmooth_strips(phi, dxc, dyc, w, cr, 0.8, sms)
    assert (hits == 1).all() and (rhits == 1).all()
    want = _presmooth_np(phi, dxc, dyc, w, cr, 0.8)
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got, ref)
    twin = tvc.presmooth_plain(*(torch.from_numpy(a) for a in
                                 (phi, dxc, dyc, w)), cr, 0.8)
    for ref, t in zip(want, twin):
        _close(ref, t.numpy(), 1e-5)


@pytest.mark.parametrize("B", [1, 2, 3, 5])
def test_presmooth_tiling_and_traffic(B):
    """presmooth_tiling's grid covers the plane with row strips of a
    multiple of 16 rows that fill the card in one wave (an H100's 132
    SMs at the bench's 4096^2, config 3's 2048^2 and a small plane),
    and presmooth_traffic counts each input read about once: within
    12% of one read at the two large sizes (w once a launch of up to
    PRESMOOTH_PLANES planes, so more often at B = 3 and 5)."""
    for n, m in ((4096, 4096), (2048, 2048), (48, 96)):
        rows, (tiles, strips) = tvc.presmooth_tiling(n, m, 132)
        assert rows % 16 == 0 and (strips - 1) * rows < n <= strips * rows
        assert tiles * tvc.PRESMOOTH_TILE >= m
        assert tiles * strips <= 132 * tvc.PRESMOOTH_BLOCKS_PER_SM or \
            rows == 16
        launches = -(-B // tvc.PRESMOOTH_PLANES)
        once = 4 * ((3 * B + launches) * n * m + (2 * B + 1) * n * m
                    + B * (n // 4) * m)
        ratio = tvc.presmooth_traffic(B, n, m, 4, 132) / once
        assert ratio >= 1.0
        if n >= 2048:
            assert ratio < 1.12


def _applyq_strips(p, w, sms):
    """csrc/vcycle.cu applyq_strip_kernel's schedule in numpy float32,
    every warp of a row strip side by side: warp (tile t, strip s) owns
    columns t * APPLYQ_COLS + [0, APPLYQ_COLS) (loaded wrapped), lane 0
    and lane 31 one halo column each (left and right of the tile); the
    lanes' x neighbours, passed by shuffles, are the next and previous
    columns of the tile. Step k loads row k (wrapped) of w and of each of
    up to PRESMOOTH_PLANES planes a launch and writes row k - 1. Returns
    q (NaN where never written), how often each output was written and
    the elements loaded."""
    f = np.float32
    B, n, m = p.shape
    C = tvc.APPLYQ_COLS
    rows, (tiles, strips) = tvc.applyq_tiling(n, m, sms)
    j0 = np.arange(tiles) * C
    c = j0[:, None] + np.arange(C)[None, :]
    cw = c % m
    hl = np.where(j0 > 0, j0 - 1, m - 1)
    hr = (j0 + C) % m
    q = np.full((B, n, m), np.nan, f)
    hits = np.zeros((B, n, m), int)
    loads = 0
    for b0 in range(0, B, tvc.PRESMOOTH_PLANES):
        pb = p[b0:b0 + tvc.PRESMOOTH_PLANES]
        for s in range(strips):
            r0, r1 = s * rows, min(s * rows + rows, n)
            ty2 = np.zeros((len(pb), tiles, C), f)
            for k in range(r0 - 1, r1 + 1):
                gk = k % n
                WWc, pc = w[gk][cw] * w[gk][cw], pb[:, gk][:, cw]
                hwc = (w[gk][hl] * w[gk][hl], w[gk][hr] * w[gk][hr])
                hpc = (pb[:, gk][:, hl], pb[:, gk][:, hr])
                loads += (1 + len(pb)) * tiles * (C + 2)
                if k >= r0:
                    rowy = (k - 1) % n != n - 1
                    wy = np.minimum(WW1, WWc) if rowy else np.zeros_like(WWc)
                    ty1 = wy * (pc - p1)
                    if k - 1 >= r0:
                        WWr = np.concatenate([WW1[:, 1:], hw1[1][:, None]],
                                             -1)
                        pr = np.concatenate([p1[..., 1:], hp1[1][..., None]],
                                            -1)
                        wx = np.where(c < m - 1, np.minimum(WW1, WWr), f(0))
                        tx = wx * (pr - p1)
                        wxh = np.where(j0 > 0, np.minimum(hw1[0], WW1[:, 0]),
                                       f(0))
                        txh = wxh * (p1[..., 0] - hp1[0])
                        txl = np.concatenate([txh[..., None], tx[..., :-1]],
                                             -1)
                        qv = ((tx - txl) + ty1) - ty2
                        on = c < m
                        for b in range(len(pb)):
                            q[b0 + b, k - 1, c[on]] = qv[b][on]
                            hits[b0 + b, k - 1, c[on]] += 1
                    ty2 = ty1
                WW1, p1, hw1, hp1 = WWc, pc, hwc, hpc
    return q, hits, loads


@pytest.mark.parametrize("B,n,m,sms", [(2, 64, 256, 1), (1, 48, 90, 132),
                                       (3, 40, 300, 2), (2, 5, 7, 132),
                                       (1, 256, 256, 1), (3, 96, 130, 1)])
def test_applyq_strip_schedule(B, n, m, sms):
    """The applyq kernel's warps and row strips, emulated in numpy at
    sizes with several strips (a partial last one), edge tiles, an
    overhanging last column tile, m not a multiple of 4 and 1-3 planes
    (3: two launches, w read by each): every output pixel is written
    exactly once, bit for bit the twin's, and applyq_traffic counts the
    emulation's own loads."""
    rng = np.random.default_rng(n * m + B)
    p = rng.normal(size=(B, n, m)).astype(np.float32)
    w = rng.uniform(0.05, 1.0, size=(n, m)).astype(np.float32)
    w[:2] = w[:, -3:] = 1e-6
    q, hits, loads = _applyq_strips(p, w, sms)
    assert (hits == 1).all()
    twin = tvc.applyq_plain(torch.from_numpy(p), torch.from_numpy(w))
    np.testing.assert_array_equal(q, twin.numpy())
    assert tvc.applyq_traffic(B, n, m, sms) == 4 * (loads + B * n * m)


@pytest.mark.parametrize("B", [1, 2, 3])
def test_applyq_tiling_and_traffic(B):
    """applyq_tiling covers the plane with row strips of at least 16 rows
    that fill the card in one wave (an H100's 132 SMs at the bench's
    4096^2, config 3's 2048^2 and a small plane), and applyq_traffic
    counts each input read about once: within 10% of one read at the
    bench's (2, 4096^2) (w once a launch of up to PRESMOOTH_PLANES
    planes, so more often at B = 3)."""
    for n, m in ((4096, 4096), (2048, 2048), (48, 96)):
        rows, (tiles, strips) = tvc.applyq_tiling(n, m, 132)
        assert rows >= min(16, n) and (strips - 1) * rows < n <= strips * rows
        assert tiles * tvc.APPLYQ_COLS >= m
        assert -(-tiles * strips // tvc.APPLYQ_WARPS) <= \
            132 * tvc.APPLYQ_BLOCKS_PER_SM or rows == 16
        launches = -(-B // tvc.PRESMOOTH_PLANES)
        once = 4 * ((B + launches) * n * m + B * n * m)
        ratio = tvc.applyq_traffic(B, n, m, 132) / once
        assert ratio >= 1.0
        if (B, n) == (2, 4096):
            assert ratio <= 1.1
