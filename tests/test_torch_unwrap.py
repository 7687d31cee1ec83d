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
