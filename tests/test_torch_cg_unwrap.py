"""The early-stopping CG of pygpa_tpu_torch (ops.cg.cg_unwrap, its plain
twin cg_unwrap_plain and solvers.unwrap's routing) on the CPU against
pygpa_tpu.solvers.unwrap's loop (_cg_unwrap_body through _cg_unwrap,
vmapped over the planes), and the arithmetic of the kernel's stencil and
of its spectral r.z (csrc/cg_unwrap.cu) emulated in numpy. Inputs are
made with numpy from a seed; the kernel itself runs in
tests/test_torch_cuda.py on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.solvers.unwrap as JU
import pygpa_tpu_torch.solvers.unwrap as TU
from pygpa_tpu_torch.core.fourier import dct2n, idct2n
from pygpa_tpu_torch.ops import _build
from pygpa_tpu_torch.ops import cg as tcg
from pygpa_tpu_torch.ops import dct as tdct
from pygpa_tpu_torch.ops.vcycle import _q

from test_torch_unwrap import _close, _problem

torch.set_num_threads(2)
HIGHEST = jax.lax.Precision.HIGHEST


def _reference(rk, WWx, WWy, kmax, aligned):
    """pygpa_tpu's loop on every plane of rk (..., n, m); the weights
    broadcast to rk's leading axes first (the reference vmaps them)."""
    lead = rk.shape[:-2]
    flat = [np.broadcast_to(w, lead + w.shape[-2:]).reshape(
        (-1,) + w.shape[-2:]) for w in (WWx, WWy)]
    phi, k = jax.vmap(lambda r, x, y: JU._cg_unwrap(
        r, x, y, kmax, precision=HIGHEST, aligned=aligned))(
            jnp.asarray(rk.reshape((-1,) + rk.shape[-2:])),
            *map(jnp.asarray, flat))
    return np.asarray(phi).reshape(rk.shape), np.asarray(k).reshape(lead)


def _inputs(dx, dy, w, aligned):
    """(rk, WWx, WWy) of the port's residual in the layout asked for."""
    t = [None if a is None else torch.from_numpy(a) for a in (dx, dy, w)]
    if not aligned:
        return TU._residual(*t)
    dxp = torch.nn.functional.pad(t[0], (0, 1))
    dyp = torch.nn.functional.pad(t[1], (0, 0, 0, 1))
    return TU._residual_aligned(dxp, dyp, t[2])


def _stack(n, m, seed):
    """Three images of two components (3, 2, ...) with weights of their
    own (3, 1, n, m): image 0 uniform (the preconditioner is exact, so
    both planes stop by the norm after an iteration or two), image 1
    weighted (runs to kmax), image 2 weighted with its second component
    zero (that plane starts done, k 0)."""
    dx, dy, w = (np.stack(a) for a in zip(*[_problem(n, seed + i, m=m)
                                             for i in range(3)]))
    w[0] = 0.5
    dx[2, 1] = 0
    dy[2, 1] = 0
    return dx, dy, w[:, None]


@pytest.mark.parametrize("aligned", [False, True],
                         ids=["unaligned", "aligned"])
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-12)])
def test_twin_matches_reference_loop(dtype, rtol, aligned):
    """The two components of a weighted 128^2 problem, stopped by kmax
    10: the twin against the reference loop in both layouts."""
    dx, dy, w = (a.astype(dtype) for a in _problem(128, 3))
    rk, WWx, WWy = _inputs(dx, dy, w, aligned)
    got, kg = tcg.cg_unwrap_plain(rk, WWx, WWy, 10, aligned)
    want, kw = _reference(rk.numpy(), WWx.numpy(), WWy.numpy(), 10, aligned)
    assert got.dtype == rk.dtype and kg.dtype == torch.int32
    _close(got.numpy(), want, rtol)
    np.testing.assert_array_equal(kg.numpy(), kw)
    assert (kw == 10).all()


@pytest.mark.parametrize("aligned", [False, True],
                         ids=["unaligned", "aligned"])
def test_twin_stack_with_per_image_weights(aligned):
    """A (3, 2) stack at odd sides 250 x 374 with per-image weights:
    planes stop by the norm (image 0), by kmax (image 1) and at the
    start (image 2's zero component), each with the reference's k; the
    norms say why each stopped; the wrapper on the CPU is the twin."""
    dx, dy, w = _stack(250, 374, 11)
    rk, WWx, WWy = _inputs(dx, dy, w, aligned)
    assert WWx.shape[:2] == (3, 1)
    norms = torch.empty((3, 2, 2))
    got, kg = tcg.cg_unwrap_plain(rk, WWx, WWy, 12, aligned, norms=norms)
    want, kw = _reference(rk.numpy(), WWx.numpy(), WWy.numpy(), 12, aligned)
    np.testing.assert_array_equal(kg.numpy(), kw)
    assert (kw[0] < 12).all() and (kw[1] == 12).all()
    assert kw[2, 0] == 12 and kw[2, 1] == 0
    _close(got.numpy(), want, 1e-5)
    assert (got[2, 1] == 0).all()
    r, thr = norms[..., 0], norms[..., 1]
    assert (r[0] < thr[0]).all() and (r[1] >= thr[1]).all()
    assert r[2, 1] == 0 and thr[2, 1] == 0
    _build.launches.clear()
    again, ka = tcg.cg_unwrap(rk, WWx, WWy, 12, aligned)
    assert torch.equal(again, got) and torch.equal(ka, kg)
    assert sum(_build.launches.values()) == 0


def test_twin_on_the_paths_calls():
    """The solves phase_unwrap_prediff (128^2, unaligned) and the
    multigrid (256^2 at unwrap_coarse=4: its 64^2 levels, aligned) hand
    the early-stopping entry, captured, against the reference loop."""
    calls = []
    real = tcg.cg_unwrap

    def rec(*a):
        calls.append(a)
        return real(*a)

    dx, dy, w = _problem(128, 5)
    args = [torch.from_numpy(a) for a in (dx, dy, w)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcg, "cg_unwrap", rec)
        TU.phase_unwrap_prediff(*args, kmax=10)
        dx, dy, w = _problem(256, 6)
        TU.phase_unwrap_prediff_mg(*(torch.from_numpy(a)
                                     for a in (dx, dy, w)), kmax=6,
                                   coarse=4)
    assert [(tuple(a[0].shape), a[4]) for a in calls[:2]] == [
        ((2, 128, 128), False), ((2, 64, 64), True)]
    for rk, WWx, WWy, kmax, aligned in calls[:2]:
        got, kg = tcg.cg_unwrap_plain(rk, WWx, WWy, kmax, aligned)
        want, kw = _reference(rk.numpy(), WWx.numpy(), WWy.numpy(), kmax,
                              aligned)
        _close(got.numpy(), want, 1e-5)
        np.testing.assert_array_equal(kg.numpy(), kw)


@pytest.mark.parametrize("n,m", [(64, 64), (250, 374), (7, 2)])
def test_padded_stencil_is_the_unaligned_stencil(n, m):
    """The kernel's stencil (csrc/cg_unwrap.cu step_p) emulated in numpy
    float32 on the padded weights: with ALIGNED false it is
    apply_q_unaligned's bits, with ALIGNED true ops.vcycle._q's on the
    same padded weights; the two orders agree to rounding."""
    g = np.random.default_rng(n + m)
    f = np.float32
    p = g.normal(size=(2, n, m)).astype(f)
    WWx = g.uniform(0, 1, size=(n, m - 1)).astype(f)
    WWy = g.uniform(0, 1, size=(n - 1, m)).astype(f)
    Px, Py = (a.numpy() for a in tcg.aligned_weights(
        torch.from_numpy(WWx), torch.from_numpy(WWy)))
    assert Px.shape == Py.shape == (n, m)
    assert (Px[:, -1] == 0).all() and (Py[-1] == 0).all()
    tx = Px * (np.roll(p, -1, -1) - p)
    txl = np.roll(Px, 1, -1) * (p - np.roll(p, 1, -1))
    ty = Py * (np.roll(p, -1, -2) - p)
    tyu = np.roll(Py, 1, -2) * (p - np.roll(p, 1, -2))
    unaligned = (tx - txl) + (ty - tyu)
    aligned = ((tx - txl) + ty) - tyu
    want = tcg.apply_q_unaligned(torch.from_numpy(p), torch.from_numpy(WWx),
                                 torch.from_numpy(WWy)).numpy()
    np.testing.assert_array_equal(unaligned, want)
    np.testing.assert_array_equal(aligned, _q(
        torch.from_numpy(p), torch.from_numpy(Px),
        torch.from_numpy(Py)).numpy())
    np.testing.assert_allclose(aligned, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n,m", [(128, 256), (250, 374), (2, 3)])
def test_spectral_rz_is_the_direct_dot(n, m):
    """The other sides' route forms rz from the spectrum (eigen_rz in
    csrc/cg_unwrap.cu): sum w_k w_l y^2 / lambda / (4 n m) with y =
    dct2n(r) is <r, idct2n(y / lambda)>: float64 within 1e-12, and the
    kernel's float32 arithmetic emulated in numpy within 1e-5 of the
    direct dot taken in float64 with the same float32 eigenvalues."""
    g = np.random.default_rng(3 * n + m)
    r = g.normal(size=(2, n, m))
    # zero mean, as every residual (the [0, 0] term would cancel others)
    r = torch.from_numpy(r - r.mean((-2, -1), keepdims=True))
    scale = tcg.poisson_scale(n, m, torch.float64, "cpu")
    y = dct2n(r)
    zh = y / scale
    direct = (r * idct2n(zh)).sum((-2, -1))
    w = np.ones((n, m))
    w[0] *= 0.5
    w[:, 0] *= 0.5
    spec = (torch.from_numpy(w) * y * zh).sum((-2, -1)) / (4 * n * m)
    np.testing.assert_allclose(spec.numpy(), direct.numpy(), rtol=1e-12)
    f = np.float32
    y32 = dct2n(r.float()).numpy()
    s32 = tcg.poisson_scale(n, m, torch.float32, "cpu").numpy()
    z32 = np.where((np.arange(n)[:, None] == 0) & (np.arange(m) == 0), y32,
                   y32 / s32)
    acc = (w.astype(f) * y32 * z32).reshape(2, -1).sum(-1, dtype=f)
    got = acc * f(1.0 / (4.0 * n * m))
    # against the direct dot with the same float32 eigenvalues (their
    # rounding near the origin moves rz by ~1e-4 whichever way it is
    # formed, in the twin too)
    want = (r * idct2n(y / torch.from_numpy(s32).double())).sum((-2, -1))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5)


def test_gate_truth_table():
    """cg_unwrap_kernel_ok: float32, sides 2 ... 8192, at most 65535
    planes; the FFT route where each side is a power of two 128 ... 8192
    or an even side 130 ... 4094 (the chirp-z pass), in any pairing."""
    ok = TU.cg_unwrap_kernel_ok
    f32, f64 = torch.float32, torch.float64
    for shape in ((2, 4096, 4096), (2, 2048, 2048), (16, 2, 512, 512),
                  (2, 4086, 4086), (250, 374), (2, 2), (8192, 8192),
                  (65535, 2, 8)):
        assert ok(shape, f32), shape
        assert not ok(shape, f64), shape
    for shape in ((1, 64), (64, 1), (8193, 64), (2, 8192, 8194),
                  (65536, 2, 8), (0, 64, 64)):
        assert not ok(shape, f32), shape
    assert tcg.UNWRAP_FFT_SIDES == (128, 256, 512, 1024, 2048, 4096, 8192)
    for n, m in ((128, 128), (4096, 4096), (2048, 8192), (128, 1024),
                 (4086, 4086), (4096, 4086), (4086, 4096), (500, 500),
                 (250, 374), (384, 640), (130, 4094), (8192, 2050)):
        assert tcg.unwrap_fft_route(n, m), (n, m)
    for n, m in ((64, 64), (4087, 4086), (4086, 4087), (4098, 4096),
                 (8190, 8190), (126, 256), (256, 126), (125, 125)):
        assert not tcg.unwrap_fft_route(n, m), (n, m)


def test_pass_side_truth_table():
    """unwrap_pass_side: the powers of two 128 ... 8192 (Stockham) and the
    even sides 130 ... 4094 (chirp-z, whose L = 256 ... 4096 has a plan);
    not odd sides, sides under 128, or non-powers of two past 4094."""
    side = tcg.unwrap_pass_side
    yes = [128, 130, 250, 374, 500, 1022, 1026, 2046, 4086, 4094, 4096,
           8192, 6144 // 2, 2 * 1000]
    no = [2, 64, 96, 126, 127, 129, 131, 4085, 4087, 4095, 4098, 6144,
          8190, 8194, 16384]
    assert all(side(s) for s in yes), [s for s in yes if not side(s)]
    assert not any(side(s) for s in no), [s for s in no if side(s)]
    for s in range(130, 4096, 2):
        assert side(s)
        if s // 2 not in tdct.RADICES:
            assert tdct.czt_length(s) in tdct.RADICES


def test_route(monkeypatch):
    """solvers.unwrap._cg_unwrap: an aligned level cg_kernel_ok admits
    takes cg_poisson; every other solve without precond or rows within
    the gate takes the early-stopping entry (on the CPU its wrapper runs
    the twin); float64, shapes past the gate, precond and rows take the
    torch loop."""
    seen = []

    def spy(name):
        return lambda *a, **k: seen.append(name) or (None, None)

    monkeypatch.setattr(tcg, "cg_poisson", lambda *a: seen.append(
        "cg_poisson") or torch.zeros(a[0].shape))
    monkeypatch.setattr(tcg, "cg_unwrap", spy("cg_unwrap"))
    monkeypatch.setattr(tcg, "cg_unwrap_plain", spy("loop"))

    def route(shape, dtype=torch.float32, aligned=False, **kw):
        seen.clear()
        z = torch.zeros(shape, dtype=dtype)
        TU._cg_unwrap(z, z, z, 6, aligned, **kw)
        return seen[0]

    assert route((2, 256, 256), aligned=True) == "cg_poisson"
    assert route((2, 256, 256)) == "cg_unwrap"
    assert route((2, 2048, 2048), aligned=True) == "cg_unwrap"
    assert route((2, 144, 144), aligned=True) == "cg_unwrap"
    assert route((2, 250, 374)) == "cg_unwrap"
    assert route((2, 256, 256), torch.float64, aligned=True) == "loop"
    assert route((2, 250, 374), torch.float64) == "loop"
    assert route((1, 9000)) == "loop"
    assert route((2, 256, 256), aligned=True,
                 precond=lambda r: r) == "loop"
    assert route((2, 256, 256), aligned=True, rows=object()) == "loop"
    assert route((2, 512, 512), precond=lambda r: r) == "loop"


def test_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor CUDA raises (no silent twin)."""
    z = torch.zeros((2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tcg.cg_unwrap(z, z[..., :-1], z[..., :-1, :], 3)
