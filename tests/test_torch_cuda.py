"""The CUDA kernels of pygpa_tpu_torch against their plain twins, on the
card, at shapes the bench does not use (odd aspect ratios, other coarse
factors and iteration counts, the 8192^2 window and DCT length; for the
warp, drizzle and expand kernels sides off every tile multiple, 1-D,
sawtooth and far-outside coordinates, cval != 0, cells near 512^2 and
of odd size, z2 = 2, u given, all-NaN images), and the unwrap's and
the undistortion's routes on the card. Marked `cuda`; each test skips
without a CUDA device. JAX is not needed, so on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from pygpa_tpu_torch.gpa.pipeline import candidate_banks
from pygpa_tpu_torch.lattices import generate_ks, hexlattice_gen
from pygpa_tpu_torch.ops import _build
from pygpa_tpu_torch.ops import cg as tcg
from pygpa_tpu_torch.ops import sweep as tsweep
from pygpa_tpu_torch.ops import vcycle as tvc
from pygpa_tpu_torch.ops import wfr as twfr

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc "
                    "for sm_90a and run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _planes(shape, seed, dev):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.normal(size=shape).astype(np.float32)).to(dev)


def _weight(n, m, seed, dev):
    g = np.random.default_rng(seed)
    w = g.uniform(0.05, 1.0, size=(n, m))
    w[:8] = w[-8:] = w[:, :8] = w[:, -8:] = 1e-6
    return torch.from_numpy(w.astype(np.float32)).to(dev)


def _presmooth_np(phi, dxc, dyc, w, cr, omega):
    """The presmooth kernel's operations on whole planes in numpy
    float32 (correctly rounded division, as __fdiv_rn; rrow summed
    row after row, as the kernel does)."""
    f = np.float32
    B, n, m = phi.shape
    lane = np.arange(m)[None, :] < m - 1
    row = np.arange(n)[:, None] != n - 1
    WW = w * w
    WWx = np.where(lane, np.fmin(WW, np.roll(WW, -1, -1)), f(0))
    WWy = np.where(row, np.fmin(WW, np.roll(WW, -1, -2)), f(0))
    tx = WWx * (dxc - np.where(lane, np.roll(phi, -1, -1) - phi, f(0)))
    ty = WWy * (dyc - np.where(row, np.roll(phi, -1, -2) - phi, f(0)))
    rk = ((tx - np.roll(tx, 1, -1)) + ty) - np.roll(ty, 1, -2)
    D = -(((WWx + np.roll(WWx, 1, -1)) + WWy) + np.roll(WWy, 1, -2))
    dinv = np.where(np.abs(D) > f(1e-8),
                    f(omega) / np.where(D != 0, D, f(1)), f(0)).astype(f)
    d = rk * dinv
    qx = WWx * (np.roll(d, -1, -1) - d)
    qy = WWy * (np.roll(d, -1, -2) - d)
    r = rk - (((qx - np.roll(qx, 1, -1)) + qy) - np.roll(qy, 1, -2))
    g = r.reshape(B, n // cr, cr, m)
    acc = g[:, :, 0]
    for q in range(1, cr):
        acc = acc + g[:, :, q]
    return r, d, dinv, acc / f(cr)



@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("cr", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n,m", [(16, 32), (48, 96), (16, 96), (48, 32)])
def test_presmooth_strip_kernel(dev, n, m, cr, B):
    """The strip-marching presmooth kernel on planes narrower than one
    column tile and shorter than one row strip (every column wraps, every
    tile is an edge tile), at every coarse factor and 1-3 batch planes:
    against its twin (normwise 1e-5), bit for bit against the numpy
    whole-plane form of its float32 operations, and against a repeat."""
    phi, dxc, dyc = (_planes((B, n, m), s, dev) for s in (51, 52, 53))
    g = np.random.default_rng(54)
    w = torch.from_numpy(g.uniform(0.05, 1.0, size=(n, m)).astype(
        np.float32)).to(dev)
    _check_presmooth(phi, dxc, dyc, w, cr)


@pytest.mark.parametrize("B,n,m", [(2, 4096, 4096), (2, 2048, 2048),
                                   (5, 256, 384), (2, 1024, 160)])
def test_presmooth_strip_kernel_at_the_paths_shapes(dev, B, n, m):
    """The bench's (2, 4096^2) and config 3's (2, 2048^2) at cr = 4, five
    planes (three launches of at most two, w read by each) and a plane
    of several row strips and an interior column tile, as
    test_presmooth_strip_kernel checks them."""
    phi, dxc, dyc = (_planes((B, n, m), s, dev) for s in (55, 56, 57))
    _check_presmooth(phi, dxc, dyc, _weight(n, m, 58, dev), 4)


def _check_presmooth(phi, dxc, dyc, w, cr):
    before = _build.launches["presmooth"]
    got = tvc.presmooth(phi, dxc, dyc, w, cr, 0.8)
    again = tvc.presmooth(phi, dxc, dyc, w, cr, 0.8)
    assert _build.launches["presmooth"] == before + 2
    want = tvc.presmooth_plain(phi, dxc, dyc, w, cr, 0.8)
    ref = _presmooth_np(*(t.cpu().numpy() for t in (phi, dxc, dyc, w)), cr,
                        0.8)
    for g, a, t, r in zip(got, again, want, ref):
        assert g.shape == t.shape and torch.equal(g, a)
        assert _rel(g, t) <= 1e-5
        np.testing.assert_array_equal(g.cpu().numpy(), r)


@pytest.mark.parametrize("n,m,cr", [(256, 384, 4), (128, 96, 2),
                                    (64, 64, 16)])
def test_presmooth_and_applyq_kernels(dev, n, m, cr):
    phi, dxc, dyc = (_planes((2, n, m), s, dev) for s in (1, 2, 3))
    w = _weight(n, m, 4, dev)
    before = _build.launches["presmooth"]
    got = tvc.presmooth(phi, dxc, dyc, w, cr, 0.8)
    want = tvc.presmooth_plain(phi, dxc, dyc, w, cr, 0.8)
    assert _build.launches["presmooth"] == before + 1
    for g, t in zip(got, want):
        assert g.shape == t.shape and _rel(g, t) <= 1e-5
    _check_applyq(phi, w)


def _check_applyq(p, w):
    """The applyq kernel bit for bit against its twin and against a
    repeat (the same _rn chain for every pixel, whatever the tiling)."""
    before = _build.launches["applyq"]
    q = tvc.applyq(p, w)
    again = tvc.applyq(p, w)
    assert _build.launches["applyq"] == before + 2
    want = tvc.applyq_plain(p, w)
    assert q.shape == want.shape
    assert torch.equal(q, want) and torch.equal(q, again)


@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("n,m,offset", [(128, 96, 0), (64, 64, 0),
                                        (48, 90, 0), (5, 7, 0),
                                        (200, 300, 0), (64, 256, 1),
                                        (2048, 2048, 0), (4096, 4096, 0)])
def test_applyq_strip_kernel(dev, B, n, m, offset):
    """The strip-marching applyq kernel at 1-3 planes (3: two launches),
    on planes narrower than a warp's column tile, with m off a multiple
    of 4 (scalar loads), p starting off a 16-byte boundary (scalar loads
    though m % 4 == 0) and at config 3's and the bench's sides."""
    flat = _planes((B * n * m + offset,), 61, dev)
    p = flat[offset:].view(B, n, m)
    _check_applyq(p, _weight(n, m, 62, dev))


def _check_cg(dev, B, n, m, kmax):
    """The CG kernel against its twin (normwise 1e-4) and against itself
    (fixed-order reductions: a second run repeats bit for bit)."""
    from pygpa_tpu_torch.solvers.unwrap import _residual_aligned
    dxp, dyp = _planes((B, n, m), 5, dev), _planes((B, n, m), 6, dev)
    dxp[..., -1] = 0
    dyp[..., -1, :] = 0
    rk, WWx, WWy = _residual_aligned(dxp, dyp, _weight(n, m, 7, dev))
    before = _build.launches["cg_poisson"]
    got = tcg.cg_poisson(rk, WWx, WWy, kmax)
    assert _build.launches["cg_poisson"] == before + 1
    want = tcg.cg_poisson_plain(rk, WWx, WWy, kmax)
    assert torch.isfinite(got).all() and _rel(got, want) <= 1e-4
    assert torch.equal(got, tcg.cg_poisson(rk, WWx, WWy, kmax))


@pytest.mark.parametrize("n,m,kmax", [(256, 128, 6), (128, 384, 1)])
def test_cg_kernel(dev, n, m, kmax):
    """(256, 128) on the FFT route, (128, 384) on the dense route."""
    assert tcg.fft_route(n, m) == (m != 384)
    _check_cg(dev, 2, n, m, kmax)


@pytest.mark.parametrize("B,n,m,kmax", [(2, 1024, 1024, 6),
                                        (1, 512, 512, 10),
                                        (2, 384, 640, 4)])
def test_cg_kernel_at_the_paths_shapes(dev, B, n, m, kmax):
    """The bench's coarse solve and config 3's (FFT route), and a side
    pair no Stockham plan covers (dense route)."""
    assert tcg.fft_route(n, m) == (n != 384)
    _check_cg(dev, B, n, m, kmax)


def test_sweep_kernel(dev):
    size, r_k, theta = 256, 0.1, 7.0
    ks = generate_ks(r_k, theta)[:3]
    img = hexlattice_gen(r_k, theta, size=size, device=dev)
    img = img - img.mean()
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    plan = twfr.plan_sweep(img.shape, candidate_banks(ks), sigma,
                           2 * sigma, ks, gauss_cut=7.0)
    sw = twfr.GroupedSweep(plan, device=dev)
    Sr4, Si4 = sw.windows(img)
    args = (Sr4, Si4, sw.gx, sw.gy, sw.A0c, sw.A0s, sw.A1cb, sw.A1sb,
            sw.run, sw.off, sw.kconst, plan.dr, sw.banded)
    ux, uy, wn = tsweep.sweep_uv(*args)
    px, py, pn = tsweep.sweep_uv_plain(*args)
    assert torch.isfinite(ux).all() and torch.isfinite(uy).all()
    assert (ux[:, :, 0] == 0).all() and (uy[:, 0, :] == 0).all()
    dx = (ux - px)[:, :, 1:].abs().cpu().numpy()
    dy = (uy - py)[:, 1:, :].abs().cpu().numpy()
    assert np.percentile(dx, 99) < 1e-3 and np.percentile(dy, 99) < 1e-3
    assert float(((wn - pn).abs() / (pn.abs() + 1e-9)).max()) < 5e-3


@pytest.mark.parametrize("n,m,batch", [(1024, 80, 2), (2048, 97, 2),
                                        (4096, 160, 2), (8192, 96, 3)])
def test_dct_kernels(dev, n, m, batch):
    """Both DCT kernels, forward and inverse, against the float32 FFT
    twins: normwise relative error <= 1e-5 (three rows, fewer than a
    lane block holds; rows one float off the 16-byte grid; column counts
    that leave a ragged strip)."""
    from pygpa_tpu_torch.ops import dct as tdct
    x = _planes((3, n), 11, dev)
    before = _build.launches["dct_lane"]
    for fn, twin in ((tdct.dct_lane, tdct.dct_lane_plain),
                     (tdct.idct_lane, tdct.idct_lane_plain)):
        assert _rel(fn(x), twin(x)) <= 1e-5
    assert _build.launches["dct_lane"] == before + 2
    x2 = _planes((batch, n, m), 12, dev)
    for fn, twin in ((tdct.dct_sub, tdct.dct_sub_plain),
                     (tdct.idct_sub, tdct.idct_sub_plain)):
        assert _rel(fn(x2), twin(x2)) <= 1e-5
    # a row that starts off the 16-byte grid goes through the lane kernel
    xs = x.flatten()[1:1 + 2 * n].reshape(2, n)
    assert _rel(tdct.dct_lane(xs), tdct.dct_lane_plain(xs)) <= 1e-5
    # each kernel's inverse gives its forward's input back
    assert _rel(tdct.idct_lane(tdct.dct_lane(x)), x) <= 1e-5
    assert _rel(tdct.idct_sub(tdct.dct_sub(x2)), x2) <= 1e-5


def _zoom_ops(P, W0, W1, n, m, seed, dev):
    g = np.random.default_rng(seed)
    shapes = [(W0, W1), (W0, W1), (P, W0), (P, W1), (n, W0), (n, W0),
              (m, W1), (m, W1)]
    ops = [g.normal(size=s) for s in shapes]
    ops[2] = g.uniform(0.2, 1.0, size=(P, W0))
    ops[3] = g.uniform(0.2, 1.0, size=(P, W1))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in ops]


def test_zoom_sweep_kernel_wide_window(dev):
    """P = 49 candidates (past the reference's 48-candidate chunk) and
    W1 = 512 (the 8192^2 window): kernel against twin with
    chip_smoke.py's flip-tolerant bounds; candidates 10 and 48 are
    identical, so 48 never wins (strict '>' across the reference's
    chunk boundary)."""
    from pygpa_tpu_torch.ops import zoom_sweep as tz
    ops = _zoom_ops(49, 64, 512, 256, 512, 13, dev)
    ops[2][48] = ops[2][10]
    ops[3][48] = ops[3][10]
    got = tz.zoom_sweep(*ops, dr=20)
    want = tz.zoom_sweep_plain(*ops, dr=20)
    same = got[3] == want[3]
    assert float(same.float().mean()) > 0.99
    assert not (got[3] == 48).any() and (got[3] == 10).any()
    assert torch.allclose(got[0][same], want[0][same], rtol=1e-4)
    scale = float(want[0].max().sqrt())
    for k in (1, 2):
        assert float((got[k] - want[k])[same].abs().max()) <= 1e-3 * scale
    assert torch.allclose(got[4][same], want[4][same], atol=1e-5)
    assert torch.allclose(got[5][same], want[5][same], rtol=1e-5, atol=1e-5)


def _zoom_agree(got, want, phase_weight=True):
    """chip_smoke.py check_zoom's bounds: winners agree on > 99%; where
    they agree |M|^2 within rtol 1e-4 (atol 1e-7 of its max), Re/Im
    within 1e-3 of max |M|, and when `phase_weight` the phase within
    1e-5 rad where |M|^2 >= 1e-6 of its max and the weight within rtol
    1e-5 (atol 1e-6)."""
    same = got[3] == want[3]
    assert float(same.float().mean()) > 0.99
    amax = float(want[0].max())
    d = [(g - w).abs() for g, w in zip(got, want)]
    assert float((d[0] - 1e-4 * want[0].abs())[same].max()) <= 1e-7 * amax
    for k in (1, 2):
        assert float(d[k][same].max()) <= 1e-3 * amax ** 0.5
    if phase_weight:
        live = same & (want[0] >= 1e-6 * amax)
        dph = torch.remainder(got[4] - want[4] + np.pi, 2 * np.pi) - np.pi
        assert float(dph.abs()[live].max()) <= 1e-5
        assert float((d[5] - 1e-5 * want[5].abs())[same].max()) <= 1e-6


def _zoom_float64(ops):
    """Every candidate's M (P, n, m), complex128, from the float32
    operands computed in float64."""
    Sr, Si, gx, gy, A0c, A0s, A1c, A1s = (o.double() for o in ops)
    g = gx[:, :, None] * gy[:, None, :]
    Tr = A0c @ (g * Sr) - A0s @ (g * Si)
    Ti = A0c @ (g * Si) + A0s @ (g * Sr)
    return torch.complex(Tr @ A1c.T - Ti @ A1s.T, Tr @ A1s.T + Ti @ A1c.T)


@pytest.mark.parametrize("P", [1, 49])
@pytest.mark.parametrize("W1", [64, 128, 256, 512])
def test_zoom_sweep_tensor_core_kernel(dev, W1, P):
    """The 3xTF32 stage 2 against the twin at every window width from 64
    to 512 (8192^2), with one candidate and with 49 (past the
    reference's 48-candidate chunk), on a 128 x 192 frame, at
    check_zoom's bounds; with P = 49, candidates 7 and 30 are identical,
    so they tie wherever they lead and 30 never wins. With one candidate
    no tournament lifts |M| off zero, and where |M| is 1e-3 of its
    maximum even the float32 twin's phase is ~4e-5 rad from a float64
    product, so the phase and the weight are held through M instead:
    against the float64 product, the kernel's rms error in M stays
    within 1e-5 of the rms of M (the weight's rtol), at every P."""
    from pygpa_tpu_torch.ops import zoom_sweep as tz
    ops = _zoom_ops(P, 64, W1, 128, 192, 30 + W1 + P, dev)
    if P > 1:
        ops[2][30] = ops[2][7]
        ops[3][30] = ops[3][7]
    before = _build.launches["zoom_sweep"]
    got = tz.zoom_sweep(*ops, dr=10)
    want = tz.zoom_sweep_plain(*ops, dr=10)
    assert _build.launches["zoom_sweep"] == before + 1
    assert got[3].dtype == torch.int32
    assert all(bool(torch.isfinite(g).all()) for g in got[:3])
    _zoom_agree(got, want, phase_weight=P > 1)
    if P > 1:
        assert not (got[3] == 30).any() and (got[3] == 7).any()
    M64 = _zoom_float64(ops)

    ref = M64.gather(0, got[3].long()[None])[0]
    err = torch.complex(got[1].double(), got[2].double()) - ref
    rel = float(err.abs().pow(2).mean().sqrt() / ref.abs().pow(2).mean()
                .sqrt())
    assert rel <= 1e-5, rel


def test_zoom_sweep_kernel_zero_window_and_refusals(dev):
    """An all-zero window: every |M|^2 is 0, so every pixel keeps index
    0 and M = 0 (strict '>' from a zero start), phase 0 and weight 0. A
    window width off the multiple of 64 is refused."""
    from pygpa_tpu_torch.ops import zoom_sweep as tz
    ops = _zoom_ops(5, 64, 64, 64, 128, 3, dev)
    ops[0].zero_()
    ops[1].zero_()
    got = tz.zoom_sweep(*ops, dr=4)
    for g in got:
        assert not g.any()
    with pytest.raises(ValueError, match="multiples of 64"):
        tz.zoom_sweep(*_zoom_ops(2, 64, 96, 64, 64, 4, dev))


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("n,m", [(300, 517), (97, 1030)])
def test_bilinear_plane_stack_kernel(dev, n, m, C):
    """The bilinear kernel on a stack (C, n, m) in one launch, against
    the stack twin (within 1e-6 of the image's maximum: the same float32
    operations in the same order) and against one launch per plane (bit
    for bit), in both modes with cval != 0, at sides off every multiple
    of 32, for smooth, sawtooth and far-outside positions."""
    from pygpa_tpu_torch.ops import warp as tw
    stack = _planes((C, n, m), 40 + C, dev)
    for kind in ("smooth", "sawtooth", "far"):
        c = _warp_coords(kind, n, m, dev)
        for mode in tw.MODES:
            before = _build.launches["warp_bilinear"]
            got = tw.warp_bilinear(stack, c[0], c[1], mode, -2.5)
            assert _build.launches["warp_bilinear"] == before + 1
            want = tw.warp_bilinear_plain(stack, c[0], c[1], mode, -2.5)
            assert got.shape == (C,) + c.shape[1:]
            assert float((got - want).abs().max()) <= 1e-6 * float(
                stack.abs().max()), (kind, mode)
            for k in range(C):
                assert torch.equal(got[k], tw.warp_bilinear(
                    stack[k], c[0], c[1], mode, -2.5))


def test_bilinear_wrapper_refuses(dev):
    """Inputs the bilinear kernel does not take raise before a launch:
    a wrong dtype, a non-contiguous image or coordinate plane, C = 5,
    coordinate planes of two shapes or on two devices, an unknown
    mode."""
    from pygpa_tpu_torch.ops import warp as tw
    img = _planes((2, 64, 96), 5, dev)
    c = _warp_coords("smooth", 64, 96, dev)
    bad = [((img.double(), c[0], c[1]), {}),
           ((img, c[0].double(), c[1]), {}),
           ((img[:, :, ::2], c[0], c[1]), {}),
           ((img, c[0].t(), c[1].t()), {}),
           ((_planes((5, 64, 96), 6, dev), c[0], c[1]), {}),
           ((img, c[0], c[1][:, :10]), {}),
           ((img, c[0].cpu(), c[1]), {}),
           ((img, c[0], c[1]), {"mode": "wrap"})]
    before = _build.launches["warp_bilinear"]
    for args, kw in bad:
        with pytest.raises(ValueError):
            tw.warp_bilinear(*args, **kw)
    assert _build.launches["warp_bilinear"] == before


def test_map_coordinates_bilinear_takes_views(dev):
    """The public bilinear routes take views: map_coordinates(order=1)
    of a cropped image at coordinates that are a transposed view, and
    the plane-stack route on a cropped stack, launch the kernel once each
    and give, bit for bit, the kernel's result on contiguous copies of
    the same values (and the twin's within 1e-6 of the image's max)."""
    from pygpa_tpu_torch.core import interp as ti
    from pygpa_tpu_torch.ops import warp as tw
    big = _planes((2, 160, 200), 9, dev)
    c = torch.empty((2, 140, 100), device=dev).transpose(1, 2)
    c.copy_(_warp_coords("smooth", 100, 140, dev))
    img, stack = big[0, 20:120, 30:170], big[:, 20:120, 30:170]
    assert not (img.is_contiguous() or stack.is_contiguous()
                or c.is_contiguous())
    for mode in tw.MODES:
        before = _build.launches["warp_bilinear"]
        got = ti.map_coordinates(img, c, order=1, mode=mode)
        got_stack = ti._map_coordinates_stack(stack, c, 1, mode)
        assert _build.launches["warp_bilinear"] == before + 2
        cc = c.contiguous()
        assert torch.equal(got, tw.warp_bilinear(img.contiguous(), cc[0],
                                                 cc[1], mode))
        assert torch.equal(got_stack, tw.warp_bilinear(
            stack.contiguous(), cc[0], cc[1], mode))
        want = tw.warp_bilinear_plain(stack, c[0], c[1], mode)
        assert float((got_stack - want).abs().max()) <= 1e-6 * float(
            stack.abs().max())


def test_multigrid_1152_runs_early_stopping_levels(dev):
    """1152^2 with unwrap_coarse=4: the 288^2 coarse level (not a
    multiple of 128) takes the early-stopping loop on the card, as the
    reference routes it; the V-branch kernels still run. Matches the CPU
    run within 1e-4."""
    from pygpa_tpu_torch.solvers.unwrap import phase_unwrap_prediff_mg
    g = np.random.default_rng(17)
    n = 1152
    x = np.linspace(-1, 1, n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    psi = np.stack([3 * np.exp(-(X ** 2 + 2 * Y ** 2) / 0.3) + X * Y,
                    2 * np.sin(2 * X + Y)])
    dx = (np.diff(psi, axis=-1) + 0.01 * g.normal(size=(2, n, n - 1)))
    dy = (np.diff(psi, axis=-2) + 0.01 * g.normal(size=(2, n - 1, n)))
    w = 0.2 + np.exp(-(X ** 2 + Y ** 2))
    w[:64] = w[-64:] = w[:, :64] = w[:, -64:] = 1e-6
    args = [torch.from_numpy(a.astype(np.float32)) for a in (dx, dy, w)]
    want = phase_unwrap_prediff_mg(*args, kmax=6, coarse=4)
    _build.launches.clear()
    got = phase_unwrap_prediff_mg(*(a.to(dev) for a in args), kmax=6,
                                  coarse=4)
    assert _build.launches["cg_poisson"] == 0
    assert _build.launches["presmooth"] == 1
    assert _rel(got.cpu(), want) <= 1e-4


def test_exact_cg_through_the_dct_kernels(dev, monkeypatch):
    """The exact CG at 4096^2 on the card as the torch loop (the
    early-stopping kernel's gate turned off) with its preconditioner on
    the DCT kernels, against the same solve on the FFT twins (also on the
    card): relative 1e-4, the same iteration counts."""
    from pygpa_tpu_torch.core import fourier as tf
    from pygpa_tpu_torch.solvers import unwrap as tu
    n = 4096
    g = np.random.default_rng(19)
    dx = torch.from_numpy(g.normal(size=(2, n, n - 1)).astype(np.float32))
    dy = torch.from_numpy(g.normal(size=(2, n - 1, n)).astype(np.float32))
    w = torch.from_numpy(g.uniform(0.1, 1.0, size=(n, n)).astype(np.float32))
    dx, dy, w = dx.to(dev), dy.to(dev), w.to(dev)
    monkeypatch.setattr(tu, "cg_unwrap_kernel_ok", lambda *a: False)
    _build.launches.clear()
    got, kg = tu.phase_unwrap_prediff(dx, dy, w, kmax=5, return_iters=True)
    assert _build.launches["dct_lane"] == 10
    assert _build.launches["dct_sub"] == 10
    monkeypatch.setattr(tf, "dct_kernel_ok", lambda n, dtype: False)
    want, kw = tu.phase_unwrap_prediff(dx, dy, w, kmax=5, return_iters=True)
    assert torch.equal(kg, kw)
    assert _rel(got, want) <= 1e-4


def test_exact_cg_through_the_unwrap_kernel(dev):
    """The exact CG at 4096^2 on the card takes the early-stopping kernel
    (one cg_unwrap launch, its own DCT passes: no dct_lane or dct_sub
    launch), within 1e-4 of the torch loop on the DCT kernels, with the
    same iteration counts."""
    from pygpa_tpu_torch.solvers import unwrap as tu
    n = 4096
    g = np.random.default_rng(19)
    dx = torch.from_numpy(g.normal(size=(2, n, n - 1)).astype(np.float32))
    dy = torch.from_numpy(g.normal(size=(2, n - 1, n)).astype(np.float32))
    w = torch.from_numpy(g.uniform(0.1, 1.0, size=(n, n)).astype(np.float32))
    dx, dy, w = dx.to(dev), dy.to(dev), w.to(dev)
    _build.launches.clear()
    got, kg = tu.phase_unwrap_prediff(dx, dy, w, kmax=5, return_iters=True)
    assert _build.launches["cg_unwrap"] == 1
    assert _build.launches["dct_lane"] == _build.launches["dct_sub"] == 0
    rk, WWx, WWy = tu._residual(tu.wrap_to_pi(dx), tu.wrap_to_pi(dy), w)
    want, kw = tcg.cg_unwrap_plain(rk, WWx, WWy, 5, False)
    assert torch.equal(kg, kw)
    assert _rel(got, want) <= 1e-4


def _unwrap_problem(lead, n, m, aligned, seed, dev, per_image=False):
    """rk, WWx, WWy of the exact path's residual (unaligned) or the
    multigrid's (aligned) from random gradients (lead + (n, m)) and a
    weight with a 1e-6 rim: one (n, m) weight, or (per_image) one per
    image (B, 1, n, m) of a (B, 2) stack, image 0's uniform (its planes
    stop by the norm) and the last image's second plane zero (done at
    the start)."""
    from pygpa_tpu_torch.solvers import unwrap as tu
    dx = _planes(lead + (n, m), seed, dev)
    dy = _planes(lead + (n, m), seed + 1, dev)
    if per_image:
        w = _image_weights(lead[0], n, m, seed + 2, dev)
        w[0] = 0.5
        dx[-1, 1] = 0
        dy[-1, 1] = 0
    else:
        w = _weight(n, m, seed + 2, dev)
    if aligned:
        dx[..., -1] = 0
        dy[..., -1, :] = 0
        return tu._residual_aligned(dx, dy, w)
    return tu._residual(dx[..., :-1], dy[..., :-1, :], w)


def _check_unwrap(rk, WWx, WWy, kmax, aligned, czt):
    """The early-stopping kernel against its twin: one counted launch,
    finite, the twin's k per plane, relative 1e-4 of the twin, bit for
    bit over two calls, and the route the case states (launches read from
    the call's captured CUDA graph, _build.graph_kernels): `czt` of the
    four DCT passes an iteration chirp-z and the rest Stockham, six launches
    an iteration with no eigen_rz or cuFFT kernel in the solve; or, with
    `czt` None, the other sides' three besides the DCTs. Both float32 solves are
    also held to the same solve in float64: the kernel no further from it
    than the twin (10% and 1e-5 of slack). Where the twin itself strays
    from it by more than 2e-4 (float32 rounding amplified by a plane's
    softest modes: 1.1e-3 at 4096 x 128, where kernel and twin differ by
    1.7e-4), the kernel is held within half that of the twin instead of
    1e-4. Returns k."""
    n, m = rk.shape[-2:]
    before = _build.launches["cg_unwrap"]
    got, k = tcg.cg_unwrap(rk, WWx, WWy, kmax, aligned)
    assert _build.launches["cg_unwrap"] == before + 1
    again, k2 = tcg.cg_unwrap(rk, WWx, WWy, kmax, aligned)
    want, kw = tcg.cg_unwrap_plain(rk, WWx, WWy, kmax, aligned)
    w64, _ = tcg.cg_unwrap_plain(rk.double(), WWx.double(), WWy.double(),
                                 kmax, aligned)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(k, kw), (k, kw)
    twin64 = _rel(want.double(), w64)
    assert _rel(got, want) <= max(1e-4, 0.5 * twin64), (_rel(got, want),
                                                         twin64)
    assert _rel(got.double(), w64) <= 1.1 * twin64 + 1e-5
    assert torch.equal(got, again) and torch.equal(k, k2)
    names = _build.graph_kernels(lambda: tcg.cg_unwrap(rk, WWx, WWy, kmax,
                                                        aligned))
    ours = [x for x in names if any(s in x for s in (
        "dct_kernel", "czt_kernel", "step_p_kernel", "step_x_kernel",
        "eigen_rz_kernel"))]
    assert sum("init_kernel" in x for x in names) == 1
    its = max(kmax, 1)
    fft = czt is not None
    assert tcg.unwrap_fft_route(n, m) == fft
    assert len(ours) == (6 if fft else 3) * its, names
    if fft:
        assert not [x for x in names if "fft" in x.lower()], names
        assert sum("czt_kernel" in x for x in names) == czt * its, names
        assert sum("dct_kernel" in x for x in names) == (4 - czt) * its
        assert not [x for x in names if "eigen_rz_kernel" in x], names
    return k


@pytest.mark.parametrize("B,n,m,aligned,kmax,czt", [
    (2, 128, 128, False, 10, 0), (2, 512, 512, False, 10, 0),
    (2, 2048, 2048, True, 6, 0), (2, 2048, 2048, True, 4, 0),
    (2, 4096, 4096, False, 10, 0), (2, 4096, 128, False, 10, 0),
    (1, 128, 4096, True, 3, 0), (2, 250, 374, False, 10, 4),
    (2, 250, 374, True, 6, 4), (2, 4086, 4086, False, 3, 4),
    (2, 4096, 4086, False, 3, 2), (2, 4086, 4096, True, 3, 2),
    (2, 130, 252, False, 6, 4), (2, 252, 130, True, 6, 4),
    (2, 1000, 1022, False, 6, 4), (1, 1022, 1000, True, 4, 4),
    (1, 1500, 2046, False, 4, 4), (1, 2046, 1500, True, 4, 4),
    (1, 3000, 4092, False, 3, 4), (1, 4094, 3000, True, 3, 4),
    (2, 64, 96, True, 6, None)])
def test_cg_unwrap_kernel(dev, B, n, m, aligned, kmax, czt):
    """The early-stopping kernel on the FFT route (powers of two from 128
    to 4096, both layouts; the chirp-z passes at 250 x 374 and 4086^2,
    beside a 4096-point pass at 4096 x 4086 and 4086 x 4096, and at every
    chirp-z length L = 256 ... 4096 with N = side / 2 odd and even on
    both axes: 130 x 252 and 252 x 130 (L = 256), 1000 x 1022 (1024),
    1500 x 2046 (2048), 3000 x 4092 and 4094 x 3000 (4096); 374 and 500
    are L = 512's) and elsewhere (64 x 96): `czt` is the chirp-z passes
    an iteration the case must run, None for the other sides."""
    rk, WWx, WWy = _unwrap_problem((B,), n, m, aligned, 95, dev)
    _check_unwrap(rk, WWx, WWy, kmax, aligned, czt)


@pytest.mark.parametrize("B,n,m,aligned", [(2, 8192, 128, False),
                                           (1, 128, 8192, True)])
def test_cg_unwrap_kernel_at_8192(dev, B, n, m, aligned):
    """At a side of 8192 the float32 Neumann eigenvalue next to the origin
    rounds to 0 in the reference's formula (2 (cos(pi / 8192) + 1 - 2),
    pygpa_tpu's _poisson_scale too), so a float32 solve divides by zero:
    the kernel's 8192-point passes give its twin's non-finite planes and
    k, and its six launches an iteration."""
    assert int((tcg.poisson_scale(n, m, torch.float32, dev) == 0).sum()) == 1
    rk, WWx, WWy = _unwrap_problem((B,), n, m, aligned, 95, dev)
    got, k = tcg.cg_unwrap(rk, WWx, WWy, 3, aligned)
    want, kw = tcg.cg_unwrap_plain(rk, WWx, WWy, 3, aligned)
    assert torch.equal(k, kw)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    names = _build.graph_kernels(lambda: tcg.cg_unwrap(rk, WWx, WWy, 3,
                                                       aligned))
    assert sum(any(s in x for s in ("dct_kernel", "step_p_kernel",
                                     "step_x_kernel")) for x in names) == 18


@pytest.mark.parametrize("B,n,m,aligned,czt", [(3, 256, 256, False, 0),
                                               (3, 512, 512, True, 0),
                                               (4, 250, 374, False, 4),
                                               (3, 500, 500, True, 4),
                                               (3, 96, 80, False, None)])
def test_cg_unwrap_kernel_with_per_image_weights(dev, B, n, m, aligned,
                                                 czt):
    """A (B, 2) stack with weights (B, 1, n, m): planes stop by the norm
    (image 0), by kmax and at the start (the last image's zero plane),
    each as its twin says; each image's solution the bits of its own
    one-weight call."""
    rk, WWx, WWy = _unwrap_problem((B, 2), n, m, aligned, 97, dev,
                                   per_image=True)
    assert WWx.shape[:2] == (B, 1)
    k = _check_unwrap(rk, WWx, WWy, 12, aligned, czt)
    assert (k[0] < 12).all() and k[-1, 1] == 0 and (k[1] == 12).all()
    got, _ = tcg.cg_unwrap(rk, WWx, WWy, 12, aligned)
    for i in range(B):
        one, ki = tcg.cg_unwrap(rk[i].contiguous(), WWx[i, 0].contiguous(),
                                WWy[i, 0].contiguous(), 12, aligned)
        assert torch.equal(got[i], one) and torch.equal(k[i], ki)


def test_cg_unwrap_kernel_refuses(dev):
    """Outside its limits the wrapper raises instead of running the
    twin: float64, a side past 8192, a side of 1."""
    z = torch.zeros((2, 16, 16), device=dev)
    with pytest.raises(ValueError):
        tcg.cg_unwrap(z.double(), z.double(), z.double(), 3, True)
    for shape in ((1, 8200, 8), (2, 1, 64)):
        z = torch.zeros(shape, device=dev)
        with pytest.raises(ValueError):
            tcg.cg_unwrap(z, z, z, 3, True)


def _warp_coords(kind, n, m, dev):
    """Sample positions (2, ...) in float32 on the card: a smooth warp
    over the image, 1-D vectors, a sawtooth (wrapped, jumps of ~n at
    every seam) and positions far outside every border."""
    if kind == "1d":
        c = np.stack([np.linspace(-4.5, n + 3.2, 1001),
                      np.linspace(m + 5.1, -3.7, 1001)])
    else:
        yy, xx = np.meshgrid(np.arange(n, dtype=float),
                             np.arange(m, dtype=float), indexing="ij")
        if kind == "smooth":
            c = np.stack([yy + 3 * np.sin(xx / 37), xx - 4 * np.cos(yy / 29)])
        elif kind == "sawtooth":
            c = np.stack([(yy * 1.73 + 0.2 * xx) % (n - 3.0),
                          (xx * 1.61 + 0.1 * yy) % (m - 5.0)])
        else:
            c = np.stack([yy * 1.4 - 0.2 * n, xx * 1.5 - 0.25 * m])
            c[:, ::7] += 1e4
    return torch.from_numpy(c.astype(np.float32)).to(dev)


@pytest.mark.parametrize("kind", ["smooth", "1d", "sawtooth", "far"])
@pytest.mark.parametrize("n,m", [(300, 517), (97, 1030)])
def test_warp_kernels(dev, n, m, kind):
    """Both warp kernels (bilinear; Catmull-Rom and B-spline cubic) in
    both modes with cval != 0, against their twins on the card: the
    same float32 operations in the same order, so within 1e-6 of the
    image's maximum."""
    from pygpa_tpu_torch.ops import warp as tw
    img = _planes((n, m), 21, dev)
    c = _warp_coords(kind, n, m, dev)
    before = dict(_build.launches)
    for mode in ("nearest", "constant"):
        cases = [(tw.warp_bilinear, tw.warp_bilinear_plain, ())]
        cases += [(tw.warp_cubic, tw.warp_cubic_plain, (cub,))
                  for cub in ("catmull", "bspline")]
        for fn, twin, extra in cases:
            got = fn(img, c[0], c[1], mode, -2.5, *extra)
            want = twin(img, c[0], c[1], mode, -2.5, *extra)
            assert got.shape == c.shape[1:] and torch.isfinite(got).all()
            assert float((got - want).abs().max()) <= 1e-6 * float(
                img.abs().max()), (mode, extra)
    assert _build.launches["warp_bilinear"] == before.get("warp_bilinear",
                                                          0) + 2
    assert _build.launches["warp_cubic"] == before.get("warp_cubic", 0) + 4


def test_undistort_on_the_card_matches_the_cpu(dev, monkeypatch):
    """undistort_image at 384 x 320 (coarse 1 and 4) on the card, with
    TF32 allowed globally, against the same float32 call on the CPU:
    the prefilter's convolutions and the coarse inversion's products
    switch TF32 off themselves."""
    from pygpa_tpu_torch.gpa.pipeline import undistort_image
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    n, m = 384, 320
    yy, xx = np.meshgrid(np.arange(n), np.arange(m), indexing="ij")
    u = np.stack([3 * np.sin(2 * np.pi * yy / n + 0.4) + 0.3,
                  2 * np.cos(2 * np.pi * xx / m)]).astype(np.float32)
    img = _planes((n, m), 22, "cpu")
    for coarse in (1, 4):
        want = undistort_image(img, torch.from_numpy(u), coarse=coarse,
                               device="cpu")
        _build.launches.clear()
        got = undistort_image(img.to(dev), torch.from_numpy(u).to(dev),
                              coarse=coarse, device=dev)
        assert _build.launches["warp_cubic"] >= 1
        assert _rel(got.cpu(), want) <= 1e-4, coarse


def _diag_ks(a, b):
    return np.array([[1.0 / a, 0.0], [0.0, 1.0 / b]])


# (k-vectors, z, image shape): a cell near the reference's 512 x 512
# limit (512 x 402, past shared memory) and one of odd sides (13 x 9)
CELLS = [(_diag_ks(255.5, 200.3), 2, (1100, 900)),
         (_diag_ks(12.4, 8.7), 1, (301, 517)),
         (generate_ks(0.06, 9.0)[:2], 3, (333, 250))]


@pytest.mark.parametrize("ks,z,shape", CELLS)
@pytest.mark.parametrize("with_u", [False, True])
def test_drizzle_kernel(dev, ks, z, shape, with_u):
    """The drizzle kernel against its float32 index_add_ twin (normwise
    1e-5, NaN pixels skipped), two launches bit-identical, and an
    all-NaN image summing to exactly 0: the 512 x 402 cell on the
    global-atomic route, the others on the shared-memory route."""
    from pygpa_tpu_torch.ops import drizzle as td
    from pygpa_tpu_torch.ucell import calc_ucell_parameters
    rmin, rsize = calc_ucell_parameters(ks, z)
    rsize = tuple(int(r) for r in rsize)
    assert td.shared_route(rsize) == (rsize[0] * rsize[1] < 100000)
    img = _planes(shape, 23, dev)
    img[5:9, 20:60] = float("nan")
    u = 0.8 * _planes((2,) + shape, 24, dev) if with_u else None
    before = _build.launches["drizzle"]
    s1, w1 = td.drizzle(img, ks, rmin, rsize, z, u)
    s2, w2 = td.drizzle(img, ks, rmin, rsize, z, u)
    assert _build.launches["drizzle"] == before + 2
    assert torch.equal(s1, s2) and torch.equal(w1, w2)
    ps, pw = td.drizzle_plain(img, ks, rmin, rsize, z, u)
    assert s1.shape == rsize and (w1 > 0).any()
    assert _rel(s1, ps) <= 1e-5 and _rel(w1, pw) <= 1e-5
    s0, w0 = td.drizzle(torch.full_like(img, float("nan")), ks, rmin, rsize,
                        z, u)
    assert not s0.any() and not w0.any()


@pytest.mark.parametrize("with_u,nan", [(False, False), (True, False),
                                        (False, True)])
def test_drizzle_routes_agree_bit_for_bit(dev, monkeypatch, with_u, nan):
    """Config 4's cell (118 x 166 at z = 2) on a 1024^2 lattice: the
    shared-memory route and the global-atomic route (forced through the
    route predicate) give the same bits, with and without u and on an
    all-NaN image, and both repeat."""
    from pygpa_tpu_torch.ops import drizzle as td
    from pygpa_tpu_torch.ucell import calc_ucell_parameters
    ks = generate_ks(0.02, 5.0)[:2].astype(np.float32)
    rmin, rsize = calc_ucell_parameters(ks, 2)
    rsize = tuple(int(r) for r in rsize)
    assert rsize == (118, 166) and td.shared_route(rsize)
    img = hexlattice_gen(0.02, 5.0, order=2, size=1024, dtype=torch.float32,
                         device=dev)
    if nan:
        img = torch.full_like(img, float("nan"))
    u = 0.8 * _planes((2, 1024, 1024), 27, dev) if with_u else None
    shared = [td.drizzle(img, ks, rmin, rsize, 2, u) for _ in range(2)]
    monkeypatch.setattr(td, "shared_route", lambda rsize: False)
    glob = [td.drizzle(img, ks, rmin, rsize, 2, u) for _ in range(2)]
    for a in shared[1:] + glob:
        assert torch.equal(a[0], shared[0][0]) and torch.equal(a[1],
                                                               shared[0][1])
    if nan:
        assert not shared[0][0].any() and not shared[0][1].any()
    else:
        ps, pw = td.drizzle_plain(img, ks, rmin, rsize, 2, u)
        assert _rel(shared[0][0], ps) <= 1e-5 and _rel(shared[0][1], pw) <= 1e-5


@pytest.mark.parametrize("ks,z,shape", CELLS)
@pytest.mark.parametrize("order,cubic,z2,with_u",
                         [(1, "bspline", 1, False), (3, "bspline", 2, True),
                          (3, "catmull", 1, True)])
def test_expand_kernel(dev, ks, z, shape, order, cubic, z2, with_u):
    """The expand kernel against its twin: shared-memory and L1 cells,
    orders 1 and 3, z2 = 2, u given; the same float32 operations in the
    same order, so within 1e-6 of the cell's maximum."""
    from pygpa_tpu_torch.ops import expand as te
    from pygpa_tpu_torch.ucell import calc_ucell_parameters
    rmin, rsize = calc_ucell_parameters(ks, z)
    cell = _planes(tuple(rsize), 25, dev)
    u = 0.5 * _planes((2,) + shape, 26, dev) if with_u else None
    before = _build.launches["expand"]
    got = te.expand_cell(cell, ks, rmin, z, z2, u, shape, order, cubic)
    want = te.expand_cell_plain(cell, ks, rmin, z, z2, u, shape, order,
                                cubic)
    assert _build.launches["expand"] == before + 1
    assert got.shape == shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-6 * float(cell.abs().max())



@pytest.mark.parametrize("with_u", [False, True])
@pytest.mark.parametrize("shape", [(4096, 4096), (517, 4097)])
def test_expand_kernel_config4(dev, monkeypatch, shape, with_u):
    """Config 4's cell (118 x 166 at z = 2, B-spline) onto 4096^2 and onto
    an odd output width (scalar stores and a masked row tail), with and
    without u: the shared route twice and the L1 route (forced through
    the route predicate) give the same bits, within 1e-6 of the cell's
    maximum of the twin."""
    from pygpa_tpu_torch.ops import expand as te
    from pygpa_tpu_torch.ucell import calc_ucell_parameters
    ks = generate_ks(0.02, 5.0)[:2].astype(np.float32)
    rmin, rsize = calc_ucell_parameters(ks, 2)
    assert tuple(int(r) for r in rsize) == (118, 166)
    cell = _planes((118, 166), 28, dev)
    u = 0.8 * _planes((2,) + shape, 29, dev) if with_u else None
    args = (cell, ks, rmin, 2, 1, u, shape)
    assert te.shared_route((122, 170))
    before = _build.launches["expand"]
    got = [te.expand_cell(*args) for _ in range(2)]
    monkeypatch.setattr(te, "shared_route", lambda s: False)
    got.append(te.expand_cell(*args))
    assert _build.launches["expand"] == before + 3
    assert all(torch.equal(g, got[0]) for g in got[1:])
    want = te.expand_cell_plain(*args)
    assert got[0].shape == shape and torch.isfinite(got[0]).all()
    assert float((got[0] - want).abs().max()) <= 1e-6 * float(
        cell.abs().max())


def _grouped_ops(G, P, W0, Wb, n, m, seed, dev):
    """sweep_uv operands made from a seed: two band runs per group at
    offsets 0 and 64, DFT bases of consecutive bins, nominal k-vectors;
    dr 6, banded."""
    g = np.random.default_rng(seed)
    f = np.float32
    T = lambda a, dt=f: torch.from_numpy(np.asarray(a, dt)).to(dev)
    a0 = twfr._zoom_basis(n, (np.arange(W0) + 5) % n)
    a1 = twfr._zoom_basis(m, (np.arange(Wb) + 3) % m)
    h = P // 2
    kc = [[2 * np.pi * a, 2 * np.pi * b] for a, b in
          g.uniform(0.05, 0.2, size=(G, 2))]
    return (T(g.normal(size=(G, 2, W0, Wb))), T(g.normal(size=(G, 2, W0, Wb))),
            T(g.uniform(0.2, 1, size=(G, P, W0))),
            T(g.uniform(0.2, 1, size=(G, P, Wb))),
            T(np.stack([a0[0].numpy()] * G)), T(np.stack([a0[1].numpy()] * G)),
            T(np.stack([a1[0].numpy()] * G)), T(np.stack([a1[1].numpy()] * G)),
            T([[0] * h + [1] * (P - h)] * G, np.int32),
            T([[0] * h + [64] * (P - h)] * G, np.int32),
            T([[a, b, a * a, a * b, b * b] for a, b in kc]), 6, True)


@pytest.mark.parametrize("Wb", [128, 256, 448])
def test_grouped_sweep_tensor_core_kernel(dev, Wb):
    """The grouped sweep's stage 2 on the tensor cores at band widths of
    the bench (128), of config 6 (256) and of config 1 at 2048^2 (448,
    which the former kernel refused), on one stage-1 output, against the
    float32 and the float64 twin's stage 2, with the flip-tolerant bounds
    of tests/test_lockin_wfr.py's banded-vs-unbanded test: winner phases
    within 1e-4 rad at 99% of the pixels (flips) and p99 < 5e-5 rad,
    weights rel p99 < 5e-5 and max < 2e-2. The whole call counts one
    launch and is finite. (Synthetic operands: the uv lstsq of random
    phases is too ill-conditioned for check_sweep's uv bounds.)"""
    args = _grouped_ops(3, 5, 64, Wb, 256, 320, 40 + Wb, dev)
    before = _build.launches["sweep_uv"]
    assert all(torch.isfinite(t).all() for t in tsweep.sweep_uv(*args))
    assert _build.launches["sweep_uv"] == before + 1
    T = tsweep.stage1(*args[:6], args[8])
    ph, wt = tsweep.stage2(T, args[6], args[7], args[9], 6, True)
    for dt in (torch.float32, torch.float64):
        pp, pw = tsweep._stage2_plain(T.to(dt), args[6].to(dt),
                                      args[7].to(dt), args[9], 6, True)
        dph = torch.remainder(ph.to(dt) - pp + np.pi, 2 * np.pi) - np.pi
        dph = dph.abs().flatten()
        rel = ((wt.to(dt) - pw).abs() / (pw.abs() + 1e-9)).flatten()
        assert float((dph > 1e-4).double().mean()) < 1e-2, (Wb, dt)
        assert float(torch.quantile(dph[::3], 0.99)) < 5e-5, (Wb, dt)
        assert float(torch.quantile(rel[::3], 0.99)) < 5e-5, (Wb, dt)
        assert float(rel.max()) < 2e-2, (Wb, dt)


def test_config1_extractor_at_2048(dev, monkeypatch):
    """make_displacement_extractor((2048, 2048), config 1's k-vectors)
    plans an unbanded Wb = 448 and runs through the grouped kernel:
    finite, config 1's gate (interior max |u| < 0.02 px, 8 sigma border)
    and within 1e-3 px (p99) of the same call on the plain twins."""
    from pygpa_tpu_torch.gpa.pipeline import make_displacement_extractor
    ks = generate_ks(0.1, 7.0)[:3]
    img = hexlattice_gen(0.1, 7.0, order=2, size=2048, dtype=torch.float32,
                         device=dev)
    fn = make_displacement_extractor((2048, 2048), ks, device=dev)
    assert fn.plan.col_groups is None and fn.plan.idx1s.shape[1] == 448
    before = _build.launches["sweep_uv"]
    u = fn(img)
    assert _build.launches["sweep_uv"] == before + 1
    assert torch.isfinite(u).all()
    b = 8 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    assert float(u[:, b:-b, b:-b].abs().max()) < 0.02
    monkeypatch.setattr(tsweep, "sweep_uv", tsweep.sweep_uv_plain)
    d = (u - fn(img))[:, b:-b, b:-b].abs().flatten()
    assert float(torch.quantile(d[::7], 0.99)) < 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("size", [500, 512])
def test_multigrid_extractor_routes_the_v_branch(dev, dtype, size):
    """make_displacement_extractor(..., unwrap_coarse=4) at 500^2 (shapes
    the V-branch kernels refuse) and in float64 runs on the card, the
    V-branch on the twins there and on the kernels at 512^2 float32, and
    matches the same call on the CPU on a lattice shifted by a smooth
    ~1 px field: float64 within 1e-9 px; float32 interior p99 within
    1e-4 px and max within 1e-2 px (near-tie winner flips between the
    grouped kernel and its twin, as chip_smoke.py phase 6)."""
    from pygpa_tpu_torch.gpa.pipeline import make_displacement_extractor
    ks = generate_ks(0.1, 7.0)[:3]
    x = np.arange(size) / size
    shift = np.stack([np.outer(np.sin(2 * np.pi * x), np.cos(np.pi * x)),
                      0.5 * np.outer(x, x)])
    img = hexlattice_gen(0.1, 7.0, order=2, size=size, shift=shift,
                         dtype=dtype)
    want = make_displacement_extractor((size, size), ks, unwrap_coarse=4,
                                       dtype=dtype, device="cpu")(img)
    before = _build.launches["presmooth"]
    got = make_displacement_extractor((size, size), ks, unwrap_coarse=4,
                                      dtype=dtype, device=dev)(img.to(dev))
    kernel = dtype == torch.float32 and size == 512
    assert _build.launches["presmooth"] == before + int(kernel)
    assert torch.isfinite(got).all()
    b = 2 * int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    d = (got.cpu() - want)[:, b:-b, b:-b].abs().flatten()
    if dtype == torch.float64:
        assert float(d.max()) <= 1e-9
    else:
        assert float(torch.quantile(d, 0.99)) <= 1e-4
        assert float(d.max()) <= 1e-2


@pytest.mark.parametrize("mode,margin", [("nearest", 13), ("constant", 0)])
@pytest.mark.parametrize("n,m", [(300, 517), (97, 1030), (256, 256)])
def test_cubic_displacement_kernel(dev, n, m, mode, margin):
    """The displacement-form cubic warp against its twin (normwise 1e-6:
    the same float32 operations in the same order), on one and two
    coefficient planes (stored planes-last), out of place and in place
    (out = u), with positions far outside, on sides off the kernel's
    32 x 8 block."""
    from pygpa_tpu_torch.core import interp as ti
    from pygpa_tpu_torch.ops import warp as tw
    planes = _planes((2, n, m), 31, dev)
    coef = ti.spline_filter(planes, mode=mode, axes=(-2, -1), margin=margin)
    coef = coef.permute(1, 2, 0).contiguous()          # planes last
    u = 3 * _planes((2, n, m), 32, dev)
    u[:, :2, :5] = torch.tensor([[50.0], [-70.0]], device=dev)[:, :, None]
    for origin in ((0, 0), (-4, -4)):
        for C in (1, 2):
            before = _build.launches["warp_cubic"]
            cf = coef[..., :C].contiguous()
            got = tw.warp_cubic_disp(cf, u, origin, margin, mode, 0.0)
            assert _build.launches["warp_cubic"] == before + 1
            want = tw.warp_cubic_disp_plain(cf, u, origin, margin, mode,
                                            0.0)
            assert got.shape == (C, n, m) and torch.isfinite(got).all()
            assert _rel(got, want) <= 1e-6, (origin, C)
        u_in = u.clone()
        tw.warp_cubic_disp(coef, u_in, origin, margin, mode, 0.0, u_in)
        assert _rel(u_in, want) <= 1e-6
    with pytest.raises(ValueError, match="warp_cubic_disp"):
        tw.warp_cubic_disp(coef.double(), u.double(), (0, 0), margin, mode)
    with pytest.raises(ValueError, match="warp_cubic_disp"):
        tw.warp_cubic_disp(torch.cat([coef, coef], -1), u, (0, 0), margin,
                           mode)
    with pytest.raises(ValueError, match="warp_cubic_disp"):
        tw.warp_cubic_disp(coef, u, (0, 0), margin, mode, 0.0, coef)


def _grad_close(got, want, agree, absq):
    """A gradient plane of a kernel against its twin's on the pixels whose
    winners agree: where |M|^2 is at least 1e-2 of its maximum, within
    rtol 2e-3 and 2e-5 of the plane's mean magnitude there (the ratio's
    float32 rounding grows as |M| falls); p99 of the relative error over
    all agreeing pixels < 1e-3."""
    live = agree & (absq >= 1e-2 * absq.max())
    sc = float(want[live].abs().mean())
    d = (got - want).abs()
    assert bool((d[live] <= 2e-3 * want[live].abs() + 2e-5 * sc).all())
    rel = (d / (want.abs() + sc))[agree]
    assert float(torch.quantile(rel[::3], 0.99)) < 1e-3


@pytest.mark.parametrize("P", [1, 36, 49])
@pytest.mark.parametrize("W1", [64, 256])
def test_zoom_grad_kernel(dev, W1, P):
    """The zoom kernel's gradient emission (c) against the twin's analytic
    gradients on seeded operands, with one candidate, 36 and 49 (past the
    reference's 48-candidate chunk), at window widths 64 and 256. One
    launch counts as "zoom_grad"; its tournament, phase and weight are
    the plain launch's bit for bit and meet check_zoom's bounds against
    the twin; the gradients meet _grad_close's."""
    from pygpa_tpu_torch.ops import zoom_sweep as tz
    ops = _zoom_ops(P, 64, W1, 128, 192, 50 + W1 + P, dev)
    gops = tuple(_planes(s, 60 + P + i, dev) for i, s in enumerate(
        ((64, W1), (64, W1), (192, W1), (192, W1))))
    before = dict(_build.launches)
    got = tz.zoom_sweep(*ops, dr=10, grad_ops=gops)
    assert _build.launches["zoom_grad"] == before.get("zoom_grad", 0) + 1
    assert _build.launches["zoom_sweep"] == before.get("zoom_sweep", 0)
    assert len(got) == 8
    plain = tz.zoom_sweep(*ops, dr=10)
    for a, b in zip(got[:4] + got[6:], plain):
        assert torch.equal(a, b)
    want = tz.zoom_sweep_plain(*ops, dr=10, grad_ops=gops)
    _zoom_agree(got[:4] + got[6:], want[:4] + want[6:], phase_weight=P > 1)
    agree = got[3] == want[3]
    for k in (4, 5):
        assert torch.isfinite(got[k]).all()
        _grad_close(got[k], want[k], agree, want[0])


def _grad_ops_grouped(G, P, W0, Wb, n, m, seed, dev, banded):
    """sweep_grad's operands: _grouped_ops' (unbanded: one run at offset
    0) with seeded row-derivative windows and column-derivative basis."""
    args = list(_grouped_ops(G, P, W0, Wb, n, m, seed, dev))
    if not banded:
        args[8] = torch.zeros_like(args[8])
        args[9] = torch.zeros_like(args[9])
    Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off, _, dr, _ = args
    S2r, S2i = (_planes(Sr.shape, seed + 1 + i, dev) for i in range(2))
    A1yc, A1ys = (_planes(A1c.shape, seed + 3 + i, dev) for i in range(2))
    return (Sr, Si, S2r, S2i, gx, gy, A0c, A0s, A1c, A1s, A1yc, A1ys, run,
            off, dr, banded)


@pytest.mark.parametrize("P", [1, 36, 49])
@pytest.mark.parametrize("Wb,banded", [(128, True), (192, True),
                                       (256, False)])
def test_grouped_pw_and_grad_kernels(dev, Wb, banded, P):
    """The grouped sweep's emissions (a) and (b) on seeded operands,
    banded (two runs, offsets 0 and 64) at Wb 128 and 192 and unbanded
    at 256, with P = 1, 36 and 49: (a) returns the planes the uv route's
    stage 2 computes, bit for bit, and (b) the same planes again; each
    call counts one launch under its name. Against the float32 and the
    float64 twins: phases within 1e-4 rad on 99% of the pixels (flips)
    and p99 < 5e-5 rad, weights rel p99 < 5e-5 and max < 2e-2 (the uv
    route's phase/weight bounds); gradients meet _grad_close's bounds on
    the pixels whose phases agree within 1e-4 rad."""
    a = _grad_ops_grouped(3, P, 64, Wb, 256, 320, 80 + Wb + P, dev, banded)
    (Sr, Si, S2r, S2i, gx, gy, A0c, A0s, A1c, A1s, A1yc, A1ys, run, off, dr,
     bd) = a
    pw_args = (Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off, dr, bd)
    before = dict(_build.launches)
    pw = tsweep.sweep_pw(*pw_args)
    assert _build.launches["sweep_pw"] == before.get("sweep_pw", 0) + 1
    T = tsweep.stage1(Sr, Si, gx, gy, A0c, A0s, run)
    for x, y in zip(pw, tsweep.stage2(T, A1c, A1s, off, dr, bd)):
        assert torch.equal(x, y)
    gr = tsweep.sweep_grad(*a)
    assert _build.launches["sweep_grad"] == before.get("sweep_grad", 0) + 1
    assert len(gr) == 4 and torch.equal(gr[0], pw[0])
    assert torch.equal(gr[1], pw[1])
    for dt in (torch.float32, torch.float64):
        want = tsweep.sweep_grad_plain(*(
            x.to(dt) if torch.is_tensor(x) and x.is_floating_point() else x
            for x in a))
        dph = (torch.remainder(gr[0].to(dt) - want[0] + np.pi, 2 * np.pi)
               - np.pi).abs()
        rel = ((gr[1].to(dt) - want[1]).abs() / (want[1].abs() + 1e-9))
        assert float((dph > 1e-4).double().mean()) < 1e-2, dt
        assert float(torch.quantile(dph.flatten()[::3], 0.99)) < 5e-5, dt
        assert float(torch.quantile(rel.flatten()[::3], 0.99)) < 5e-5, dt
        assert float(rel.max()) < 2e-2, dt
        for k in (2, 3):
            assert torch.isfinite(gr[k]).all()
            _grad_close(gr[k].to(dt), want[k], dph < 1e-4, want[1] ** 2)


def test_gradient_routes_on_the_card_match_the_cpu(dev):
    """wfr_sweep_phase_weight_multi(with_grad=True) on config 1's lattice
    at 256^2 through both of its routes on the card, each against the
    same call on the CPU (the twins): the grouped route (4x4 candidate
    grids, banded: one "sweep_grad" launch) and the per-peak route
    (banks of unequal lengths: three "zoom_grad" launches). Weights within
    rtol 1e-4; on > 1 - 2e-4 of the pixels the phase within 1e-3 rad and
    the rebased gradients within rtol 2e-3, atol 2e-5 rad/px (near-tie
    winner flips aside)."""
    r_k, theta = 0.12, 5.0
    ks = np.asarray(generate_ks(r_k, theta), np.float64)[:3]
    img = hexlattice_gen(r_k, theta, order=1, size=256, dtype=torch.float32)
    img = img - img.mean()
    kn = np.linalg.norm(ks, axis=1)
    kw = kn.mean() / 2.5
    sigma = int(np.ceil(1 / kn.min()))
    offs = (np.arange(4) - 1.5) * (2 * kw / 4)
    grid = np.stack([a.ravel() for a in np.meshgrid(offs, offs,
                                                    indexing="ij")], -1)
    grouped = [k[None] + grid for k in ks]
    per_peak = [np.stack([a.ravel() for a in np.meshgrid(
        np.arange(k[0] - kw, k[0] + kw, kw / d),
        np.arange(k[1] - kw, k[1] + kw, kw / d), indexing="ij")], -1)
        for k, d in zip(ks, (3, 3.5, 2.5))]
    for wl, name, count, gc in ((grouped, "sweep_grad", 1, 10.0),
                                (per_peak, "zoom_grad", 3, None)):
        before = _build.launches[name]
        got = twfr.wfr_sweep_phase_weight_multi(
            img.to(dev), wl, sigma, 2, with_grad=True, krefs=ks,
            gauss_cut=gc)
        assert _build.launches[name] == before + count, name
        want = twfr.wfr_sweep_phase_weight_multi(
            img, wl, sigma, 2, with_grad=True, krefs=ks, gauss_cut=gc)
        got = [x.cpu() for x in got]
        assert torch.allclose(got[1], want[1], rtol=1e-4,
                              atol=1e-6 * float(want[1].max()))
        dphi = (torch.remainder(got[0] - want[0] + np.pi, 2 * np.pi)
                - np.pi).abs()
        bad = dphi >= 1e-3
        for c in (0, 1):
            bad |= ((got[2][..., c] - want[2][..., c]).abs()
                    > 2e-5 + 2e-3 * want[2][..., c].abs())
        assert float(bad.double().mean()) < 2e-4, name


def _index_plane(G, n, m, P, seed):
    """A (G, n, m) int32 numpy index plane made from a seed: 8 x 8 blocks
    drawn from three candidates that shift with the band, and every 97th
    pixel any candidate, so bands and tiles hold several winners."""
    g = np.random.default_rng(seed)
    blocks = g.integers(0, min(P, 3), size=(G, n // 8, m // 8))
    blocks += (np.arange(n // 8)[None, :, None] // 8 * 5) % P
    idx = np.repeat(np.repeat(blocks % P, 8, 1), 8, 2)
    flat = idx.reshape(-1)
    flat[::97] = g.integers(0, P, size=flat[::97].shape)
    return idx.astype(np.int32)


@pytest.mark.parametrize("G,n,m,P", [(1, 128, 192, 5), (3, 256, 320, 42),
                                     (2, 192, 128, 300)])
def test_band_winners_kernel(dev, G, n, m, P):
    """The band flags kernel against its twin, equal, on index planes
    with several winners a band, and with P = 300 (the flag array longer
    than a block); one launch counts as "grad_flags"."""
    idx = torch.from_numpy(_index_plane(G, n, m, P, 7 + P)).to(dev)
    before = _build.launches["grad_flags"]
    got = tsweep.band_winners(idx, P)
    assert _build.launches["grad_flags"] == before + 1
    want = tsweep.band_winners_plain(idx, P)
    assert got.shape == (G, n // 64, P) and got.dtype == torch.int32
    assert torch.equal(got, want)
    assert int(want.sum(-1).max()) > 1


@pytest.mark.parametrize("Wb", [128, 192])
def test_flagged_stage1_kernel(dev, Wb):
    """Stage 1 with band flags: the flagged (band, candidate) rows are the
    full launch's bit for bit and lie within 1e-5 of the masked twin's
    (relative to the rows' maximum); one launch counts as
    "grad_stage1", the full launch none."""
    a = _grouped_ops(3, 7, 64, Wb, 256, 320, 20 + Wb, dev)
    Sr, Si, gx, gy, A0c, A0s, run = a[:6] + (a[8],)
    g = np.random.default_rng(Wb)
    flags = torch.from_numpy(
        (g.random((3, 4, 7)) < 0.3).astype(np.int32)).to(dev)
    before = _build.launches["grad_stage1"]
    full = tsweep.stage1(Sr, Si, gx, gy, A0c, A0s, run)
    assert _build.launches["grad_stage1"] == before
    got = tsweep.stage1(Sr, Si, gx, gy, A0c, A0s, run, flags)
    assert _build.launches["grad_stage1"] == before + 1
    want = tsweep._stage1_plain(Sr, Si, gx, gy, A0c, A0s, run, flags)
    rows = flags.permute(0, 2, 1).repeat_interleave(64, dim=2).bool()
    assert torch.equal(got[rows], full[rows])
    assert float((got[rows] - want[rows]).abs().max()) <= 1e-5 * float(
        want[rows].abs().max())


@pytest.mark.parametrize("split,banded", [(True, True), (True, False),
                                          (False, False)])
def test_winner_products_kernel(dev, split, banded):
    """The winner products on a grouped tournament's winners (P = 9,
    several winners a tile) against the twin's, within _grad_close's
    bounds on every pixel (the winners are shared); in place (out = the
    winners' M planes) the same bits; one launch counts as
    "grad_products"."""
    a = _grad_ops_grouped(3, 9, 64, 128, 256, 320, 33 + split + banded, dev,
                          banded)
    (Sr, Si, S2r, S2i, gx, gy, A0c, A0s, A1c, A1s, A1yc, A1ys, run, off, dr,
     bd) = a
    T = tsweep.stage1(Sr, Si, gx, gy, A0c, A0s, run)
    ph, wt, mr, mi, idx = tsweep.stage2(T, A1c, A1s, off, dr, bd,
                                        winners=True)
    flags = tsweep.band_winners(idx, 9)
    Tx = tsweep.stage1(S2r, S2i, gx, gy, A0c, A0s, run, flags)
    before = _build.launches["grad_products"]
    got = tsweep.winner_products(T, Tx, A1c, A1s, A1yc, A1ys, mr, mi, idx,
                                 flags, off, bd, split)
    assert _build.launches["grad_products"] == before + 1
    want = tsweep.winner_products_plain(T, Tx, A1c, A1s, A1yc, A1ys, mr, mi,
                                        idx, flags, off, bd)
    tiles = idx.long().reshape(3, 4, 64, 5, 64).permute(0, 1, 3, 2, 4)
    assert any(t.unique().numel() > 1 for t in tiles.reshape(-1, 4096))
    every = torch.ones_like(idx, dtype=torch.bool)
    for k in (0, 1):
        assert torch.isfinite(got[k]).all()
        _grad_close(got[k], want[k], every, mr * mr + mi * mi)
    inplace = tsweep.winner_products(T, Tx, A1c, A1s, A1yc, A1ys, mr, mi,
                                     idx, flags, off, bd, split,
                                     out=(mr, mi))
    assert inplace[0] is mr and inplace[1] is mi
    assert torch.equal(mr, got[0]) and torch.equal(mi, got[1])


def test_gradient_tournaments_are_the_plain_launches(dev):
    """The gradient emissions' tournaments: the grouped launch that stores
    the winners returns the phase/weight launch's planes bit for bit,
    its stored |M| gives the weight (torch's sqrt of the same rounded
    |M|^2, times the rim factor, within one rounding) and its indices
    the twin's winners at > 99% of the pixels; the zoom gradient call's
    first four planes are the plain launch's."""
    from pygpa_tpu_torch.ops import zoom_sweep as tz
    a = _grouped_ops(3, 7, 64, 192, 256, 320, 61, dev)
    T = tsweep.stage1(*a[:6], a[8])
    pw = tsweep.stage2(T, a[6], a[7], a[9], 6, True)
    ph, wt, mr, mi, idx = tsweep.stage2(T, a[6], a[7], a[9], 6, True,
                                        winners=True)
    assert torch.equal(ph, pw[0]) and torch.equal(wt, pw[1])
    w = torch.sqrt(mr * mr + mi * mi) * tsweep.rim_weights(
        256, 320, 6, torch.float32, dev)
    assert torch.allclose(w, wt, rtol=2.4e-7, atol=0)
    want = tsweep._stage2_plain(T, a[6], a[7], a[9], 6, True, winners=True)
    assert float((idx == want[4]).float().mean()) > 0.99
    ops = _zoom_ops(42, 64, 256, 128, 192, 62, dev)
    gops = tuple(_planes(s, 63 + i, dev) for i, s in enumerate(
        ((64, 256), (64, 256), (192, 256), (192, 256))))
    got = tz.zoom_sweep(*ops, grad_ops=gops)
    for x, y in zip(got[:4], tz.zoom_sweep(*ops)):
        assert torch.equal(x, y)


# sha256 digests of the outputs below, taken on an NVIDIA H100 80GB HBM3
# from the kernels as they were before the tile's products were shared
# with the gradient emissions (tc_products in csrc/sweep_tc.cuh)
KEPT_BITS = {
    "sweep_uv_Wb128":
        "2af4513470a191271acef50f2e06399f4f56a3abf6803479232056485d4200b4",
    "sweep_uv_Wb192":
        "c6e7766cd30b67578c5be0e76c0508bc54d715470b647c5c23d694737b065ba2",
    "zoom_P49_W1256":
        "2cb7866dccc9ea3ce5fdf359b5b93cc27b55e71e392145fba5e619d924e65c50",
    "zoom_P5_W164":
        "adc81e7e4a1d5e3aa0546f3d26b11d3933fec7f41ed7f50afff6df338820b84e",
    "zoom_pw_P49_W1256":
        "c454498676a87409e3d27861d473e044ce6ca027165c0054019a7e3037ed1348",
    "zoom_pw_P5_W164":
        "b9c85bdfb0c4f74ea6d989f160b6bc939df3f6998b28c154bda4dcf04fc6df29",
}


def test_uv_and_zoom_outputs_keep_their_bits(dev):
    """The grouped uv sweep (banded, Wb 128 and 192, P = 7) and the zoom
    sweep (P = 49 at W1 = 256, P = 5 at 64; with and without the
    phase/weight emission) on fixed seeded inputs: the sha256 of their
    outputs is KEPT_BITS', so sharing the tile's product loop with the
    gradient emissions changed none of their bits."""
    import hashlib
    from pygpa_tpu_torch.ops import zoom_sweep as tz

    def sha(outs):
        h = hashlib.sha256()
        for o in outs:
            h.update(o.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()
    got = {}
    for Wb in (128, 192):
        got[f"sweep_uv_Wb{Wb}"] = sha(tsweep.sweep_uv(*_grouped_ops(
            3, 7, 64, Wb, 256, 320, 90 + Wb, dev)))
    for P, W1 in ((49, 256), (5, 64)):
        ops = _zoom_ops(P, 64, W1, 128, 192, 91 + P, dev)
        got[f"zoom_P{P}_W1{W1}"] = sha(tz.zoom_sweep(*ops))
        got[f"zoom_pw_P{P}_W1{W1}"] = sha(tz.zoom_sweep(*ops, dr=10))
    assert got == KEPT_BITS


def _stage2_float64(T, A1c, A1s):
    """Every candidate's M (P, n, m) of stage 2, complex128, from stage
    1's float32 T (P, n, 2K) and the column basis (m, K) in float64."""
    K = A1c.shape[1]
    T64, c, s = T.double(), A1c.double(), A1s.double()
    Tr, Ti = T64[..., :K], T64[..., K:]
    return torch.complex(Tr @ c.T - Ti @ s.T, Tr @ s.T + Ti @ c.T)


@pytest.mark.parametrize("n,m", [(64, 64), (64, 192), (192, 64)])
@pytest.mark.parametrize("K", [32, 64, 256, 512])
@pytest.mark.parametrize("P", [1, 49])
def test_zoom_tournament_ring_and_boxes(dev, P, K, n, m):
    """The zoom tournament's wgmma stage 2 straight from a seeded T, at
    the ring's edges: one candidate (one fill and drain, P K / 32 stages
    fewer than the ring's 4 when K = 32) and 49 (the ring crossing 48
    candidate boundaries); K from one 32-column stage to 16; one tile and
    a tile row or column of three. Winners agree with the float64
    tournament at > 99% of the pixels (near ties may flip) and, against
    the float64 M of the kernel's own winners, the rms error of M is
    within 1e-6 of the rms of M (3xTF32: ~2^-22 a product); the basis
    split counts one launch with the tournament."""
    from pygpa_tpu_torch.ops import zoom_sweep as tz
    g = np.random.default_rng(7 * P + K + n + 3 * m)
    f = lambda *s: torch.from_numpy(
        g.normal(size=s).astype(np.float32)).to(dev)
    T, A1c, A1s = f(P, n, 2 * K), f(m, K), f(m, K)
    before = _build.launches["split_basis"]
    ba, br, bi, bx = tz.stage2(T, A1c, A1s, None)
    assert _build.launches["split_basis"] == before + 1
    M64 = _stage2_float64(T, A1c, A1s)
    want = M64.abs().square().argmax(0)
    assert float((bx.long() == want).double().mean()) > 0.99
    ref = M64.gather(0, bx.long()[None])[0]
    err = torch.complex(br.double(), bi.double()) - ref
    rel = float(err.abs().square().mean().sqrt()
                / ref.abs().square().mean().sqrt())
    assert rel <= 1e-6, rel


@pytest.mark.parametrize("banded", [True, False])
@pytest.mark.parametrize("n,m", [(64, 192), (192, 64)])
@pytest.mark.parametrize("P,Wb", [(1, 64), (49, 128)])
def test_grouped_tournament_ring_and_boxes(dev, P, Wb, n, m, banded):
    """The grouped tournament (SPLIT chains, candidate 0 taken first)
    straight from a seeded T of two groups, each group's basis planes a
    box coordinate apart: its phase and weight against the float64
    twin's stage 2, banded and not, with test_grouped_sweep_tensor_core_
    kernel's flip-tolerant bounds; the winners launch stores the same
    planes."""
    G, dr = 2, 6
    g = np.random.default_rng(P + Wb + n + 5 * m + banded)
    f = lambda *s: torch.from_numpy(
        g.normal(size=s).astype(np.float32)).to(dev)
    T, A1c, A1s = f(G, P, n, 2 * Wb), f(G, m, Wb), f(G, m, Wb)
    off = torch.from_numpy(g.integers(0, m, size=(G, P)).astype(
        np.int32)).to(dev)
    ph, wt = tsweep.stage2(T, A1c, A1s, off, dr, banded)
    win = tsweep.stage2(T, A1c, A1s, off, dr, banded, winners=True)
    assert torch.equal(win[0], ph) and torch.equal(win[1], wt)
    pp, pw = tsweep._stage2_plain(T.double(), A1c.double(), A1s.double(),
                                  off, dr, banded)
    dph = (torch.remainder(ph.double() - pp + np.pi, 2 * np.pi)
           - np.pi).abs().flatten()
    rel = ((wt.double() - pw).abs() / (pw.abs() + 1e-9)).flatten()
    assert float((dph > 1e-4).double().mean()) < 1e-2
    assert float(torch.quantile(dph, 0.99)) < 5e-5
    assert float(torch.quantile(rel, 0.99)) < 5e-5
    assert float(rel.max()) < 2e-2


def test_grouped_stage2_splits_stacks_past_the_grid_limit(dev):
    """A grouped stack whose B G passes CUDA's gridDim.z (65535) runs its
    tournament in launches of whole images (one T map each): the first
    and the last image's planes are the bits of their own launches."""
    G, P, n, m, Wb = 3, 1, 64, 64, 64
    B = tsweep.MAX_GRID_Z // G + 1
    g = np.random.default_rng(79)
    f = lambda *s: torch.from_numpy(
        g.normal(size=s).astype(np.float32)).to(dev)
    T, A1c, A1s = f(B, G, P, n, 2 * Wb), f(G, m, Wb), f(G, m, Wb)
    off = torch.zeros((G, P), dtype=torch.int32, device=dev)
    got = tsweep.stage2(T, A1c, A1s, off, 4, False)
    for i in (0, B - 1):
        one = tsweep.stage2(T[i].contiguous(), A1c, A1s, off, 4, False)
        for x, y in zip(got, one):
            assert torch.equal(x[i], y), i


def test_split_basis_kernel(dev):
    """The basis split on the card is its twin's bits (the zoom sweep's
    (1, m, K) and the grouped sweep's (G, m, K)); each call counts one
    launch."""
    g = np.random.default_rng(83)
    for shape in ((1, 192, 256), (3, 320, 128)):
        c, s_ = (torch.from_numpy(g.normal(size=shape).astype(np.float32))
                 .to(dev) for _ in range(2))
        before = _build.launches["split_basis"]
        got = tsweep.split_basis(c, s_)
        assert _build.launches["split_basis"] == before + 1
        assert torch.equal(got, tsweep.split_basis_plain(c, s_))


# ---- the image axis: stacks of images with per-image weights, each
# kernel against its twin and against its own single-image launch on each
# image's slice (bit for bit: a block's arithmetic does not depend on the
# stack)


def _lattice_stack(B, size, dev):
    """B config 1 lattices (r_k 0.1, theta 7 deg, order 2) at `size`,
    image i displaced by a smooth field scaled by (i + 1) / B and shifted
    by 0.31 i px, each mean-subtracted; the plan's k-vectors."""
    ks = generate_ks(0.1, 7.0)[:3]
    S = size // 2
    xp, yp = np.meshgrid(np.arange(-S, S), np.arange(-S, S), indexing="ij")
    bump = 0.1 * xp * np.exp(-0.5 * ((xp / (S / 4)) ** 2
                                     + 1.2 * (yp / (S / 3)) ** 2))
    imgs = []
    for i in range(B):
        u = np.stack([bump * (i + 1) / B + 0.31 * i,
                      np.full_like(bump, 0.31 * i)]).astype(np.float32)
        im = hexlattice_gen(0.1, 7.0, order=2, size=size, shift=u,
                            dtype=torch.float32, device=dev)
        imgs.append(im - im.mean())
    return torch.stack(imgs), ks


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("emit", ["uv", "pw"])
def test_batched_sweep_kernel(dev, B, emit):
    """The grouped sweep's uv and phase/weight emissions on a stack of B
    256^2 lattices: one launch, each image's outputs the bits of its own
    single-image launch on the same windows, and the stack against the
    twin run image by image (uv: test_sweep_kernel's flip-tolerant
    bounds; pw: test_grouped_sweep_tensor_core_kernel's)."""
    imgs, ks = _lattice_stack(B, 256, dev)
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    plan = twfr.plan_sweep((256, 256), candidate_banks(ks), sigma,
                           2 * sigma, ks, gauss_cut=7.0)
    sw = twfr.GroupedSweep(plan, device=dev, emit=emit)
    Sr, Si = sw.windows(imgs)
    assert Sr.shape[:2] == (B, 3)
    rest = (sw.gx, sw.gy, sw.A0c, sw.A0s, sw.A1cb, sw.A1sb, sw.run, sw.off)
    rest += (sw.kconst,) if emit == "uv" else ()
    rest += (plan.dr, sw.banded)
    fn = tsweep.sweep_uv if emit == "uv" else tsweep.sweep_pw
    twin = tsweep.sweep_uv_plain if emit == "uv" else tsweep.sweep_pw_plain
    name = "sweep_" + emit
    before = _build.launches[name]
    got = fn(Sr, Si, *rest)
    assert _build.launches[name] == before + 1
    for i in range(B):
        one = fn(Sr[i].contiguous(), Si[i].contiguous(), *rest)
        for g, o in zip(got, one):
            assert torch.equal(g[i], o), (emit, B, i)
    want = twin(Sr, Si, *rest)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
    if emit == "uv":
        dx = (got[0] - want[0])[..., 1:].abs().flatten()
        dy = (got[1] - want[1])[..., 1:, :].abs().flatten()
        assert float(torch.quantile(dx[::7], 0.99)) < 1e-3
        assert float(torch.quantile(dy[::7], 0.99)) < 1e-3
        assert float(((got[2] - want[2]).abs()
                      / (want[2].abs() + 1e-9)).max()) < 5e-3
        return
    dph = torch.remainder(got[0] - want[0] + np.pi, 2 * np.pi) - np.pi
    dph = dph.abs().flatten()
    rel = ((got[1] - want[1]).abs() / (want[1].abs() + 1e-9)).flatten()
    assert float((dph > 1e-4).double().mean()) < 1e-2
    assert float(torch.quantile(dph[::7], 0.99)) < 5e-5
    assert float(torch.quantile(rel[::7], 0.99)) < 5e-5


@pytest.mark.parametrize("G,P,W0,Wb,n,m", [(3, 5, 64, 128, 256, 320),
                                           (2, 9, 32, 64, 128, 192)])
def test_batched_sweep_steps_at_other_shapes(dev, G, P, W0, Wb, n, m):
    """Stage 1, stage 2 and the uv epilogue on a stack of 3 images of
    synthetic operands (_grouped_ops' plan, each image its own windows):
    each image's T, phase, weight and uv planes the bits of its own
    single-image launch, and stage 2 against its float32 twin within
    test_grouped_sweep_tensor_core_kernel's bounds."""
    args = _grouped_ops(G, P, W0, Wb, n, m, 70 + n, dev)
    g = np.random.default_rng(71)
    Sr, Si = (torch.from_numpy(g.normal(size=(3, G, 2, W0, Wb)).astype(
        np.float32)).to(dev) for _ in range(2))
    T = tsweep.stage1(Sr, Si, *args[2:6], args[8])
    assert T.shape == (3, G, P, n, 2 * Wb)
    ph, wt = tsweep.stage2(T, args[6], args[7], args[9], 6, True)
    uv = tsweep.epilogue(ph, wt, args[10])
    for i in range(3):
        Ti = tsweep.stage1(Sr[i].contiguous(), Si[i].contiguous(),
                           *args[2:6], args[8])
        assert torch.equal(T[i], Ti)
        pi, wi = tsweep.stage2(Ti, args[6], args[7], args[9], 6, True)
        assert torch.equal(ph[i], pi) and torch.equal(wt[i], wi)
        for a, b in zip(uv, tsweep.epilogue(pi, wi, args[10])):
            assert torch.equal(a[i], b)
    pp, pw = tsweep.stage2(T.cpu(), *(a.cpu() for a in (args[6], args[7],
                                                          args[9])), 6, True)
    dph = torch.remainder(ph.cpu() - pp + np.pi, 2 * np.pi) - np.pi
    dph = dph.abs().flatten()
    rel = ((wt.cpu() - pw).abs() / (pw.abs() + 1e-9)).flatten()
    assert float((dph > 1e-4).double().mean()) < 1e-2
    assert float(torch.quantile(dph[::3], 0.99)) < 5e-5
    assert float(torch.quantile(rel[::3], 0.99)) < 5e-5


def test_stage1_splits_stacks_past_the_grid_limit(dev):
    """A stack whose stage-1 grid z (B G P) passes CUDA's 65535 runs in
    launches of whole images: the last image's T is the bits of its own
    launch. One image over the limit raises, naming it."""
    G, P, W0, Wb, n = 1, 48, 16, 64, 64
    B = tsweep.MAX_GRID_Z // (G * P) + 2
    g = np.random.default_rng(72)
    T_ = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    a0 = twfr._zoom_basis(n, np.arange(W0))
    ops = (T_(g.uniform(0.2, 1, size=(G, P, W0))),
           T_(g.uniform(0.2, 1, size=(G, P, Wb))),
           a0[0][None].to(dev).contiguous(), a0[1][None].to(dev).contiguous(),
           torch.zeros((G, P), dtype=torch.int32, device=dev))
    Sr = T_(g.normal(size=(B, G, 1, W0, Wb)))
    Si = T_(g.normal(size=(B, G, 1, W0, Wb)))
    T = tsweep.stage1(Sr, Si, *ops)
    for i in (0, B - 1):
        assert torch.equal(T[i], tsweep.stage1(Sr[i].contiguous(),
                                               Si[i].contiguous(), *ops))
    del T
    with pytest.raises(ValueError, match="65535"):
        tsweep._grid_z_ok("stage1", 1366, 48)


def _zoom_stack_ops(B, P, W0, W1, n, m, seed, dev):
    """_zoom_ops' plan with a stack of B seeded windows (B, W0, W1), and
    the gradient operands: B row-derivative windows and a seeded
    column-derivative basis (m, W1)."""
    ops = _zoom_ops(P, W0, W1, n, m, seed, dev)
    g = np.random.default_rng(seed + 1)
    T_ = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    win = [T_(g.normal(size=(B, W0, W1))) for _ in range(4)]
    basis = [T_(g.normal(size=(m, W1))) for _ in range(2)]
    return win[:2] + ops[2:], (win[2], win[3], basis[0], basis[1])


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("P,W1", [(5, 64), (42, 256)])
def test_batched_zoom_kernels(dev, B, P, W1):
    """The zoom sweep on a stack of B windows: one stage-1 and one
    stage-2 launch for the stack (and with gradients one "zoom_grad",
    the three gradient steps once each), each image's outputs, phase and
    weight, and gradients the bits of its own single-window launch, and
    the stack against the twin run window by window (check_zoom's bounds;
    the gradients _grad_close's)."""
    from pygpa_tpu_torch.ops import zoom_sweep as tz
    n, m = 128, 192
    ops, gops = _zoom_stack_ops(B, P, 64, W1, n, m, 100 + B + P, dev)
    before = dict(_build.launches)
    got = tz.zoom_sweep(*ops, dr=10)
    assert _build.launches["zoom_sweep"] == before.get("zoom_sweep", 0) + 1
    gr = tz.zoom_sweep(*ops, dr=10, grad_ops=gops)
    for name in ("zoom_grad", "grad_flags", "grad_stage1", "grad_products"):
        assert _build.launches[name] == before.get(name, 0) + 1, name
    assert all(o.shape == (B, n, m) for o in got + gr)
    for x, y in zip(gr[:4] + gr[6:], got):
        assert torch.equal(x, y)
    for i in range(B):
        one = (ops[0][i].contiguous(), ops[1][i].contiguous()) + tuple(
            ops[2:])
        gone = (gops[0][i].contiguous(), gops[1][i].contiguous()) + tuple(
            gops[2:])
        for x, y in zip(got, tz.zoom_sweep(*one, dr=10)):
            assert torch.equal(x[i], y), ("plain", i)
        for x, y in zip(gr, tz.zoom_sweep(*one, dr=10, grad_ops=gone)):
            assert torch.equal(x[i], y), ("grad", i)
    want = tz.zoom_sweep_plain(*ops, dr=10, grad_ops=gops)
    for i in range(B):
        wi = tuple(w[i] for w in want)
        gi = tuple(g[i] for g in gr)
        _zoom_agree(gi[:4] + gi[6:], wi[:4] + wi[6:], phase_weight=P > 1)
        agree = gi[3] == wi[3]
        for k in (4, 5):
            assert torch.isfinite(gi[k]).all()
            _grad_close(gi[k], wi[k], agree, wi[0])


@pytest.mark.parametrize("B", [1, 3, 16])
def test_batched_gradient_steps(dev, B):
    """The grouped gradient emission (b) on a stack of B images of
    synthetic windows, banded: the tournament that stores the winners,
    the band flags, stage 1 on the flagged pairs and the winner products
    each take the stack in one launch ("sweep_grad" once), and each
    image's planes are the bits of its own single-image emission; the
    flags equal their twin's and the stack's gradients meet
    _grad_close's bounds against the twin's steps."""
    G, P, W0, Wb, n, m = 3, 9, 64, 128, 256, 320
    a = list(_grad_ops_grouped(G, P, W0, Wb, n, m, 120 + B, dev, True))
    g = np.random.default_rng(121 + B)
    for k in range(4):
        a[k] = torch.from_numpy(g.normal(size=(B, G, 2, W0, Wb)).astype(
            np.float32)).to(dev)
    before = dict(_build.launches)
    got = tsweep.sweep_grad(*a)
    for name in ("sweep_grad", "grad_flags", "grad_stage1", "grad_products"):
        assert _build.launches[name] == before.get(name, 0) + 1, name
    assert all(o.shape == (B, G, n, m) for o in got)
    for i in range(B):
        one = tsweep.sweep_grad(*(x[i].contiguous() for x in a[:4]), *a[4:])
        for x, y in zip(got, one):
            assert torch.equal(x[i], y), i
    T = tsweep.stage1(*a[:2], *a[4:8], a[12])
    ph, wt, mr, mi, idx = tsweep.stage2(T, a[8], a[9], a[13], a[14], True,
                                        winners=True)
    assert torch.equal(ph, got[0]) and torch.equal(wt, got[1])
    flags = tsweep.band_winners(idx, P)
    assert flags.shape == (B, G, n // 64, P)
    assert torch.equal(flags, tsweep.band_winners_plain(idx.cpu(), P).to(dev))
    Tx = tsweep.stage1(a[2], a[3], *a[4:8], a[12], flags)
    want = tsweep.winner_products_plain(
        *(x.cpu() for x in (T, Tx, a[8], a[9], a[10], a[11], mr, mi, idx,
                            flags, a[13])), True)
    every = torch.ones(idx.shape, dtype=torch.bool)
    for k in (0, 1):
        _grad_close(got[2 + k].cpu(), want[k], every,
                    (mr * mr + mi * mi).cpu())


def test_zoom_stage2_splits_stacks_past_the_grid_limit(dev):
    """A zoom stack of more windows than CUDA's gridDim.z (65535) runs in
    launches of whole images (stage 1 and stage 2 both): the first and
    the last window's outputs are the bits of their own launches."""
    from pygpa_tpu_torch.ops import zoom_sweep as tz
    B, P, W0, W1, n = tsweep.MAX_GRID_Z + 2, 1, 16, 64, 64
    g = np.random.default_rng(73)
    T_ = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    a0 = twfr._zoom_basis(n, np.arange(W0))
    a1 = twfr._zoom_basis(n, np.arange(W1))
    ops = [T_(g.normal(size=(B, W0, W1))), T_(g.normal(size=(B, W0, W1))),
           T_(g.uniform(0.2, 1, size=(P, W0))),
           T_(g.uniform(0.2, 1, size=(P, W1))), a0[0].to(dev).contiguous(),
           a0[1].to(dev).contiguous(), a1[0].to(dev).contiguous(),
           a1[1].to(dev).contiguous()]
    got = tz.zoom_sweep(*ops, dr=4)
    for i in (0, B - 1):
        one = tz.zoom_sweep(ops[0][i].contiguous(), ops[1][i].contiguous(),
                            *ops[2:], dr=4)
        for x, y in zip(got, one):
            assert torch.equal(x[i], y), i


def _image_weights(B, n, m, seed, dev):
    g = np.random.default_rng(seed)
    w = g.uniform(0.05, 1.0, size=(B, 1, n, m))
    w[..., :8, :] = w[..., -8:, :] = w[..., :8] = w[..., -8:] = 1e-6
    return torch.from_numpy(w.astype(np.float32)).to(dev)


@pytest.mark.parametrize("B,C,n,m,cr", [(1, 2, 256, 384, 4),
                                        (3, 2, 256, 384, 4),
                                        (16, 2, 256, 384, 4),
                                        (3, 3, 48, 96, 2),
                                        (5, 1, 1024, 160, 16)])
def test_vcycle_kernels_with_per_image_weights(dev, B, C, n, m, cr):
    """presmooth and applyq on B images of C planes, image b with its own
    weight (B, 1, n, m): one launch per call (C odd and > 1: two inside
    it), each image's outputs the bits of its own one-weight launch,
    presmooth within 1e-5 of its twin and applyq its twin's bits."""
    phi, dxc, dyc = (_planes((B, C, n, m), s, dev) for s in (81, 82, 83))
    w = _image_weights(B, n, m, 84, dev)
    before = (_build.launches["presmooth"], _build.launches["applyq"])
    got = tvc.presmooth(phi, dxc, dyc, w, cr, 0.8)
    q = tvc.applyq(phi, w)
    assert (_build.launches["presmooth"], _build.launches["applyq"]) == (
        before[0] + 1, before[1] + 1)
    assert got[2].shape == (B, 1, n, m)
    want = tvc.presmooth_plain(phi, dxc, dyc, w, cr, 0.8)
    for g, t in zip(got, want):
        assert g.shape == t.shape and _rel(g, t) <= 1e-5
    assert torch.equal(q, tvc.applyq_plain(phi, w))
    for i in range(B):
        one = tvc.presmooth(phi[i], dxc[i], dyc[i], w[i, 0], cr, 0.8)
        for g, o in zip(got, one):
            assert torch.equal(g[i].reshape(o.shape), o)
        assert torch.equal(q[i], tvc.applyq(phi[i], w[i, 0]))


@pytest.mark.parametrize("B,n,m,kmax", [(1, 256, 256, 6), (3, 256, 256, 6),
                                        (16, 256, 256, 6),
                                        (3, 384, 640, 4),
                                        (2, 1024, 1024, 4)])
def test_cg_kernel_with_per_image_weights(dev, B, n, m, kmax):
    """The CG kernel on B images of 2 planes, image b with its own
    weights (B, 1, n, m), on the FFT route and (384 x 640) the dense
    one: one launch, within 1e-4 of its twin, and each image's solution
    the bits of its own one-weight launch."""
    from pygpa_tpu_torch.solvers.unwrap import _residual_aligned
    dxp, dyp = _planes((B, 2, n, m), 91, dev), _planes((B, 2, n, m), 92,
                                                       dev)
    dxp[..., -1] = 0
    dyp[..., -1, :] = 0
    rk, WWx, WWy = _residual_aligned(dxp, dyp,
                                     _image_weights(B, n, m, 93, dev))
    assert WWx.shape == (B, 1, n, m)
    before = _build.launches["cg_poisson"]
    got = tcg.cg_poisson(rk, WWx, WWy, kmax)
    assert _build.launches["cg_poisson"] == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, tcg.cg_poisson_plain(rk, WWx, WWy, kmax)) <= 1e-4
    for i in range(B):
        assert torch.equal(got[i], tcg.cg_poisson(
            rk[i].contiguous(), WWx[i, 0].contiguous(),
            WWy[i, 0].contiguous(), kmax))


@pytest.mark.parametrize("size,nb,kw", [(512, 16, {}),
                                        (1024, 2, {"chunk": 4}),
                                        (512, 3, {"deconvolve": True}),
                                        (512, 3, "eager"),
                                        (512, 3, "batch"),
                                        (512, 3, "factory")])
def test_extractor_stack_makes_no_host_sync(dev, size, nb, kw):
    """One call of the multigrid extractor on a stack (config 1b's 16 x
    512^2, two 1024^2 images, and three with the Wiener deconvolution),
    and of the eager extract_displacement_field, of
    parallel.extract_displacement_field_batch (which reads the free
    memory to size its calls) and of the factory at its defaults (the
    exact early-stopping CG kernel) on a stack of three,
    makes no synchronizing CUDA operation from the port's code
    (torch.cuda.set_sync_debug_mode("warn"), each warning's call site):
    the host never waits for the card inside the call, so a tile
    loader's host reads can overlap the device work queued before them.
    Found on the card: the multigrid's block-mean and resize weights and
    the deconvolution's transfer copied host data to the card, a sync
    each."""
    import os
    import warnings
    from pygpa_tpu_torch.gpa.pipeline import (extract_displacement_field,
                                              make_displacement_extractor)
    from pygpa_tpu_torch.parallel import extract_displacement_field_batch
    imgs, ks = _lattice_stack(nb, size, dev)
    if kw == "eager":
        def fn(x):
            return extract_displacement_field(x, ks, device=dev)
    elif kw == "batch":
        def fn(x):
            return extract_displacement_field_batch(x, ks, device=dev)
    elif kw == "factory":
        fn = make_displacement_extractor((size, size), ks, device=dev)
    else:
        fn = make_displacement_extractor((size, size), ks, unwrap_coarse=4,
                                         device=dev, **kw)
    fn(imgs)
    torch.cuda.synchronize()
    pkg = os.path.dirname(os.path.abspath(tsweep.__file__))
    pkg = os.path.dirname(pkg)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(imgs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ours = [f"{w.filename}:{w.lineno}" for w in rec
            if "synchroniz" in str(w.message)
            and os.path.abspath(w.filename).startswith(pkg)]
    assert not ours, ours


def test_kernel_smoke_launches_every_entry(dev):
    """ops.kernel_smoke on the card: every kernel entry launches (its
    counter rises) and gives finite outputs."""
    from pygpa_tpu_torch.ops.kernel_smoke import run_kernel_smoke
    assert run_kernel_smoke(device=dev)


def _fit_stack(B, n, m, seed, outliers):
    """B tilted planes (slopes ~1e-2 rad/px, offsets of several radians,
    as the quick start's unwrapped phases) with unit noise and a share
    `outliers` of gross outliers (+-10 ... 100), float32."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(n), np.arange(m), indexing="ij")
    out = np.empty((B, n, m), np.float32)
    for b in range(B):
        a0, a1 = rng.uniform(-0.02, 0.02, size=2)
        p = a0 * xx + a1 * yy + rng.uniform(5.0, 30.0) \
            + rng.normal(size=(n, m))
        bad = rng.uniform(size=(n, m)) < outliers
        p[bad] += rng.choice([-1.0, 1.0], size=int(bad.sum())) \
            * rng.uniform(10.0, 100.0, size=int(bad.sum()))
        out[b] = p
    return out


def _flat_stack(B, n, m):
    """B planes of an order-one field odd about the grid's centre in both
    axes (its own fit is zero), plus slopes of ~1e-9 rad/px and offsets
    of a few 1e-5 rad, float32: the w v sums cancel to 1e-5 of their
    terms, where float32 partials of 16 pixels would miss the offset by
    more than 1e-5 of it."""
    x = np.arange(n)[:, None] - (n - 1) / 2
    y = np.arange(m)[None, :] - (m - 1) / 2
    field = np.sin(2 * np.pi * x / 1531) * np.sin(2 * np.pi * y / 977)
    out = np.empty((B, n, m), np.float32)
    for b, (a0, a1, c) in enumerate(((2e-9, -1e-9, 3e-5), (-3e-9, 2e-9, -5e-5),
                                     (1e-9, 1e-9, 1.5e-5))[:B]):
        out[b] = field + a0 * x + a1 * y + c
    return out


@pytest.mark.parametrize("case", ["1x48x40", "3x4086x4086",
                                  "2x500x374 shared mask",
                                  "2x500x374 per-image mask", "16x512x512",
                                  "2x256x320 20% outliers", "3x37x41",
                                  "3x4086x4086 from 1",
                                  "3x333x517 per-image mask",
                                  "3x1001x999 per-image mask from 3",
                                  "3x4086x4086 near-zero offset"])
def test_fit_plane_kernel(dev, case):
    """The plane fit's kernel (ops.fit, csrc/fit_plane.cu) against its
    twin's fit of a float64 copy: the slopes within 1e-5 of the larger
    |slope| of each plane, the offset within 1e-5 of |offset| (the
    float32 bound test_fit_plane_matches holds the twin to, applied to
    the slopes and the offset apart: at 4086^2 the offset is many
    radians and a slope ~1e-2 rad/px); a second call bit for bit; finite;
    exactly iters + 1 launches, counted by the wrapper and in the call's
    captured graph (ops._build.graph_kernels), with no other kernel (no
    solver library) in the fit. Planes off the 16-byte grid: n m not a
    multiple of 4 (37 x 41, 333 x 517, 1001 x 999: every plane past the
    first starts off it) and "from s", a stack that starts s floats past
    it; "per-image mask": a mask a plane. "near-zero offset": phases of
    order one whose plane is nearly flat with an offset ~1e-5 of them, as
    refine_ks's last fits see them (the sums of w v cancel)."""
    from pygpa_tpu_torch.ops import fit as tfit
    dims, *rest = case.split(" ")
    B, n, m = (int(s) for s in dims.split("x"))
    if "near-zero" in case:
        img = torch.from_numpy(_flat_stack(B, n, m)).to(dev)
    else:
        img = torch.from_numpy(_fit_stack(
            B, n, m, B * n + m, 0.2 if "20%" in case else 0.05)).to(dev)
    if "from" in case:
        start = int(case.split("from ")[1])
        buf = torch.empty(B * n * m + start, device=dev)
        buf[start:] = img.flatten()
        img = buf[start:].view(B, n, m)
        assert img.data_ptr() % 16 == 4 * start
    mask = None
    if "mask" in case:
        g = np.random.default_rng(n)
        mk = g.uniform(size=(n, m)) > 0.3
        mk[n // 4:n // 2, m // 3:m // 2] = False
        mask = torch.from_numpy(
            mk if "shared" in case
            else np.stack([mk, mk[::-1], mk[:, ::-1]][:B])).to(dev)
    iters = 60
    before = _build.launches["fit_plane"]
    got = tfit.fit_plane_irls(img, mask, 1.0, iters)
    counted = _build.launches["fit_plane"] - before
    again = tfit.fit_plane_irls(img, mask, 1.0, iters)
    want = tfit.fit_plane_irls_plain(img.double(), mask, 1.0, iters)
    torch.cuda.synchronize()
    graph = _build.graph_kernels(lambda: tfit.fit_plane_irls(img, mask, 1.0,
                                                             iters))
    assert got.shape == (B, 3) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert counted == iters + 1
    assert len(graph) == iters + 1, graph
    assert all("irls_step_kernel" in nm for nm in graph), graph
    d = (got.double() - want).abs()
    slope = want[:, :2].abs().amax(-1)
    assert bool((d[:, :2].amax(-1) <= 1e-5 * slope).all()), (got, want)
    assert bool((d[:, 2] <= 1e-5 * want[:, 2].abs()).all()), (got, want)
