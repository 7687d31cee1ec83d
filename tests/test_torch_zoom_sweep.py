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
from pygpa_tpu_torch.ops import sweep as TSW
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
    """Where the grouped gate holds (float32, 256^2, three banks of 36),
    wfr_sweep_phase_weight_multi runs the grouped phase/weight emission
    (its twin here, no launch counted) and agrees with the per-peak
    sweep of the same bank: weights within rtol 1e-4, phases within
    1e-4 rad where the weight is above 1e-3 of its maximum."""
    img, k, wl, sigma = _lattice()
    dr = 2 * sigma
    assert TW.plan_sweep(img.shape, [wl] * 3, sigma, dr) is not None
    _build.launches.clear()
    ph, wt = (a.numpy() for a in TW.wfr_sweep_phase_weight_multi(
        torch.from_numpy(img), [wl] * 3, sigma, dr))
    assert sum(_build.launches.values()) == 0
    assert ph.shape == wt.shape == (3,) + img.shape
    ph1, wt1 = (a.numpy() for a in TW.wfr_sweep_phase_weight(
        torch.from_numpy(img), wl, k, sigma, dr))
    for g in range(3):
        np.testing.assert_allclose(wt[g], wt1, rtol=1e-4,
                                   atol=1e-6 * wt1.max())
        live = wt1 > 1e-3 * wt1.max()
        assert np.abs(np.angle(np.exp(1j * (ph[g] - ph1)))[live]).max() \
            < 1e-4


def test_continuity_and_grad_options_match_reference():
    """continuity_dk (the wfr4 scan, on the zoom window here) runs and
    matches the reference's: winning candidates on >= 99% of the 5 sigma
    interior, the lock-in within 1e-4 of its peak there; with_grad
    returns the winner gradient (n, m, 2), rebased to [-pi/2, pi/2),
    within 1e-4 rad/px of the reference's np.gradient route on the 5
    sigma interior (the analytic form here: the zoom kernel's twin)."""
    img, k, wl, sigma = _lattice(128)
    b = 5 * sigma
    dk = float(wl[1, 1] - wl[0, 1])      # one step of the bank
    g4 = TW.wfr_sweep(torch.from_numpy(img), wl, k, sigma, continuity_dk=dk)
    w4 = W.wfr_sweep(jnp.asarray(img), wl, k, sigma, continuity_dk=dk)
    same = (g4["w"].numpy() == np.asarray(w4["w"])).all(0)[b:-b, b:-b]
    assert same.mean() >= 0.99
    lw = np.asarray(w4["lockin"])[b:-b, b:-b]
    assert np.abs(g4["lockin"].numpy()[b:-b, b:-b] - lw)[same].max() \
        <= 1e-4 * np.abs(lw).max()
    got = TW.wfr_sweep(torch.from_numpy(img), wl, k, sigma, with_grad=True)
    want = W.wfr_sweep(jnp.asarray(img), wl, k, sigma, with_grad=True)
    g = got["grad"].numpy()
    assert g.shape == img.shape + (2,) and g.dtype == np.float32
    assert g.min() >= -np.pi / 2 and g.max() < np.pi / 2
    b = 5 * sigma
    same = (got["w"].numpy() == np.asarray(want["w"])).all(0)[b:-b, b:-b]
    assert same.mean() > 0.99
    d = np.abs(g - np.asarray(want["grad"]))[b:-b, b:-b][same]
    assert d.max() < 1e-4


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


def _tf32_rna(x):
    """cvt.rna.tf32.f32 by bit operations: the float32 mantissa rounded
    to its top 10 bits, half away from zero (add half of the 13 dropped
    bits' unit to the magnitude, then clear them)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """The kernel's split: hi = tf32(x), lo = tf32(x - hi)."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _f32_toward_zero(x):
    """float64 -> float32 rounded toward zero: how a tensor-core mma
    leaves its float32 accumulator."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _stage2_tensor_cores(T, A1c, A1s, passes, chain=32, split=False):
    """csrc/zoom_sweep.cu's stage 2 as its tensor cores compute it: M_r =
    Tr A1c^T - Ti A1s^T and M_i = Tr A1s^T + Ti A1c^T (P, n, m) from T
    (P, n, 2 W1), in the kernel's order (per 8-deep group of W1: the Tr
    product, then the Ti one), each float32 product a b taken as the
    TF32 products `passes` ((a part, b part) in order, of 'hi' and 'lo')
    into a float32 accumulator. One mma adds its 8 exact products to the
    accumulator and truncates the sum to float32, as the card's tensor
    cores do. A chain of mma runs over `chain` columns of W1 (the
    kernel's 32: one stage) from zero, and the chains' sums are added
    in float32, rounded to nearest. With `split` (the grouped sweep's
    tile, sweep_tc.cuh SPLIT) every pass but hi.hi goes into a second
    chain, added to the first's sum before the stage sum."""
    W1 = A1c.shape[1]
    halves = {"r": _split(T[..., :W1]), "i": _split(T[..., W1:])}
    basis = {"c": _split(A1c), "s": _split(A1s), "-s": _split(-A1s)}
    part = {"hi": 0, "lo": 1}
    terms = {"r": (("r", "c"), ("i", "-s")), "i": (("r", "s"), ("i", "c"))}
    shape = T.shape[:2] + A1c.shape[:1]
    total = {out: np.zeros(shape, np.float32) for out in terms}
    for k0 in range(0, W1, chain):
        acc = {out: np.zeros(shape, np.float32) for out in terms}
        sml = {out: np.zeros(shape, np.float32) for out in terms}
        for k in range(k0, min(k0 + chain, W1), 8):
            for out, pairs in terms.items():
                for h, b in pairs:
                    for pa, pb in passes:
                        a = halves[h][part[pa]][..., k:k + 8]
                        bb = basis[b][part[pb]][:, k:k + 8]
                        into = sml if split and (pa, pb) != ("hi", "hi") \
                            else acc
                        into[out] = _f32_toward_zero(into[out] + np.einsum(
                            "pnk,mk->pnm", a.astype(np.float64),
                            bb.astype(np.float64)))
        for out in terms:
            total[out] = total[out] + (acc[out] + sml[out])
    return total["r"], total["i"]


def _stage1_float32(ops, W1):
    """Stage 1's T (P, n, 2 W1) in float32 from _operands' arrays, and
    the float64 tournament of the stage-2 products of that T."""
    Sr, Si, gx, gy, A0c, A0s, A1c, A1s = ops
    Swr = gx[:, :, None] * Sr[None] * gy[:, None, :]
    Swi = gx[:, :, None] * Si[None] * gy[:, None, :]
    T = np.concatenate([A0c @ Swr - A0s @ Swi, A0c @ Swi + A0s @ Swr],
                       -1).astype(np.float32)
    T64, c64, s64 = (a.astype(np.float64) for a in (T, A1c, A1s))
    Tr, Ti = T64[..., :W1], T64[..., W1:]
    return T, _tournament(Tr @ c64.T - Ti @ s64.T, Tr @ s64.T + Ti @ c64.T)


def _tournament(Mr, Mi):
    """Strict '>' from a zero start over the candidates (the kernel's
    and the twin's rule): best |M|^2, Re, Im, index."""
    ba = np.zeros(Mr.shape[1:], Mr.dtype)
    br, bi = np.zeros_like(ba), np.zeros_like(ba)
    bx = np.zeros(ba.shape, np.int32)
    for i in range(Mr.shape[0]):
        a = Mr[i] * Mr[i] + Mi[i] * Mi[i]
        better = a > ba
        ba, br, bi = (np.where(better, x, y) for x, y in
                      ((a, ba), (Mr[i], br), (Mi[i], bi)))
        bx = np.where(better, i, bx)
    return ba, br, bi, bx


def _check_zoom_excess(got, want):
    """chip_smoke.py check_zoom's numbers, each as a fraction of its
    bound (<= 1 passes): winner disagreement over 1%, |M|^2 beyond rtol
    1e-4 (atol 1e-7 of its max), Re and Im beyond 1e-3 of max |M|, the
    phase beyond 1e-5 rad where |M|^2 >= 1e-6 of its max, the weight
    sqrt(|M|^2) beyond rtol 1e-5 (atol 1e-6)."""
    same = got[3] == want[3]
    amax = want[0].max()
    top = np.sqrt(amax)
    live = same & (want[0] >= 1e-6 * amax)
    dph = np.angle(np.exp(1j * (np.arctan2(got[2], got[1]).astype(np.float64)
                                - np.arctan2(want[2], want[1]))))
    wg, ww = np.sqrt(got[0]).astype(np.float64), np.sqrt(want[0])
    return {
        "winners": (1 - same.mean()) / 0.01,
        "absq": max((np.abs(got[0] - want[0]) - 1e-4 * want[0])[same].max(),
                    0) / (1e-7 * amax),
        "re": np.abs(got[1] - want[1])[same].max() / (1e-3 * top),
        "im": np.abs(got[2] - want[2])[same].max() / (1e-3 * top),
        "phase": np.abs(dph[live]).max() / 1e-5,
        "weight": max((np.abs(wg - ww) - 1e-5 * ww)[same].max(), 0) / 1e-6,
    }


def test_tf32_rounding_by_bits():
    """cvt.rna's rule: 10 mantissa bits, a half ulp rounds away from zero
    on both signs; hi + lo keeps x to 2^-22 of its size."""
    one = np.float32(1.0)
    half = np.float32(2.0 ** -11)          # half a TF32 ulp at 1
    got = _tf32_rna(np.array([one + half, -(one + half), one + half / 2,
                              np.float32(3.0)], np.float32))
    np.testing.assert_array_equal(
        got, np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1, 3], np.float32))
    x = np.random.default_rng(7).normal(size=4096).astype(np.float32)
    hi, lo = _split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    err = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert err.max() <= 2.0 ** -22


def _split_cases(seed, shape):
    """Seeded basis planes with the rounding's edge cases written in:
    exact half-ulp ties of both signs, zeros of both signs, values just
    below and above a tie, subnormals, and magnitudes near float32's
    largest."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    b = x.reshape(-1).view(np.uint32)
    edge = np.array([0x3F801000, 0xBF801000, 0x00000000, 0x80000000,
                     0x3F800FFF, 0x3F801001, 0x00001234, 0x80FFF000,
                     0x7F7FEFFF, 0xFF7FEFFF, 0x40490FDB, 0xC0490FDB],
                    np.uint32)
    b[:edge.size] = edge
    return b.view(np.float32).reshape(shape)


@pytest.mark.parametrize("shape", [(1, 64, 64), (3, 128, 32), (2, 64, 256)])
def test_split_basis_twin_is_the_kernels_rounding(shape):
    """The basis split's twin (ops.sweep.split_basis_plain, the bits the
    split kernel must give on the card) against the bit emulation of
    cvt.rna above: planes -hi(A1s), hi(A1c), hi(A1s), -lo(A1s), lo(A1c),
    lo(A1s), bit for bit (the negation a sign-bit flip, zeros included),
    each a TF32 value (13 low mantissa bits clear)."""
    c, s = _split_cases(11, shape), _split_cases(12, shape)
    got = TSW.split_basis_plain(torch.from_numpy(c), torch.from_numpy(s))
    assert got.shape == shape[:1] + (6,) + shape[1:]
    (ch, cl), (sh, sl) = _split(c), _split(s)
    flip = lambda x: (x.view(np.uint32) ^ np.uint32(0x80000000)).view(
        np.float32)
    want = np.stack([flip(sh), ch, sh, flip(sl), cl, sl], axis=1)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert not (got.numpy().view(np.uint32) & 0x1FFF).any()


def test_split_of_the_negated_basis_is_the_negated_split():
    """Why the -A1s planes are A1s's split with the sign bit flipped
    rather than a split of -A1s: the two agree (cvt.rna rounds half away
    from zero on both signs) but for the sign of a zero lo, where x is a
    TF32 value; the flip is what the mma.sync kernel took (Ti times the
    sign-flipped split of A1s), so the products keep their bits, the
    signs of zeros included."""
    x = _split_cases(13, (2, 64, 64))
    for got, want in zip(_split(-x), _split(x)):
        np.testing.assert_array_equal(got, -want)
    lo = _split(x)[1]
    differ = _split(-x)[1].view(np.uint32) != (-lo).view(np.uint32)
    assert differ.any() and (lo[differ] == 0).all()


def test_split_basis_wrapper_dispatch():
    """A CPU tensor runs the split's twin and counts no launch; another
    device raises."""
    c = torch.from_numpy(_split_cases(14, (1, 64, 64)))
    _build.launches.clear()
    assert torch.equal(TSW.split_basis(c, -c),
                       TSW.split_basis_plain(c, -c))
    assert sum(_build.launches.values()) == 0
    with pytest.raises(ValueError, match="device"):
        TSW.split_basis(c.to("meta"), c.to("meta"))


def test_three_tf32_passes_meet_the_kernel_bounds_and_one_does_not():
    """The zoom kernel's 3xTF32 arithmetic (lo.hi, hi.lo, hi.hi per
    product, truncating float32 accumulation), emulated at P = 3, n = m
    = 64, W1 = 64, stays within chip_smoke.py's check_zoom bounds of the
    float64 product of the same stage-1 output; one TF32 pass (hi.hi)
    misses the 1e-5 rad phase bound, which is why the kernel takes
    three."""
    ops = _operands(8, 3, 64, 64, 64, 64, glo=0.2)
    A1c, A1s = ops[6], ops[7]
    T, want = _stage1_float32(ops, 64)
    three = _check_zoom_excess(_tournament(*_stage2_tensor_cores(
        T, A1c, A1s, (("lo", "hi"), ("hi", "lo"), ("hi", "hi")))), want)
    one = _check_zoom_excess(_tournament(*_stage2_tensor_cores(
        T, A1c, A1s, (("hi", "hi"),))), want)
    assert max(three.values()) <= 1, three
    assert one["phase"] > 1, one


def test_truncating_chains_restart_every_stage():
    """Why the kernel restarts its tensor-core chain every 32 columns of
    W1: the tensor cores truncate each mma's sum to float32, and over one
    chain of W1 = 512 columns (384 mma per output) that shrinks |M| past
    check_zoom's weight rtol of 1e-5 against the float64 product, while
    one chain per 32-column stage, its sums added in float32 rounded to
    nearest, stays within every check_zoom bound (emulated at P = 3,
    W0 = 64, n = m = 64)."""
    ops = _operands(21, 3, 64, 512, 64, 64, glo=0.2)
    T, want = _stage1_float32(ops, 512)
    passes = (("lo", "hi"), ("hi", "lo"), ("hi", "hi"))
    per_stage = _check_zoom_excess(_tournament(*_stage2_tensor_cores(
        T, ops[6], ops[7], passes, chain=32)), want)
    one_chain = _check_zoom_excess(_tournament(*_stage2_tensor_cores(
        T, ops[6], ops[7], passes, chain=512)), want)
    assert max(per_stage.values()) <= 1, per_stage
    assert one_chain["weight"] > 1, one_chain
