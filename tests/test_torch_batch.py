"""The batch axis of the port's displacement extractor on the CPU: a
stack (B, n, m) through make_displacement_extractor's run against
jax.jit(jax.vmap(the reference's run)) on every route, the stack
against the port's own per-image calls, the V-branch and CG twins with
per-image weights against a loop of their one-weight forms,
parallel.extract_displacement_field_batch against the reference's, the
eager path on a stack against the vmapped reference, and both gradient
emissions and the per-peak route on a stack against a loop of
single-image calls."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpa_tpu import gpa as jgpa
from pygpa_tpu.gpa import pipeline as jpipe
from pygpa_tpu.lattices import generate_ks, hexlattice_gen
from pygpa_tpu.parallel import (
    extract_displacement_field_batch as j_batch)
from pygpa_tpu_torch.gpa import pipeline as tpipe
from pygpa_tpu_torch.ops import cg as tcg
from pygpa_tpu_torch.ops import sweep as tsweep
from pygpa_tpu_torch.ops import vcycle as tvc
from pygpa_tpu_torch.ops import wfr as twfr
from pygpa_tpu_torch.parallel import extract_displacement_field_batch
from pygpa_tpu_torch.solvers.unwrap import _residual_aligned

torch.set_num_threads(2)
SIZE, R_K, THETA = 256, 0.1, 7.0
B = 8           # the 8-sigma border of config 1b's gate (sigma 10 here)


def stack_1b(nb=3, size=SIZE, dtype=np.float32):
    """Config 1b's images (benchmarks/run_all.py:87-118) at `size`, each
    given a field of its own: the lattice (r_k 0.1, theta 7 deg, order 2)
    displaced in image i by the bench's bump scaled by (i + 1) / nb
    (dc-free peaks ~0.56 (i + 1) px at 256^2) plus 1b's constant shift of 0.31
    i px; the last image has a hole of seeded noise (3 times the
    lattice's std) off centre, so its weight differs from the others'
    where the phases are garbage: a stack that mixes the images up,
    returns zeros or hands one image another's weight fails the bounds
    (a shared weight moves the last image by ~0.7 px)."""
    S = size // 2
    xp, yp = np.meshgrid(np.arange(-S, S), np.arange(-S, S), indexing="ij")
    bump = 0.1 * xp * np.exp(-0.5 * ((xp / (S / 4)) ** 2
                                     + 1.2 * (yp / (S / 3)) ** 2))
    env = 1 - np.exp(-(np.hypot(xp + S / 2, yp - S / 2) / (S / 5)) ** 4)
    out = []
    for i in range(nb):
        u = np.stack([bump * (i + 1) / nb + 0.31 * i,
                      np.full_like(bump, 0.31 * i)]).astype(np.float32)
        im = np.asarray(hexlattice_gen(R_K, THETA, order=2, size=size,
                                       shift=u, dtype=jnp.float32),
                        np.float64)
        if i == nb - 1:
            noise = np.random.default_rng(7).normal(size=im.shape)
            im = im * env + 3 * im.std() * noise * (1 - env)
        out.append(im)
    return np.stack(out).astype(dtype)


def distinct_fields(u):
    """Each image's field (dc removed, interior) lies over 0.1 px, a
    hundred times the bounds below, from 0 and from every other image's:
    what those bounds must tell apart."""
    u = interior(np.asarray(u))
    u = u - u.mean(axis=(-2, -1), keepdims=True)
    assert np.abs(u).max(axis=(1, 2, 3)).min() > 0.1
    for i in range(len(u)):
        for j in range(i):
            assert np.abs(u[i] - u[j]).max() > 0.1, (i, j)


def interior(a, b=B):
    return a[..., b:-b, b:-b]


def flip_tolerant(got, want, p99, mx):
    """Interior p99 and max of |got - want| within p99 and mx."""
    d = np.abs(interior(np.asarray(got) - np.asarray(want)))
    assert np.quantile(d, 0.99) < p99 and d.max() < mx, (
        np.quantile(d, 0.99), d.max())


@pytest.mark.parametrize("route", ["multigrid", "exact", "pw"])
def test_batched_factory_matches_vmapped_reference(monkeypatch, route):
    """3 x 256^2 stack_1b images in one call of the port's run, against
    jax.jit(jax.vmap(the reference's run)) on the reference's own CPU
    route (its plain XLA sweep and solves; tests/test_torch_pipeline.py
    holds one image against its Pallas kernels in interpret mode, which
    under vmap cost ~40 s a call): the uv route with the multigrid
    (unwrap_coarse=4) and the exact CG (unwrap_coarse=None), and the
    phase/weight route (DEFAULTS.pipeline_fused_uv = False in both
    packages, multigrid); each image's interior within 1e-3 px
    (test_extractor_matches_reference's bound)."""
    jax.clear_caches()
    if route == "pw":
        for mod in (tpipe, jpipe):
            monkeypatch.setattr(mod, "DEFAULTS", mod.DEFAULTS.__class__(
                pipeline_fused_uv=False))
    uc = None if route == "exact" else 4
    imgs = stack_1b()
    ks = np.array(generate_ks(R_K, THETA))[:3]
    jfn = jpipe.make_displacement_extractor((SIZE, SIZE), ks, chunk=4,
                                            unwrap_coarse=uc)
    want = np.asarray(jax.jit(jax.vmap(jfn))(jnp.asarray(imgs)))
    fn = tpipe.make_displacement_extractor((SIZE, SIZE), ks, chunk=4,
                                           unwrap_coarse=uc, device="cpu")
    assert fn.plan is not None
    got = fn(torch.from_numpy(imgs))
    assert got.shape == (3, 2, SIZE, SIZE) and got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(got).all()
    distinct_fields(want)
    assert np.abs(interior(got - want)).max() < 1e-3


def test_per_peak_route_float64_matches_vmapped_reference():
    """float64 images leave the grouped plan in both packages: the port's
    run takes the per-peak route image by image, the reference vmaps it;
    each image's interior within 1e-3 px."""
    size = 128
    imgs = stack_1b(size=size, dtype=np.float64)
    ks = np.array(generate_ks(R_K, THETA))[:3]
    jfn = jpipe.make_displacement_extractor((size, size), ks, chunk=4,
                                            unwrap_coarse=4,
                                            dtype=jnp.float64)
    want = np.asarray(jax.jit(jax.vmap(jfn))(jnp.asarray(imgs)))
    fn = tpipe.make_displacement_extractor((size, size), ks, chunk=4,
                                           unwrap_coarse=4,
                                           dtype=torch.float64, device="cpu")
    assert fn.plan is None
    got = fn(torch.from_numpy(imgs)).numpy()
    assert got.shape == (3, 2, size, size)
    distinct_fields(want)
    assert np.abs(interior(got - want)).max() < 1e-3


@pytest.mark.parametrize("uc", [4, None])
def test_stack_equals_per_image_calls(uc):
    """The stack's fields against the port's own per-image calls: the
    stack's spectrum windows come from other products than one image's,
    so a near-tie winner may flip (interior p99 < 1e-5 px, max < 1e-3
    px); and a stack of one is the unbatched call, bit for bit."""
    imgs = torch.from_numpy(stack_1b())
    ks = np.array(generate_ks(R_K, THETA))[:3]
    fn = tpipe.make_displacement_extractor((SIZE, SIZE), ks, chunk=4,
                                           unwrap_coarse=uc, device="cpu")
    got = fn(imgs)
    loop = torch.stack([fn(im) for im in imgs])
    distinct_fields(loop)
    flip_tolerant(got.numpy(), loop.numpy(), 1e-5, 1e-3)
    assert torch.equal(fn(imgs[:1])[0], loop[0])


def _planes(shape, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.normal(size=shape).astype(np.float32))


def _weights(nb, n, m, seed):
    g = np.random.default_rng(seed)
    w = g.uniform(0.05, 1.0, size=(nb, 1, n, m))
    w[..., :4, :] = w[..., -4:, :] = 1e-6
    return torch.from_numpy(w.astype(np.float32))


def test_twins_with_per_image_weights_equal_a_loop():
    """presmooth_plain, applyq_plain and cg_poisson_plain on planes (3, 2,
    n, m) with weights (3, 1, n, m): bit for bit the loop of their
    one-weight (n, m) forms over the images."""
    nb, n, m, cr = 3, 64, 96, 4
    phi, dxc, dyc = (_planes((nb, 2, n, m), s) for s in (1, 2, 3))
    w = _weights(nb, n, m, 4)
    got = tvc.presmooth_plain(phi, dxc, dyc, w, cr, 0.8)
    assert got[2].shape == (nb, 1, n, m)
    for i in range(nb):
        one = tvc.presmooth_plain(phi[i], dxc[i], dyc[i], w[i, 0], cr, 0.8)
        for g, o in zip(got, one):
            assert torch.equal(g[i].reshape(o.shape), o)
        assert torch.equal(tvc.applyq_plain(phi, w)[i],
                           tvc.applyq_plain(phi[i], w[i, 0]))
    dxp, dyp = _planes((nb, 2, n, m), 5), _planes((nb, 2, n, m), 6)
    dxp[..., -1] = 0
    dyp[..., -1, :] = 0
    rk, WWx, WWy = _residual_aligned(dxp, dyp, w)
    assert WWx.shape == (nb, 1, n, m)
    phi_cg = tcg.cg_poisson_plain(rk, WWx, WWy, 4)
    for i in range(nb):
        assert torch.equal(phi_cg[i], tcg.cg_poisson_plain(
            rk[i], WWx[i, 0], WWy[i, 0], 4))


def test_image_axis_reads_the_weight_layout():
    """The kernels' wrappers read a weight (n, m) as one image of every
    plane, (B, 1, n, m) beside (B, C, n, m) as B images of C planes, and
    refuse a weight whose images do not lead."""
    p = torch.zeros((3, 2, 8, 8))
    assert tvc.image_axis("t", p, torch.zeros((8, 8))) == (1, 6)
    assert tvc.image_axis("t", p, torch.zeros((3, 1, 8, 8))) == (3, 2)
    assert tvc.image_axis("t", p, torch.zeros((3, 2, 8, 8))) == (6, 1)
    with pytest.raises(ValueError, match="image axes leading"):
        tvc.image_axis("t", p, torch.zeros((1, 2, 8, 8)))


def _parallel_stack():
    """tests/test_parallel.py's stack: the 96^2 float64 lattice (r_k 0.12,
    theta 9 deg, order 1) less its mean, rolled and flipped, 8 images."""
    img = np.array(hexlattice_gen(0.12, 9.0, order=1, size=96,
                                  dtype=np.float64))
    img = img - img.mean()
    ks = np.array(generate_ks(0.12, 9.0))[:3]
    return np.stack([img, np.roll(img, 5, axis=0), np.roll(img, -3, axis=1),
                     img[::-1], img, np.roll(img, 2, axis=0),
                     np.roll(img, 1, axis=1), img]), ks


def test_extract_displacement_field_batch_matches_reference():
    """The port's extract_displacement_field_batch on tests/test_parallel.py's
    rolled and flipped stack (8 x 96^2, float64) against the
    reference's (jax.vmap of the eager function) within 1e-8 px, image 1
    against the port's eager call, and a mesh that is no DeviceMesh
    refused (the sharded batch itself: tests/test_torch_parallel.py)."""
    batch, ks = _parallel_stack()
    want = np.asarray(j_batch(batch, ks))
    got = extract_displacement_field_batch(batch, ks, device="cpu")
    assert got.shape == (8, 2, 96, 96) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8)
    one = tpipe.extract_displacement_field(batch[1], ks, device="cpu")
    np.testing.assert_array_equal(got[1].numpy(), one.numpy())
    np.testing.assert_allclose(
        got[1].numpy(), np.asarray(jgpa.extract_displacement_field(
            batch[1], ks)), rtol=0, atol=1e-8)
    with pytest.raises(TypeError, match="DeviceMesh"):
        extract_displacement_field_batch(batch, ks, mesh=object(),
                                         device="cpu")


@pytest.mark.parametrize("shape,itemsize,free,want", [
    ((4096, 4096), 4, 80e9, 15), ((4096, 4096), 4, 45e9, 8),
    ((4096, 4096), 8, 80e9, 7), ((512, 512), 4, 1e6, 1),
    ((96, 96), 8, 80e9, 15069)])
def test_images_per_call_fits_the_free_memory(shape, itemsize, free, want):
    """The eager batch call's chunk: the free memory over the estimated
    per-image peak (EAGER_BYTES_PER_PIXEL a float32 pixel, scaled by the
    itemsize), less one image for the call's fixed part, at least 1."""
    from pygpa_tpu_torch.parallel import sharded
    got = sharded.images_per_call(shape, itemsize, free)
    assert got == want
    per = sharded.EAGER_BYTES_PER_PIXEL * shape[0] * shape[1] * itemsize / 4
    assert got == 1 or (got + 1) * per <= free


def test_extract_displacement_field_batch_in_chunks(monkeypatch):
    """A stack that does not fit one call goes in equal chunks of whole
    images (8 images at 3 a call: 3, 3 and 2), each image's field and
    g-dicts the bits of the one-call run."""
    from pygpa_tpu_torch.parallel import sharded
    batch, ks = _parallel_stack()
    one_u, one_gs = extract_displacement_field_batch(batch, ks, device="cpu",
                                                     return_gs=True)
    sizes = []
    run = sharded.extract_displacement_field

    def spy(images, *a, **kw):
        sizes.append(images.shape[0])
        return run(images, *a, **kw)
    monkeypatch.setattr(sharded, "_cap", lambda images: 3)
    monkeypatch.setattr(sharded, "extract_displacement_field", spy)
    u = extract_displacement_field_batch(batch, ks, device="cpu")
    u_gs, gs = extract_displacement_field_batch(batch, ks, device="cpu",
                                                return_gs=True)
    assert sizes == [3, 3, 2, 3, 3, 2]
    assert torch.equal(u, one_u) and torch.equal(u_gs, one_u)
    assert len(gs) == len(one_gs) == 3
    for g, w in zip(gs, one_gs):
        assert g.keys() == w.keys()
        assert all(torch.equal(g[k], w[k]) for k in w)


def _close(got, want, agree):
    """A gradient plane against its twin's where the winners agree:
    p99 of |got - want| within 1e-4 of the plane's mean magnitude there
    (the twin's products take other shapes, so rounding differs; where
    |M| is small the ratio's rounding grows)."""
    sc = float(want[agree].abs().mean())
    d = (got - want).abs()[agree]
    assert float(torch.quantile(d[::5], 0.99)) < 1e-4 * sc


@pytest.mark.parametrize("emission", ["grouped", "zoom"])
def test_gradient_emission_takes_a_stack(emission):
    """Both gradient emissions take a stack of two 128^2 stack_1b images
    in one call through their steps (band flags, stage 1 on the flagged
    pairs, winner products; on the CPU each step's twin): the grouped
    one (GroupedSweep(emit="grad"), ops.sweep.sweep_grad_steps) and the
    zoom one (ops.zoom_sweep.winner_grads after stage 1 and the
    tournament). Each image's planes are the bits of its own call; the
    steps' phases and weights are the sweep twin's bits and their
    gradients lie near the twin's where the winners agree."""
    size = 128
    ks = np.array(generate_ks(R_K, THETA))[:3]
    wl = tpipe.candidate_banks(ks)
    imgs = torch.from_numpy(stack_1b(nb=2, size=size))
    img0 = imgs - imgs.mean(dim=(-2, -1), keepdim=True)
    if emission == "grouped":
        plan = twfr.plan_sweep((size, size), wl, 10, 20, ks)
        sw = twfr.GroupedSweep(plan, emit="grad")
        want = sw(img0)
        assert [tuple(w.shape) for w in want] == [(2, 3, size, size)] * 4
        Sr, Si = sw._scaled(img0)
        t = sw.tpf0[:, :, None]
        args = (sw._bands(Sr), sw._bands(Si), sw._bands(-t * Si),
                sw._bands(t * Sr), sw.gx, sw.gy, sw.A0c, sw.A0s, sw.A1cb,
                sw.A1sb, sw.A1ycb, sw.A1ysb, sw.run, sw.off, plan.dr,
                sw.banded)
        got = tsweep.sweep_grad_steps(*args)
        for b in range(2):
            one = sw(img0[b])
            step = tsweep.sweep_grad_steps(*(a[b] for a in args[:4]),
                                           *args[4:])
            for k in range(4):
                assert torch.equal(want[k][b], one[k])
                assert torch.equal(got[k][b], step[k])
        agree = torch.ones_like(want[0], dtype=torch.bool)
    else:
        from pygpa_tpu_torch.ops import zoom_sweep as tz
        spectrum = torch.fft.fft2(img0)
        zp = twfr._plan_zoom((size, size), wl[0], 10.0)
        ops, gops = twfr._zoom_operands(spectrum, wl[0], zp[0], zp[1],
                                        10.0, with_grad=True)
        assert ops[0].shape[0] == 2 and gops[0].shape == ops[0].shape
        T = tz.stage1(*ops[:6])
        P, W1 = wl[0].shape[0], ops[0].shape[-1]
        assert T.shape == (2, P, size, 2 * W1)
        want = tz.zoom_sweep_plain(*ops, grad_ops=gops)
        got = want[:4] + tz.winner_grads(T, want, *ops[2:], gops)
        for b in range(2):
            bops = (ops[0][b], ops[1][b]) + ops[2:]
            bg = (gops[0][b], gops[1][b]) + gops[2:]
            one = tz.zoom_sweep_plain(*bops, grad_ops=bg)
            step = tz.winner_grads(T[b], tuple(o[b] for o in want),
                                   *ops[2:], bg)
            for k in range(6):
                assert torch.equal(want[k][b], one[k])
            for k in (0, 1):
                assert torch.equal(got[4 + k][b], step[k])
        agree = want[0] >= 1e-2 * want[0].amax(dim=(-2, -1), keepdim=True)
    for k in (2, 3) if emission == "grouped" else (4, 5):
        assert torch.isfinite(got[k]).all()
        _close(got[k], want[k], agree)


def test_eager_stack_matches_vmapped_reference():
    """extract_displacement_field on a stack of 3 x 128^2 stack_1b images
    (a field of its own in each, a hole of noise in the last) in one
    call, against jax.jit(jax.vmap(the reference's eager function)) on
    its XLA route, each image's interior within 1e-3 px away from the
    hole (the eager path's bound, test_torch_exact.py), and each image
    the bits of the port's own eager call on it."""
    size = 128
    imgs = stack_1b(size=size)
    ks = np.array(generate_ks(R_K, THETA))[:3]
    want = np.asarray(jax.jit(jax.vmap(
        lambda im: jpipe.extract_displacement_field(im, ks)))(
            jnp.asarray(imgs)))
    got = tpipe.extract_displacement_field(torch.from_numpy(imgs), ks,
                                           device="cpu")
    assert got.shape == (3, 2, size, size) and got.dtype == torch.float32
    distinct_fields(want)
    d = np.abs(interior(got.numpy() - want))
    assert d[:2].max() < 1e-3
    flip_tolerant(got.numpy()[2:], want[2:], 1e-3, 5e-1)
    for i in range(3):
        one = tpipe.extract_displacement_field(torch.from_numpy(imgs[i]), ks,
                                               device="cpu")
        assert torch.equal(got[i], one)


def test_per_peak_phase_weight_stack_equals_a_loop():
    """wfr_sweep_phase_weight_multi on a stack (2 x 128^2) through the
    per-peak route (banks of unequal lengths), with and without
    gradients: (B, G, n, m) planes and (B, G, n, m, 2) gradients, each
    image the bits of its own call."""
    size = 128
    ks = np.array(generate_ks(R_K, THETA))[:3]
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    wl = [np.stack([a.ravel() for a in np.meshgrid(
        np.arange(k[0] - kw, k[0] + kw, kw / d),
        np.arange(k[1] - kw, k[1] + kw, kw / d), indexing="ij")], -1)
        for k, d in zip(ks, (3, 3.5, 2.5))]
    imgs = torch.from_numpy(stack_1b(nb=2, size=size))
    img0 = imgs - imgs.mean(dim=(-2, -1), keepdim=True)
    for grad in (False, True):
        kw_ = {"with_grad": True, "krefs": ks} if grad else {}
        got = twfr.wfr_sweep_phase_weight_multi(img0, wl, 10, 20, **kw_)
        assert got[0].shape == (2, 3, size, size)
        if grad:
            assert got[2].shape == (2, 3, size, size, 2)
        for b in range(2):
            one = twfr.wfr_sweep_phase_weight_multi(img0[b], wl, 10, 20,
                                                    **kw_)
            for g, o in zip(got, one):
                assert torch.equal(g[b], o)
