"""The batch axis of the port's displacement extractor on the CPU: a
stack (B, n, m) through make_displacement_extractor's run against
jax.jit(jax.vmap(the reference's run)) on every route, the stack
against the port's own per-image calls, the V-branch and CG twins with
per-image weights against a loop of their one-weight forms,
parallel.extract_displacement_field_batch against the reference's, and
the gradient emission refusing a stack."""
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
    against the port's eager call, and a mesh raising."""
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
    with pytest.raises(NotImplementedError, match="item 8"):
        extract_displacement_field_batch(batch, ks, mesh=object(),
                                         device="cpu")


def test_gradient_emission_refuses_a_stack():
    """The gradient emission has no image axis: GroupedSweep(emit="grad")
    and ops.sweep.sweep_grad raise ValueError naming the ROADMAP item
    on a stack."""
    size = 128
    ks = np.array(generate_ks(R_K, THETA))[:3]
    wl = tpipe.candidate_banks(ks)
    plan = twfr.plan_sweep((size, size), wl, 10, 20, ks)
    imgs = torch.from_numpy(stack_1b(nb=2, size=size))
    with pytest.raises(ValueError, match="item 11"):
        twfr.GroupedSweep(plan, emit="grad")(imgs)
    sw = twfr.GroupedSweep(plan, emit="uv")
    Sr, Si = sw.windows(imgs)
    assert Sr.shape[:2] == (2, 3)
    with pytest.raises(ValueError, match="item 11"):
        tsweep.sweep_grad(Sr, Si, Sr, Si, sw.gx, sw.gy, sw.A0c, sw.A0s,
                          sw.A1cb, sw.A1sb, sw.A1cb, sw.A1sb, sw.run,
                          sw.off, 20, sw.banded)
