"""The port's unit-cell averaging (pygpa_tpu_torch.ucell) and the drizzle
and expand kernels' plain twins (ops.drizzle, ops.expand) against
pygpa_tpu on the CPU: the module against pygpa_tpu.ucell, the round
trips with the bounds of tests/test_ucell.py, the twins against the
Pallas kernels in interpret mode with the bounds of
tests/test_pallas_drizzle.py and atol 1e-10 (expand). Where the
reference's two routes disagree, the port follows the kernels, and a
test at such a geometry shows it. float64 inputs from numpy seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpa_tpu.lattices import generate_ks, hexlattice_gen
import pygpa_tpu.ucell as JUC
from pygpa_tpu.ucell.averaging import _drizzle as xla_drizzle
from pygpa_tpu.ops.pallas_drizzle import drizzle as pallas_drizzle
from pygpa_tpu.ops.pallas_expand import expand_cell as pallas_expand
import pygpa_tpu_torch.ucell as TUC
from pygpa_tpu_torch.ops import _build
from pygpa_tpu_torch.ops import drizzle as TD
from pygpa_tpu_torch.ops import expand as TE

torch.set_num_threads(2)
# a cell box that ends exactly where the cell does (rmin = 0, extents
# 10.3 x 7.6 px): drizzle taps reach column R1 and expand positions
# pass R - 1, where the reference's routes differ
KS_DIAG = np.array([[1 / 10.3, 0.0], [0.0, 1 / 7.6]])


def _ks(r_k=0.02, xi0=7.0, kappa=1.05):
    return np.asarray(generate_ks(r_k, xi0, kappa=kappa, psi=0.0))[:2]


def _lattice(size, shift=None):
    img = np.asarray(hexlattice_gen(0.02, 7.0, 2, kappa=1.05, psi=0.0,
                                    size=size, shift=shift,
                                    dtype=np.float64))
    return img / img.max()


def test_cell_geometry_matches():
    ks = _ks()
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(50, 2)) * 40
    for fn in (JUC.forward_transform, JUC.backward_transform):
        want = np.asarray(fn(jnp.asarray(vecs), jnp.asarray(ks)))
        got = getattr(TUC, fn.__name__)(torch.from_numpy(vecs), ks)
        assert np.allclose(got.numpy(), want, atol=1e-12)
    want = np.asarray(JUC.cart_in_uc(jnp.asarray(vecs), jnp.asarray(ks),
                                     rmin=jnp.asarray([1.5, -2.0])))
    got = TUC.cart_in_uc(torch.from_numpy(vecs), ks,
                         rmin=torch.tensor([1.5, -2.0], dtype=torch.float64))
    assert np.allclose(got.numpy(), want, atol=1e-10)
    f = np.array([0.3, 0.8])
    assert np.allclose(TUC.float_overlap(torch.from_numpy(f)).numpy(),
                       np.asarray(JUC.float_overlap(jnp.asarray(f))))
    for z in (1, 2, 3):
        rj, sj = JUC.calc_ucell_parameters(ks, z)
        rt, st = TUC.calc_ucell_parameters(ks, z)
        assert np.allclose(rt, rj) and tuple(st) == tuple(sj)


@pytest.mark.parametrize("R", [(2.25, 3.5), (4.6, 4.2), (-1.3, 0.4),
                               (-6.5, 1.0)])
def test_add_to_position_matches(R):
    """Inside, across the far edge (taps dropped) and at negative
    positions (taken from the end, or dropped past it)."""
    res = np.random.default_rng(1).normal(size=(5, 5))
    w = np.zeros((5, 5))
    want = JUC.add_to_position(2.5, jnp.asarray(R), jnp.asarray(res),
                               jnp.asarray(w))
    got = TUC.add_to_position(2.5, torch.tensor(R, dtype=torch.float64),
                              torch.from_numpy(res), torch.from_numpy(w))
    for g, t in zip(got, want):
        assert np.allclose(g.numpy(), np.asarray(t), atol=1e-14)


@pytest.mark.parametrize("z,with_u", [(1, False), (2, False), (2, True)])
def test_unit_cell_average_matches(z, with_u):
    """At a geometry where no tap reaches the cell's last column the two
    reference routes agree, and the port matches them: values, weights,
    the NaN of unvisited bins, and the factory form."""
    ks = _ks()
    img = _lattice(160)
    img[20:24, 30:70] = np.nan
    u = 0.7 * np.random.default_rng(2).normal(size=(2,) + img.shape)
    uu = u if with_u else None
    want, wantw = JUC.unit_cell_average(img, ks, u=uu, z=z,
                                        return_weights=True)
    got, gotw = TUC.unit_cell_average(torch.from_numpy(img), ks,
                                      u=None if uu is None else
                                      torch.from_numpy(uu), z=z,
                                      return_weights=True, device="cpu")
    want, wantw = np.asarray(want), np.asarray(wantw)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.allclose(gotw.numpy(), wantw, atol=1e-10)
    assert np.allclose(got.numpy(), want, atol=1e-10, equal_nan=True)
    f = TUC.unit_cell_average(None, ks, z=z, only_generate_func=True,
                              device="cpu")
    assert torch.equal(torch.nan_to_num(f(torch.from_numpy(img), uu)),
                       torch.nan_to_num(got))


@pytest.mark.parametrize("order,z2,with_u", [(3, 1, False), (3, 1, True),
                                             (1, 1, True), (3, 2, False)])
def test_expand_unitcell_matches(order, z2, with_u):
    ks = _ks(0.05, 7.0, 1.0)
    z = 2
    _, rsize = JUC.calc_ucell_parameters(ks, z)
    rng = np.random.default_rng(3)
    cell = rng.normal(size=rsize)
    cell[0, :3] = np.nan                  # nan_to_num'd by both
    shape = (96, 128)
    u = 0.5 * rng.normal(size=(2,) + shape) if with_u else 0
    want = JUC.expand_unitcell(jnp.asarray(cell), ks, shape, z=z, z2=z2,
                               u=u, order=order)
    got = TUC.expand_unitcell(torch.from_numpy(cell), ks, shape, z=z, z2=z2,
                              u=torch.from_numpy(u) if with_u else 0,
                              order=order, device="cpu")
    assert np.allclose(got.numpy(), np.asarray(want), atol=1e-10)


@pytest.mark.parametrize("z", [2, 3])
def test_project_and_expand(z):
    """tests/test_ucell.py's round trip and bounds."""
    ks = _ks()
    original = _lattice(200)
    cell = TUC.unit_cell_average(torch.from_numpy(original), ks, z=z,
                                 device="cpu")
    expanded = TUC.expand_unitcell(cell, ks, original.shape, z=z,
                                   device="cpu").numpy()
    assert np.abs(original - expanded).mean() < 5e-3
    assert np.abs(original - expanded).max() < 0.11


@pytest.mark.parametrize("z", [2, 3])
def test_deformed_project_and_expand(z, gaussiandeform):
    u = gaussiandeform[:, :200, :200]
    ks = _ks()
    deformed = _lattice(200, shift=u)
    ut = torch.from_numpy(np.ascontiguousarray(u))
    cell = TUC.unit_cell_average(torch.from_numpy(deformed), ks, z=z, u=ut,
                                 device="cpu")
    expanded = TUC.expand_unitcell(cell, ks, deformed.shape, z=z,
                                   u=ut, device="cpu").numpy()
    assert np.abs(deformed - expanded).mean() < 3e-3
    assert np.abs(deformed - expanded).max() < 0.15


def test_nan_masking_and_weights():
    """tests/test_ucell.py's NaN-masking and weight checks."""
    ks = np.asarray(generate_ks(0.05, 0.0))[:2]
    clean = np.array(hexlattice_gen(0.05, 0.0, 1, size=100,
                                    dtype=np.float64))
    img = clean.copy()
    img[:50] = np.nan
    cell = TUC.unit_cell_average(torch.from_numpy(img), ks, z=2,
                                 device="cpu").numpy()
    ref = TUC.unit_cell_average(torch.from_numpy(clean), ks, z=2,
                                device="cpu").numpy()
    assert np.isfinite(cell).any()
    both = np.isfinite(cell) & np.isfinite(ref)
    assert both.sum() > 0.9 * np.isfinite(ref).sum()
    d = np.abs(cell - ref)[both]
    assert d.mean() < 0.05 and np.quantile(d, 0.9) < 0.1
    small = torch.from_numpy(clean[:64, :64].copy())
    _, w = TUC.unit_cell_average(small, ks, z=2, return_weights=True,
                                 device="cpu")
    assert np.isclose(float(w.sum()), 64 * 64)


@pytest.fixture(scope="module")
def drizzle_case():
    rng = np.random.default_rng(1)
    ks = np.asarray(generate_ks(0.06, 9.0))[:2]
    z = 2
    rmin, rsize = JUC.calc_ucell_parameters(ks, z)
    img = rng.normal(size=(160, 256))
    img[10:14, 40:60] = np.nan
    u = 0.8 * rng.normal(size=(2,) + img.shape)
    return ks, z, rmin, tuple(int(r) for r in rsize), img, u


@pytest.mark.parametrize("with_u", [False, True])
def test_drizzle_twin_matches_interpret_kernel(drizzle_case, with_u):
    """tests/test_pallas_drizzle.py's bounds: the same bins visited,
    weights rtol 1e-5, averages rtol 1e-4 / atol 1e-5."""
    ks, z, rmin, rsize, img, u = drizzle_case
    uu = u if with_u else None
    s, w = pallas_drizzle(jnp.asarray(img), ks, rmin, rsize, z, u=uu,
                          interpret=True)
    s, w = np.asarray(s), np.asarray(w)
    ts, tw = TD.drizzle_plain(torch.from_numpy(img), ks, rmin, rsize, z,
                              None if uu is None else torch.from_numpy(uu))
    ts, tw = ts.numpy(), tw.numpy()
    assert ((w > 0) == (tw > 0)).all()
    ok = w > 1e-9
    assert np.allclose(tw[ok], w[ok], rtol=1e-5)
    assert np.allclose(ts[ok] / tw[ok], s[ok] / w[ok], rtol=1e-4, atol=1e-5)


def test_drizzle_all_nan_sums_exactly_zero(drizzle_case):
    ks, z, rmin, rsize, img, _ = drizzle_case
    s, w = TD.drizzle_plain(torch.full(img.shape, float("nan"),
                                       dtype=torch.float64),
                            ks, rmin, rsize, z)
    assert float(s.abs().max()) == 0.0 and float(w.abs().max()) == 0.0


@pytest.mark.parametrize("order,z2,with_u", [(1, 1, False), (1, 1, True),
                                             (3, 1, True), (3, 2, False)])
def test_expand_twin_matches_interpret_kernel(order, z2, with_u):
    ks = np.asarray(generate_ks(0.05, 7.0))[:2]
    z = 2
    rmin, rsize = JUC.calc_ucell_parameters(ks, z)
    rng = np.random.default_rng(0)
    cell = rng.normal(size=rsize)
    shape = (192, 256)
    u = 0.5 * rng.normal(size=(2,) + shape) if with_u else None
    want = pallas_expand(jnp.asarray(cell), ks, rmin, z, z2, u, shape,
                         order=order, interpret=True)
    got = TE.expand_cell_plain(torch.from_numpy(cell), ks, rmin, z, z2,
                               None if u is None else torch.from_numpy(u),
                               shape, order)
    assert np.allclose(got.numpy(), np.asarray(want), atol=1e-10)


def test_drizzle_route_truth_table():
    """shared_route: the shared-memory kernel where one int64 cell plane
    fits a block's opt-in shared memory (227 KB on an H100), config 4's
    118 x 166 cell among them; larger cells, up to the reference's
    512 x 512, take the global-atomic kernel."""
    assert TD.SHARED_BYTES == 227 * 1024
    for rsize in ((118, 166), (13, 9), (1, 1), (170, 170), (512, 56)):
        assert TD.shared_route(rsize), rsize
    for rsize in ((171, 170), (512, 512), (512, 402), (200, 150)):
        assert not TD.shared_route(rsize), rsize
    for rsize in ((118, 166), (512, 512)):
        assert TD.supported(rsize)
    # config 4's cell (benchmarks/run_all.py, z = 2)
    ks4 = np.asarray(generate_ks(0.02, 5.0))[:2].astype(np.float32)
    _, rsize = TUC.calc_ucell_parameters(ks4, 2)
    assert tuple(int(r) for r in rsize) == (118, 166)


def _fixed_taps(img, ks, rmin, rsize, z, u):
    """csrc/drizzle.cu's taps in numpy: per pixel the float32 cell
    position (ops.drizzle.cell_coords), the float32 hat products, each
    rounded to int64 at the kernel's fixed_scale (2^(62 - e), count
    max|v| < 2^e; max|v| over the non-NaN pixels). Returns the bin of
    every tap inside the cell, its value and weight integers, the pixel
    it came from, and both scales."""
    n, m = img.shape
    R0, R1 = rsize
    t = torch.from_numpy(img.astype(np.float32))
    ut = None if u is None else torch.from_numpy(u.astype(np.float32))
    ii, jj = TD._positions(n, m, ut, torch.float32, t.device)
    X0, X1 = TD.cell_coords(TD.scalars(ks, rmin, z, torch.float32), ii, jj)
    X0, X1 = X0.numpy(), X1.numpy()
    fl0, fl1 = np.floor(X0), np.floor(X1)
    t0, t1 = X0 - fl0, X1 - fl1
    valid = ~np.isnan(img)
    val = np.where(valid, img, 0).astype(np.float32)
    vw = valid.astype(np.float32)

    def scale(vmax):
        _, e = np.frexp(float(n * m) * float(vmax))
        return 2.0 ** (62 - int(e)) if n * m * float(vmax) > 0 else 1.0

    sv = scale(np.abs(val).max())
    sw = scale(1.0)
    one = np.float32(1)
    bins, tv, tw, pix = [], [], [], []
    for li in range(2):
        r = fl0.astype(np.int64) + li
        hy = t0 if li else one - t0
        hv, hw = hy * val, hy * vw
        for lj in range(2):
            c = fl1.astype(np.int64) + lj
            hx = t1 if lj else one - t1
            ok = (r >= 0) & (r < R0) & (c >= 0) & (c < R1)
            bins.append((r * R1 + c)[ok])
            tv.append(np.rint((hv * hx)[ok].astype(np.float64) * sv))
            tw.append(np.rint((hw * hx)[ok].astype(np.float64) * sw))
            pix.append(np.flatnonzero(ok))
    return (np.concatenate(bins), np.concatenate(tv).astype(np.int64),
            np.concatenate(tw).astype(np.int64), np.concatenate(pix), sv, sw)


def _split_words_plane(bins, taps, nbins):
    """One block's plane as the shared-memory kernel keeps it: per bin a
    uint32 low word (its wraps carried into the high word) and a uint32
    high word, read back as the int64 lo + 2^32 hi."""
    t = taps.view(np.uint64)
    lo_sum = np.zeros(nbins, dtype=object)
    hi_sum = np.zeros(nbins, dtype=object)
    np.add.at(lo_sum, bins, [int(x) & 0xFFFFFFFF for x in t])
    np.add.at(hi_sum, bins, [int(x) >> 32 for x in t])
    lo = np.array([int(x) & 0xFFFFFFFF for x in lo_sum], dtype=np.uint64)
    hi = np.array([(int(h) + (int(x) >> 32)) & 0xFFFFFFFF
                   for h, x in zip(hi_sum, lo_sum)], dtype=np.uint64)
    return ((hi << np.uint64(32)) | lo).view(np.int64)


@pytest.mark.parametrize("with_u", [False, True])
def test_drizzle_block_planes_sum_to_the_single_plane(drizzle_case, with_u):
    """The shared-memory route's argument on the CPU: the fixed-point
    taps scattered into per-block planes (contiguous pixel runs, each
    plane kept as split 32-bit words) and those planes summed give the
    single-plane int64 scatter of the global route bit for bit, and the
    result matches the twin within the kernel test's 1e-5 bound."""
    ks, z, rmin, rsize, img, u = drizzle_case
    uu = u if with_u else None
    bins, tv, tw, pix, sv, sw = _fixed_taps(img, ks, rmin, rsize, z, uu)
    nbins = rsize[0] * rsize[1]
    blocks = np.array_split(np.arange(img.size), 7)
    for taps, sc, k in ((tv, sv, 0), (tw, sw, 1)):
        single = np.zeros(nbins, np.int64)
        np.add.at(single, bins, taps)
        total = np.zeros(nbins, np.int64)
        for run in blocks:
            sel = (pix >= run[0]) & (pix <= run[-1])
            total += _split_words_plane(bins[sel], taps[sel], nbins)
        np.testing.assert_array_equal(total, single)
        got = (single.astype(np.float64) / sc).astype(np.float32)
        want = TD.drizzle_plain(torch.from_numpy(img.astype(np.float32)), ks,
                                rmin, rsize, z,
                                None if uu is None else
                                torch.from_numpy(uu.astype(np.float32)))[k]
        want = want.numpy().reshape(-1)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_drizzle_drops_taps_past_the_last_column():
    """At KS_DIAG the cell's last column R1 - 1 has taps to its right.
    The TPU kernel drops them (so does the port); the reference's XLA
    scatter adds them to the first column of the next row."""
    z = 2
    rmin, rsize = JUC.calc_ucell_parameters(KS_DIAG, z)
    rsize = tuple(int(r) for r in rsize)
    rng = np.random.default_rng(4)
    img = rng.normal(size=(96, 128))
    u = 0.8 * rng.normal(size=(2,) + img.shape)  # positions off the grid
    s, w = pallas_drizzle(jnp.asarray(img), KS_DIAG, rmin, rsize, z, u=u,
                          interpret=True)
    ts, tw = TD.drizzle_plain(torch.from_numpy(img), KS_DIAG, rmin, rsize, z,
                              torch.from_numpy(u))
    assert np.allclose(tw.numpy(), np.asarray(w), rtol=1e-5, atol=1e-9)
    assert np.allclose(ts.numpy(), np.asarray(s), rtol=1e-4, atol=1e-6)
    _, xw = xla_drizzle(jnp.asarray(img), jnp.asarray(u),
                        jnp.asarray(KS_DIAG), tuple(rmin), rsize, z)
    extra = np.asarray(xw) - tw.numpy()
    # the wrapped taps land in column 0 of rows 1..R0-1 and nowhere else
    assert np.abs(extra[:, 1:]).max() < 1e-9
    assert extra[1:, 0].min() > 0.1


def test_expand_samples_the_mirror_rim():
    """At KS_DIAG (z = 1) cell rows run to X0 = 10.3 > R0 - 1 = 10. The
    TPU kernel samples the mirror-extended B-spline there (so does the
    port); the reference's map_coordinates route cuts those positions
    to 0."""
    z = 1
    rmin, rsize = JUC.calc_ucell_parameters(KS_DIAG, z)
    cell = np.random.default_rng(5).normal(size=rsize)
    shape = (64, 48)
    want = np.asarray(pallas_expand(jnp.asarray(cell), KS_DIAG, rmin, z, 1,
                                    None, shape, order=3, interpret=True))
    got = TUC.expand_unitcell(torch.from_numpy(cell), KS_DIAG, shape,
                              z=z, device="cpu").numpy()
    assert np.allclose(got, want, atol=1e-10)
    xla = np.asarray(JUC.expand_unitcell(jnp.asarray(cell), KS_DIAG, shape,
                                         z=z))
    # positions past the last row or column (X0 > R0 - 1 or X1 > R1 - 1),
    # with X as the reference's map_coordinates route computes it
    ii, jj = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                         indexing="ij")
    X = [((ii * KS_DIAG[k, 0] + jj * KS_DIAG[k, 1]) % 1.0)
         * np.linalg.inv(KS_DIAG)[k, k] - rmin[k] for k in (0, 1)]
    rim = (X[0] > rsize[0] - 1) | (X[1] > rsize[1] - 1)
    assert rim.any() and not rim.all()
    assert np.abs(xla[rim]).max() == 0.0
    assert np.abs(got[rim]).min() > 0.0
    assert np.allclose(got[~rim], xla[~rim], atol=1e-10)


def test_wrappers_route_on_device():
    """CPU tensors run the twins and count no launch; a tensor on
    another device goes to the kernel path and raises there."""
    ks = np.asarray(generate_ks(0.05, 7.0))[:2]
    rmin, rsize = TUC.calc_ucell_parameters(ks, 2)
    img = torch.from_numpy(np.random.default_rng(6).normal(size=(64, 64)))
    _build.launches.clear()
    a = TD.drizzle(img, ks, rmin, rsize, 2)
    b = TD.drizzle_plain(img, ks, rmin, rsize, 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    cell = torch.ones(tuple(rsize), dtype=torch.float64)
    assert torch.equal(TE.expand_cell(cell, ks, rmin, 2, 1, None, (32, 32)),
                       TE.expand_cell_plain(cell, ks, rmin, 2, 1, None,
                                            (32, 32)))
    assert sum(_build.launches.values()) == 0
    meta = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        TD.drizzle(meta, ks, rmin, rsize, 2)
    with pytest.raises(ValueError, match="device"):
        TE.expand_cell(meta, ks, rmin, 2, 1, None, (32, 32))


@pytest.mark.parametrize("route", ["shared", "l1"])
@pytest.mark.parametrize("n,m,grid", [(4096, 4096, 264), (37, 4097, 1056),
                                      (5, 3, 132), (64, 2050, 7)])
def test_expand_launch_covers_every_pixel_once(route, n, m, grid):
    """csrc/expand.cu's partition in numpy: a grid of `grid` blocks walks
    items (row, run of VEC * threads columns) with a stride of the grid;
    each thread takes VEC adjacent pixels, one aligned 16-byte store
    when m % VEC == 0, else scalar stores with the row's tail masked.
    Every pixel is written exactly once, config 4's 4096^2 among the
    sizes."""
    NT, V = TE.THREADS[route], TE.VEC
    chunks = -(-m // (NT * V))
    items = n * chunks
    grid = min(grid, items)
    vec = m % V == 0
    hits = np.zeros(n * m, int)
    t = np.arange(NT)
    for b in range(grid):
        w = np.arange(b, items, grid)[:, None]
        i = w // chunks
        j = (w - i * chunks) * (NT * V) + t * V
        live = j < m
        p = (i * m + j)[live]
        if vec:
            assert (p % V == 0).all()           # 16-byte aligned store
            np.add.at(hits, (p[:, None] + np.arange(V)).ravel(), 1)
        else:
            jj = j[live][:, None] + np.arange(V)
            pp = (p[:, None] + np.arange(V))[jj < m]
            np.add.at(hits, pp, 1)
    assert (hits == 1).all()


def test_expand_route_truth_table():
    """shared_route: cells whose float32 plane fits a block's opt-in
    shared memory (227 KB) are staged, config 4's prepared 122 x 170
    cell among them; larger ones, up to the reference's 512 x 512, are
    read through L1."""
    for shape in ((122, 170), (13, 9), (238, 238), (512, 113)):
        assert TE.shared_route(shape), shape
    for shape in ((242, 242), (512, 402), (512, 512)):
        assert not TE.shared_route(shape), shape


@pytest.mark.parametrize("kfn", ["bspline", "catmull", "hat"])
def test_expand_tap_pieces_are_the_kernel_function(kfn):
    """csrc/expand.cu evaluates one piece of the kernel function per tap
    (the inner one for taps 1 and 2 of four, the outer one for taps 0
    and 3): on float32 positions across a cell's range, dense near
    integers where the rounded distances reach |d| = 1 and 2, that piece
    equals the twin's piecewise function bit for bit at every tap."""
    K = {"hat": TE._hat, "catmull": TE._catmull_rom, "bspline": TE._bspline3}
    rng = np.random.default_rng(8)
    k = np.arange(-3, 520, dtype=np.float64)
    eps = np.array([0, 2 ** -24, 2 ** -20, 1e-7, 1e-4, 0.5])
    X = np.concatenate([rng.uniform(-3, 520, 200000),
                        (k[:, None] + eps).ravel(),
                        (k[:, None] - eps).ravel()]).astype(np.float32)
    X = torch.from_numpy(X)
    taps, first = (2, 0) if kfn == "hat" else (4, -1)
    fl = torch.floor(X)
    for b in range(taps):
        d = X - (fl + (first + b))
        a = d.abs()
        if kfn == "hat" or b in (1, 2):
            piece = {"hat": lambda a: torch.clamp(1.0 - a, min=0.0),
                     "catmull": lambda a: (1.5 * a - 2.5) * a * a + 1.0,
                     "bspline": lambda a: (1.0 / 6.0) * (
                         4.0 + a * a * (3.0 * a - 6.0))}[kfn](a)
            assert float(a.max()) <= 1.0
        else:
            t = 2.0 - a
            piece = {"catmull": ((-0.5 * a + 2.5) * a - 4.0) * a + 2.0,
                     "bspline": (1.0 / 6.0) * t * t * t}[kfn]
            assert float(a.min()) >= 1.0 and float(a.max()) <= 2.0
        want = K[kfn](d)
        assert torch.equal(piece.view(torch.int32), want.view(torch.int32)), b
