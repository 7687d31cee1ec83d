"""pygpa_tpu_torch.parallel on a gloo world of 4 CPU processes against
pygpa_tpu.parallel on a 4-device mesh (of the conftest's 8 virtual CPU
devices) and against the port's single-device functions, at the
reference's inputs and tolerances (tests/test_parallel.py), in float64.

One world is spawned for the module (tests/torch_parallel_cases.py runs
every case in each rank, one thread a rank, rendezvous through a file
store under the test's temporary directory, 60 s timeouts); each test
reads its case's results. The no-full-plane case records, in every rank,
each tensor an op creates while the row-sharded pipeline and unwrap run
on DTensor inputs, and fails on any whose last two axes are the whole
plane.
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pygpa_tpu.parallel as JP
from pygpa_tpu.gpa.pipeline import make_displacement_extractor as j_factory
from pygpa_tpu.lattices import generate_ks, hexlattice_gen
from pygpa_tpu.core import fourier as jfourier
from pygpa_tpu.ops.wfr import wfr_sweep as j_wfr_sweep
from pygpa_tpu.solvers import unwrap as JU

import torch_parallel_cases as cases
from pygpa_tpu_torch.core import fourier as tfourier
from pygpa_tpu_torch.gpa import pipeline as tpipe
from pygpa_tpu_torch.gpa.reconstruct import reconstruct_u_inv_from_demod
from pygpa_tpu_torch.ops.wfr import wfr_sweep as t_wfr_sweep
from pygpa_tpu_torch.solvers import unwrap as TU

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JOIN_S = 60


def _bank(ks):
    k = ks[0]
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    kstep = kw / 3
    wx, wy = np.meshgrid(np.arange(k[0] - kw, k[0] + kw, kstep),
                         np.arange(k[1] - kw, k[1] + kw, kstep),
                         indexing="ij")
    return np.stack([wx.ravel(), wy.ravel()], -1)


def _inputs():
    """The reference's fixtures (tests/test_parallel.py), made with its
    own generators."""
    r_k = 0.12
    img96 = np.array(hexlattice_gen(r_k, 9.0, order=1, size=96,
                                    dtype=np.float64))
    img96 = img96 - img96.mean()
    ks = np.array(generate_ks(r_k, 9.0))[:3]
    img128 = np.array(hexlattice_gen(r_k, 9.0, order=1, size=128,
                                     dtype=np.float64))
    rng = np.random.default_rng(2)
    n = 64
    xx, yy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    phi_true = 0.08 * xx + 0.03 * yy + 2.0 * np.sin(xx / 9.0)
    psi = (phi_true + np.pi) % (2 * np.pi) - np.pi
    w64 = 0.5 + rng.uniform(size=(n, n))
    # demodulated phases of a displaced lattice (a Gaussian bump of u)
    # with noise, and positive weights, for the reconstruction
    x = np.arange(128) - 64.0
    u = 1.5 * np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / (2 * 30.0 ** 2))
    ph = -2 * np.pi * (ks[:, 0, None, None] * u + ks[:, 1, None, None] * u)
    ph = (ph + 0.05 * rng.normal(size=ph.shape) + np.pi) % (2 * np.pi) \
        - np.pi
    wt = 0.2 + rng.uniform(size=ph.shape)
    return {
        "img96": img96, "ks96": ks, "wlist96": _bank(ks),
        "batch96": np.stack([img96, np.roll(img96, 5, axis=0),
                             np.roll(img96, -3, axis=1), img96[::-1],
                             img96, np.roll(img96, 2, axis=0),
                             np.roll(img96, 1, axis=1), img96]),
        "batch2d": np.stack([img96, img96[::-1], img96[:, ::-1],
                             img96[::-1, ::-1]]),
        "img128": img128, "ks128": ks, "wlist128": _bank(ks),
        "rand128x256": np.random.default_rng(0).normal(size=(128, 256)),
        "rand64x128": np.random.default_rng(1).normal(size=(64, 128)),
        "dx64": np.diff(psi, axis=-1), "dy64": np.diff(psi, axis=-2),
        "w64": w64, "ph128": ph, "wt128": wt,
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, [rank 0's results, ..., rank 3's]) of one gloo world of 4
    running every case."""
    tmp = tmp_path_factory.mktemp("gloo")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([HERE, ROOT]))
    procs = []
    for r in range(cases.WORLD):
        code = ("import torch_parallel_cases as c; "
                f"c.run_rank({r}, {str(tmp / 'store')!r}, "
                f"{str(tmp / 'inputs.npz')!r}, {str(tmp / f'r{r}.pkl')!r})")
        with open(tmp / f"r{r}.log", "wb") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", code],
                                          env=env, cwd=str(tmp), stdout=log,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + JOIN_S
    try:
        for p in procs:
            p.wait(timeout=max(1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (f"rank {r} exited {p.returncode}:\n"
                                   + (tmp / f"r{r}.log").read_text())
    results = []
    for r in range(cases.WORLD):
        with open(tmp / f"r{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return inp, results


def _case(world, name):
    """Rank 0's results of a case (failing on any rank's error)."""
    _, results = world
    for r, res in enumerate(results):
        status, val = res[name]
        assert status == "ok", f"rank {r}, case {name}:\n{val}"
    return results[0][name][1]


@pytest.fixture(scope="module")
def jmesh():
    return JP.make_mesh(4, ("batch",))


def test_world_ran_every_case(world):
    """All four ranks ran every case and agree on its outputs (each
    gathered its DTensors; the op counts of the dispatch-mode case are
    each rank's own)."""
    _, results = world
    for name in cases.CASES:
        first = _case(world, name)
        for res in results[1:]:
            for k, v in res[name][1].items():
                if v.dtype != object and not k.endswith("_ops"):
                    np.testing.assert_array_equal(v, first[k])


def test_make_mesh_and_batch_sharding(world):
    out = _case(world, "mesh")
    assert tuple(out["shape"]) == (4,) and tuple(out["shape2"]) == (2, 2)
    assert out["multi_axis_raises"] == 1
    assert list(out["placements"]) == ["Shard(dim=0)"]
    assert list(out["placements2"]) == ["Replicate()", "Shard(dim=0)"]


def test_sharded_wfr_matches_jax_and_single(world, jmesh):
    inp = world[0]
    out = _case(world, "sweep")
    k = inp["ks96"][0]
    want = JP.wfr_sweep_sharded(jnp.asarray(inp["img96"]), inp["wlist96"],
                                k, 8, mesh=jmesh, with_grad=True)
    single = t_wfr_sweep(torch.from_numpy(inp["img96"]), inp["wlist96"], k,
                         8, with_grad=True)
    for key in ("lockin", "w", "grad"):
        np.testing.assert_allclose(out[key], np.asarray(want[key]),
                                   atol=1e-10, rtol=0)
        np.testing.assert_allclose(out[key], single[key].numpy(),
                                   atol=1e-10, rtol=0)


def test_sharded_sweep_tie_break(world, jmesh):
    """16 identical candidates, four on each rank: the lowest global
    candidate wins every pixel, as in the reference."""
    inp = world[0]
    out = _case(world, "tie")
    k = inp["ks96"][0]
    wl = np.tile(k[None, :], (16, 1))
    want = JP.wfr_sweep_sharded(jnp.asarray(inp["img96"]), wl, k, 8,
                                mesh=jmesh)
    single = t_wfr_sweep(torch.from_numpy(inp["img96"]), wl, k, 8)
    np.testing.assert_allclose(out["lockin"], np.asarray(want["lockin"]),
                               atol=1e-9, rtol=0)
    np.testing.assert_allclose(out["lockin"], single["lockin"].numpy(),
                               atol=1e-9, rtol=0)
    np.testing.assert_array_equal(out["w"], np.asarray(want["w"]))


def test_batch_sharded_pipeline(world, jmesh):
    inp = world[0]
    out = _case(world, "batch")
    assert out["u"].shape == (8, 2, 96, 96)
    assert list(out["placements"]) == ["Shard(dim=0)"]
    want = np.asarray(JP.extract_displacement_field_batch(
        inp["batch96"], inp["ks96"], mesh=jmesh))
    np.testing.assert_allclose(out["u"], want, atol=1e-8, rtol=0)
    one = tpipe.extract_displacement_field(inp["batch96"][1], inp["ks96"],
                                           device="cpu")
    np.testing.assert_allclose(out["u"][1], one.numpy(), atol=1e-8, rtol=0)


def test_pencil_fft_matches(world, jmesh):
    inp = world[0]
    out = _case(world, "fft")
    img = inp["rand128x256"]
    np.testing.assert_allclose(out["fft"], np.fft.fft2(img), atol=1e-9,
                               rtol=0)
    np.testing.assert_allclose(out["fft"], np.asarray(JP.fft2_sharded(
        jnp.asarray(img), jmesh)), atol=1e-9, rtol=0)
    np.testing.assert_allclose(out["back"].real, img, atol=1e-9, rtol=0)
    assert out["odd_raises"] == 1


def test_spatial_sweep_matches(world):
    """The row-sharded zoom sweep of one 128^2 image against the
    single-device zoom sweep of pygpa_tpu and of the port, at the
    reference's tolerances. (pygpa_tpu's own row-sharded sweep, which
    tests/test_parallel.py holds to its single-device sweep at these
    tolerances, takes about a minute to compile on the CPU.)"""
    inp = world[0]
    out = _case(world, "spatial")
    img, wl, k = inp["img128"], inp["wlist128"], inp["ks128"][0]
    want = j_wfr_sweep(jnp.asarray(img), wl, k, 8, rebase=False,
                       return_absq=True, with_w=False)
    single = t_wfr_sweep(torch.from_numpy(img), wl, k, 8, rebase=False,
                         return_absq=True)
    for ref in ({k2: np.asarray(v) for k2, v in want.items()},
                {k2: v.numpy() for k2, v in single.items()}):
        np.testing.assert_allclose(out["absq"], ref["absq"], rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(out["lockin"], ref["lockin"], atol=1e-8,
                                   rtol=0)
    np.testing.assert_array_equal(np.moveaxis(wl[out["idx"]], -1, 0),
                                  single["w"].numpy())


def test_2d_mesh_batch_by_candidate(world):
    """A 2 x 2 mesh: the candidate sweep sharded on "k" for each image,
    and the batch pipeline on "batch" of the same mesh."""
    inp = world[0]
    out = _case(world, "mesh2d")
    jmesh2 = JP.make_mesh(4, ("batch", "k"), shape=(2, 2))
    k = inp["ks96"][0]
    for b in (0, 3):
        im = inp["batch2d"][b]
        want = JP.wfr_sweep_sharded(jnp.asarray(im), inp["wlist96"], k, 8,
                                    mesh=jmesh2, axis="k")
        single = j_wfr_sweep(jnp.asarray(im), inp["wlist96"], k, 8)
        np.testing.assert_allclose(out[f"lockin{b}"],
                                   np.asarray(want["lockin"]), atol=1e-9,
                                   rtol=0)
        np.testing.assert_allclose(out[f"lockin{b}"],
                                   np.asarray(single["lockin"]), atol=1e-9,
                                   rtol=0)
    want_u = np.asarray(JP.extract_displacement_field_batch(
        inp["batch2d"], inp["ks96"], mesh=jmesh2))
    np.testing.assert_allclose(out["u"], want_u, atol=1e-9, rtol=0)
    u0 = tpipe.extract_displacement_field(inp["batch2d"][0], inp["ks96"],
                                          device="cpu")
    np.testing.assert_allclose(out["u"][0], u0.numpy(), atol=1e-9, rtol=0)


def test_sharded_dct_matches(world, jmesh):
    inp = world[0]
    out = _case(world, "dct")
    x = inp["rand64x128"]
    np.testing.assert_allclose(out["dct"], np.asarray(JP.dct2n_sharded(
        jnp.asarray(x), jmesh)), atol=1e-8, rtol=0)
    np.testing.assert_allclose(out["dct"], tfourier.dct2n(
        torch.from_numpy(x)).numpy(), atol=1e-8, rtol=0)
    np.testing.assert_allclose(out["dct"], np.asarray(jfourier.dct2n(
        jnp.asarray(x))), atol=1e-8, rtol=0)
    np.testing.assert_allclose(out["back"], x, atol=1e-9, rtol=0)


@pytest.mark.parametrize("coarse", [None, 4])
def test_sharded_unwrap_matches(world, jmesh, coarse):
    """The row-sharded CG (coarse None) and multigrid (coarse 4) unwrap
    against pygpa_tpu's sharded solve and the port's single-device
    solvers (kmax 30; the multigrid's coarse iterations clamped as the
    reconstruction clamps them)."""
    inp = world[0]
    out = _case(world, "unwrap")["cg" if coarse is None else "mg"]
    dx, dy, w = (jnp.asarray(inp[k]) for k in ("dx64", "dy64", "w64"))
    want = np.asarray(JP.phase_unwrap_prediff_sharded(dx, dy, w, jmesh,
                                                      kmax=30, coarse=coarse))
    np.testing.assert_allclose(out, want, atol=1e-6, rtol=0)
    tdx, tdy, tw = (torch.from_numpy(inp[k]) for k in ("dx64", "dy64",
                                                       "w64"))
    if coarse is None:
        single = TU.phase_unwrap_prediff(tdx, tdy, tw, kmax=30)
    else:
        single = TU.phase_unwrap_prediff_mg(
            tdx, tdy, tw, kmax=min(30, TU.DEFAULTS.unwrap_kmax_mg),
            coarse=4)
    np.testing.assert_allclose(out, single.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("coarse", [None, 4])
def test_sharded_reconstruct_matches(world, jmesh, coarse):
    inp = world[0]
    out = _case(world, "reconstruct")[f"u{coarse}"]
    ks, ph, wt = inp["ks128"], inp["ph128"], inp["wt128"]
    want = np.asarray(JP.reconstruct_u_inv_from_demod_sharded(
        ks, jnp.asarray(ph), jnp.asarray(wt), jmesh, unwrap_coarse=coarse))
    np.testing.assert_allclose(out, want, atol=1e-6, rtol=0)
    single = reconstruct_u_inv_from_demod(ks, torch.from_numpy(ph),
                                          torch.from_numpy(wt),
                                          unwrap_coarse=coarse)
    np.testing.assert_allclose(out, single.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("coarse", [None, 4])
def test_sharded_pipeline_end_to_end(world, coarse):
    """extract_displacement_field_sharded on a 128^2 lattice against
    the single-device factories (float64) of pygpa_tpu and the port with
    the same unwrap, at the reference's tolerance. (pygpa_tpu's own
    row-sharded pipeline, which tests/test_parallel.py holds to its
    factory at this tolerance, takes about four minutes to compile on
    the CPU.)"""
    inp = world[0]
    res = _case(world, "pipeline")
    out = res[f"u{coarse}"]
    assert list(res["placements"]) == ["Shard(dim=1)"]
    img, ks = inp["img128"], inp["ks128"]
    fn = j_factory((128, 128), ks, unwrap_coarse=coarse, dtype=jnp.float64)
    np.testing.assert_allclose(out, np.asarray(fn(jnp.asarray(img))),
                               atol=1e-6, rtol=0)
    tfn = tpipe.make_displacement_extractor((128, 128), ks,
                                            unwrap_coarse=coarse,
                                            dtype=torch.float64,
                                            device="cpu")
    np.testing.assert_allclose(out, tfn(torch.from_numpy(img)).numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("part", ["pipeline", "unwrapNone", "unwrap4"])
def test_no_rank_holds_a_whole_plane(world, part):
    """While the row-sharded pipeline (128^2, 4 ranks) and the row-sharded
    CG and multigrid unwraps (64^2) run on DTensor inputs, no op in any
    rank creates a tensor whose last two axes are the whole plane; their
    results equal the full-tensor calls'."""
    _, results = world
    for r, res in enumerate(results):
        status, val = res["no_full_plane"]
        assert status == "ok", f"rank {r}:\n{val}"
        assert int(val[f"{part}_ops"]) > 100
        assert list(val[f"{part}_seen"]) == [], (
            f"rank {r} made whole planes in {part}: "
            f"{sorted(set(val[f'{part}_seen']))}")
    val = results[0]["no_full_plane"][1]
    if part == "pipeline":
        want = _case(world, "pipeline")["u4"]
        np.testing.assert_allclose(val["pipeline_u"], want, atol=1e-12,
                                   rtol=0)
    else:
        coarse = part[len("unwrap"):]
        want = _case(world, "unwrap")["cg" if coarse == "None" else "mg"]
        np.testing.assert_allclose(val[part], want, atol=1e-12, rtol=0)


def test_precond_factory_through_the_multigrid():
    """phase_unwrap_prediff_mg with a precond_factory (each level's
    preconditioner a DCT solve with shifted eigenvalues, not a multiple
    of the default one, which CG would not tell apart) and `precision`, on one process, against pygpa_tpu's
    with the same factory: the V-branch and the CG loops take the
    factory's preconditioners."""
    rng = np.random.default_rng(5)
    n = 64
    xx, yy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    psi = 0.07 * xx - 0.04 * yy + 1.5 * np.cos(yy / 7.0)
    psi = (psi + np.pi) % (2 * np.pi) - np.pi
    w = 0.4 + rng.uniform(size=(n, n))
    dx, dy = np.diff(psi, axis=-1), np.diff(psi, axis=-2)
    calls = []

    def t_factory(shape):
        scale = TU.poisson_scale(*shape, torch.float64, "cpu")

        def precond(rk):
            calls.append(tuple(rk.shape))
            return tfourier.idct2n(tfourier.dct2n(rk) / (scale - 0.5))
        return precond

    def j_factory_(shape):
        scale = JU._poisson_scale(shape, jnp.float64)
        return lambda rk: jfourier.idct2n(jfourier.dct2n(rk) / (scale - 0.5))

    want = np.asarray(JU.phase_unwrap_prediff_mg(
        jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(w), kmax=8, coarse=4,
        precond_factory=j_factory_))
    got = TU.phase_unwrap_prediff_mg(
        torch.from_numpy(dx), torch.from_numpy(dy), torch.from_numpy(w),
        kmax=8, coarse=4, precision="highest", precond_factory=t_factory)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)
    # the coarse level (16^2), the mid level (32^2) and the V-branch's
    # correction (16^2) all ran the factory's preconditioners
    assert {(16, 16), (32, 32)} <= set(calls)
    plain = TU.phase_unwrap_prediff_mg(
        torch.from_numpy(dx), torch.from_numpy(dy), torch.from_numpy(w),
        kmax=8, coarse=4)
    assert not np.allclose(got.numpy(), plain.numpy(), atol=1e-9)
