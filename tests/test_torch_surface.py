"""The port's package surface: `import pygpa_tpu_torch as gt` in a fresh
interpreter with JAX blocked, the README quick start's names (and the
analysis names: wfr4, wff, the Kerelsky fits) under gt., the
subpackages' exports mirroring pygpa_tpu's, the new entry points'
device rule, and examples/quickstart.py's chain at 256^2 on the CPU held
to pygpa_tpu's output on the same image."""
import inspect
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu as jg
import pygpa_tpu_torch as tg
from pygpa_tpu_torch.ops import _build

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK_START = ("gpa.extract_primary_ks", "gpa.refine_ks", "gpa.iterate_GPA",
               "gpa.GPA", "gpa.optGPA", "gpa.vecGPA",
               "gpa.extract_displacement_field", "gpa.undistort_image",
               "gpa.pipeline.make_displacement_extractor",
               "props.calc_props_from_kvecs4", "ucell.unit_cell_average",
               "gpa.wfr4", "gpa.wff", "props.Kerelsky_plus",
               "props.Kerelsky_Jac", "props.Kerelsky_J",
               "props.iterate_J_leastsq")
# the utilities and the pyGPA module-path shims under gt.
SURFACE = ("imagetools.gauss_homogenize2", "imagetools.generate_mask",
           "imagetools.trim_nans2", "imagetools.fftplot", "viz.fftplot",
           "viz.to_KovesiRGB", "tpugpa.cuGPA", "tpugpa.wfr2_grad_opt",
           "geometric_phase_analysis.prep_image", "gpa.prep.prep_image",
           "phase_unwrap.phase_unwrap", "property_extract.u2J",
           "unit_cell_averaging.unit_cell_average", "mathtools.wrapToPi",
           "io.save_checkpoint_orbax", "io.restore_checkpoint_orbax")


def test_fresh_import_without_jax():
    """A fresh interpreter where `import jax` fails imports the package
    and reaches the quick start's names and the utilities and shims; no
    module of pygpa_tpu is loaded, nor matplotlib (viz imports it inside
    its functions), and nothing is built."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import pygpa_tpu_torch as gt\n"
            f"for name in {QUICK_START + SURFACE!r}:\n"
            "    obj = gt\n"
            "    for part in name.split('.'):\n"
            "        obj = getattr(obj, part)\n"
            "    assert callable(obj), name\n"
            "bad = [m for m, v in sys.modules.items() if v is not None "
            "and (m == 'pygpa_tpu' or m.startswith('pygpa_tpu.') "
            "or m == 'jax' or m.startswith('jax.') "
            "or m.split('.')[0] == 'matplotlib')]\n"
            "assert not bad, bad\n"
            "from pygpa_tpu_torch.ops import _build\n"
            "assert _build._lib is None and _build.build_seconds is None\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _public(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


# the reference's parallel names and modules the port lacks: none since
# the multi-device half of ROADMAP queue 1 item 8 and item 9's kernel
# smoke (the Pallas kernel modules are csrc/*.cu and their ops/ wrappers
# here)
PARALLEL_MISSING = set()
MODULES_MISSING = set()


@pytest.mark.parametrize("sub,missing", [
    ("gpa", set()), ("solvers", set()), ("ops", set()),
    ("core", set()), ("props", set()), ("ucell", None), ("lattices", None),
    ("parallel", PARALLEL_MISSING)])
def test_subpackage_exports(sub, missing):
    """Each subpackage exports the reference's names (gpa and props all
    of them, wff and the Kerelsky fits included; parallel the meshes, the
    sharded sweeps, the pencil FFT and DCT and the row-sharded unwrap and
    pipeline besides extract_displacement_field_batch); core holds
    mathtools, fourier and interp."""
    tmod, jmod = getattr(tg, sub), getattr(jg, sub)
    if sub == "core":
        for name in ("mathtools", "fourier", "interp"):
            assert inspect.ismodule(getattr(tmod, name))
        return
    if missing is None:
        assert _public(tmod)
        return
    assert _public(jmod) - _public(tmod) == missing
    if sub == "ops":
        assert {"gpa_lockin", "gpa_lockin_batch", "wfr_sweep",
                "local_max_mask"} <= _public(tmod)


def _modules(pkg):
    """The package's modules as paths without .py, relative to it."""
    root = os.path.dirname(pkg.__file__)
    return {os.path.relpath(os.path.join(d, f), root)[:-3]
            for d, _, files in os.walk(root) for f in files
            if f.endswith(".py") and f != "__init__.py"}


def test_modules_still_missing():
    """The reference's modules the port lacks are MODULES_MISSING and its
    Pallas kernel modules, no more; gt.data, gt.io, gt.parallel,
    gt.imagetools and the shims are there as in the reference."""
    missing = _modules(jg) - _modules(tg)
    pallas = {m for m in missing if m.startswith("ops/pallas_")}
    assert missing - pallas == MODULES_MISSING
    for name in ("data", "io", "parallel", "imagetools", "tpugpa",
                 "geometric_phase_analysis", "mathtools"):
        assert inspect.ismodule(getattr(tg, name))
    assert callable(tg.data.MosaicTiles) and callable(tg.io.save_checkpoint)


def _entry(name):
    """One of the new entry points at 64^2 with no `device`."""
    img = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    ks = np.array([[0.1, 0.02], [-0.03, 0.12], [0.07, -0.1]])
    if name == "extract_primary_ks":
        return tg.gpa.extract_primary_ks(img)
    if name == "refine_ks":
        return tg.gpa.refine_ks(img, ks, iters=1, kmax_iter=2)
    if name == "iterate_GPA":
        return tg.gpa.iterate_GPA(img, ks, 8, iters=1, kmax_iter=2, kmax=2)
    if name == "GPA":
        return tg.gpa.GPA(img, 0.1, 0.02)
    if name == "wfr4":
        return tg.gpa.wfr4(img, 8, ks[:1], ks[0], 0.01)
    if name == "wff":
        return tg.gpa.wff(img, 4, [1.0], 0.3, 0.6)
    if name == "iterate_J_leastsq":
        return tg.props.iterate_J_leastsq(np.eye(2)[None], np.zeros(4))
    if name == "Kerelsky_J":
        return tg.props.Kerelsky_J(np.zeros((2, 2, 2, 2)), ks)
    if name == "moire_props_from_Jac_2_Kerelsky":
        return tg.props.moire_props_from_Jac_2_Kerelsky(
            ks, np.tile(np.eye(2), (2, 2, 1, 1)), 1.0)
    if name in ("optGPA", "gpa_lockin"):
        return getattr(tg.gpa if name == "optGPA" else tg.ops, name)(
            img, ks[0])
    return getattr(tg.gpa if name == "vecGPA" else tg.ops, name)(img, ks)


@pytest.mark.parametrize("name", ["extract_primary_ks", "refine_ks",
                                  "iterate_GPA", "GPA", "optGPA", "vecGPA",
                                  "gpa_lockin", "gpa_lockin_batch", "wfr4",
                                  "wff", "iterate_J_leastsq", "Kerelsky_J",
                                  "moire_props_from_Jac_2_Kerelsky"])
def test_new_entry_points_default_to_the_card(name):
    """With no `device`, a new entry point moves its numpy input to the
    card; where torch has no CUDA it raises instead of running on the
    CPU, and launches nothing."""
    _build.launches.clear()
    if torch.cuda.is_available():
        out = _entry(name)
        if isinstance(out, dict):
            out = out["lockin"]
        if name in ("Kerelsky_J", "moire_props_from_Jac_2_Kerelsky"):
            out = out[0]    # X and props, beside host results
        assert isinstance(out, (np.ndarray, tuple)) or \
            out.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
        _entry(name)
    assert sum(_build.launches.values()) == 0


def test_quickstart_chain_matches():
    """examples/quickstart.py's chain at 256^2 (r_k 0.07, theta 12 deg,
    a Gaussian bump of u) on device="cpu": detected and refined ks, u
    after deconvolution, the undistorted image, the lattice properties
    and the unit cell, each within 1e-10 of the reference's largest value
    (the refined ks and the properties: rtol 1e-10), and u within the
    quick start's own accuracy of the truth (0.2 px on the 20-px
    interior)."""
    size = 256
    S = size // 2
    xp, yp = np.meshgrid(np.arange(-S, S), np.arange(-S, S), indexing="ij")
    u_true = np.stack([2.0 * np.exp(-((xp / 60.) ** 2 + (yp / 45.) ** 2)),
                       np.zeros((size, size))])
    u_true -= u_true.mean(axis=(1, 2), keepdims=True)
    image = np.asarray(jg.lattices.hexlattice_gen(0.07, 12.0, order=2,
                                                  size=size, shift=u_true))

    pj, _ = jg.gpa.extract_primary_ks(image, DoG=False, subpixel=True)
    kj = jg.gpa.refine_ks(image, pj)
    uj = -np.asarray(jg.gpa.extract_displacement_field(image, kj,
                                                       deconvolve=True))
    fj = np.asarray(jg.gpa.undistort_image(image, jnp.asarray(u_true),
                                           coarse=4))
    prj = np.asarray(jg.props.calc_props_from_kvecs4(kj, standardize=True))
    cj = np.asarray(jg.ucell.unit_cell_average(image, kj[:2],
                                               u=jnp.asarray(u_true), z=2))

    pt, _ = tg.gpa.extract_primary_ks(image, DoG=False, subpixel=True,
                                      device="cpu")
    kt = tg.gpa.refine_ks(image, pt, device="cpu")
    ut = -tg.gpa.extract_displacement_field(image, kt, deconvolve=True,
                                            device="cpu").numpy()
    ft = tg.gpa.undistort_image(image, u_true, coarse=4,
                                device="cpu").numpy()
    prt = np.asarray(tg.props.calc_props_from_kvecs4(kt, standardize=True))
    ct = tg.ucell.unit_cell_average(image, kt[:2], u=u_true, z=2,
                                    device="cpu").numpy()

    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(kt, kj, rtol=1e-10)
    for got, want in ((ut, uj), (ft, fj)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())
    np.testing.assert_allclose(prt, prj, rtol=1e-10)
    np.testing.assert_array_equal(np.isnan(ct), np.isnan(cj))
    np.testing.assert_allclose(ct, cj, rtol=0,
                               atol=1e-10 * np.nanmax(np.abs(cj)))
    assert np.abs(ut - u_true)[:, 20:-20, 20:-20].max() < 0.2
