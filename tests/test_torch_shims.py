"""The port's pyGPA compatibility surface on the CPU: each module-path
shim (geometric_phase_analysis, phase_unwrap, property_extract,
unit_cell_averaging, mathtools) exports the reference shim's public
names; the cuGPA mirror (tpugpa) against pygpa_tpu.tpugpa at 128^2 in
float32 (the reference on its kernel route, the Pallas zoom sweep in
interpret mode, as the port's float32 route is its kernel's twin) and
in float64 (both plain routes), and through the wfr_func seam; and
the orbax-named checkpoint pair's round trip."""
import functools
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.tpugpa as jtg
from pygpa_tpu.lattices import generate_ks, hexlattice_gen
import pygpa_tpu_torch as gt
import pygpa_tpu_torch.tpugpa as ttg

from test_torch_wfr_grad import _flip_tolerant, kernels  # noqa: F401

torch.set_num_threads(2)
SHIMS = ("geometric_phase_analysis", "phase_unwrap", "property_extract",
         "unit_cell_averaging", "mathtools", "tpugpa")


def _public(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("name", SHIMS)
def test_shim_exports_the_references_names(name):
    """The shim's public names are the reference shim's, each callable,
    and it is reachable as gt.<name>; phase_unwrap's private _wrapToPi
    too."""
    tmod = importlib.import_module(f"pygpa_tpu_torch.{name}")
    jmod = importlib.import_module(f"pygpa_tpu.{name}")
    assert getattr(gt, name) is tmod
    names = _public(jmod) - {"jnp"}
    assert _public(tmod) - {"np", "torch"} == names
    for n in names:
        assert callable(getattr(tmod, n)), n
    if name == "phase_unwrap":
        assert callable(tmod._wrapToPi)


def _image(dtype):
    img = np.array(hexlattice_gen(0.12, 9.0, order=1, size=128,
                                  dtype=np.float64)).astype(dtype)
    return img - img.mean()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tpugpa_mirror_matches(request, dtype):
    """tpuGPA/cuGPA, wfr2_grad_opt, wfr2_grad_single, wfr2_only_lockin and
    wfr2_only_grad at 128^2 against the reference's: the lock-ins within
    1e-5 (float32) or 1e-10 (float64) of their largest magnitude away
    from near-tie winner flips, the gradients within the flip-tolerant
    bounds of tests/test_lockin_wfr.py; single precision returns
    complex64 and float32."""
    if dtype == np.float32:
        request.getfixturevalue("kernels")
    img = _image(dtype)
    k = np.array(generate_ks(0.12, 9.0))[0]
    tol = 1e-5 if dtype == np.float32 else 1e-10

    def close_lockin(got, want, frac):
        got, want = got.numpy(), np.asarray(want)
        bad = np.abs(got - want) > tol * np.abs(want).max()
        assert bad.mean() <= frac, bad.mean()

    for fn in ("tpuGPA", "cuGPA"):
        close_lockin(getattr(ttg, fn)(img, k, 10, device="cpu"),
                     getattr(jtg, fn)(jnp.asarray(img), k, 10), 0)
    kw, ks = 0.03, 0.01
    args = (10, k[0], k[1], kw, ks)
    g = ttg.wfr2_grad_opt(img, *args, device="cpu")
    jg = jtg.wfr2_grad_opt(jnp.asarray(img), *args)
    close_lockin(g["lockin"], jg["lockin"], 2e-4)
    ph = np.angle(g["lockin"].numpy())
    jph = np.angle(np.asarray(jg["lockin"]))
    _flip_tolerant(ph, jph, (g["grad"][..., 0].numpy(),
                             g["grad"][..., 1].numpy()),
                   (np.asarray(jg["grad"])[..., 0],
                    np.asarray(jg["grad"])[..., 1]))
    s = ttg.wfr2_grad_single(img, *args, device="cpu")
    assert s["lockin"].dtype == torch.complex64
    assert s["grad"].dtype == torch.float32 and set(s) == {"lockin", "grad"}
    if dtype == np.float32:
        for key in ("lockin", "grad"):
            assert torch.equal(s[key], g[key])
    lk = ttg.wfr2_only_lockin(img, 10, k, kw, ks, device="cpu")
    close_lockin(lk, jtg.wfr2_only_lockin(jnp.asarray(img), 10, k, kw, ks),
                 2e-4)
    og = ttg.wfr2_only_grad(img, 10, k, kw, ks, device="cpu")
    assert torch.equal(og, g["grad"])


def test_tpugpa_through_the_wfr_func_seam():
    """The mirror's sweep injected through extract_displacement_field's
    wfr_func seam gives the native field (float64, 96^2), as the
    reference's test_compat_api holds its own."""
    img = np.array(hexlattice_gen(0.12, 9.0, order=1, size=96,
                                  dtype=np.float64))
    ks = np.array(generate_ks(0.12, 9.0))[:3]
    GPA = gt.geometric_phase_analysis
    u_plugin = GPA.extract_displacement_field(
        img, ks, wfr_func=functools.partial(ttg.wfr2_grad_opt,
                                            device="cpu"), device="cpu")
    u_native = GPA.extract_displacement_field(img, ks, device="cpu")
    np.testing.assert_allclose(u_plugin.numpy(), u_native.numpy(),
                               rtol=0, atol=1e-10)


def test_orbax_named_pair_round_trips(tmp_path):
    """save_checkpoint_orbax / restore_checkpoint_orbax keep a flat dict
    of tensors and arrays, dtypes and bits; an abstract tree of tensors
    places each on its entry's device."""
    g = np.random.default_rng(0)
    tree = {"u": torch.from_numpy(g.normal(size=(2, 8, 8)).astype(np.float32)),
            "ks": g.normal(size=(3, 2)), "idx": np.arange(5, dtype=np.int32)}
    path = str(tmp_path / "sub" / "ckpt.pt")
    gt.io.save_checkpoint_orbax(path, tree)
    out = gt.io.restore_checkpoint_orbax(path)
    assert set(out) == set(tree)
    assert torch.equal(out["u"], tree["u"])
    np.testing.assert_array_equal(out["ks"].numpy(), tree["ks"])
    assert out["idx"].dtype == torch.int32
    placed = gt.io.restore_checkpoint_orbax(
        path, {"u": torch.zeros(1, device="cpu"), "ks": None})
    assert placed["u"].device.type == "cpu"
    assert torch.equal(placed["u"], tree["u"])
