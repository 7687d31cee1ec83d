"""The port's displacement extractor end to end on the CPU against the
reference's, its Wiener deconvolution, and the package's boundaries:
it imports no JAX, and a kernel asked for without nvcc fails loudly
instead of falling back."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.ops.pallas_sweep as ps
import pygpa_tpu.ops.wfr as wfr_mod
import pygpa_tpu.solvers.unwrap as JU
from pygpa_tpu.gpa import pipeline as jpipe
from pygpa_tpu.lattices import generate_ks, hexlattice_gen
from pygpa_tpu_torch.gpa import pipeline as tpipe
from pygpa_tpu_torch.ops import _build
from pygpa_tpu_torch.ops import cg as tcg
from pygpa_tpu_torch.ops import sweep as tsweep
from pygpa_tpu_torch.ops import vcycle as tvc

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def kernel_reference(monkeypatch):
    """The reference extractor on its grouped kernel route (sweep in
    interpret mode, unwrap kernels forced), as
    tests/test_lockin_wfr.py runs it off the TPU."""
    jax.clear_caches()
    monkeypatch.setattr(wfr_mod, "_use_pallas_sweep", lambda: True)
    orig = ps.fused_zoom_sweep_grouped

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(ps, "fused_zoom_sweep_grouped", interp)
    monkeypatch.setattr(JU, "_PALLAS_CG", True)
    monkeypatch.setattr(JU, "_PALLAS_VCYCLE", True)
    yield
    jax.clear_caches()


def test_extractor_matches_reference(kernel_reference):
    size, r_k, theta = 256, 0.1, 7.0
    img = np.array(hexlattice_gen(r_k, theta, order=1, size=size,
                                  dtype=jnp.float32))
    ks = np.array(generate_ks(r_k, theta))[:3]
    want = np.asarray(jpipe.make_displacement_extractor(
        (size, size), ks, chunk=4, unwrap_coarse=4)(jnp.asarray(img)))
    fn = tpipe.make_displacement_extractor((size, size), ks, chunk=4,
                                           unwrap_coarse=4, device="cpu")
    got = fn(torch.from_numpy(img))
    assert got.shape == (2, size, size) and got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(got).all()
    b = 8
    assert np.abs(got - want)[:, b:-b, b:-b].max() < 1e-3
    # the factory's plan is the reference's (same banks, same windows)
    assert fn.plan.sigma == 10 and fn.plan.dr == 20
    assert fn.plan.wl.shape == (3, 36, 2)


def test_extractor_refuses_unported_routes(kernel_reference, monkeypatch):
    """Two routes that run rather than raise. (1) The factory with
    pipeline_fused_uv=False: the grouped phase/weight emission,
    then the demodulated reconstruction, against the reference's same
    route (its grouped kernel in interpret mode), within 1e-3 px on the
    8-px interior, as the uv route is held. (2)
    extract_displacement_field(with_grad=True, return_gs=True) on the
    CPU: each peak's g-dict carries 'grad' (n, m, 2), and u is the same
    as without with_grad; on a float64 image (the plain route on both
    sides) the gradients match the reference's within 1e-9 rad/px."""
    size, r_k, theta = 256, 0.1, 7.0
    ks = np.array(generate_ks(r_k, theta))[:3]
    img = np.array(hexlattice_gen(r_k, theta, order=1, size=size,
                                  dtype=jnp.float32))
    for mod in (tpipe, jpipe):
        monkeypatch.setattr(mod, "DEFAULTS", mod.DEFAULTS.__class__(
            pipeline_fused_uv=False))
    want = np.asarray(jpipe.make_displacement_extractor(
        (size, size), ks, chunk=4, unwrap_coarse=4)(jnp.asarray(img)))
    fn = tpipe.make_displacement_extractor((size, size), ks, chunk=4,
                                           unwrap_coarse=4, device="cpu")
    assert fn.plan is not None
    got = fn(torch.from_numpy(img)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want)[:, 8:-8, 8:-8].max() < 1e-3
    img64 = img[:128, :128].astype(np.float64)
    u, gs = tpipe.extract_displacement_field(img64, ks, with_grad=True,
                                             return_gs=True, device="cpu")
    u0 = tpipe.extract_displacement_field(img64, ks, device="cpu")
    np.testing.assert_array_equal(u.numpy(), u0.numpy())
    _, jgs = jpipe.extract_displacement_field(img64, ks, with_grad=True,
                                              return_gs=True)
    for g, jg in zip(gs, jgs):
        assert g["grad"].shape == (128, 128, 2)
        np.testing.assert_allclose(g["grad"].numpy(), np.asarray(jg["grad"]),
                                   rtol=0, atol=1e-9)


def test_demod_reconstruction_wraps_without_the_pi_shift():
    """A trait of the reference: its reconstruct_u_inv_from_demod wraps
    each phase difference as (x + pi) mod 2 pi - pi, and in float32 that
    rounds a difference near 2 pi k (here 0.126 rad) to the spacing at
    pi; the port wraps as the uv epilogue does (ops.sweep.wrap_diff),
    which returns such an x unchanged. On the card this decided the
    bench's dc-free gate for the factory with pipeline_fused_uv=False.
    Here, on a smooth u (two Gaussian and sine components) at 512^2: in
    float64 the two routes agree within 1e-9 px; in float32 the port's
    u lies nearer the float64 u than the reference's does."""
    from pygpa_tpu.gpa import reconstruct as JR
    from pygpa_tpu_torch.core.mathtools import wrap_to_pi
    from pygpa_tpu_torch.gpa import reconstruct as TR
    x = torch.tensor([0.12566371], dtype=torch.float32)
    assert torch.equal(tsweep.wrap_diff(x), x)
    assert not torch.equal(wrap_to_pi(x), x)
    ks = np.asarray(generate_ks(0.02, 5.0, kappa=1.005, psi=10.0))[:3]
    n = 512
    y, xx = np.mgrid[:n, :n]
    u = np.stack([0.3 * np.exp(-((xx - n / 2) ** 2 + (y - n / 2) ** 2)
                               / (2 * (n / 6) ** 2)),
                  0.2 * np.sin(2 * np.pi * xx / n)])
    ph = np.angle(np.exp(-2j * np.pi * np.einsum("kc,cnm->knm", ks, u)))
    w = np.ones_like(ph)
    want = np.asarray(JR.reconstruct_u_inv_from_demod(
        jnp.asarray(ks), jnp.asarray(ph), jnp.asarray(w)))
    got = TR.reconstruct_u_inv_from_demod(ks, torch.from_numpy(ph),
                                          torch.from_numpy(w)).numpy()
    assert np.abs(got - want).max() < 1e-9

    def dc_free_err(a):
        d = a - want
        return np.abs(d - d.mean(axis=(1, 2), keepdims=True)).max()
    f32 = np.float32
    ref32 = np.asarray(JR.reconstruct_u_inv_from_demod(
        jnp.asarray(ks, jnp.float32), jnp.asarray(ph, jnp.float32),
        jnp.asarray(w, jnp.float32)))
    port32 = TR.reconstruct_u_inv_from_demod(
        ks, torch.from_numpy(ph.astype(f32)),
        torch.from_numpy(w.astype(f32))).numpy()
    assert dc_free_err(port32) < dc_free_err(ref32)


@pytest.mark.parametrize("shape,sigma,dr", [((2, 96, 80), 6, 12),
                                            ((2, 256, 256), 10, 20)])
def test_gaussian_deconvolve_matches(shape, sigma, dr):
    rng = np.random.default_rng(11)
    u = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jpipe.gaussian_deconvolve(jnp.asarray(u), sigma, dr))
    got = tpipe.gaussian_deconvolve(torch.from_numpy(u), sigma, dr).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _host_built(shape, sigma, dtype):
    """The deconvolution's Gaussian and Laplacian transfers as they were
    built from host arrays (np.fft.fftfreq in float64, cast once; the
    scalar 2 pi^2 sigma^2 from 0-dim tensors of `dtype`)."""
    fx, fy = (torch.as_tensor(np.fft.fftfreq(n)).to(dtype) for n in shape)
    s2 = torch.tensor(2.0 * np.pi ** 2, dtype=dtype) \
        * torch.tensor(float(sigma), dtype=dtype) ** 2
    H = torch.exp(-s2 * (fx[:, None] ** 2 + fy[None, :] ** 2))
    L = -(2 * torch.cos(2 * np.pi * fx)[:, None]
          + 2 * torch.cos(2 * np.pi * fy)[None, :] - 4.0)
    return H, L


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,sigma", [((96, 80), 6), ((135, 256), 10),
                                         ((1, 7), 3), ((500, 375), 51)])
def test_deconvolution_transfer_keeps_its_bits(shape, sigma, dtype):
    """The Gaussian and Laplacian transfers and the Wiener filter of
    gaussian_deconvolve, now built on the device without a host copy,
    equal the host-built ones bit for bit at odd, even and one-long
    sides in float32 and float64; the padded filter the deconvolution
    uses is the one built from them."""
    from pygpa_tpu_torch.core import fourier as tf
    H0, L0 = _host_built(shape, sigma, dtype)
    H = tf.fourier_gaussian_multiplier(shape, sigma, dtype, "cpu")
    L = tf.laplacian_transfer(shape, dtype, "cpu")
    assert H.dtype == L.dtype == dtype
    assert torch.equal(H, H0) and torch.equal(L, L0)
    assert torch.equal(tf.wiener_filter(H, L, 5000.0),
                       H0 / (H0 * H0 + 5000.0 * L0 * L0))
    n, m = 2 * shape[0] + 8, 2 * shape[1] + 8
    en, em = tpipe._deconvolve_pads(n, m, 4)
    Hp, Lp = _host_built((n + 16 + en, m + 16 + em), sigma, dtype)
    filt = tpipe.deconvolution_filter((n, m), sigma, 4, 5000.0, dtype,
                                      torch.device("cpu"))
    assert torch.equal(filt, Hp / (Hp * Hp + 5000.0 * Lp * Lp))


def test_next_fast_fft_size_matches():
    for n in list(range(1, 300)) + [4096 + 4 * 102, 4504, 8192 + 408]:
        assert tpipe._next_fast_fft_size(n) == jpipe._next_fast_fft_size(n)


def test_port_imports_no_jax():
    code = ("import sys, pkgutil, importlib\n"
            "import pygpa_tpu_torch\n"
            "names = set()\n"
            "for m in pkgutil.walk_packages(pygpa_tpu_torch.__path__, "
            "'pygpa_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "    names.add(m.name)\n"
            "new = {'core.interp', 'ops.warp', 'ops.drizzle', 'ops.expand', "
            "'ucell', 'ucell.averaging', 'gpa.api', 'gpa.kgeometry', "
            "'props', 'props.jacobians', 'data', 'io', 'parallel', "
            "'parallel.sharded'}\n"
            "assert {'pygpa_tpu_torch.' + n for n in new} <= names, names\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'pygpa_tpu' or "
            "m.startswith('pygpa_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_kernels_without_nvcc_raise(monkeypatch, tmp_path):
    """No nvcc: building the kernels raises a RuntimeError naming nvcc;
    nothing falls back to a twin."""
    for var in ("CUDACXX", "CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_HOMES", (str(tmp_path / "cuda"),))
    monkeypatch.setattr(_build, "_lib", None)
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()


def test_bind_caches_per_name_and_layout(monkeypatch):
    """_build.bind declares a launcher's argument types once per (name,
    layout): a repeated call returns the same function, and a second
    layout of the same name gets its own function with its own types,
    never the first caller's (the C library stands in for the kernels')."""
    import ctypes
    monkeypatch.setattr(_build, "_lib", ctypes.CDLL(None))
    monkeypatch.setattr(_build, "_bound", {})
    one = _build.bind("abs", "i")
    assert _build.bind("abs", "i") is one
    two = _build.bind("abs", "f")
    assert two is not one
    assert one.argtypes == [ctypes.c_int] and two.argtypes == [ctypes.c_float]
    assert one(-7) == 7


def test_wrappers_dispatch_on_device():
    """A CPU tensor runs the plain twin and counts no launch; a tensor
    on any other device goes to the kernel path or raises, never to the
    twin."""
    _build.launches.clear()
    p = torch.zeros((2, 32, 32))
    w = torch.ones((32, 32))
    assert torch.equal(tvc.applyq(p, w), tvc.applyq_plain(p, w))
    assert sum(_build.launches.values()) == 0
    meta = torch.empty((2, 32, 32), device="meta")
    wm = torch.empty((32, 32), device="meta")
    with pytest.raises(ValueError, match="device"):
        tvc.applyq(meta, wm)
    with pytest.raises(ValueError, match="device"):
        tvc.presmooth(meta, meta, meta, wm, 4, 0.8)
    with pytest.raises(ValueError, match="device"):
        tcg.cg_poisson(meta, wm, wm, 2)
    args = [torch.empty((1,), device="meta")] * 11
    with pytest.raises(ValueError, match="device"):
        tsweep.sweep_uv(*args, 2, True)
    assert sum(_build.launches.values()) == 0


def _entry_call(name):
    """One of the README's five entry points at 128^2, with no `device`
    argument, on numpy inputs."""
    from pygpa_tpu_torch import lattices as tlat
    from pygpa_tpu_torch import ucell as tucell
    ks = np.asarray(tlat.generate_ks(0.1, 7.0))[:3]
    img = hexlattice_gen(0.1, 7.0, order=1, size=128, dtype=jnp.float32)
    img = np.array(img)
    if name == "extract_displacement_field":
        return tpipe.extract_displacement_field(img, ks)
    if name == "make_displacement_extractor":
        return tpipe.make_displacement_extractor(img.shape, ks)(img)
    if name == "undistort_image":
        return tpipe.undistort_image(img, np.zeros((2,) + img.shape,
                                                   np.float32))
    if name == "unit_cell_average":
        return tucell.unit_cell_average(img, ks[:2], z=2)
    _, rsize = tucell.calc_ucell_parameters(ks[:2], 2)
    return tucell.expand_unitcell(np.ones(rsize, np.float32), ks[:2],
                                  img.shape, z=2)


@pytest.mark.parametrize("name", ["extract_displacement_field",
                                  "make_displacement_extractor",
                                  "undistort_image", "unit_cell_average",
                                  "expand_unitcell"])
def test_entry_points_default_to_the_card(name):
    """With no `device`, an entry point moves its numpy inputs to the
    card and returns a CUDA tensor; where torch has no CUDA it raises
    instead of running on the CPU, and launches nothing."""
    _build.launches.clear()
    if torch.cuda.is_available():
        assert _entry_call(name).device.type == "cuda"
        return
    # a CPU-only torch asserts; a CUDA build without a card finds no driver
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
        _entry_call(name)
    assert sum(_build.launches.values()) == 0
