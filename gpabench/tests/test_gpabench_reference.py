"""The plain reference on the CPU: its transforms and solver against
known answers, and against the program's CPU route on a 256^2 fixture
(the program's plain route is what the reference must agree with; the
reference itself imports nothing of it)."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from gpabench.harness import check, inputs  # noqa: E402
from gpabench.reference import gpa as rgpa  # noqa: E402
from gpabench.reference import props as rprops  # noqa: E402
from gpabench.reference import quickstart as rqs  # noqa: E402
from gpabench.reference.precision import Store  # noqa: E402

LATTICE = {"r_k": 0.1, "theta_deg": 5.0, "kappa": 1.005, "psi_deg": 10.0,
           "order": 2}
TRAFFIC = {"noise": 0.5, "field": {"amplitude": [0.02, 0.03],
                                  "centre_frac": 0.1,
                                  "width_frac": [0.2, 0.33]}}


@pytest.fixture(scope="module")
def fixture():
    frames, _ = inputs.frame_pool(LATTICE, 256, 1, TRAFFIC, 2 ** 31 + 11,
                                  "cpu")
    return frames[0], inputs.primary_ks(LATTICE)


def test_dct_pair_is_scipys():
    scipy_fft = pytest.importorskip("scipy.fft")
    x = torch.randn(6, 10, dtype=torch.float64)
    want = scipy_fft.dct(x.numpy(), type=2, axis=-1)
    got = rgpa._dct(x, -1)
    assert np.allclose(got.numpy(), want, atol=1e-12)
    assert torch.allclose(rgpa._idct(got, -1), x, atol=1e-12)


def test_ls_integrate_recovers_a_field():
    n = 96
    x = torch.arange(n, dtype=torch.float64)
    phi = torch.sin(x[:, None] / 9) * torch.cos(x[None, :] / 13) * 3
    wn = 0.5 + torch.rand(n, n, dtype=torch.float64)
    got = rgpa.ls_integrate(rgpa._dx(phi), rgpa._dy(phi), wn)
    d = got - phi
    assert float((d - d.mean()).abs().max()) < 1e-6


def test_bspline_interpolates_its_samples():
    x = torch.randn(40, 50, dtype=torch.float64)
    c = rqs.bspline_coefficients(x)
    X = torch.arange(40, dtype=torch.float64)[:, None].expand(40, 50)
    Y = torch.arange(50, dtype=torch.float64)[None, :].expand(40, 50)
    assert torch.allclose(rqs.bspline_sample(c, X, Y), x, atol=1e-10)


def test_huber_plane_is_the_programs_fit():
    gt = pytest.importorskip("pygpa_tpu_torch")
    n, m = 64, 80
    x = torch.arange(n, dtype=torch.float64)[:, None]
    y = torch.arange(m, dtype=torch.float64)[None, :]
    z = 0.03 * x - 0.02 * y + 1.5 + 0.3 * torch.sin(x * y / 17)
    z[5, 7] += 100.0
    got = rqs.huber_plane(z)
    want = gt.core.mathtools.fit_plane(z)
    assert torch.allclose(got, want.to(got.dtype), atol=1e-9)


def test_store_rounds_to_bfloat16():
    x = torch.tensor([1.0 + 2 ** -10, 3.0], dtype=torch.float64)
    assert Store()(x) is x
    assert Store("bfloat16")(x)[0] == 1.0


def test_factory_field_agrees_with_the_programs_cpu_route(fixture):
    gt = pytest.importorskip("pygpa_tpu_torch")
    img, ks = fixture
    run = gt.gpa.pipeline.make_displacement_extractor(
        (256, 256), ks, chunk=4, unwrap_coarse=None, device="cpu")
    u = run(img)
    res = check.judge_factory(img[None], u[None], ks, "cpu", 40, None)
    assert res["u_p99_px"] < 1e-4
    ctrl = check.factory_reference(img, ks, "cpu", None, Store("bfloat16"))
    bad = check.judge_factory(img[None], ctrl[None], ks, "cpu", 40, None)
    assert bad["u_p99_px"] > 30 * res["u_p99_px"]


def test_quickstart_agrees_with_the_programs_cpu_route(fixture):
    gt = pytest.importorskip("pygpa_tpu_torch")
    img, _ = fixture
    found, _ = gt.gpa.extract_primary_ks(img, device="cpu")
    pks, _ = gt.gpa.extract_primary_ks(img, DoG=False, subpixel=True,
                                       device="cpu")
    pks = gt.gpa.peaks.select_closest_to_triangle(pks)
    assert rqs.match(pks, rqs.primary_ks(img, dog=False,
                                         subpixel=True))[1].max() < 1e-8
    ks = gt.gpa.refine_ks(img, pks, device="cpu")
    u = gt.gpa.extract_displacement_field(img, ks, device="cpu")
    out = {"ks_found": found, "ks": ks, "u": u,
           "flat": gt.gpa.undistort_image(img, u, device="cpu"),
           "cell": gt.ucell.unit_cell_average(img, ks[:2], u=u, z=2,
                                              device="cpu")}
    res = check.judge_quickstart(img, out, 2, "cpu")
    assert res["ks_found_bins"] == 0
    assert res["k_refined_bins"] < 1e-4
    assert res["u_p99_px"] < 1e-4
    assert res["flat_max_rel"] < 1e-4
    assert res["cell_max_rel"] < 2e-4


def test_props_agree_with_the_programs(fixture):
    gt = pytest.importorskip("pygpa_tpu_torch")
    img, ks = fixture
    u = rgpa.displacement(img, ks, rgpa.factory_banks(ks)).float()
    got = gt.props.props_from_u(u, 1.0).double()
    twist, alpha, kappa = rprops.props(u)
    b = 20
    for g, r in ((got[0], twist), (got[2], alpha), (got[3], kappa)):
        assert float((g - r)[b:-b, b:-b].abs().max()) < 1e-4


def test_tiles_agree_with_the_programs_loader(tmp_path):
    gt = pytest.importorskip("pygpa_tpu_torch")
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 65535, (300, 280), dtype=np.uint16)
    path = str(tmp_path / "m.gpam")
    inputs.write_gpam(path, arr)
    with gt.data.MosaicTiles(path) as mt:
        got = mt.read_tiles([(10, 20)], 128)[0]
    want = rprops.tile(path, (10, 20), 128)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_lattice_copy_is_the_programs():
    gt = pytest.importorskip("pygpa_tpu_torch")
    u = inputs.bump_field(128, (3.0, -5.0), (30.0, 40.0), 0.02, "cpu")
    want = gt.lattices.hexlattice_gen(0.1, 5.0, order=2, size=128,
                                      kappa=1.005, psi=10.0, shift=u,
                                      dtype=torch.float64, device="cpu")
    S = 64
    x = torch.arange(-S, S, dtype=torch.float64)[:, None] + u[0]
    y = torch.arange(-S, S, dtype=torch.float64)[None, :] + u[1]
    got = inputs.render(LATTICE, x, y)
    assert torch.allclose(got, want, atol=1e-10)
    assert np.allclose(inputs.primary_ks(LATTICE),
                       gt.lattices.generate_ks(0.1, 5.0, kappa=1.005,
                                               psi=10.0)[:3])
