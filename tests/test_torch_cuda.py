"""The CUDA kernels of pygpa_tpu_torch against their plain twins, on the
card, at small shapes the bench does not use (odd aspect ratios, other
coarse factors and iteration counts). Marked `cuda`; each test skips
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
    q = tvc.applyq(phi, w)
    assert _rel(q, tvc.applyq_plain(phi, w)) <= 1e-5


@pytest.mark.parametrize("n,m,kmax", [(256, 128, 6), (128, 384, 1)])
def test_cg_kernel(dev, n, m, kmax):
    from pygpa_tpu_torch.solvers.unwrap import _residual_aligned
    dxp, dyp = _planes((2, n, m), 5, dev), _planes((2, n, m), 6, dev)
    dxp[..., -1] = 0
    dyp[..., -1, :] = 0
    rk, WWx, WWy = _residual_aligned(dxp, dyp, _weight(n, m, 7, dev))
    got = tcg.cg_poisson(rk, WWx, WWy, kmax)
    want = tcg.cg_poisson_plain(rk, WWx, WWy, kmax)
    assert _rel(got, want) <= 1e-4
    # fixed-order reductions: a second run repeats bit for bit
    assert torch.equal(got, tcg.cg_poisson(rk, WWx, WWy, kmax))


def test_sweep_kernel(dev):
    size, r_k, theta = 256, 0.1, 7.0
    ks = generate_ks(r_k, theta)[:3]
    img = hexlattice_gen(r_k, theta, size=size, device=dev)
    img = img - img.mean()
    sigma = int(np.ceil(1 / np.linalg.norm(ks, axis=1).min()))
    plan = twfr.plan_sweep(img.shape, candidate_banks(ks), sigma,
                           2 * sigma, ks, gauss_cut=7.0)
    sw = twfr.UVSweep(plan, device=dev)
    Sr4, Si4 = sw.windows(img)
    args = (Sr4, Si4, sw.gx, sw.gy, sw.A0c, sw.A0s, sw.A1cT, sw.A1sT,
            sw.run, sw.off, sw.kconst, plan.dr, sw.banded)
    ux, uy, wn = tsweep.sweep_uv(*args)
    px, py, pn = tsweep.sweep_uv_plain(*args)
    assert torch.isfinite(ux).all() and torch.isfinite(uy).all()
    assert (ux[:, :, 0] == 0).all() and (uy[:, 0, :] == 0).all()
    dx = (ux - px)[:, :, 1:].abs().cpu().numpy()
    dy = (uy - py)[:, 1:, :].abs().cpu().numpy()
    assert np.percentile(dx, 99) < 1e-3 and np.percentile(dy, 99) < 1e-3
    assert float(((wn - pn).abs() / (pn.abs() + 1e-9)).max()) < 5e-3
