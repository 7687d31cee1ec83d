"""The port's displacement inversion and Lawler-Fujita undistortion
(pygpa_tpu_torch.gpa.pipeline invert_u, invert_u_overlap,
undistort_image) and phase_unwrap_mg against pygpa_tpu on the CPU.
Fields and images are made with numpy from a seed. Tolerances: float64
atol 1e-10; float32 within 1e-5 of max |u| (inversions) or 3e-5 of max
|image| (undistortion): the reference's own float32 rounding between two
summation orders."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.gpa.pipeline as JP
import pygpa_tpu.solvers.unwrap as JU
import pygpa_tpu_torch.gpa.pipeline as TP
import pygpa_tpu_torch.solvers.unwrap as TU

torch.set_num_threads(2)


def _field(n, dtype=np.float64):
    """A smooth (2, n, n) displacement of a few pixels that does not
    vanish on the border (so no sample lands exactly on the 'constant'
    cut at a border pixel, where one rounding flips the result)."""
    yy, xx = np.meshgrid(np.arange(n, dtype=float), np.arange(n, dtype=float),
                         indexing="ij")
    return np.stack([3.0 * np.sin(2 * np.pi * yy / n + 0.4) + 0.3,
                     2.0 * np.cos(2 * np.pi * xx / n) + 0.5
                     * np.sin(2 * np.pi * yy / n)]).astype(dtype)


def _close(got, want, atol):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= atol, np.abs(got - want).max()


@pytest.mark.parametrize("order,edge", [(3, 0), (1, 0), (3, 5)])
def test_invert_u_matches(order, edge):
    us = _field(128)
    want = JP.invert_u(jnp.asarray(us), iters=35, edge=edge, order=order)
    got = TP.invert_u(torch.from_numpy(us), iters=35, edge=edge, order=order)
    _close(got, want, 1e-10)


@pytest.mark.parametrize("n,coarse,edge", [(128, 1, 0), (128, 1, 6),
                                           (256, 4, 0), (128, 4, 6)])
def test_invert_u_overlap_matches(n, coarse, edge):
    us = _field(n)
    want = JP.invert_u_overlap(jnp.asarray(us), edge=edge, coarse=coarse)
    got = TP.invert_u_overlap(torch.from_numpy(us), edge=edge, coarse=coarse)
    _close(got, want, 1e-10)
    us32 = us.astype(np.float32)
    want = JP.invert_u_overlap(jnp.asarray(us32), edge=edge, coarse=coarse)
    got = TP.invert_u_overlap(torch.from_numpy(us32), edge=edge,
                              coarse=coarse)
    _close(got, want, 1e-5 * np.abs(us).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_coarse_inversion_samples_plane_stacks(dtype, monkeypatch):
    """invert_u_overlap(coarse=4) samples u's two planes together in each
    of the 17 Picard steps and the 2 Newton steps, and the four gradient
    planes of J together: 20 bilinear samplings of stacks (on the card,
    20 launches), with the result of the reference."""
    from pygpa_tpu_torch.ops import warp as TW
    calls = []
    plain = TW.warp_bilinear_plain

    def count(image, *a):
        calls.append(tuple(image.shape[:-2]))
        return plain(image, *a)

    monkeypatch.setattr(TW, "warp_bilinear_plain", count)
    us = _field(256, dtype)
    got = TP.invert_u_overlap(torch.from_numpy(us), coarse=4)
    assert sorted(calls) == [(2,)] * 19 + [(4,)]
    want = JP.invert_u_overlap(jnp.asarray(us), coarse=4)
    _close(got, want, 1e-10 if dtype == np.float64 else 1e-5
           * np.abs(us).max())


@pytest.mark.parametrize("n,coarse", [(128, 1), (256, 4)])
def test_undistort_image_matches(n, coarse):
    img = np.random.default_rng(3).normal(size=(n, n))
    us = _field(n)
    # float32: one ulp of a 256-px coordinate (1.5e-5 px) times the
    # slope of a white-noise image is ~1e-5 of its maximum
    for dt, atol in ((np.float64, 1e-10), (np.float32, 3e-5)):
        x, u = img.astype(dt), us.astype(dt)
        want = JP.undistort_image(jnp.asarray(x), jnp.asarray(u),
                                  coarse=coarse)
        got = TP.undistort_image(torch.from_numpy(x), torch.from_numpy(u),
                                 coarse=coarse, device="cpu")
        _close(got, want, atol * np.abs(x).max())


def test_undistort_recovers_the_lattice():
    """The README's call on a deformed lattice gives back the clean one
    (the reference's own check: rel err < 1%)."""
    from pygpa_tpu_torch.lattices import hexlattice_gen
    n = 256
    u = _field(n)
    clean = hexlattice_gen(0.09, 21.5, order=2, size=n, dtype=torch.float64)
    deformed = hexlattice_gen(0.09, 21.5, order=2, size=n, shift=u,
                              dtype=torch.float64)
    rec = TP.undistort_image(deformed, torch.from_numpy(u), device="cpu")
    d = (rec - clean)[16:-16, 16:-16]
    assert float(d.norm() / clean[16:-16, 16:-16].norm()) < 0.01


def _phase(n):
    x = np.linspace(-1, 1, n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    psi = 12 * np.exp(-(X ** 2 + 2 * Y ** 2) / 0.3) + 20 * X * Y
    w = 0.2 + np.exp(-(X ** 2 + Y ** 2))
    return (np.angle(np.exp(1j * psi)).astype(np.float32),
            w.astype(np.float32))


@pytest.mark.parametrize("weighted", [True, False])
def test_phase_unwrap_mg_matches(weighted):
    """Weighted (the multigrid) and unweighted (one Poisson solve) on a
    wrapped 256^2 float32 phase: normwise within 1e-5."""
    psi, w = _phase(256)
    want = np.asarray(JU.phase_unwrap_mg(jnp.asarray(psi),
                                         jnp.asarray(w) if weighted else None))
    got = TU.phase_unwrap_mg(torch.from_numpy(psi),
                             torch.from_numpy(w) if weighted else None)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("mode,margin,origin", [("nearest", 13, (0, 0)),
                                                ("nearest", 13, (-5, -5)),
                                                ("constant", 0, (0, 0))])
def test_displacement_twin_is_the_composition(mode, margin, origin):
    """The displacement-form cubic warp's twin (and so the CPU route of
    the inversion's Picard step and the undistortion's final warp) is
    the composition it replaces, bit for bit, in float32: positions r +
    u built in torch, then map_coordinates(order=3, prefilter=False) of
    each coefficient plane (with the 'nearest' margin's clamp and
    shift); and an in-place call (out = u) gives the same planes."""
    from pygpa_tpu_torch.core import interp as TI
    from pygpa_tpu_torch.ops import warp as TW
    rng = np.random.default_rng(17)
    h, w = 96, 80
    planes = torch.from_numpy(rng.normal(size=(2, h, w)).astype(np.float32))
    coef = TI.spline_filter(planes, mode=mode, axes=(-2, -1), margin=margin)
    coef = coef.permute(1, 2, 0).contiguous()          # planes last
    # a few pixels of displacement, and some positions far outside
    u = torch.from_numpy((4 * rng.normal(size=(2, h, w))).astype(np.float32))
    u[:, :3, :4] = torch.tensor([[40.0], [-60.0]])[:, :, None]
    xx = torch.arange(origin[0], origin[0] + h).float()[:, None]
    yy = torch.arange(origin[1], origin[1] + w).float()[None, :]
    coords = torch.stack([xx.expand(h, w) + u[0], yy.expand(h, w) + u[1]])
    want = torch.stack([TI.map_coordinates(coef[..., p], coords, order=3,
                                           mode=mode, prefilter=False,
                                           margin=margin)
                        for p in range(2)])
    got = TW.warp_cubic_disp(coef, u, origin, margin, mode)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(TI.map_displaced(coef, u, origin, mode, margin), want)
    u_in = u.clone()
    TI.map_displaced(coef, u_in, origin, mode, margin, out=u_in)
    assert torch.equal(u_in, want)
    one = TW.warp_cubic_disp(coef[..., :1], u, origin, margin, mode)
    assert torch.equal(one, want[:1])


def test_order3_inversion_steps_in_place(monkeypatch):
    """invert_u_overlap (coarse 1, order 3) runs one displacement-form
    warp of both planes per Picard step, 36 in all, each writing u_it in
    place, and undistort_image adds one for its final warp: 37."""
    from pygpa_tpu_torch.ops import warp as TW
    calls = []
    plain = TW.warp_cubic_disp_plain

    def count(coef, u, origin, margin, mode, cval, out=None):
        calls.append((coef.shape[-1], out is u, mode))
        return plain(coef, u, origin, margin, mode, cval, out)

    monkeypatch.setattr(TW, "warp_cubic_disp_plain", count)
    us = _field(64, np.float32)
    TP.undistort_image(torch.from_numpy(us[0]), torch.from_numpy(us),
                       device="cpu")
    assert calls == [(2, True, "nearest")] * 36 + [(1, False, "constant")]
