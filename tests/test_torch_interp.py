"""The port's resampling (pygpa_tpu_torch.core.interp) and the warp
kernels' plain twins (ops.warp) against pygpa_tpu on the CPU: the
prefilter and map_coordinates against pygpa_tpu.core.interp, the twins
against pygpa_tpu.ops.pallas_warp in interpret mode. float64 inputs made
with numpy from a seed; tolerance atol 1e-12 (the same operations up to
summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpa_tpu.core.interp as JI
from pygpa_tpu.ops import pallas_warp
import pygpa_tpu_torch.core.interp as TI
from pygpa_tpu_torch.ops import _build
from pygpa_tpu_torch.ops import warp as TW

torch.set_num_threads(2)
ATOL = 1e-12


def _img(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


def _far_coords(n, m):
    """Positions crossing and far beyond every border, gently warped."""
    yy, xx = np.meshgrid(np.linspace(-25, n + 24, 48),
                         np.linspace(-25, m + 27, 64), indexing="ij")
    return np.stack([yy + 2 * np.sin(xx / 10), xx + 2 * np.cos(yy / 10)])


def _sawtooth(n, m):
    """Cell-like wrapped coordinates: jumps of ~n at every seam."""
    yy, xx = np.meshgrid(np.arange(48, dtype=float),
                         np.arange(64, dtype=float), indexing="ij")
    return np.stack([(yy * 1.73 + 0.2 * xx) % (n - 3.0),
                     (xx * 1.61 + 0.1 * yy) % (m - 5.0)])


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= atol, np.abs(got - want).max()


@pytest.mark.parametrize("margin", [0, 13])
@pytest.mark.parametrize("mode", ["mirror", "nearest", "constant", "wrap"])
def test_spline_filter_matches(mode, margin):
    img = _img((40, 56), 1)
    stack = _img((2, 24, 30), 2)
    for x, axes in ((img, None), (img, (-1,)), (img, (0,)),
                    (stack, (-2, -1))):
        want = JI.spline_filter(jnp.asarray(x), mode=mode, axes=axes,
                                margin=margin)
        _close(TI.spline_filter(torch.from_numpy(x), mode=mode, axes=axes,
                                margin=margin), want)


def test_spline_filter_short_axes():
    """Axes shorter than the 27 + margin pad: the reference pads in
    repeated steps of n - 1, and so does the port."""
    x = _img((5, 3), 3)
    for mode in ("mirror", "nearest", "wrap"):
        _close(TI.spline_filter(torch.from_numpy(x), mode=mode, margin=13),
               JI.spline_filter(jnp.asarray(x), mode=mode, margin=13))


@pytest.mark.parametrize("order,cubic", [(0, "bspline"), (1, "bspline"),
                                         (3, "bspline"), (3, "catmull")])
@pytest.mark.parametrize("mode", ["nearest", "constant"])
def test_map_coordinates_matches(order, cubic, mode):
    img = _img((40, 56), 4)
    for c in (_far_coords(40, 56), _sawtooth(40, 56)):
        want = JI.map_coordinates(jnp.asarray(img), jnp.asarray(c),
                                  order=order, mode=mode, cval=1.5,
                                  cubic=cubic)
        _close(TI.map_coordinates(torch.from_numpy(img), torch.from_numpy(c),
                                  order=order, mode=mode, cval=1.5,
                                  cubic=cubic), want)


def test_map_coordinates_prefiltered_with_margin():
    """prefilter=False on coefficients filtered with NEAREST_MARGIN: the
    'nearest' clamp at +-12 px and the shift into the extended frame."""
    img = _img((48, 40), 5)
    c = _far_coords(48, 40)
    mg = TI.NEAREST_MARGIN
    coef = JI.spline_filter(jnp.asarray(img), mode="nearest", margin=mg)
    tcoef = TI.spline_filter(torch.from_numpy(img), mode="nearest", margin=mg)
    _close(tcoef, coef)
    want = JI.map_coordinates(coef, jnp.asarray(c), order=3,
                              mode="nearest", prefilter=False, margin=mg)
    _close(TI.map_coordinates(tcoef, torch.from_numpy(c), order=3,
                              mode="nearest", prefilter=False, margin=mg),
           want)


@pytest.mark.parametrize("order", [1, 3])
def test_map_coordinates_1d_and_rect(order):
    """1-D coordinate vectors, and an output grid other than the
    image's (the edge-extended inversion's)."""
    img = _img((64, 64), 6)
    cy, cx = np.linspace(-3, 70, 301), np.linspace(70, -3, 301)
    c1 = np.stack([cy, cx])
    yy, xx = np.meshgrid(np.arange(10, 52, dtype=float),
                         np.arange(5, 75, dtype=float), indexing="ij")
    c2 = np.stack([yy + 4 * np.sin(yy / 20) * np.cos(xx / 25),
                   xx - 5 * np.cos(xx / 30) * np.sin(yy / 17)])
    for c in (c1, c2):
        for mode in ("nearest", "constant"):
            want = JI.map_coordinates(jnp.asarray(img), jnp.asarray(c),
                                      order=order, mode=mode)
            got = TI.map_coordinates(torch.from_numpy(img),
                                     torch.from_numpy(c), order=order,
                                     mode=mode)
            _close(got, want)


def _smooth(n, m):
    """A smooth displacement field sampled on a (48, 64) grid inside an
    (n, m) image."""
    yy, xx = np.meshgrid(4 + 1.2 * np.arange(48), 10 + 1.3 * np.arange(64),
                         indexing="ij")
    return np.stack([
        yy + 5 * np.sin(2 * np.pi * yy / n) * np.cos(2 * np.pi * xx / m),
        xx + 5 * np.cos(2 * np.pi * yy / n + 1.0) * np.sin(2 * np.pi * xx / m)])


@pytest.mark.parametrize("case", ["smooth", "sawtooth", "far"])
@pytest.mark.parametrize("mode", ["nearest", "constant"])
def test_warp_twins_match_interpret_kernels(case, mode):
    """warp_bilinear_plain and the B-spline warp_cubic_plain against the
    Pallas warps in interpret mode, the Catmull-Rom one against the
    reference's plain sampler (which its own tests hold to the kernel at
    1e-12): a smooth field, a sawtooth field (the reference's
    dense-fallback case) and positions far outside. One image and grid
    shape for all cases, so each Pallas variant compiles once."""
    img = _img((64, 96), 8)
    c = {"smooth": _smooth, "sawtooth": _sawtooth,
         "far": _far_coords}[case](64, 96)
    cy, cx = (jnp.asarray(a) for a in c)
    ty, tx = (torch.from_numpy(a) for a in c)
    t = torch.from_numpy(img)
    want = pallas_warp.warp_bilinear(jnp.asarray(img), cy, cx, mode=mode,
                                     cval=-3.5, interpret=True)
    _close(TW.warp_bilinear_plain(t, ty, tx, mode, -3.5), want)
    want = pallas_warp.warp_cubic(jnp.asarray(img), cy, cx, mode=mode,
                                  cval=-3.5, interpret=True, cubic="bspline")
    _close(TW.warp_cubic_plain(t, ty, tx, mode, -3.5, "bspline"), want)
    want = JI._map_coordinates_cubic(jnp.asarray(img), jnp.asarray(c), -3.5,
                                     mode, cubic="catmull")
    _close(TW.warp_cubic_plain(t, ty, tx, mode, -3.5, "catmull"), want)


def test_routes_on_the_cpu():
    """CPU tensors and float64 take the plain samplers: no launch is
    counted, and the gate refuses them; a tensor on another device goes
    to the kernel path and raises there, never to a twin."""
    img = torch.from_numpy(_img((32, 32), 9))
    c = torch.from_numpy(_far_coords(32, 32))
    assert not TI.warp_kernel_ok(img, c, 3, "nearest")
    assert not TI.warp_kernel_ok(img.float(), c.float(), 3, "nearest")
    _build.launches.clear()
    TI.map_coordinates(img.float(), c.float(), order=3)
    TI.map_coordinates(img, c, order=1, mode="constant")
    assert torch.equal(TW.warp_cubic(img, c[0], c[1]),
                       TW.warp_cubic_plain(img, c[0], c[1]))
    assert sum(_build.launches.values()) == 0
    meta = torch.empty((32, 32), device="meta")
    for fn in (TW.warp_bilinear, TW.warp_cubic):
        with pytest.raises(ValueError, match="device"):
            fn(meta, meta, meta)
    with pytest.raises(NotImplementedError):
        TI.map_coordinates(img, c, order=3, mode="wrap")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", ["nearest", "constant"])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_bilinear_plane_stack_is_bit_identical_per_plane(C, mode, dtype):
    """The bilinear twin on a stack (C, n, m) and the private stack route
    (core.interp._map_coordinates_stack) against one call per plane: the
    same float operations, so equal bit for bit, for positions inside,
    on and far beyond the border and across sawtooth seams."""
    stack = torch.from_numpy(_img((C, 40, 56), 10 + C).astype(dtype))
    c = np.concatenate([_far_coords(40, 56), _sawtooth(40, 56)], axis=1)
    c = torch.from_numpy(c.astype(dtype))
    got = TW.warp_bilinear_plain(stack, c[0], c[1], mode, -1.5)
    assert got.shape == (C,) + c.shape[1:] and got.dtype == stack.dtype
    via_route = TI._map_coordinates_stack(stack, c, 1, mode)
    for k in range(C):
        assert torch.equal(got[k], TW.warp_bilinear_plain(
            stack[k], c[0], c[1], mode, -1.5))
        assert torch.equal(via_route[k], TI.map_coordinates(
            stack[k], c, order=1, mode=mode))
