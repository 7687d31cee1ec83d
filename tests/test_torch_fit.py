"""The robust plane fit's kernel route (ops.fit, csrc/fit_plane.cu) on
the CPU: the kernel's step emulated in float64 numpy (its block partials
in the kernel's fixed order, the nine normal-equation sums, the float64
3x3 solve with partial pivoting and the final offset shift) against the
plain twin fit_plane_irls_plain in float64; the route gate's truth table;
core.mathtools' routing between kernel and twin; the mask's plane layout.
The kernel itself runs in tests/test_torch_cuda.py on the card; the twin
against pygpa_tpu's fit is tests/test_torch_lockin.py's
test_fit_plane_matches."""
import numpy as np
import pytest
import torch

from pygpa_tpu_torch.core import mathtools as tmath
from pygpa_tpu_torch.ops import fit as tfit

from test_torch_lockin import _planes

torch.set_num_threads(2)


def _block_sums(t):
    """csrc/fit_plane.cu block_sums on (..., NT) thread values: each
    warp's shuffle-down tree, then the warps in order."""
    v = t.reshape(t.shape[:-1] + (tfit.NT // 32, 32))
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    v = v[..., 0]
    out = v[..., 0]
    for w in range(1, v.shape[-1]):
        out = out + v[..., w]
    return out


def _solve3(t):
    """csrc/fit_plane.cu solve3 in float64: Gaussian elimination with
    partial pivoting on the normal equations of the nine sums t."""
    a = [[t[3], t[4], t[1], t[7]], [t[4], t[5], t[2], t[8]],
         [t[1], t[2], t[0], t[6]]]
    for c in range(3):
        piv = c
        for r in range(c + 1, 3):
            if abs(a[r][c]) > abs(a[piv][c]):
                piv = r
        a[c], a[piv] = a[piv], a[c]
        for r in range(c + 1, 3):
            f = a[r][c] / a[c][c]
            for k in range(c, 4):
                a[r][k] -= f * a[c][k]
    q = [0.0] * 3
    for r in (2, 1, 0):
        v = a[r][3]
        for k in range(r + 1, 3):
            v -= a[r][k] * q[k]
        q[r] = v / a[r][r]
    return q


def _emulate(img, mask, f_scale=1.0, iters=60):
    """The kernel's fit of img (B, n, m) in float64: iters + 1 launches;
    in each, block b's thread t adds pixels b TILE + k NT + t, k < EPT,
    in order, the block adds its threads (_block_sums), and the plane's
    last block adds the partials, thread t those of blocks t, t + NT,
    ..., in order, then the threads, and solves. mask: None, one (n, m)
    plane for all or (B, n, m)."""
    B, n, m = img.shape
    nm = n * m
    nb = -(-nm // tfit.TILE)
    v = np.zeros((B, nb * tfit.TILE))
    v[:, :nm] = img.reshape(B, nm)
    inside = np.zeros((B, nb * tfit.TILE), bool)
    inside[:, :nm] = True if mask is None else np.broadcast_to(
        mask, img.shape).reshape(B, nm)
    e = np.arange(nb * tfit.TILE)
    cx, cy = (n - 1) / 2, (m - 1) / 2
    x, y = e // m - cx, e % m - cy
    p = np.zeros((B, 3))
    ns = -(-nb // tfit.NT)
    for step in range(iters + 1):
        if step == 0:
            w = np.ones_like(v)
        else:
            plane = p[:, :1] * x + (p[:, 1:2] * y + p[:, 2:])
            r = v - plane
            w = np.minimum(1.0, f_scale / np.maximum(np.abs(r), 1e-30))
        w = np.where(inside, w, 0.0)
        terms = np.stack([w, w * x, w * y, w * x * x, w * x * y, w * y * y,
                          w * v, w * v * x, w * v * y], 1)
        terms = terms.reshape(B, 9, nb, tfit.EPT, tfit.NT)
        thr = terms[..., 0, :]
        for k in range(1, tfit.EPT):
            thr = thr + terms[..., k, :]
        part = np.zeros((B, 9, ns * tfit.NT))
        part[..., :nb] = _block_sums(thr)
        part = part.reshape(B, 9, ns, tfit.NT)
        acc = part[..., 0, :]
        for s in range(1, ns):
            acc = acc + part[..., s, :]
        tot = _block_sums(acc)
        p = np.array([_solve3(tot[b]) for b in range(B)])
    return np.stack([p[:, 0], p[:, 1],
                     p[:, 2] - p[:, 0] * cx - p[:, 1] * cy], -1)


def _masked_planes():
    """The 64 x 96 masked case: two tilted planes with noise and a block
    of gross outliers, a shared mask with a hole and a ragged edge."""
    rng = np.random.default_rng(21)
    xx, yy = np.meshgrid(np.arange(64), np.arange(96), indexing="ij")
    planes = np.stack([0.02 * xx - 0.013 * yy + 4.0,
                       -0.031 * xx + 0.007 * yy - 1.5])
    planes = planes + 0.3 * rng.normal(size=planes.shape)
    planes[:, 10:20, 30:50] += 12.0
    mask = rng.uniform(size=(64, 96)) > 0.25
    mask[40:60, 5:25] = False
    return planes, mask


@pytest.mark.parametrize("case", ["48x40", "48x40 shared mask",
                                  "64x96 shared mask", "64x96 per image"])
def test_kernel_step_emulation_matches_twin(case):
    """The kernel's arithmetic in float64 reproduces the twin's float64
    fit within 1e-10 of the largest coefficient (the summation orders
    differ; the fit is the same)."""
    if case.startswith("48x40"):
        planes = _planes(np.float64)
        mask = (np.random.default_rng(9).uniform(size=planes.shape[1:]) > 0.3
                if "mask" in case else None)
    else:
        planes, mask = _masked_planes()
        if case.endswith("per image"):
            mask = np.stack([mask, mask[::-1]])
    got = _emulate(planes, mask)
    t = torch.from_numpy(planes)
    tm = None if mask is None else torch.from_numpy(mask)
    want = tfit.fit_plane_irls_plain(t, tm, 1.0, 60).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("shape,dtype,device,ok", [
    ((3, 4086, 4086), torch.float32, "cuda", True),
    ((48, 40), torch.float32, "cuda", True),
    ((65535, 4, 4), torch.float32, "cuda", True),
    ((3, 4086, 4086), torch.float64, "cuda", False),
    ((3, 4086, 4086), torch.float32, "cpu", False),
    ((46341, 46341), torch.float32, "cuda", False),
    ((65536, 4, 4), torch.float32, "cuda", False),
    ((0, 4, 4), torch.float32, "cuda", False)])
def test_fit_kernel_gate(shape, dtype, device, ok):
    """The route gate: CUDA float32 with n m < 2^31 and 1 ... 65535 planes
    takes the kernel; float64, the CPU and shapes past the limits the
    twin."""
    assert tfit.fit_kernel_ok(shape, dtype, torch.device(device)) is ok


def test_mathtools_routes_by_the_gate(monkeypatch):
    """core.mathtools' fits call the kernel wrapper where the gate holds
    (fit_plane with no mask, fit_plane_masked with its boolean mask on
    the image's device) and the twin otherwise."""
    calls = []

    def rec(image, mask, f_scale, iters):
        calls.append((mask, f_scale, iters))
        return torch.zeros(image.shape[:-2] + (3,), dtype=image.dtype)

    monkeypatch.setattr(tfit, "fit_plane_irls", rec)
    planes = torch.from_numpy(_planes(np.float32))
    mask = np.random.default_rng(9).uniform(size=planes.shape[1:]) > 0.3
    tmath.fit_plane(planes)
    assert calls == []                      # the CPU: the twin
    monkeypatch.setattr(tfit, "fit_kernel_ok", lambda *a: True)
    tmath.fit_plane(planes, iters=7, f_scale=0.5)
    tmath.fit_plane_masked(planes, mask=mask)
    tmath.fit_plane_masked(planes, mask=False)
    assert calls[0] == (None, 0.5, 7) and calls[2][0] is None
    m = calls[1][0]
    assert m.dtype == torch.bool and m.device == planes.device
    assert torch.equal(m, torch.from_numpy(mask))


def test_wrapper_on_the_cpu_is_the_twin():
    """On a CPU tensor the wrapper runs the twin, a missing mask as all
    pixels; another device type raises."""
    planes = torch.from_numpy(_planes(np.float32))
    full = torch.ones(planes.shape, dtype=torch.bool)
    assert torch.equal(tfit.fit_plane_irls(planes, None, 1.0, 60),
                       tfit.fit_plane_irls_plain(planes, full, 1.0, 60))
    with pytest.raises(ValueError, match="unsupported device"):
        tfit.fit_plane_irls(planes.to("meta"), None, 1.0, 60)


def test_mask_plane_layout():
    """A mask of one (n, m) plane (any leading ones) is read at plane
    stride 0; a mask with the image's planes, or one that broadcasts to
    them, at n m."""
    rng = np.random.default_rng(3)
    m = torch.from_numpy(rng.uniform(size=(3, 5, 7)) > 0.5)
    for shared in (m[0], m[:1]):
        planes, stride = tfit._mask_planes(shared, (3, 5, 7))
        assert stride == 0 and planes.dtype == torch.uint8
        assert torch.equal(planes, m[0].to(torch.uint8))
    planes, stride = tfit._mask_planes(m, (3, 5, 7))
    assert stride == 35 and torch.equal(planes, m.to(torch.uint8))
    planes, stride = tfit._mask_planes(m[:, :1], (3, 5, 7))
    assert stride == 35 and torch.equal(
        planes, m[:, :1].expand(3, 5, 7).to(torch.uint8))
