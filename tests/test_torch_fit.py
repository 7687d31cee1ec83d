"""The robust plane fit's kernel route (ops.fit, csrc/fit_plane.cu) on
the CPU: the kernel's step emulated in float64 numpy (its grid of G
blocks a plane over tiles, the head and tail off the 16-byte grid, its
block partials in the kernel's fixed order, the nine normal-equation
sums, the float64 3x3 solve with partial pivoting and the final offset
shift) against the plain twin fit_plane_irls_plain in float64; the route gate's truth table;
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


def _owners(nm, start, G):
    """csrc/fit_plane.cu's split of a plane of nm pixels that starts
    `start` floats past the 16-byte grid among its G blocks: (block of
    each pixel, its thread, its tile of that block). The vector part
    (float4s from pixel h, the first on the grid) in tiles of NT LPT
    float4s, block g taking tiles g, g + G, ..., thread t float4s t, t +
    NT, ... of a tile; the head (e < h) and the tail past the last whole
    float4 are block 0's first tile (tile -1 here), a pixel a thread."""
    h = (-start) % 4
    nv = (nm - h) // 4 if nm > h else 0
    e = np.arange(nm)
    f = (e - h) // 4
    vec = (e >= h) & (f < nv)
    tile = np.where(vec, f // (tfit.NT * tfit.LPT), -1)
    block = np.where(vec, tile % G, 0)
    edge = np.cumsum(~vec) - 1
    thread = np.where(vec, f % tfit.NT, edge)
    return block, thread, np.where(vec, tile // G, -1)


def _emulate(img, mask, G, start=0, f_scale=1.0, iters=60):
    """The kernel's fit of img (B, n, m) in float64 on a grid of G blocks a
    plane, plane b starting start + b n m floats past the 16-byte grid:
    iters + 1 launches; in each, every pixel goes to the float32 sum of
    its (block, thread, tile) (_owners), each thread adds its tiles in
    order, the block adds its threads (_block_sums), and the plane's last
    block adds the G partials, thread t those of blocks t, t + NT, ...,
    then the threads, and solves. mask: None, one (n, m) plane for all or
    (B, n, m)."""
    B, n, m = img.shape
    nm = n * m
    v = img.reshape(B, nm)
    inside = np.ones((B, nm), bool) if mask is None else np.broadcast_to(
        mask, img.shape).reshape(B, nm)
    e = np.arange(nm)
    cx, cy = (n - 1) / 2, (m - 1) / 2
    x, y = e // m - cx, e % m - cy
    owners = [_owners(nm, start + b * nm, G) for b in range(B)]
    for blk, _, _ in owners:        # every pixel once, the tail a thread each
        assert blk.shape == (nm,) and blk.min() >= 0 and blk.max() < G
    ns = -(-G // tfit.NT)
    p = np.zeros((B, 3))
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
        tot = np.empty((B, 9))
        for b, (blk, thr, til) in enumerate(owners):
            ntile = til.max() + 2
            # (tile + 1, block, thread) float32 sums
            key = ((til + 1) * G + blk) * tfit.NT + thr
            sums = np.stack([np.bincount(key, terms[b, k],
                                         ntile * G * tfit.NT)
                             for k in range(9)])
            sums = sums.reshape(9, ntile, G, tfit.NT)
            thr_sum = sums[:, 0]
            for t in range(1, ntile):
                thr_sum = thr_sum + sums[:, t]
            part = np.zeros((9, ns * tfit.NT))
            part[:, :G] = _block_sums(thr_sum)
            part = part.reshape(9, ns, tfit.NT)
            acc = part[:, 0]
            for s in range(1, ns):
                acc = acc + part[:, s]
            tot[b] = _block_sums(acc)
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


def _ragged_planes():
    """Three 37 x 41 planes (n m = 1517, not a multiple of 4, so planes 1
    and 2 start off the 16-byte grid) with noise and outliers, and a mask
    a plane."""
    rng = np.random.default_rng(37)
    xx, yy = np.meshgrid(np.arange(37), np.arange(41), indexing="ij")
    planes = np.stack([a * xx + b * yy + c for a, b, c in
                       ((0.03, -0.01, 2.0), (-0.02, 0.04, -6.0),
                        (0.005, 0.011, 9.5))])
    planes = planes + 0.2 * rng.normal(size=planes.shape)
    planes[:, 5:9, 20:30] -= 15.0
    return planes, rng.uniform(size=planes.shape) > 0.2


@pytest.mark.parametrize("case", ["48x40", "48x40 shared mask",
                                  "64x96 shared mask", "64x96 per image",
                                  "48x40 one block", "37x41",
                                  "37x41 per image", "37x41 from 3",
                                  "37x41 per image from 1",
                                  "37x41 from 3 one block"])
def test_kernel_step_emulation_matches_twin(case):
    """The kernel's arithmetic in float64 (its grid of G blocks a plane,
    3 or "one block", the head, vector part and tail of each plane)
    reproduces the twin's float64 fit within 1e-10 of the largest
    coefficient (the summation orders differ; the fit is the same);
    "from s": the stack starts s floats past the 16-byte grid."""
    G = 1 if "one block" in case else 3
    start = int(case.split("from ")[1].split()[0]) if "from" in case else 0
    if case.startswith("48x40"):
        planes = _planes(np.float64)
        mask = (np.random.default_rng(9).uniform(size=planes.shape[1:]) > 0.3
                if "mask" in case else None)
    elif case.startswith("37x41"):
        planes, mask = _ragged_planes()
        mask = mask if "per image" in case else None
    else:
        planes, mask = _masked_planes()
        if case.endswith("per image"):
            mask = np.stack([mask, mask[::-1]])
    got = _emulate(planes, mask, G, start)
    t = torch.from_numpy(planes)
    tm = None if mask is None else torch.from_numpy(mask)
    want = tfit.fit_plane_irls_plain(t, tm, 1.0, 60).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("nm,start,G", [(1517, 0, 1), (1517, 1, 1),
                                        (1517, 3, 2), (1001 * 999, 2, 37),
                                        (3, 1, 1), (5, 0, 1)])
def test_kernel_split_covers_each_pixel_once(nm, start, G):
    """_owners: each pixel in exactly one slot (block, thread, tile, load,
    lane),
    whole float4s on the grid in the vector part, at most 3 head and 3
    tail pixels (block 0's first tile, a thread each), and the tiles of
    block g those congruent to g mod G."""
    blk, thr, til = _owners(nm, start, G)
    h = (-start) % 4
    edge = til < 0
    assert edge.sum() <= 6 and (blk[edge] == 0).all()
    assert sorted(thr[edge]) == list(range(int(edge.sum())))
    e = np.flatnonzero(~edge)
    assert ((start + e[::4]) % 4 == 0).all() and e.size % 4 == 0
    if nm > h + 3:
        assert (e[0] == h) and edge[:h].all()
    # (block, thread, tile, load of the tile, lane of the float4)
    f = (np.arange(nm) - h) // 4
    key = np.stack([blk, thr, til, f // tfit.NT % tfit.LPT,
                    (np.arange(nm) - h) % 4])[:, ~edge]
    assert np.unique(key, axis=1).shape[1] == e.size
    assert (blk[~edge] == (f[~edge] // (tfit.NT * tfit.LPT)) % G).all()


def test_fit_grid():
    """G: three blocks an SM of the card over the planes, at most one a
    tile of 4096 pixels, at least one."""
    assert tfit.fit_grid(3, 4086, 4086, 132) == 132
    assert tfit.fit_grid(1, 4086, 4086, 132) == 396
    assert tfit.fit_grid(2, 64, 64, 132) == 1
    assert tfit.fit_grid(2, 100, 100, 132) == 3
    assert tfit.fit_grid(5000, 4086, 4086, 132) == 1


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
