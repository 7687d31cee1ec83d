"""Launch every hand-written kernel entry once at small shapes
(counterpart of pygpa_tpu/ops/kernel_smoke.py).

The production routes choose the kernels by shape, dtype and device, so
a run that never meets one of those shapes cannot catch a broken
launch signature, grid or stride in it. ``run_kernel_smoke()`` drives
every entry through the production wrappers on small fixtures and
checks each output's shape and finiteness:

- the grouped sweep (``csrc/sweep.cu``): the uv, phase/weight and
  gradient emissions, unbanded and on the smallest fixture that bands
  its columns (Wb < W1);
- the zoom sweep (``csrc/zoom_sweep.cu``): plain, with gradients, the
  phase/weight emission and a stack of two images;
- the warps (``csrc/warp.cu``): bilinear, cubic (Catmull-Rom and
  B-spline) and the displacement form of the cubic, both boundary modes;
- the DCT passes (``csrc/dct.cu``): lane and sub, forward and inverse;
- the V-branch's presmooth and applyq (``csrc/vcycle.cu``);
- the CG (``csrc/cg.cu``) on its FFT route (128^2) and its dense route
  (384^2); the early-stopping CG (``csrc/cg_unwrap.cu``) on its FFT
  route (128 x 256, the exact path's unaligned weights) and at other
  sides (96 x 80, aligned);
- the drizzle and the unit-cell expand (``csrc/drizzle.cu``,
  ``csrc/expand.cu``), each on its shared-memory route (a small cell)
  and its other route (a cell past a block's shared memory);
- the plane fit's IRLS steps (``csrc/fit_plane.cu``), with no mask and
  with one mask shared by the planes.

Shapes respect each kernel's limits: the sweeps take n, m and the band
width in multiples of 64, the DCT an axis of 1024 or more, the CG sides
in multiples of 128, the early-stopping CG sides 2 ... 8192. On the card (device None or "cuda") every entry
must raise its launch counter in ops._build.launches, so a twin hidden
behind a kernel's name fails the smoke; on the CPU the wrappers run
their plain twins. The reference's refined-sweep branch is not ported
(its ``_REFINE`` was a TPU experiment), so it has no entry here.
"""
import collections

import numpy as np
import torch

from . import _build

# entry -> the launch counters it must raise on the card
ENTRIES = {
    # stage 2 of either sweep splits its column basis in a launch of its
    # own ("split_basis") before the tournament
    "grouped uv": ("sweep_uv", "split_basis"),
    "grouped phase/weight": ("sweep_pw",),
    "grouped gradients": ("sweep_grad", "grad_flags", "grad_stage1",
                          "grad_products"),
    "banded uv": ("sweep_uv",),
    "banded phase/weight": ("sweep_pw",),
    "banded gradients": ("sweep_grad", "grad_flags", "grad_stage1",
                         "grad_products"),
    "zoom plain": ("zoom_sweep", "split_basis"),
    "zoom gradients": ("zoom_grad", "grad_flags", "grad_stage1",
                       "grad_products"),
    "zoom phase/weight": ("zoom_sweep",),
    "zoom stack": ("zoom_sweep",),
    "warp bilinear nearest": ("warp_bilinear",),
    "warp bilinear constant": ("warp_bilinear",),
    "warp cubic nearest": ("warp_cubic",),
    "warp cubic constant": ("warp_cubic",),
    "warp cubic displacement nearest": ("warp_cubic",),
    "warp cubic displacement constant": ("warp_cubic",),
    "dct lane": ("dct_lane",),
    "idct lane": ("dct_lane",),
    "dct sub": ("dct_sub",),
    "idct sub": ("dct_sub",),
    "presmooth": ("presmooth",),
    "applyq": ("applyq",),
    "cg fft route": ("cg_poisson",),
    "cg dense route": ("cg_poisson",),
    "cg unwrap fft route": ("cg_unwrap",),
    "cg unwrap chirp-z route": ("cg_unwrap",),
    "cg unwrap other sides": ("cg_unwrap",),
    "drizzle shared": ("drizzle",),
    "drizzle global": ("drizzle",),
    "expand shared": ("expand",),
    "expand l1": ("expand",),
    "fit plane": ("fit_plane",),
    "fit plane masked": ("fit_plane",),
}


def _fixture(device, size=256, r_k=0.1, theta=7.0):
    from ..lattices import generate_ks, hexlattice_gen
    img = hexlattice_gen(r_k, theta, order=1, size=size).to(device)
    ks = np.asarray(generate_ks(r_k, theta), np.float32)[:3]
    return img - img.mean(), ks


def _wlists(ks, pts=4):
    """Small pts x pts candidate grids around each k (the pipeline's
    shape)."""
    kw = np.linalg.norm(ks, axis=1).mean() / 2.5
    offs = (np.arange(pts) - (pts - 1) / 2) * (2 * kw / pts)
    wx, wy = np.meshgrid(offs, offs, indexing="ij")
    grid = np.stack([wx.ravel(), wy.ravel()], -1)
    return [np.asarray(k)[None] + grid for k in ks]


def _check(name, *ts):
    for t in ts:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"kernel smoke [{name}]: non-finite output "
                                 f"(shape {tuple(t.shape)})")


def run_kernel_smoke(verbose=False, device=None):
    """Launch every kernel entry of ENTRIES once (module docstring) on
    `device` (None: the card); returns True, raising on a bad output or,
    on the card, on an entry whose kernel did not launch."""
    from ..core import entry_device
    from . import cg, dct, drizzle, expand, fit, vcycle, warp, wfr
    from ..ucell.averaging import calc_ucell_parameters

    dev = entry_device(device)

    def entry(name, fn):
        """Run one entry: finite outputs and, on the card, every counter
        of ENTRIES[name] risen."""
        before = collections.Counter(_build.launches)
        outs = fn()
        _check(name, *(outs if isinstance(outs, (tuple, list)) else (outs,)))
        idle = [c for c in ENTRIES[name] if _build.launches[c] <= before[c]]
        if dev.type == "cuda" and idle:
            raise AssertionError(f"kernel smoke [{name}]: no launch of "
                                 f"{idle} (a twin ran in its place)")
        if verbose:
            print(f"  kernel-smoke: {name} ok", flush=True)

    def sigma_of(kk):
        return int(np.ceil(1 / np.linalg.norm(kk, axis=1).min()))

    img, ks = _fixture(dev)
    wlists = _wlists(ks)
    sigma = sigma_of(ks)
    dr = 2

    # --- the grouped sweep, unbanded at 256^2 ---
    def uv(im, wl, kk, gc=None):
        out = wfr.wfr_sweep_uv_multi(im, wl, sigma_of(kk), dr, kk,
                                     gauss_cut=gc)
        if out is None:
            raise AssertionError("kernel smoke: the grouped uv route does "
                                 "not apply to its fixture")
        return out

    entry("grouped uv", lambda: uv(img, wlists, ks))
    entry("grouped phase/weight", lambda: wfr.wfr_sweep_phase_weight_multi(
        img, wlists, sigma, dr))
    entry("grouped gradients", lambda: wfr.wfr_sweep_phase_weight_multi(
        img, wlists, sigma, dr, with_grad=True, krefs=ks))

    # --- the banded grouped sweep: the smallest fixture whose plan bands
    # the columns (a 128-row strip of a 512^2 lattice, tighter windows)
    imgb, ksb = _fixture(dev, size=512, r_k=0.12, theta=5.0)
    imgb = imgb[:128].contiguous()
    wlb = _wlists(ksb)
    gcb = 10.0
    plan = wfr.plan_sweep(imgb.shape, wlb, sigma_of(ksb), dr, ksb,
                          gauss_cut=gcb)
    if plan is None or plan.col_groups is None or \
            plan.col_groups[0] >= plan.idx1s.shape[1]:
        raise AssertionError("kernel smoke: the banded fixture no longer "
                             "bands its columns")
    entry("banded uv", lambda: uv(imgb, wlb, ksb, gcb))
    entry("banded phase/weight", lambda: wfr.wfr_sweep_phase_weight_multi(
        imgb, wlb, sigma_of(ksb), dr, gauss_cut=gcb))
    entry("banded gradients", lambda: wfr.wfr_sweep_phase_weight_multi(
        imgb, wlb, sigma_of(ksb), dr, with_grad=True, krefs=ksb,
        gauss_cut=gcb))

    # --- the zoom sweep ---
    def zoom(im, **kw):
        g = wfr.wfr_sweep(im, wlists[0], ks[0], sigma, **kw)
        return [g["lockin"].abs()] + [g[k] for k in ("w", "grad") if k in g]

    entry("zoom plain", lambda: zoom(img))
    entry("zoom gradients", lambda: zoom(img, with_grad=True))
    entry("zoom phase/weight", lambda: wfr.wfr_sweep_phase_weight(
        img, wlists[0], ks[0], sigma, dr))
    entry("zoom stack", lambda: zoom(torch.stack([img, img.flip(0)])))

    # --- the warps, both boundary modes ---
    yy, xx = torch.meshgrid(torch.arange(64.0, device=dev),
                            torch.arange(64.0, device=dev), indexing="ij")
    cy = yy + 1.3 * torch.sin(xx / 9)
    cx = xx + 0.7 * torch.cos(yy / 7)
    src = img[:64, :64].contiguous()
    coef = torch.stack([src, src.T.contiguous()], -1).contiguous()
    u = torch.stack([cy - yy, cx - xx])
    for mode in ("nearest", "constant"):
        entry(f"warp bilinear {mode}",
              lambda: warp.warp_bilinear(src, cy, cx, mode=mode))
        entry(f"warp cubic {mode}",
              lambda: [warp.warp_cubic(src, cy, cx, mode=mode, cubic=c)
                       for c in ("catmull", "bspline")])
        entry(f"warp cubic displacement {mode}",
              lambda: warp.warp_cubic_disp(coef, u, mode=mode))

    # --- the DCT passes (forward and inverse, each axis) ---
    g = torch.Generator().manual_seed(0)
    x = torch.randn((8, 1024), generator=g).to(dev)
    xs = x.T.contiguous()
    if not dct.supported(1024):
        raise AssertionError("kernel smoke: the DCT refuses 1024")
    y = {}
    entry("dct lane", lambda: y.setdefault("lane", dct.dct_lane(x)))
    entry("idct lane", lambda: _close("idct lane",
                                      dct.idct_lane(y["lane"]), x))
    entry("dct sub", lambda: y.setdefault("sub", dct.dct_sub(xs)))
    entry("idct sub", lambda: _close("idct sub", dct.idct_sub(y["sub"]),
                                     xs))

    # --- the V-branch stencils ---
    nv = 128
    if not vcycle.supported(nv, nv, 4):
        raise AssertionError("kernel smoke: presmooth refuses 128^2")
    phi = torch.randn((nv, nv), generator=g).to(dev)
    wv = (0.1 + torch.rand((nv, nv), generator=g)).to(dev)
    dxs = torch.randn((nv, nv), generator=g).to(dev)

    def presmooth():
        out = vcycle.presmooth(phi, dxs, dxs, wv, 4, 0.8)
        if tuple(out[3].shape) != (nv // 4, nv):
            raise AssertionError("kernel smoke [presmooth]: rrow shape "
                                 f"{tuple(out[3].shape)}")
        return out

    entry("presmooth", presmooth)
    entry("applyq", lambda: vcycle.applyq(phi, wv))

    # --- the CG, both routes ---
    for label, side in (("cg fft route", 128), ("cg dense route", 384)):
        if cg.fft_route(side, side) != (label == "cg fft route"):
            raise AssertionError(f"kernel smoke [{label}]: {side}^2 takes "
                                 "the other route")
        rk = torch.randn((side, side), generator=g).to(dev)
        ww = (0.1 + torch.rand((side, side), generator=g)).to(dev) ** 2
        entry(label, lambda: cg.cg_poisson(rk, ww, ww, 3))

    # --- the early-stopping CG: its own passes (Stockham; chirp-z on
    # both axes) and the other sides ---
    for label, (n, m), aligned in (("cg unwrap fft route", (128, 256), False),
                                   ("cg unwrap chirp-z route", (250, 130),
                                    True),
                                   ("cg unwrap other sides", (96, 80), True)):
        if cg.unwrap_fft_route(n, m) != (label != "cg unwrap other sides"):
            raise AssertionError(f"kernel smoke [{label}]: {n} x {m} takes "
                                 "the other route")
        rk = torch.randn((2, n, m), generator=g)
        rk = (rk - rk.mean((-2, -1), keepdim=True)).to(dev)
        ww = (0.1 + torch.rand((n, m), generator=g)).to(dev) ** 2
        wx, wy = (ww, ww) if aligned else (ww[:, 1:], ww[1:])
        entry(label, lambda: cg.cg_unwrap(rk, wx, wy, 3, aligned)[0])

    # --- the drizzle and the expand, each on both routes ---
    ks2 = np.asarray(ks[:2], np.float64)
    for z, route in ((1, "shared"), (25, "global")):
        rmin, rsize = calc_ucell_parameters(ks2, z)
        if drizzle.shared_route(rsize) != (route == "shared"):
            raise AssertionError(f"kernel smoke: a z={z} cell {rsize} takes "
                                 "the other drizzle route")
        acc = []
        entry(f"drizzle {route}", lambda: acc.extend(
            drizzle.drizzle(src, ks2, rmin, rsize, z)) or acc)
        s, w = acc
        cell = torch.where(w > 0, s / torch.clamp(w, min=1e-9),
                           torch.zeros((), device=dev))
        # the bspline cell gains a 2-bin reflect pad a side
        shared = expand.shared_route((rsize[0] + 4, rsize[1] + 4))
        label = "expand shared" if shared else "expand l1"
        if shared != (route == "shared"):
            raise AssertionError(f"kernel smoke: a z={z} cell {rsize} takes "
                                 "the other expand route")
        entry(label, lambda: expand.expand_cell(cell, ks2, rmin, z, 1, None,
                                                src.shape))

    # --- the plane fit, unmasked and with a shared mask ---
    xf = torch.arange(48.0)[:, None] * 0.3 - torch.arange(40.0) * 0.7
    planes = (xf + torch.randn((2, 48, 40), generator=g)).to(dev)
    fmask = (torch.rand((48, 40), generator=g) > 0.3).to(dev)
    entry("fit plane", lambda: fit.fit_plane_irls(planes, None, 1.0, 5))
    entry("fit plane masked",
          lambda: fit.fit_plane_irls(planes, fmask, 1.0, 5))
    return True


def _close(name, got, want):
    """got, after a check that it inverts its forward pass."""
    err = float((got - want).abs().max())
    if not err < 1e-3:
        raise AssertionError(f"kernel smoke [{name}]: round trip error "
                             f"{err}")
    return got
