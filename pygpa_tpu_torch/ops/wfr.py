"""Windowed-Fourier-ridge sweep planning and the grouped uv sweep
(counterpart of a subset of pygpa_tpu/ops/wfr.py).

The sweep evaluates, for every Bragg peak g and candidate reference
vector w, the full-resolution demodulated lock-in

    M_w(r) = sum_q F(q) G_sigma(q + w) e^{2 pi i q.r} / (n m)

restricted to the small spectrum window (W0, W1) the Gaussian bandpass
leaves non-zero, as two skinny inverse-DFT products (ops/sweep.py). The
host planners here are numpy copies of the reference's, so both
packages plan the same sweep. Only the production route is ported: all
peaks in one grouped launch with equal window shapes, P <= 48
candidates, sides multiples of 128 and float32. Anything else raises
NotImplementedError (ROADMAP queue 1: the per-peak sweep route).
"""
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import sweep as _sweep

_NOT_PORTED = ("only the grouped single-launch sweep is ported "
               "(float32, sides multiples of 128, equal window shapes and "
               "candidate counts, P <= 48, dr >= 1); the per-peak sweep "
               "route is ROADMAP queue 1 work")


def _zoom_window(n, center_bin, half_need):
    """Window bin indices (mod n) around center_bin: int32 (W,)."""
    W = int(half_need) * 2
    idx = (center_bin - W // 2 + np.arange(W)) % n
    return idx.astype(np.int32)


# -ln(G) at the zoom-window edge (G ~ 3e-10, below float32 resolution)
_GAUSS_CUT = 22.0


def _plan_zoom(shape, wlist, sigma, *, pad_bins=6, gauss_cut=None,
               lane=64, min_half=(0, 0)):
    """Band-limited (zoom) window of one peak's candidate bank: the
    (idx0, idx1) bin vectors all candidate passbands live in, or None
    when the window would span most of the spectrum."""
    n, m = shape
    if gauss_cut is None:
        gauss_cut = _GAUSS_CUT
    f_band = np.sqrt(gauss_cut / 2.0) / (np.pi * sigma)
    w = np.asarray(wlist, np.float64)
    c0 = int(np.round(-np.mean(w[:, 0]) * n))
    c1 = int(np.round(-np.mean(w[:, 1]) * m))
    ext0 = np.max(np.abs(-w[:, 0] * n - c0)) if len(w) else 0.0
    ext1 = np.max(np.abs(-w[:, 1] * m - c1)) if len(w) else 0.0
    need0 = int(np.ceil(f_band * n + ext0)) + pad_bins
    need1 = int(np.ceil(f_band * m + ext1)) + pad_bins
    # round the half-width up so W = 2*half is a multiple of `lane`
    half0 = -(-need0 // (lane // 2)) * (lane // 2)
    half1 = -(-need1 // (lane // 2)) * (lane // 2)
    # widening a window is exact (extra bins carry ~zero weight)
    half0 = max(half0, int(min_half[0]))
    half1 = max(half1, int(min_half[1]))
    if 2 * half0 > 0.7 * n or 2 * half1 > 0.7 * m:
        return None
    return _zoom_window(n, c0, half0), _zoom_window(m, c1, half1)


def _plan_zoom_multi(shape, wlists, sigma, gauss_cut=None):
    """Per-peak zoom plans with unified window shapes (re-planned at
    the largest half-widths when the peaks' passbands round apart)."""
    plans = [_plan_zoom(shape, np.asarray(w), float(sigma),
                        gauss_cut=gauss_cut)
             for w in wlists]
    if (all(p is not None for p in plans)
            and len({(p[0].shape[0], p[1].shape[0])
                     for p in plans}) > 1):
        h0 = max(p[0].shape[0] for p in plans) // 2
        h1 = max(p[1].shape[0] for p in plans) // 2
        plans = [_plan_zoom(shape, np.asarray(w), float(sigma),
                            gauss_cut=gauss_cut, min_half=(h0, h1))
                 for w in wlists]
    return plans


def _plan_col_groups(wlists, plans, m, sigma, *, pad_bins=6,
                     gauss_cut=None, lane=64):
    """Banded sweep plan: candidates whose wy passbands share a Wb-wide
    column sub-band of the zoom window form runs (wy-sorted). Returns
    (orders, col_groups, Wb) with col_groups[g] = ((count, off), ...)
    (equal run counts across groups), or None when banding is not
    worthwhile or the window crosses the Nyquist index."""
    if gauss_cut is None:
        gauss_cut = _GAUSS_CUT
    W1 = plans[0][1].shape[0]
    need1 = np.sqrt(gauss_cut / 2.0) / (np.pi * sigma) * m + pad_bins
    Wb = int(-(-int(np.ceil(2 * need1)) // lane) * lane)
    if Wb > W1 - lane:
        return None

    def _off_range(lo, hi):
        """Valid integer band offsets covering [lo, hi] (or empty)."""
        return (max(0, int(np.ceil(hi - Wb))),
                min(W1 - Wb, int(np.floor(lo))))

    orders, groups = [], []
    for w, plan in zip(wlists, plans):
        idx1 = np.asarray(plan[1])
        if (m // 2 - int(idx1[0])) % m < W1:
            return None
        w = np.asarray(w, np.float64)
        pf = (-w[:, 1] * m - float(idx1[0])) % m
        if np.any(pf >= W1):
            return None
        order = np.argsort(pf, kind="stable")
        runs = []
        i = 0
        while i < len(order):
            lo = pf[order[i]] - need1
            hi = pf[order[i]] + need1
            j = i
            while j + 1 < len(order):
                nhi = pf[order[j + 1]] + need1
                o_lo, o_hi = _off_range(lo, nhi)
                if o_lo > o_hi:
                    break
                hi = nhi
                j += 1
            o_lo, o_hi = _off_range(lo, hi)
            if o_lo > o_hi:
                return None
            runs.append([j - i + 1, o_lo])
            i = j + 1
        orders.append(order)
        groups.append(runs)
    # equal run counts: split the largest runs of shorter groups
    H = max(len(r) for r in groups)
    for runs in groups:
        while len(runs) < H:
            k = int(np.argmax([c for c, _ in runs]))
            if runs[k][0] < 2:
                return None
            c, off = runs[k]
            runs[k] = [c - c // 2, off]
            runs.insert(k + 1, [c // 2, off])
    col_groups = tuple(tuple((int(c), int(o)) for c, o in runs)
                       for runs in groups)
    return [np.asarray(o) for o in orders], col_groups, Wb


def _zoom_basis(n, idx, dtype=torch.float32, device=None):
    """cos/sin of the inverse-DFT submatrix e^{2 pi i r idx / n}, (n, W);
    the product r*idx is reduced mod n in exact integers first."""
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=device)
    r = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    ang = ((r * idx[None, :]) % n).to(dtype) * (2 * math.pi / n)
    return torch.cos(ang), torch.sin(ang)


def _dft_windows(image, A0c_flat, A0s_flat, A1c, A1s):
    """Forward-DFT spectrum windows of a real image as skinny DFT
    products (no full-size FFT): A0*_flat are the (n, G*W0) row bases,
    A1c/A1s the (G, m, W1) column bases. Returns raw (unnormalized)
    (Sr, Si), each (G, W0, W1)."""
    G, m, _ = A1c.shape
    W0 = A0c_flat.shape[1] // G
    Ur = (A0c_flat.T @ image).reshape(G, W0, m)
    Ui = (-(A0s_flat.T @ image)).reshape(G, W0, m)
    Sr = Ur @ A1c + Ui @ A1s
    Si = Ui @ A1c - Ur @ A1s
    return Sr, Si


@dataclass(frozen=True)
class SweepPlan:
    """Host plan of the grouped uv sweep, the same numbers the reference
    derives: wl (G, P, 2) candidate banks (wy-sorted when banded), idx0s
    (G, W0) / idx1s (G, W1) window bins, col_groups (Wb, runs) or None,
    uv_ks the G nominal (k_row, k_col) pairs."""
    shape: tuple
    sigma: float
    dr: int
    wl: np.ndarray
    idx0s: np.ndarray
    idx1s: np.ndarray
    col_groups: object
    uv_ks: tuple


def plan_sweep(shape, wlists, sigma, dr, krefs, gauss_cut=None,
               dtype=torch.float32):
    """Plan the grouped banded uv sweep exactly as
    pygpa_tpu.ops.wfr.wfr_sweep_phase_weight_multi(_uv=True) does;
    raises NotImplementedError where the reference would leave the
    grouped route."""
    shape = tuple(int(s) for s in shape)
    plans = _plan_zoom_multi(shape, wlists, float(sigma),
                             gauss_cut=gauss_cut)
    ok = (all(p is not None for p in plans)
          and dtype == torch.float32
          and shape[0] % 128 == 0 and shape[1] % 128 == 0
          and len({(p[0].shape[0], p[1].shape[0]) for p in plans}) == 1
          and len({np.asarray(w).shape[0] for w in wlists}) == 1
          and np.asarray(wlists[0]).shape[0] <= 48
          and int(dr) >= 1)
    if not ok:
        raise NotImplementedError(_NOT_PORTED)
    wls = [np.asarray(w, np.float64) for w in wlists]
    col_groups = None
    cg = _plan_col_groups(wls, plans, shape[1], float(sigma),
                          gauss_cut=gauss_cut)
    if cg is not None:
        orders, groups, Wb = cg
        wls = [w[o] for w, o in zip(wls, orders)]
        col_groups = (int(Wb), groups)
    return SweepPlan(
        shape=shape, sigma=float(sigma), dr=int(dr), wl=np.stack(wls),
        idx0s=np.stack([p[0] for p in plans]),
        idx1s=np.stack([p[1] for p in plans]),
        col_groups=col_groups,
        uv_ks=tuple((float(k[0]), float(k[1]))
                    for k in np.asarray(krefs, np.float64)))


class UVSweep:
    """A planned grouped uv sweep with its image-independent operands
    (DFT bases, Gaussian factors, band slices) built once on `device`.
    Calling it on a mean-subtracted float32 image returns (dudx_s
    (2, n, m), dudy_s (2, n, m), wnorm (n, m)), the shifted per-pixel
    weighted-lstsq displacement gradients and weight norm that
    gpa.reconstruct.reconstruct_u_inv_from_uv integrates."""

    def __init__(self, plan, device=None):
        self.plan = plan
        dt = torch.float32
        n, m = plan.shape
        G, P, _ = plan.wl.shape
        W0 = plan.idx0s.shape[1]
        W1 = plan.idx1s.shape[1]
        A0c, A0s = _zoom_basis(n, plan.idx0s.reshape(-1), dt, device)
        self.A0c_flat, self.A0s_flat = A0c, A0s            # (n, G*W0)
        A1 = [_zoom_basis(m, i, dt, device) for i in plan.idx1s]
        self.A1c = torch.stack([a[0] for a in A1])          # (G, m, W1)
        self.A1s = torch.stack([a[1] for a in A1])
        self.A0c = A0c.reshape(n, G, W0).permute(1, 0, 2).contiguous()
        self.A0s = A0s.reshape(n, G, W0).permute(1, 0, 2).contiguous()
        idx0 = torch.as_tensor(plan.idx0s.astype(np.int64), device=device)
        idx1 = torch.as_tensor(plan.idx1s.astype(np.int64), device=device)
        f0 = torch.where(idx0 < n // 2 + n % 2, idx0, idx0 - n).to(dt) / n
        f1 = torch.where(idx1 < m // 2 + m % 2, idx1, idx1 - m).to(dt) / m
        s2 = torch.tensor(2.0 * np.pi ** 2 * plan.sigma ** 2, dtype=dt,
                          device=device)
        wr = torch.as_tensor(plan.wl, device=device).to(dt)
        gxs = torch.exp(-s2 * (f0[:, None, :] + wr[:, :, 0:1]) ** 2)
        gys = torch.exp(-s2 * (f1[:, None, :] + wr[:, :, 1:2]) ** 2)
        if plan.col_groups is not None:
            Wb, runs = plan.col_groups
            Wb = int(Wb)
            if len(runs) != G or any(sum(c for c, _ in r) != P
                                     for r in runs):
                raise ValueError("col_groups runs do not partition the "
                                 "candidate banks")
            self.runs = tuple(tuple(r) for r in runs)
            gyb, run_of, off_of = [], [], []
            for g in range(G):
                b0, parts = 0, []
                for h, (cnt, off) in enumerate(runs[g]):
                    parts.append(gys[g, b0:b0 + cnt, off:off + Wb])
                    run_of += [h] * cnt
                    off_of += [off] * cnt
                    b0 += cnt
                gyb.append(torch.cat(parts, dim=0))
            self.gy = torch.stack(gyb).contiguous()
            self.banded = True
        else:
            Wb = W1
            self.runs = tuple(((P, 0),) for _ in range(G))
            self.gy = gys.contiguous()
            run_of = [0] * (G * P)
            off_of = [0] * (G * P)
            self.banded = False
        self.Wb = Wb
        self.gx = gxs.contiguous()
        self.run = torch.tensor(run_of, dtype=torch.int32,
                                device=device).reshape(G, P)
        self.off = torch.tensor(off_of, dtype=torch.int32,
                                device=device).reshape(G, P)
        self.A1cT = self.A1c[:, :, :Wb].transpose(1, 2).contiguous()
        self.A1sT = self.A1s[:, :, :Wb].transpose(1, 2).contiguous()
        kc = []
        for k0, k1 in plan.uv_ks:
            t0, t1 = 2 * np.pi * k0, 2 * np.pi * k1
            kc.append([t0, t1, t0 * t0, t0 * t1, t1 * t1])
        self.kconst = torch.tensor(kc, dtype=torch.float64,
                                   device=device).to(dt)
        self.scale = torch.tensor(1.0 / (n * m), dtype=dt, device=device)

    def windows(self, img0):
        """Band-sliced, normalized spectrum windows (G, H, W0, Wb)."""
        Sr, Si = _dft_windows(img0, self.A0c_flat, self.A0s_flat,
                              self.A1c, self.A1s)
        Sr = Sr * self.scale
        Si = Si * self.scale
        Wb = self.Wb
        Sr4 = torch.stack([torch.stack([Sr[g, :, off:off + Wb]
                                        for _, off in rg])
                           for g, rg in enumerate(self.runs)])
        Si4 = torch.stack([torch.stack([Si[g, :, off:off + Wb]
                                        for _, off in rg])
                           for g, rg in enumerate(self.runs)])
        return Sr4.contiguous(), Si4.contiguous()

    def __call__(self, img0):
        if tuple(img0.shape) != self.plan.shape \
                or img0.dtype != torch.float32:
            raise ValueError(f"UVSweep planned for float32 {self.plan.shape}"
                             f", got {img0.dtype} {tuple(img0.shape)}")
        Sr4, Si4 = self.windows(img0)
        return _sweep.sweep_uv(Sr4, Si4, self.gx, self.gy, self.A0c,
                               self.A0s, self.A1cT, self.A1sT, self.run,
                               self.off, self.kconst, self.plan.dr,
                               self.banded)


def wfr_sweep_uv_multi(image, wlists, sigma, dr, krefs, *, gauss_cut=None):
    """Fused sweep + reconstruction prologue for all Bragg peaks: returns
    (dudx_s (2, N, M), dudy_s (2, N, M), wnorm (N, M)) for a
    mean-subtracted float32 image (pygpa_tpu.ops.wfr.wfr_sweep_uv_multi
    on its grouped route)."""
    plan = plan_sweep(image.shape, wlists, sigma, dr, krefs,
                      gauss_cut=gauss_cut, dtype=image.dtype)
    return UVSweep(plan, device=image.device)(image)
