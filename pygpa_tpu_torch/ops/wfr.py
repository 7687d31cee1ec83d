"""Windowed-Fourier-ridge sweeps (counterpart of pygpa_tpu/ops/wfr.py
without the gradient and continuity variants).

A sweep evaluates, for a Bragg peak and every candidate reference
vector w of its bank, the full-resolution demodulated lock-in

    M_w(r) = sum_q F(q) G_sigma(q + w) e^{2 pi i q.r} / (n m)

and keeps, per pixel, the candidate of largest |M_w|^2. The host
planners here are numpy copies of the reference's, so both packages
plan the same sweep. Routes, chosen as the reference chooses them:

- the grouped uv sweep (``wfr_sweep_uv_multi``, ``UVSweep``): all peaks
  in one launch of ops.sweep, from spectrum windows taken by skinny DFT
  products; float32, sides multiples of 128, equal window shapes and
  candidate counts, P <= 48;
- the per-peak zoom sweep (``_wfr_sweep_zoom``): the Gaussian bandpass
  confines every candidate to a small window of the full spectrum, and
  ops.zoom_sweep evaluates the window as two DFT products (the CUDA
  kernel for float32 with sides multiples of 128, its plain twin
  otherwise, as the reference's fused/XLA split);
- the full-FFT sweep (``_wfr_sweep_chunked``), one inverse FFT per
  candidate, where no zoom window pays off.
"""
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import sweep as _sweep
from . import zoom_sweep as _zoom
from ..core.fourier import _fftfreq

_NOT_PORTED_GRAD = ("is not ported: the winner phase-gradient and "
                    "k-continuity sweeps are ROADMAP queue 1 item 7")


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


def _grouped_plans(shape, wlists, sigma, dr, gauss_cut, dtype):
    """The per-peak zoom plans when the reference's grouped-sweep gate
    holds (float32, sides multiples of 128, equal window shapes and
    candidate counts, P <= 48, dr >= 1), else None."""
    plans = _plan_zoom_multi(shape, wlists, float(sigma),
                             gauss_cut=gauss_cut)
    ok = (all(p is not None for p in plans)
          and dtype == torch.float32
          and shape[0] % 128 == 0 and shape[1] % 128 == 0
          and len({(p[0].shape[0], p[1].shape[0]) for p in plans}) == 1
          and len({np.asarray(w).shape[0] for w in wlists}) == 1
          and np.asarray(wlists[0]).shape[0] <= 48
          and int(dr) >= 1)
    return plans if ok else None


def plan_sweep(shape, wlists, sigma, dr, krefs, gauss_cut=None,
               dtype=torch.float32):
    """Plan the grouped banded uv sweep exactly as
    pygpa_tpu.ops.wfr.wfr_sweep_phase_weight_multi(_uv=True) does;
    None where the reference leaves the grouped route (the per-peak
    route then runs)."""
    shape = tuple(int(s) for s in shape)
    plans = _grouped_plans(shape, wlists, sigma, dr, gauss_cut, dtype)
    if plans is None:
        return None
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
        self.A1cb = self.A1c[:, :, :Wb].contiguous()        # (G, m, Wb)
        self.A1sb = self.A1s[:, :, :Wb].contiguous()
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
                               self.A0s, self.A1cb, self.A1sb, self.run,
                               self.off, self.kconst, self.plan.dr,
                               self.banded)


def wfr_sweep_uv_multi(image, wlists, sigma, dr, krefs, *, gauss_cut=None):
    """Fused sweep + reconstruction prologue for all Bragg peaks: returns
    (dudx_s (2, N, M), dudy_s (2, N, M), wnorm (N, M)) for a
    mean-subtracted float32 image (pygpa_tpu.ops.wfr.wfr_sweep_uv_multi
    on its grouped route), or None where the grouped route does not
    apply."""
    plan = plan_sweep(image.shape, wlists, sigma, dr, krefs,
                      gauss_cut=gauss_cut, dtype=image.dtype)
    if plan is None:
        return None
    return UVSweep(plan, device=image.device)(image)


def _real_dtype(spectrum):
    return torch.empty((), dtype=spectrum.dtype).real.dtype


def _zoom_operands(spectrum, wlist, idx0, idx1, sigma):
    """The zoom sweep's operands, as the reference builds them: the
    (W0, W1) spectrum window pre-scaled by 1/(n m), the Gaussian factors
    gx (P, W0), gy (P, W1) and the DFT bases A0c/A0s (n, W0), A1c/A1s
    (m, W1)."""
    n, m = spectrum.shape
    rdt = _real_dtype(spectrum)
    dev = spectrum.device
    i0 = torch.as_tensor(np.asarray(idx0, np.int64), device=dev)
    i1 = torch.as_tensor(np.asarray(idx1, np.int64), device=dev)
    S = spectrum.index_select(0, i0).index_select(1, i1)
    scale = torch.tensor(1.0 / (n * m), dtype=rdt, device=dev)
    A0c, A0s = _zoom_basis(n, idx0, rdt, dev)
    A1c, A1s = _zoom_basis(m, idx1, rdt, dev)
    f0 = torch.where(i0 < n // 2 + n % 2, i0, i0 - n).to(rdt) / n
    f1 = torch.where(i1 < m // 2 + m % 2, i1, i1 - m).to(rdt) / m
    s2 = torch.tensor(2.0 * np.pi ** 2 * sigma ** 2, dtype=rdt, device=dev)
    w = torch.as_tensor(np.asarray(wlist), device=dev).to(rdt)
    gx = torch.exp(-s2 * (f0[None, :] + w[:, 0:1]) ** 2)
    gy = torch.exp(-s2 * (f1[None, :] + w[:, 1:2]) ** 2)
    return (S.real * scale, S.imag * scale, gx, gy, A0c, A0s, A1c, A1s)


def _kernel_route(spectrum):
    """The reference's fused-sweep gate: float32, sides multiples of
    128 (ops.zoom_sweep runs the kernel on the card, its twin on the
    CPU); float64 and other sides take the plain twin."""
    n, m = spectrum.shape
    return (_real_dtype(spectrum) == torch.float32
            and n % 128 == 0 and m % 128 == 0)


def _wfr_sweep_zoom(spectrum, wlist, idx0, idx1, sigma, chunk):
    """Band-limited sweep on the (idx0, idx1) window: (best_absq,
    best_lockin (complex), best_idx)."""
    ops = _zoom_operands(spectrum, wlist, idx0, idx1, sigma)
    if _kernel_route(spectrum):
        ba, br, bi, bx = _zoom.zoom_sweep(*ops)
    else:
        ba, br, bi, bx = _zoom.zoom_sweep_plain(*ops, chunk=int(chunk))
    return ba, torch.complex(br, bi), bx


def _wfr_sweep_zoom_pw(spectrum, wlist, idx0, idx1, sigma, dr):
    """Zoom sweep emitting the winner phase and rim-masked weight (the
    float32 kernel route)."""
    ops = _zoom_operands(spectrum, wlist, idx0, idx1, sigma)
    return _zoom.zoom_sweep(*ops, dr=int(dr))[4:]


def _wfr_sweep_chunked(spectrum, wlist, sigma, chunk):
    """Full-FFT sweep: one inverse FFT of the Gaussian-bandpassed
    spectrum per candidate, `chunk` candidates per batched FFT."""
    n, m = spectrum.shape
    rdt = _real_dtype(spectrum)
    dev = spectrum.device
    fx = _fftfreq(n, rdt, dev)
    fy = _fftfreq(m, rdt, dev)
    s2 = torch.tensor(2.0 * np.pi ** 2 * sigma ** 2, dtype=rdt, device=dev)
    wl = torch.as_tensor(np.asarray(wlist), device=dev).to(rdt)
    best_absq = torch.zeros((n, m), dtype=rdt, device=dev)
    best_lockin = torch.zeros((n, m), dtype=spectrum.dtype, device=dev)
    best_idx = torch.zeros((n, m), dtype=torch.int32, device=dev)
    for s in range(0, wl.shape[0], chunk):
        ws = wl[s:s + chunk]
        gx = torch.exp(-s2 * (fx[None, :] + ws[:, 0:1]) ** 2)
        gy = torch.exp(-s2 * (fy[None, :] + ws[:, 1:2]) ** 2)
        G = (gx[:, :, None] * gy[:, None, :]).to(spectrum.dtype)
        Mw = torch.fft.ifft2(spectrum[None] * G)
        absq = Mw.real * Mw.real + Mw.imag * Mw.imag
        for i in range(ws.shape[0]):
            better = absq[i] > best_absq
            best_absq = torch.where(better, absq[i], best_absq)
            best_lockin = torch.where(better, Mw[i], best_lockin)
            best_idx = torch.where(better, s + i, best_idx)
    return best_absq, best_lockin, best_idx


def wfr_sweep(image, wlist, kref, sigma, *, with_grad=False, with_w=True,
              continuity_dk=None, chunk=8, spectrum=None, zoom="auto",
              rebase=True, return_absq=False):
    """WFR sweep of one Bragg peak over the candidates `wlist` (P, 2),
    rebased to `kref` (pygpa_tpu.ops.wfr.wfr_sweep).

    image is the mean-subtracted (N, M) image; `spectrum`, its fft2,
    may be passed to share it across peaks. zoom: "auto" plans the
    zoom window and falls back to the full-FFT sweep when it would not
    pay off, True demands it, False forces the full-FFT sweep.

    Returns a dict: 'lockin' (complex (N, M); phase relative to kref, or
    demodulated when rebase=False), 'w' ((2, N, M) winning candidates)
    when with_w, 'absq' (winner |M|^2) when return_absq. with_grad and
    continuity_dk raise NotImplementedError."""
    if with_grad:
        raise NotImplementedError("wfr_sweep(with_grad=True) "
                                  + _NOT_PORTED_GRAD)
    if continuity_dk is not None:
        raise NotImplementedError("wfr_sweep(continuity_dk=...) "
                                  + _NOT_PORTED_GRAD)
    if spectrum is None:
        spectrum = torch.fft.fft2(image)
    shape = tuple(spectrum.shape)
    rdt = _real_dtype(spectrum)
    wl_h = np.asarray(wlist)
    plan = None
    if zoom == "auto" or zoom is True:
        plan = _plan_zoom(shape, wl_h, float(sigma))
        if zoom is True and plan is None:
            raise ValueError("wfr_sweep(zoom=True): the bandpass window "
                             "spans most of the spectrum; zoom would not "
                             "be worthwhile (use zoom='auto' or "
                             "zoom=False)")
    chunk = int(min(chunk, wl_h.shape[0]))
    if plan is not None:
        best_absq, best_lockin, best_idx = _wfr_sweep_zoom(
            spectrum, wl_h, plan[0], plan[1], float(sigma), chunk)
    else:
        best_absq, best_lockin, best_idx = _wfr_sweep_chunked(
            spectrum, wl_h, float(sigma), chunk)
    if rebase:
        # separable rank-1 plane wave e^{2 pi i kref . r}
        k = torch.tensor(np.asarray(kref, np.float64),
                         device=spectrum.device).to(rdt)
        phx = (2 * np.pi) * (torch.arange(shape[0], dtype=rdt,
                                          device=spectrum.device) * k[0])
        phy = (2 * np.pi) * (torch.arange(shape[1], dtype=rdt,
                                          device=spectrum.device) * k[1])
        px = torch.complex(torch.cos(phx), torch.sin(phx))
        py = torch.complex(torch.cos(phy), torch.sin(phy))
        out = {"lockin": best_lockin * px[:, None] * py[None, :]}
    else:
        out = {"lockin": best_lockin}
    if return_absq:
        out["absq"] = best_absq
    if with_w:
        wl = torch.as_tensor(wl_h, device=spectrum.device).to(rdt)
        out["w"] = wl[best_idx.long()].permute(2, 0, 1)
    return out


def wfr_sweep_phase_weight(image, wlist, kref, sigma, dr, *, spectrum=None,
                           chunk=8, gauss_cut=None):
    """Demodulated winner phase and interior-masked weight sqrt(|M|^2)
    * (mask + 1e-6) of one peak's sweep, the inputs of
    reconstruct_u_inv_from_demod. Emitted by the zoom kernel route
    (float32, sides multiples of 128, P <= 48, a zoom plan at
    `gauss_cut`); computed from wfr_sweep otherwise."""
    if int(dr) < 1:
        raise ValueError("wfr_sweep_phase_weight requires dr >= 1 "
                         f"(got {dr})")
    if spectrum is None:
        spectrum = torch.fft.fft2(image)
    shape = tuple(spectrum.shape)
    wl_h = np.asarray(wlist)
    plan = _plan_zoom(shape, wl_h, float(sigma), gauss_cut=gauss_cut)
    if plan is not None and _kernel_route(spectrum) and wl_h.shape[0] <= 48:
        return _wfr_sweep_zoom_pw(spectrum, wl_h, plan[0], plan[1],
                                  float(sigma), int(dr))
    g = wfr_sweep(image, wl_h, kref, sigma, with_w=False, rebase=False,
                  return_absq=True, spectrum=spectrum, chunk=chunk)
    rdt = _real_dtype(spectrum)
    return (torch.angle(g["lockin"]).to(rdt), torch.sqrt(g["absq"])
            * _sweep.rim_weights(*shape, int(dr), rdt, spectrum.device))


def wfr_sweep_phase_weight_multi(image, wlists, sigma, dr, *, spectrum=None,
                                 chunk=8, gauss_cut=None):
    """Demodulated winner phases and rim-masked weights, (G, N, M) each,
    for all Bragg peaks, one per-peak sweep each
    (pygpa_tpu.ops.wfr.wfr_sweep_phase_weight_multi on its per-peak
    route). Where the reference would run its grouped phase/weight
    emission instead (the grouped_kernel's emission (a), ROADMAP queue 1
    item 7) this raises NotImplementedError."""
    shape = tuple(spectrum.shape if spectrum is not None else image.shape)
    dtype = image.dtype if spectrum is None else _real_dtype(spectrum)
    if _grouped_plans(shape, wlists, sigma, dr, gauss_cut,
                      dtype) is not None:
        raise NotImplementedError(
            "the grouped phase/weight sweep emission is not ported "
            "(ROADMAP queue 1 item 7); the grouped uv route "
            "(wfr_sweep_uv_multi) and the per-peak route are")
    if spectrum is None:
        spectrum = torch.fft.fft2(image)
    phs, wts = [], []
    for w in wlists:
        ph, wt = wfr_sweep_phase_weight(image, w, np.asarray(w)[0], sigma,
                                        dr, spectrum=spectrum, chunk=chunk,
                                        gauss_cut=gauss_cut)
        phs.append(ph)
        wts.append(wt)
    return torch.stack(phs), torch.stack(wts)
