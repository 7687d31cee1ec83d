"""Windowed-Fourier-ridge sweeps (counterpart of pygpa_tpu/ops/wfr.py,
the wfr4 k-continuity scans included).

A sweep evaluates, for a Bragg peak and every candidate reference
vector w of its bank, the full-resolution demodulated lock-in

    M_w(r) = sum_q F(q) G_sigma(q + w) e^{2 pi i q.r} / (n m)

and keeps, per pixel, the candidate of largest |M_w|^2 and, on request,
the winner's phase gradient (the reference's wfr2_grad_opt: the
gradient of -angle(M_w), rebased to the nominal k-vector as
wrap_to_pi(2 (g - 2 pi k)) / 2). The host planners here are numpy
copies of the reference's, so both packages plan the same sweep.
Routes, chosen as the reference chooses them:

- the grouped sweep (``GroupedSweep``; ``wfr_sweep_uv_multi`` and the
  grouped route of ``wfr_sweep_phase_weight_multi``): all peaks in one
  tournament launch of ops.sweep, from spectrum windows taken by skinny
  DFT products, emitting the uv prologue, the phase and weight planes,
  or those planes with the winners' analytic phase gradients (three
  more launches for the tiles' winners only); float32,
  sides multiples of 128, equal window shapes and candidate counts,
  P <= 48;
- the per-peak zoom sweep (``_wfr_sweep_zoom``): the Gaussian bandpass
  confines every candidate to a small window of the full spectrum, and
  ops.zoom_sweep evaluates the window as two DFT products (the CUDA
  kernel, with analytic gradients, for float32 with sides multiples of
  128, its plain twin on the CPU; the reference's XLA route, with
  np.gradient of each candidate's phase, otherwise);
- the full-FFT sweep (``_wfr_sweep_chunked``), one inverse FFT per
  candidate, where no zoom window pays off (np.gradient gradients);
- the wfr4 continuity scans (``continuity_dk``): one candidate at a
  time in the bank's order, a candidate winning a pixel only if it also
  lies within 2 sqrt(2) dk of that pixel's current winner; on the zoom
  window as two DFT products a candidate (``torch.matmul`` in float32,
  TF32 off; analytic gradients) or one inverse FFT a candidate
  (np.gradient gradients).
"""
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import sweep as _sweep
from . import zoom_sweep as _zoom
from ..core import host_to_device
from ..core.fourier import _fftfreq
from ..core.interp import no_tf32
from ..core.mathtools import wrap_to_pi
from .sweep import np_gradient_2d as _np_gradient_2d


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


def _zoom_basis(n, idx, dtype=torch.float32, device=None, rows=None):
    """cos/sin of the inverse-DFT submatrix e^{2 pi i r idx / n}, (n, W)
    (only the rows r in range(*rows) when rows = (start, stop) is given);
    the product r*idx is reduced mod n in exact integers first."""
    idx = host_to_device(np.asarray(idx, np.int64), device)
    r0, r1 = (0, n) if rows is None else rows
    r = torch.arange(r0, r1, dtype=torch.int64, device=device)[:, None]
    ang = ((r * idx[None, :]) % n).to(dtype) * (2 * math.pi / n)
    return torch.cos(ang), torch.sin(ang)


def _dft_windows(image, A0c_flat, A0s_flat, A1c, A1s):
    """Forward-DFT spectrum windows of a real image (n, m), or of each
    image of a stack (B, n, m), as skinny DFT products (no full-size
    FFT): A0*_flat are the (n, G*W0) row bases, A1c/A1s the (G, m, W1)
    column bases. A stack takes as many products as one image: the row
    products over the images side by side (n, B m), the column products
    with the images' rows stacked per group. Returns raw (unnormalized)
    (Sr, Si), each (G, W0, W1), or (B, G, W0, W1) for a stack."""
    images = image if image.dim() == 3 else image[None]
    B, n, m = images.shape
    G = A1c.shape[0]
    W0 = A0c_flat.shape[1] // G
    X = images.permute(1, 0, 2).reshape(n, B * m)

    def per_group(U):
        # (G W0, B m) -> (G, B W0, m)
        return U.reshape(G, W0, B, m).permute(0, 2, 1, 3).reshape(
            G, B * W0, m)

    Ur = per_group(A0c_flat.T @ X)
    Ui = per_group(-(A0s_flat.T @ X))
    Sr = Ur @ A1c + Ui @ A1s
    Si = Ui @ A1c - Ur @ A1s

    def per_image(S):
        # (G, B W0, W1) -> (B, G, W0, W1), or (G, W0, W1) for one image
        S = S.reshape(G, B, W0, -1).transpose(0, 1)
        return S if image.dim() == 3 else S[0]

    return per_image(Sr), per_image(Si)


@dataclass(frozen=True)
class SweepPlan:
    """Host plan of the grouped sweep, the same numbers the reference
    derives: wl (G, P, 2) candidate banks (wy-sorted when banded), idx0s
    (G, W0) / idx1s (G, W1) window bins, col_groups (Wb, runs) or None,
    uv_ks the G nominal (k_row, k_col) pairs (None without krefs)."""
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


def plan_sweep(shape, wlists, sigma, dr, krefs=None, gauss_cut=None,
               dtype=torch.float32):
    """Plan the grouped banded sweep exactly as
    pygpa_tpu.ops.wfr.wfr_sweep_phase_weight_multi does on its grouped
    route; None where the reference leaves the grouped route (the
    per-peak route then runs). krefs, the nominal k-vectors, are needed
    by the uv emission only."""
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
    uv_ks = None if krefs is None else tuple(
        (float(k[0]), float(k[1])) for k in np.asarray(krefs, np.float64))
    return SweepPlan(
        shape=shape, sigma=float(sigma), dr=int(dr), wl=np.stack(wls),
        idx0s=np.stack([p[0] for p in plans]),
        idx1s=np.stack([p[1] for p in plans]),
        col_groups=col_groups, uv_ks=uv_ks)


_EMISSIONS = ("uv", "pw", "grad")


class GroupedSweep:
    """A planned grouped sweep with its image-independent operands (DFT
    bases, Gaussian factors, band slices) built once on `device`, for
    one emission of the reference's grouped kernel:

    - "uv" (the plan needs krefs): (dudx_s (2, n, m), dudy_s (2, n, m),
      wnorm (n, m)), the shifted per-pixel weighted-lstsq displacement
      gradients and weight norm that
      gpa.reconstruct.reconstruct_u_inv_from_uv integrates;
    - "pw": (phases (G, n, m), weights (G, n, m)), the demodulated
      winner phases and rim-masked weights;
    - "grad": (phases, weights, grad_x, grad_y), each (G, n, m), the
      winners' derivatives of -angle(M) along rows and columns before
      the wfr2_grad_opt rebase.

    Called on a mean-subtracted float32 image (its windows taken by
    skinny DFT products) or, with `spectrum`, on windows of a given
    fft2. Every emission also takes a stack of images (B, n, m) of the
    plan's shape, each mean-subtracted, and returns each output with a
    leading image axis: the stack's windows come from as many products as
    one image's (_dft_windows) and its sweep from the launches of one
    (ops.sweep). The spectrum form takes one image."""

    def __init__(self, plan, device=None, emit="uv"):
        if emit not in _EMISSIONS:
            raise ValueError(f"emit must be one of {_EMISSIONS}, got {emit!r}")
        if emit == "uv" and plan.uv_ks is None:
            raise ValueError("the uv emission needs a plan with krefs")
        self.plan, self.emit = plan, emit
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
        self.idx0 = torch.as_tensor(plan.idx0s.astype(np.int64),
                                    device=device)
        self.idx1 = torch.as_tensor(plan.idx1s.astype(np.int64),
                                    device=device)
        f0 = torch.where(self.idx0 < n // 2 + n % 2, self.idx0,
                         self.idx0 - n).to(dt) / n
        f1 = torch.where(self.idx1 < m // 2 + m % 2, self.idx1,
                         self.idx1 - m).to(dt) / m
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
        if emit == "grad":
            # the row-derivative factor 2 pi f0 of the windows, and the
            # base band of the column-derivative basis (2 pi i f1) A1
            self.tpf0 = (2 * np.pi) * f0
            tpf1 = (2 * np.pi) * f1
            self.A1ycb = (-self.A1s * tpf1[:, None, :])[:, :, :Wb].contiguous()
            self.A1ysb = (self.A1c * tpf1[:, None, :])[:, :, :Wb].contiguous()
        if plan.uv_ks is not None:
            kc = []
            for k0, k1 in plan.uv_ks:
                t0, t1 = 2 * np.pi * k0, 2 * np.pi * k1
                kc.append([t0, t1, t0 * t0, t0 * t1, t1 * t1])
            self.kconst = torch.tensor(kc, dtype=torch.float64,
                                       device=device).to(dt)
        self.scale = torch.tensor(1.0 / (n * m), dtype=dt, device=device)

    def _bands(self, X):
        """(..., G, W0, W1) windows band-sliced per run: (..., G, H, W0,
        Wb)."""
        Wb = self.Wb
        return torch.stack([torch.stack([X[..., g, :, off:off + Wb]
                                         for _, off in rg], dim=-3)
                            for g, rg in enumerate(self.runs)],
                           dim=-4).contiguous()

    def _scaled(self, img0=None, spectrum=None):
        """The normalized (G, W0, W1) windows ((B, G, W0, W1) for a stack
        of images): skinny DFT products of the image(s), or the window
        bins of a given fft2."""
        if spectrum is None:
            Sr, Si = _dft_windows(img0, self.A0c_flat, self.A0s_flat,
                                  self.A1c, self.A1s)
        else:
            S = torch.stack([spectrum.index_select(0, i0).index_select(1, i1)
                             for i0, i1 in zip(self.idx0, self.idx1)])
            Sr, Si = S.real, S.imag
        return Sr * self.scale, Si * self.scale

    def windows(self, img0, spectrum=None):
        """Band-sliced, normalized spectrum windows (G, H, W0, Wb)."""
        Sr, Si = self._scaled(img0, spectrum)
        return self._bands(Sr), self._bands(Si)

    def __call__(self, img0, spectrum=None):
        src = img0 if spectrum is None else spectrum
        stack = spectrum is None and src.dim() == 3
        if tuple(src.shape[-2:]) != self.plan.shape or \
                src.dim() != 2 + stack or \
                (spectrum is None and img0.dtype != torch.float32) or \
                (spectrum is not None and spectrum.dtype != torch.complex64):
            raise ValueError(f"GroupedSweep planned for float32 "
                             f"{self.plan.shape} (or a stack (B, "
                             f"*{self.plan.shape})), got {src.dtype} "
                             f"{tuple(src.shape)}")
        Sr, Si = self._scaled(img0, spectrum)
        Sr4, Si4 = self._bands(Sr), self._bands(Si)
        common = (self.gx, self.gy, self.A0c, self.A0s, self.A1cb, self.A1sb,
                  self.run, self.off)
        if self.emit == "uv":
            return _sweep.sweep_uv(Sr4, Si4, *common, self.kconst,
                                   self.plan.dr, self.banded)
        if self.emit == "pw":
            return _sweep.sweep_pw(Sr4, Si4, *common, self.plan.dr,
                                   self.banded)
        # S2 = (2 pi i f0) S, from the normalized windows (the reference's
        # -tpf0 Si, tpf0 Sr); a stack's windows broadcast over the images
        t = self.tpf0[:, :, None]
        S2r4, S2i4 = self._bands(-t * Si), self._bands(t * Sr)
        return _sweep.sweep_grad(Sr4, Si4, S2r4, S2i4, self.gx, self.gy,
                                 self.A0c, self.A0s, self.A1cb, self.A1sb,
                                 self.A1ycb, self.A1ysb, self.run, self.off,
                                 self.plan.dr, self.banded)


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
    return GroupedSweep(plan, device=image.device)(image)


def _real_dtype(spectrum):
    return torch.empty((), dtype=spectrum.dtype).real.dtype


def _rounded(x, dtype):
    """x rounded to `dtype` (float32 or float64) as a Python float, which
    a tensor of that dtype then takes exactly: a host scalar that needs
    no copy to the card."""
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


def _zoom_operands(spectrum, wlist, idx0, idx1, sigma, with_grad=False):
    """The zoom sweep's operands, as the reference builds them: the
    (W0, W1) spectrum window pre-scaled by 1/(n m) ((B, W0, W1) from a
    stack of spectra (B, n, m)), the Gaussian factors gx (P, W0), gy (P,
    W1) and the DFT bases A0c/A0s (n, W0), A1c/A1s (m, W1), shared by a
    stack's images; with_grad also returns the gradient operands (S2r,
    S2i, A1yc, A1ys): S2 = (2 pi i f0) S pre-scaled and A1y = (2 pi i f1)
    A1 (else None). The host's numbers reach the card without a wait on
    the stream (host_to_device, scalars as Python numbers)."""
    dev = spectrum.device
    i0 = host_to_device(np.asarray(idx0, np.int64), dev)
    i1 = host_to_device(np.asarray(idx1, np.int64), dev)
    S = spectrum.index_select(-2, i0).index_select(-1, i1)
    return _window_operands(S, spectrum.shape[-2:], wlist, idx0, idx1,
                            sigma, with_grad)


def _window_operands(S, shape, wlist, idx0, idx1, sigma, with_grad=False,
                     rows=None):
    """_zoom_operands from the raw spectrum window S (W0, W1) (or (B, W0,
    W1)) of an (n, m) = `shape` spectrum at the bins (idx0, idx1); `rows`
    = (start, stop) builds only those rows of the row basis A0c/A0s (the
    output rows of a row block)."""
    n, m = shape
    rdt = _real_dtype(S)
    dev = S.device
    i0 = host_to_device(np.asarray(idx0, np.int64), dev)
    i1 = host_to_device(np.asarray(idx1, np.int64), dev)
    scale = _rounded(1.0 / (n * m), rdt)
    A0c, A0s = _zoom_basis(n, idx0, rdt, dev, rows)
    A1c, A1s = _zoom_basis(m, idx1, rdt, dev)
    f0 = torch.where(i0 < n // 2 + n % 2, i0, i0 - n).to(rdt) / n
    f1 = torch.where(i1 < m // 2 + m % 2, i1, i1 - m).to(rdt) / m
    s2 = _rounded(2.0 * np.pi ** 2 * sigma ** 2, rdt)
    w = host_to_device(np.asarray(wlist), dev, rdt)
    gx = torch.exp(-s2 * (f0[None, :] + w[:, 0:1]) ** 2)
    gy = torch.exp(-s2 * (f1[None, :] + w[:, 1:2]) ** 2)
    ops = (S.real * scale, S.imag * scale, gx, gy, A0c, A0s, A1c, A1s)
    if not with_grad:
        return ops, None
    tpf0 = (2 * np.pi) * f0
    tpf1 = (2 * np.pi) * f1
    return ops, ((-tpf0[:, None] * S.imag * scale).contiguous(),
                 (tpf0[:, None] * S.real * scale).contiguous(),
                 (-A1s * tpf1[None, :]).contiguous(),
                 (A1c * tpf1[None, :]).contiguous())


def _kernel_route(spectrum):
    """The reference's fused-sweep gate: float32, sides multiples of
    128 (ops.zoom_sweep runs the kernel on the card, its twin on the
    CPU); float64 and other sides take the plain twin."""
    n, m = spectrum.shape[-2:]
    return (_real_dtype(spectrum) == torch.float32
            and n % 128 == 0 and m % 128 == 0)


def _wfr_sweep_zoom(spectrum, wlist, idx0, idx1, sigma, chunk,
                    with_grad=False):
    """Band-limited sweep on the (idx0, idx1) window: (best_absq,
    best_lockin (complex), best_idx, best_grad ((n, m, 2) winner
    gradients of -angle M, or None)); a stack of spectra (B, n, m) gives
    each with a leading image axis, through the launches of one image on
    the kernel route. The kernel route's gradients are analytic, the
    plain route's np.gradient of each candidate's phase, as the
    reference's two routes compute them."""
    ops, gops = _zoom_operands(spectrum, wlist, idx0, idx1, sigma,
                               with_grad)
    if _kernel_route(spectrum):
        out = _zoom.zoom_sweep(*ops, grad_ops=gops)
    else:
        out = _zoom.zoom_sweep_plain(*ops, chunk=int(chunk),
                                     fd_grad=with_grad)
    ba, br, bi, bx = out[:4]
    grad = torch.stack(out[4:6], dim=-1) if with_grad else None
    return ba, torch.complex(br, bi), bx, grad


def _wfr_sweep_zoom_pw(spectrum, wlist, idx0, idx1, sigma, dr):
    """Zoom sweep emitting the winner phase and rim-masked weight (the
    float32 kernel route; a stack of spectra gives (B, n, m) planes)."""
    ops, _ = _zoom_operands(spectrum, wlist, idx0, idx1, sigma)
    return _zoom.zoom_sweep(*ops, dr=int(dr))[4:]


def _wfr_sweep_chunked(spectrum, wlist, sigma, chunk, with_grad=False):
    """Full-FFT sweep: one inverse FFT of the Gaussian-bandpassed
    spectrum per candidate, `chunk` candidates per batched FFT; with_grad
    adds the winner's np.gradient of -angle(M) (n, m, 2), else None. A
    stack of spectra (B, n, m) gives each output with a leading image
    axis."""
    n, m = spectrum.shape[-2:]
    lead = tuple(spectrum.shape[:-2])
    rdt = _real_dtype(spectrum)
    dev = spectrum.device
    fx = _fftfreq(n, rdt, dev)
    fy = _fftfreq(m, rdt, dev)
    s2 = _rounded(2.0 * np.pi ** 2 * sigma ** 2, rdt)
    wl = host_to_device(np.asarray(wlist), dev, rdt)
    best_absq = torch.zeros(lead + (n, m), dtype=rdt, device=dev)
    best_lockin = torch.zeros(lead + (n, m), dtype=spectrum.dtype,
                              device=dev)
    best_idx = torch.zeros(lead + (n, m), dtype=torch.int32, device=dev)
    best_grad = torch.zeros(lead + (n, m, 2), dtype=rdt, device=dev) \
        if with_grad else None
    for s in range(0, wl.shape[0], chunk):
        ws = wl[s:s + chunk]
        gx = torch.exp(-s2 * (fx[None, :] + ws[:, 0:1]) ** 2)
        gy = torch.exp(-s2 * (fy[None, :] + ws[:, 1:2]) ** 2)
        G = (gx[:, :, None] * gy[:, None, :]).to(spectrum.dtype)
        Mw = torch.fft.ifft2(spectrum[..., None, :, :] * G)
        absq = Mw.real * Mw.real + Mw.imag * Mw.imag
        if with_grad:
            ggx, ggy = _np_gradient_2d(-torch.atan2(Mw.imag, Mw.real))
        for i in range(ws.shape[0]):
            a = absq[..., i, :, :]
            better = a > best_absq
            best_absq = torch.where(better, a, best_absq)
            best_lockin = torch.where(better, Mw[..., i, :, :], best_lockin)
            best_idx = torch.where(better, s + i, best_idx)
            if with_grad:
                gi = torch.stack([ggx[..., i, :, :], ggy[..., i, :, :]],
                                 dim=-1)
                best_grad = torch.where(better[..., None], gi, best_grad)
    return best_absq, best_lockin, best_idx, best_grad


def _continuity_init(wl, n, m, cdtype, with_grad):
    """The continuity scans' carry: |M|^2, the winner's lock-in (complex)
    and candidate (starting at the bank's first), and its gradient."""
    rdt, dev = wl.dtype, wl.device
    return (torch.zeros((n, m), dtype=rdt, device=dev),
            torch.zeros((n, m), dtype=cdtype, device=dev),
            wl[0].expand(n, m, 2).clone(),
            torch.zeros((n, m, 2), dtype=rdt, device=dev)
            if with_grad else None)


def _continuity_wins(absq, best_absq, best_w, w, lim):
    """Pixels candidate w takes: a larger |M|^2 than the winner's, and
    |w - winner|^2 < 8 dk^2 (lim)."""
    d0 = best_w[..., 0] - w[0]
    d1 = best_w[..., 1] - w[1]
    return (absq > best_absq) & (d0 * d0 + d1 * d1 < lim)


def _wfr_sweep_sequential(spectrum, wlist, sigma, dk, with_grad=False):
    """The wfr4 continuity scan with one inverse FFT of the bandpassed
    spectrum a candidate, in the bank's order: (best_absq, best_lockin,
    best_w (n, m, 2), best_grad (the winner's np.gradient of -angle M,
    (n, m, 2), or None))."""
    n, m = spectrum.shape
    rdt = _real_dtype(spectrum)
    dev = spectrum.device
    fx = _fftfreq(n, rdt, dev)
    fy = _fftfreq(m, rdt, dev)
    s2 = _rounded(2.0 * np.pi ** 2 * sigma ** 2, rdt)
    wl = host_to_device(np.asarray(wlist), dev, rdt)
    best_absq, best_lockin, best_w, best_grad = _continuity_init(
        wl, n, m, spectrum.dtype, with_grad)
    lim = 8.0 * dk * dk
    for i in range(wl.shape[0]):
        w = wl[i]
        gx = torch.exp(-s2 * (fx + w[0]) ** 2)
        gy = torch.exp(-s2 * (fy + w[1]) ** 2)
        Mw = torch.fft.ifft2(spectrum * (gx[:, None] * gy[None, :]).to(
            spectrum.dtype))
        absq = Mw.real * Mw.real + Mw.imag * Mw.imag
        t = _continuity_wins(absq, best_absq, best_w, w, lim)
        best_absq = torch.where(t, absq, best_absq)
        best_lockin = torch.where(t, Mw, best_lockin)
        best_w = torch.where(t[..., None], w, best_w)
        if with_grad:
            ggx, ggy = _np_gradient_2d(-torch.atan2(Mw.imag, Mw.real))
            best_grad = torch.where(t[..., None],
                                    torch.stack([ggx, ggy], dim=-1),
                                    best_grad)
    return best_absq, best_lockin, best_w, best_grad


def _wfr_sweep_sequential_zoom(spectrum, wlist, idx0, idx1, sigma, dk,
                               with_grad=False):
    """The wfr4 continuity scan on the zoom window: a candidate's
    full-resolution lock-in is two DFT products of the Gaussian-weighted
    window, [Tr | Ti] = [A0c | A0s] [[Swr, Swi], [-Swi, Swr]] and
    [Mr | Mi] = [Tr | Ti] [[A1c^T, A1s^T], [-A1s^T, A1c^T]], in float32
    with TF32 off (or float64); the gradients are the analytic
    derivatives of the band-limited interpolant, (Im M Re D - Re M Im D)
    / max(|M|^2, 1e-30). Returns as _wfr_sweep_sequential."""
    n, m = spectrum.shape
    ops, gops = _zoom_operands(spectrum, wlist, idx0, idx1, sigma,
                               with_grad)
    Sr, Si, gxs, gys, A0c, A0s, A1c, A1s = ops
    rdt, dev = Sr.dtype, Sr.device
    wl = torch.as_tensor(np.asarray(wlist), device=dev).to(rdt)
    A0 = torch.cat([A0c, A0s], dim=1)                          # (n, 2 W0)
    B = torch.cat([torch.cat([A1c.T, A1s.T], dim=1),
                   torch.cat([-A1s.T, A1c.T], dim=1)])         # (2 W1, 2 m)
    BB = B
    if with_grad:
        # [Mr | Mi | Myr | Myi] from one product: A1y = (2 pi i f1) A1
        S2r, S2i, A1yc, A1ys = gops
        BB = torch.cat([B, torch.cat([torch.cat([A1yc.T, A1ys.T], dim=1),
                                      torch.cat([-A1ys.T, A1yc.T], dim=1)])],
                       dim=1)                                  # (2 W1, 4 m)

    def window(gx, gy, xr, xi):
        """[[Swr, Swi], [-Swi, Swr]] of the weighted window x."""
        wr = gx[:, None] * xr * gy[None, :]
        wi = gx[:, None] * xi * gy[None, :]
        return torch.cat([torch.cat([wr, wi], dim=1),
                          torch.cat([-wi, wr], dim=1)])

    best_absq, best_lockin, best_w, best_grad = _continuity_init(
        wl, n, m, spectrum.dtype, with_grad)
    lim = 8.0 * dk * dk
    with no_tf32():
        for i in range(wl.shape[0]):
            w, gx, gy = wl[i], gxs[i], gys[i]
            MM = (A0 @ window(gx, gy, Sr, Si)) @ BB
            Mr, Mi = MM[:, :m], MM[:, m:2 * m]
            absq = Mr * Mr + Mi * Mi
            t = _continuity_wins(absq, best_absq, best_w, w, lim)
            best_absq = torch.where(t, absq, best_absq)
            best_lockin = torch.where(t, torch.complex(Mr, Mi), best_lockin)
            best_w = torch.where(t[..., None], w, best_w)
            if with_grad:
                Mx = (A0 @ window(gx, gy, S2r, S2i)) @ B
                gi = torch.stack([
                    _sweep.winner_gradients(Mr, Mi, Mx[:, :m], Mx[:, m:]),
                    _sweep.winner_gradients(Mr, Mi, MM[:, 2 * m:3 * m],
                                            MM[:, 3 * m:])], dim=-1)
                best_grad = torch.where(t[..., None], gi, best_grad)
    return best_absq, best_lockin, best_w, best_grad


def _grad_rebase(grad, kref):
    """The wfr2_grad_opt epilogue: wrap_to_pi(2 (g - 2 pi kref)) / 2 in
    the reference's (x + pi) mod 2 pi - pi form, kref broadcasting over
    the trailing (row, column) axis."""
    return wrap_to_pi(2.0 * (grad - 2 * math.pi * kref)) / 2.0


def _rebased(lockin, k):
    """lockin (..., n, m) times the separable rank-1 plane wave
    e^{2 pi i k . r}, k (2,) in lockin's real dtype on its device."""
    n, m = lockin.shape[-2:]
    phx = (2 * np.pi) * (torch.arange(n, dtype=k.dtype, device=k.device)
                         * k[0])
    phy = (2 * np.pi) * (torch.arange(m, dtype=k.dtype, device=k.device)
                         * k[1])
    px = torch.complex(torch.cos(phx), torch.sin(phx))
    py = torch.complex(torch.cos(phy), torch.sin(phy))
    return lockin * px[:, None] * py[None, :]


def wfr_sweep(image, wlist, kref, sigma, *, with_grad=False, with_w=True,
              continuity_dk=None, chunk=8, spectrum=None, zoom="auto",
              rebase=True, return_absq=False):
    """WFR sweep of one Bragg peak over the candidates `wlist` (P, 2),
    rebased to `kref` (pygpa_tpu.ops.wfr.wfr_sweep).

    image is the mean-subtracted (N, M) image, or a stack (B, N, M) of
    them, each returned array then with a leading image axis (the zoom
    kernel takes the stack in the launches of one image; the continuity
    scans run image by image); `spectrum`, its fft2, may be passed to
    share it across peaks. zoom: "auto" plans the
    zoom window and falls back to the full-FFT sweep when it would not
    pay off, True demands it, False forces the full-FFT sweep.

    Returns a dict: 'lockin' (complex (N, M); phase relative to kref, or
    demodulated when rebase=False), 'w' ((2, N, M) winning candidates)
    when with_w, 'absq' (winner |M|^2) when return_absq, 'grad' ((N, M,
    2) the winner's phase gradient along rows and columns, rebased to
    kref as wrap_to_pi(2 (g - 2 pi kref)) / 2) when with_grad.
    continuity_dk (wfr4) scans the candidates one at a time in the bank's
    order under the k-continuity constraint |w - winner| < 2 sqrt(2) dk,
    on the zoom window unless zoom is False or no window pays off; its
    'w' is the winning candidates, whatever with_w says."""
    if spectrum is None:
        spectrum = torch.fft.fft2(image)
    if spectrum.dim() == 3 and continuity_dk is not None:
        outs = [wfr_sweep(None, wlist, kref, sigma, with_grad=with_grad,
                          with_w=with_w, continuity_dk=continuity_dk,
                          chunk=chunk, spectrum=sp, zoom=zoom, rebase=rebase,
                          return_absq=return_absq) for sp in spectrum]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    shape = tuple(spectrum.shape[-2:])
    rdt = _real_dtype(spectrum)
    wl_h = np.asarray(wlist)
    w_field = None
    if continuity_dk is not None:
        plan = _plan_zoom(shape, wl_h, float(sigma)) \
            if zoom is not False else None
        if plan is not None:
            best_absq, best_lockin, w_field, best_grad = \
                _wfr_sweep_sequential_zoom(spectrum, wl_h, plan[0], plan[1],
                                           float(sigma), float(continuity_dk),
                                           with_grad)
        else:
            best_absq, best_lockin, w_field, best_grad = \
                _wfr_sweep_sequential(spectrum, wl_h, float(sigma),
                                      float(continuity_dk), with_grad)
    else:
        plan = None
        if zoom == "auto" or zoom is True:
            plan = _plan_zoom(shape, wl_h, float(sigma))
            if zoom is True and plan is None:
                raise ValueError("wfr_sweep(zoom=True): the bandpass window "
                                 "spans most of the spectrum; zoom would "
                                 "not be worthwhile (use zoom='auto' or "
                                 "zoom=False)")
        chunk = int(min(chunk, wl_h.shape[0]))
        if plan is not None:
            best_absq, best_lockin, best_idx, best_grad = _wfr_sweep_zoom(
                spectrum, wl_h, plan[0], plan[1], float(sigma), chunk,
                with_grad)
        else:
            best_absq, best_lockin, best_idx, best_grad = _wfr_sweep_chunked(
                spectrum, wl_h, float(sigma), chunk, with_grad)
        if with_w:
            wl = host_to_device(wl_h, spectrum.device, rdt)
            w_field = wl[best_idx.long()]
    k = host_to_device(np.asarray(kref, np.float64), spectrum.device, rdt)
    out = {"lockin": _rebased(best_lockin, k) if rebase else best_lockin}
    if return_absq:
        out["absq"] = best_absq
    if w_field is not None:
        out["w"] = w_field.movedim(-1, -3)
    if with_grad:
        out["grad"] = _grad_rebase(best_grad, k)
    return out


def wfr_sweep_phase_weight(image, wlist, kref, sigma, dr, *, spectrum=None,
                           chunk=8, gauss_cut=None):
    """Demodulated winner phase and interior-masked weight sqrt(|M|^2)
    * (mask + 1e-6) of one peak's sweep, the inputs of
    reconstruct_u_inv_from_demod. Emitted by the zoom kernel route
    (float32, sides multiples of 128, P <= 48, a zoom plan at
    `gauss_cut`); computed from wfr_sweep otherwise. A stack of images
    (B, N, M) gives (B, N, M) planes."""
    if int(dr) < 1:
        raise ValueError("wfr_sweep_phase_weight requires dr >= 1 "
                         f"(got {dr})")
    if spectrum is None:
        spectrum = torch.fft.fft2(image)
    shape = tuple(spectrum.shape[-2:])
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
                                 chunk=8, with_grad=False, krefs=None,
                                 gauss_cut=None):
    """Demodulated winner phases and rim-masked weights, (G, N, M) each,
    for all Bragg peaks (pygpa_tpu.ops.wfr.wfr_sweep_phase_weight_multi):
    one grouped sweep where the reference's grouped gate holds (float32,
    sides multiples of 128, equal windows and candidate counts, P <= 48;
    the spectrum windows come from skinny DFT products of `image` unless
    `spectrum` is given), one sweep per peak otherwise.

    with_grad=True also returns grads (G, N, M, 2), each peak's
    wfr2_grad_opt winner phase gradient rebased to its nominal k-vector
    (krefs (G, 2), required): wrap_to_pi(2 (g - 2 pi k)) / 2.

    A stack of images (B, N, M) (without `spectrum`) gives (B, G, N, M)
    planes and (B, G, N, M, 2) gradients in one call: the grouped sweep
    takes it in the launches of one image, the per-peak route sweeps
    each peak on the whole stack (the zoom kernel where its gate holds,
    the twins elsewhere)."""
    if with_grad and krefs is None:
        raise ValueError(
            "wfr_sweep_phase_weight_multi(with_grad=True) requires "
            "krefs (the per-peak nominal k-vectors)")
    shape = tuple((spectrum if spectrum is not None else image).shape[-2:])
    rdt = image.dtype if spectrum is None else _real_dtype(spectrum)
    dev = image.device if spectrum is None else spectrum.device
    plan = plan_sweep(shape, wlists, sigma, dr, gauss_cut=gauss_cut,
                      dtype=rdt)
    if plan is not None:
        out = GroupedSweep(plan, device=dev,
                           emit="grad" if with_grad else "pw")(image,
                                                               spectrum)
        if not with_grad:
            return out
        ph, wt, ggx, ggy = out
        k = host_to_device(np.asarray(krefs, np.float64), dev, rdt)
        return ph, wt, _grad_rebase(torch.stack([ggx, ggy], dim=-1),
                                    k[:, None, None, :])
    if spectrum is None:
        spectrum = torch.fft.fft2(image)
    phs, wts, gds = [], [], []
    for i, w in enumerate(wlists):
        if with_grad:
            g = wfr_sweep(image, w, np.asarray(krefs)[i], sigma,
                          with_grad=True, with_w=False, chunk=chunk,
                          spectrum=spectrum, rebase=False)
            phs.append(torch.angle(g["lockin"]))
            wts.append(torch.abs(g["lockin"]) * _sweep.rim_weights(
                *shape, int(dr), rdt, dev))
            gds.append(g["grad"])
            continue
        # kref is unused on the demod (rebase=False) path
        ph, wt = wfr_sweep_phase_weight(image, w, np.asarray(w)[0], sigma,
                                        dr, spectrum=spectrum, chunk=chunk,
                                        gauss_cut=gauss_cut)
        phs.append(ph)
        wts.append(wt)
    # the peaks' axis sits before the planes (and a stack's images before
    # it)
    if with_grad:
        return (torch.stack(phs, dim=-3), torch.stack(wts, dim=-3),
                torch.stack(gds, dim=-4))
    return torch.stack(phs, dim=-3), torch.stack(wts, dim=-3)
