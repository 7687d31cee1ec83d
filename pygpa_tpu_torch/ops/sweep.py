"""Grouped banded WFR sweep: the reconstruction-prologue (uv),
phase/weight and phase-gradient emissions.

Replaces the TPU kernel ``pygpa_tpu/ops/pallas_sweep.py``
``_grouped_kernel`` (banded column groups), reached through
``fused_zoom_sweep_grouped``, with its three output sets: the uv
prologue (``uv_ks``), the phase and weight planes (a: neither ``uv_ks``
nor ``grad_ops``) and those planes with the winners' phase gradients
(b: ``grad_ops``). For G Bragg peaks x P candidates it evaluates every
candidate's full-resolution lock-in as two skinny DFT products of its
spectrum window, keeps the per-pixel argmax of |M|^2 (strict '>',
candidate 0 first), emits the winner's phase (with the banded column
ramp) and rim-masked weight, and either returns them (a), adds the
winner's derivatives of -angle(M) along rows and columns (b), or
reduces them to the shifted per-pixel weighted-lstsq displacement
gradients ``dudx_s``/``dudy_s`` (2, n, m) and the weight norm ``wnorm``
(n, m).

CUDA route (``csrc/sweep.cu``), launches on the current stream:

1. stage 1: T[g, i] = ((A0 . gx_i) @ S_run(i)) . gy_i as [Re | Im]
   rows into a (G, P, n, 2*Wb) float32 scratch (float32 FMA);
2. stage 2 + tournament: M_i = T_i @ [A1c | -A1s], [A1s | A1c] per
   64x64 pixel tile on the tensor cores (``csrc/sweep_tc.cuh``, shared
   with the zoom sweep: 3xTF32 on Hopper's warpgroup ``wgmma``, fed by a
   TMA ring over T and the column basis loaded two stages ahead; the
   basis is split into its TF32 hi and lo planes once a call by
   :func:`split_basis`, its own launch, counted "split_basis";
   tensor-core chains that restart every 32 columns of Wb with float32
   adds between, the hi.hi products in a chain apart from the two small
   ones, so any Wb that is a multiple of 64 runs), looped over the
   candidates with the running best kept in registers; emits the phase
   and weight planes (G, n, m);
3. (uv) the uv epilogue, one thread per pixel reading its left and
   upper neighbours from device memory; or (b) the gradients, after a
   tournament launch that also stores each pixel's winner (Re M, Im M,
   index; the same products and tournament, so the phase and weight
   planes are (a)'s bits): the band flags (which candidates win a
   pixel of each 64-row band, "grad_flags"), stage 1 once more on the
   row-derivative windows S2 = (2 pi i f0) S for the flagged (band,
   candidate) pairs only (Tx, "grad_stage1"; on a lattice 1-2 of 36-49
   candidates a band), and the winner products ("grad_products"): per
   tile, for each candidate that wins one of its pixels, Tx_i @ B1 and
   T_i @ B1y (the base band's f1-scaled basis A1y = (2 pi i f1) A1) as
   two jobs of one ``cp.async`` ring on ``mma.sync``, then the
   gradients at the pixels it wins, the banded winner's column gradient
   less its ramp's slope off * 2 pi / m. Nothing waits for the host
   between these launches; the zoom sweep runs the same three for its
   gradient emission.

What bounds it on an H100: stage 2's G*P*n*m*Wb complex multiply-adds
(1.86 TFLOP at the 4096^2 bench shapes), three times over at the
dense TF32 rate (~11.3 ms; 27.8 ms in float32 FMA outside the tensor
cores), plus stage 1. The design keeps the (G, P, n, m) candidate
planes out of memory entirely (the tournament never leaves registers)
and schedules the column tiles of one 64-row band next to each other,
so the band's slice of T (2.4 MB per peak) is re-read from L2 rather
than device memory. The kernel's stage 2 lies nearer its float64 value
than the float32 twin's does, so chip_smoke.py holds its path to the
path with a float64 sweep. ``stage1``, ``stage2``, ``band_winners``,
``winner_products`` and ``epilogue`` launch one kernel each on checked
operands (chip_smoke.py times them apart; the zoom sweep reuses
``stage1``, ``band_winners`` and ``winner_products``). Launch counts:
"sweep_uv", "sweep_pw" (a), "sweep_grad" (b), one per call, and the
gradient steps' "grad_flags", "grad_stage1", "grad_products".

The uv epilogue wraps its phase differences with :func:`wrap_diff`,
not the reference's (x + pi) form, which rounds a near-zero float32
difference to the spacing at pi: a coherent bias that the unwrap
integrates into a ~1e-3 px ripple on the bench fixture.

Every emission also takes a stack of B images planned alike (the
factory's batch axis): windows (B, G, H, W0, Wb) and the plan's other
operands shared, outputs with a leading image axis. The stack runs in
the launches of one image (the image beside the group on stage 1's,
stage 2's and the winner products' grid z, the epilogue a thread per
pixel of every image, the band flags a row of their grid per (image,
group) pair), each image's outputs the bits of its own launch; a stack
whose B G P passes CUDA's gridDim.z limit (65535) goes in launches of as
many images as fit. The twins run a stack image by image.

The plain twins :func:`sweep_uv_plain`, :func:`sweep_pw_plain` and
:func:`sweep_grad_plain` run the same stages with torch ops
(``sweep_grad_plain`` keeps every candidate's gradients and the
winner's by where, independent of the steps above);
:func:`sweep_uv`, :func:`sweep_pw` and :func:`sweep_grad` send a CPU
tensor there and a CUDA tensor to the kernels. Each step wrapper
(``stage1``, ``stage2``, ``band_winners``, ``winner_products``) runs
its own plain twin on a CPU tensor, so :func:`winner_grads` composes
the gradient steps on either device.
"""
import torch

from . import _build

_PI = 3.14159265358979
_TWO_PI = 6.283185307179586
TILE = 64          # stage-1/2 output tile (rows x columns), csrc/sweep.cu
MAX_GRID_Z = 65535  # CUDA's gridDim.z limit: stage 1 runs G P blocks a
                    # (row, column) tile an image on it


def wrap_pi(x):
    """(x + pi) mod 2 pi - pi with the kernel's float32 constants."""
    t = x + _PI
    return t - _TWO_PI * torch.floor(t / _TWO_PI) - _PI


def wrap_diff(x):
    """x wrapped to [-pi, pi) as x - 2 pi floor(x / 2 pi + 1/2): equal
    to wrap_pi in exact arithmetic, but a float32 x with |x| < pi comes
    back unchanged. The (x + pi) form rounds a small phase difference
    to the float32 spacing at pi (2.4e-7 rad), a bias the unwrap
    integrates across the image."""
    return x - _TWO_PI * torch.floor(x / _TWO_PI + 0.5)


def rim_weights(n, m, dr, dtype, device=None):
    """The rim factor of the lock-in weights (extract_displacement_field's
    interior mask + 1e-6): 1 + 1e-6 inside the dr-pixel border, 1e-6 on
    it; (n, m) of `dtype`."""
    ii = torch.arange(n, device=device)[:, None]
    jj = torch.arange(m, device=device)[None, :]
    interior = (ii >= dr) & (ii < n - dr) & (jj >= dr) & (jj < m - dr)
    # filled on the device: no host scalar is copied (a copy waits)
    return torch.where(interior,
                       torch.full((), 1.0 + 1e-6, dtype=dtype, device=device),
                       torch.full((), 1e-6, dtype=dtype, device=device))


def np_gradient_2d(ph):
    """np.gradient along the last two axes (first-order edges, central
    interior): (d/d axis -2, d/d axis -1)."""
    gx = torch.cat([ph[..., 1:2, :] - ph[..., 0:1, :],
                    (ph[..., 2:, :] - ph[..., :-2, :]) * 0.5,
                    ph[..., -1:, :] - ph[..., -2:-1, :]], dim=-2)
    gy = torch.cat([ph[..., :, 1:2] - ph[..., :, 0:1],
                    (ph[..., :, 2:] - ph[..., :, :-2]) * 0.5,
                    ph[..., :, -1:] - ph[..., :, -2:-1]], dim=-1)
    return gx, gy


def winner_gradients(Mr, Mi, Dr, Di):
    """d(-angle M) from M and its derivative D: (Im M Re D - Re M Im D)
    / max(|M|^2, 1e-30), the TPU kernel's and the CUDA kernels' form."""
    den = torch.clamp(Mr * Mr + Mi * Mi, min=1e-30)
    return (Mi * Dr - Mr * Di) / den


def _stage1_plain(Sr, Si, gx, gy, A0c, A0s, run, flags=None):
    G, P = gx.shape[:2]
    Ts = []
    for g in range(G):
        sr = Sr[g][run[g].long()]                 # (P, W0, Wb)
        si = Si[g][run[g].long()]
        ac = A0c[g][None] * gx[g][:, None, :]     # (P, n, W0)
        as_ = A0s[g][None] * gx[g][:, None, :]
        gyi = gy[g][:, None, :]
        tr = (ac @ sr - as_ @ si) * gyi
        ti = (ac @ si + as_ @ sr) * gyi
        Ts.append(torch.cat([tr, ti], dim=-1))
    T = torch.stack(Ts)                           # (G, P, n, 2 Wb)
    if flags is None:
        return T
    # the rows of unflagged (band, candidate) pairs: 0 here, unwritten by
    # the kernel; no later step reads them
    keep = flags.permute(0, 2, 1).repeat_interleave(TILE, dim=2)
    return T * keep[..., None].to(T.dtype)


def _stage2_plain(T, A1c, A1s, off, dr, banded, Tx=None, A1yc=None,
                  A1ys=None, winners=False):
    G, P, n, _ = T.shape
    m = A1c.shape[1]
    dev = T.device
    jj = torch.arange(m, device=dev)[None, :]
    mask = rim_weights(n, m, dr, T.dtype, dev)
    grad = Tx is not None
    phs, wts, gxs, gys, wins = [], [], [], [], []
    for g in range(G):
        B1r = torch.cat([A1c[g].T, -A1s[g].T], dim=0)   # (2 Wb, m)
        B1i = torch.cat([A1s[g].T, A1c[g].T], dim=0)
        if grad:
            B1yr = torch.cat([A1yc[g].T, -A1ys[g].T], dim=0)
            B1yi = torch.cat([A1ys[g].T, A1yc[g].T], dim=0)
        offg = off[g].to(T.dtype)
        for i in range(P):
            mr = T[g, i] @ B1r
            mi = T[g, i] @ B1i
            absq = mr * mr + mi * mi
            if grad:
                # the winner's gradients, from every candidate's (the
                # where below keeps the winner's)
                ggx = winner_gradients(mr, mi, Tx[g, i] @ B1r,
                                       Tx[g, i] @ B1i)
                ggy = winner_gradients(mr, mi, T[g, i] @ B1yr,
                                       T[g, i] @ B1yi)
            if i == 0:
                ba, br, bi = absq, mr, mi
                bo = torch.full_like(absq, float(offg[0]))
                bx = torch.zeros(absq.shape, dtype=torch.int32, device=dev)
                if grad:
                    bgx, bgy = ggx, ggy
                continue
            sel = absq > ba
            ba = torch.where(sel, absq, ba)
            br = torch.where(sel, mr, br)
            bi = torch.where(sel, mi, bi)
            bo = torch.where(sel, offg[i], bo)
            bx = torch.where(sel, i, bx)
            if grad:
                bgx = torch.where(sel, ggx, bgx)
                bgy = torch.where(sel, ggy, bgy)
        pht = torch.atan2(bi, br)
        if banded:
            # the winner's true lock-in is its base-band value times the
            # column ramp e^{2 pi i c off / m}; off*c is float32-exact
            rr = bo * jj.to(T.dtype)
            rr = rr - m * torch.floor(rr * (1.0 / m))
            pht = wrap_pi(pht + rr * (_TWO_PI / m))
            if grad:
                bgy = bgy - bo * (_TWO_PI / m)
        phs.append(pht)
        wts.append(torch.sqrt(torch.clamp(ba, min=0.0)) * mask)
        if grad:
            gxs.append(bgx)
            gys.append(bgy)
        wins.append((br, bi, bx))
    out = (torch.stack(phs), torch.stack(wts))
    if grad:
        out += (torch.stack(gxs), torch.stack(gys))
    if winners:
        out += tuple(torch.stack(w) for w in zip(*wins))
    return out


def _uv_plain(ph, wt, kconst):
    G, n, m = ph.shape
    dt = ph.dtype
    zx = torch.zeros((n, m - 1), dtype=dt, device=ph.device)
    zy = torch.zeros((n - 1, m), dtype=dt, device=ph.device)
    a00x = a01x = a11x = r0x = r1x = zx
    a00y = a01y = a11y = r0y = r1y = zy
    wsq = torch.zeros((n, m), dtype=dt, device=ph.device)
    for g in range(G):
        k0, k1, k00, k01, k11 = (kconst[g, j] for j in range(5))
        # position j holds the diff ENDING at j; its weight is w[j-1]
        dbdx = wrap_diff(ph[g, :, 1:] - ph[g, :, :-1] + k1)
        dbdy = wrap_diff(ph[g, 1:, :] - ph[g, :-1, :] + k0)
        wwx = wt[g, :, :-1] * wt[g, :, :-1]
        wwy = wt[g, :-1, :] * wt[g, :-1, :]
        a00x = a00x + wwx * k00
        a01x = a01x + wwx * k01
        a11x = a11x + wwx * k11
        r0x = r0x + wwx * k0 * dbdx
        r1x = r1x + wwx * k1 * dbdx
        a00y = a00y + wwy * k00
        a01y = a01y + wwy * k01
        a11y = a11y + wwy * k11
        r0y = r0y + wwy * k0 * dbdy
        r1y = r1y + wwy * k1 * dbdy
        wsq = wsq + wt[g] * wt[g]
    # clamp the Gram determinant away from the f32 underflow of rim
    # pixels (weights ~1e-6 enter to the fourth power)
    detx = torch.clamp(a00x * a11x - a01x * a01x, min=1e-30)
    dety = torch.clamp(a00y * a11y - a01y * a01y, min=1e-30)
    ux = torch.zeros((2, n, m), dtype=dt, device=ph.device)
    uy = torch.zeros((2, n, m), dtype=dt, device=ph.device)
    ux[0, :, 1:] = (a11x * r0x - a01x * r1x) / detx
    ux[1, :, 1:] = (a00x * r1x - a01x * r0x) / detx
    uy[0, 1:, :] = (a11y * r0y - a01y * r1y) / dety
    uy[1, 1:, :] = (a00y * r1y - a01y * r0y) / dety
    return ux, uy, torch.sqrt(wsq)


def _per_image(fn, Sr, Si, *rest):
    """fn on each image of a stack (windows (B, G, H, W0, Wb)), its
    outputs stacked on a leading image axis."""
    outs = [fn(Sr[b], Si[b], *rest) for b in range(Sr.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def sweep_uv_plain(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off, kconst,
                   dr, banded):
    """Plain PyTorch twin of the CUDA sweep (same arguments as
    :func:`sweep_uv`); a stack runs image by image."""
    if Sr.dim() == 5:
        return _per_image(sweep_uv_plain, Sr, Si, gx, gy, A0c, A0s, A1c,
                          A1s, run, off, kconst, dr, banded)
    T = _stage1_plain(Sr, Si, gx, gy, A0c, A0s, run)
    ph, wt = _stage2_plain(T, A1c, A1s, off, int(dr), bool(banded))
    return _uv_plain(ph, wt, kconst)


def sweep_pw_plain(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off, dr, banded):
    """Plain PyTorch twin of emission (a) (same arguments as
    :func:`sweep_pw`); a stack runs image by image."""
    if Sr.dim() == 5:
        return _per_image(sweep_pw_plain, Sr, Si, gx, gy, A0c, A0s, A1c,
                          A1s, run, off, dr, banded)
    T = _stage1_plain(Sr, Si, gx, gy, A0c, A0s, run)
    return _stage2_plain(T, A1c, A1s, off, int(dr), bool(banded))


def sweep_grad_plain(Sr, Si, S2r, S2i, gx, gy, A0c, A0s, A1c, A1s, A1yc,
                     A1ys, run, off, dr, banded, winners=False):
    """Plain PyTorch twin of emission (b) (same arguments as
    :func:`sweep_grad`); with `winners`, the tournament's (Re M, Im M,
    index) planes follow the four outputs. A stack runs image by
    image."""
    if Sr.dim() == 5:
        outs = [sweep_grad_plain(Sr[b], Si[b], S2r[b], S2i[b], gx, gy, A0c,
                                 A0s, A1c, A1s, A1yc, A1ys, run, off, dr,
                                 banded, winners)
                for b in range(Sr.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    T = _stage1_plain(Sr, Si, gx, gy, A0c, A0s, run)
    Tx = _stage1_plain(S2r, S2i, gx, gy, A0c, A0s, run)
    return _stage2_plain(T, A1c, A1s, off, int(dr), bool(banded), Tx, A1yc,
                         A1ys, winners)


def band_winners_plain(idx, P):
    """Plain twin of :func:`band_winners`."""
    n, m = idx.shape[-2:]
    lead = idx.shape[:-2]
    flat = idx.reshape(-1, n // TILE, TILE * m).long()
    flags = torch.zeros((flat.shape[0], n // TILE, P), dtype=torch.int32,
                        device=idx.device)
    return flags.scatter_(2, flat, 1).reshape(lead + (n // TILE, P))


def winner_products_plain(T, Tx, A1c, A1s, A1yc, A1ys, mr, mi, idx, flags,
                          off, banded, out=None):
    """Plain twin of :func:`winner_products` (its arguments; `split`
    concerns the kernel's rounding alone): per flagged (band, candidate)
    pair, the band's rows of Tx_i . B1 and T_i . B1y, and the gradients
    at the pixels the candidate wins. A stack runs image by image."""
    if T.dim() == 5:
        outs = [winner_products_plain(T[b], Tx[b], A1c, A1s, A1yc, A1ys,
                                      mr[b], mi[b], idx[b], flags[b], off,
                                      banded)
                for b in range(T.shape[0])]
        gx, gy = (torch.stack(o) for o in zip(*outs))
        if out is None:
            return gx, gy
        out[0].copy_(gx)
        out[1].copy_(gy)
        return out
    G, P, n, _ = T.shape
    m = A1c.shape[1]
    gx = torch.zeros_like(mr)
    gy = torch.zeros_like(mr)
    for g in range(G):
        B1r = torch.cat([A1c[g].T, -A1s[g].T], dim=0)   # (2 Wb, m)
        B1i = torch.cat([A1s[g].T, A1c[g].T], dim=0)
        B1yr = torch.cat([A1yc[g].T, -A1ys[g].T], dim=0)
        B1yi = torch.cat([A1ys[g].T, A1yc[g].T], dim=0)
        for band, i in flags[g].nonzero().tolist():
            rows = slice(band * TILE, (band + 1) * TILE)
            wr, wi = mr[g, rows], mi[g, rows]
            ggx = winner_gradients(wr, wi, Tx[g, i, rows] @ B1r,
                                   Tx[g, i, rows] @ B1i)
            ggy = winner_gradients(wr, wi, T[g, i, rows] @ B1yr,
                                   T[g, i, rows] @ B1yi)
            if banded:
                ggy = ggy - off[g, i].to(T.dtype) * (_TWO_PI / m)
            sel = idx[g, rows] == i
            gx[g, rows] = torch.where(sel, ggx, gx[g, rows])
            gy[g, rows] = torch.where(sel, ggy, gy[g, rows])
    if out is None:
        return gx, gy
    out[0].copy_(gx)
    out[1].copy_(gy)
    return out


def _tf32_rna(x):
    """cvt.rna.tf32.f32 of a float32 tensor by bit operations: the
    mantissa rounded to its top 10 bits, half away from zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_basis_plain(A1c, A1s):
    """The plain twin of :func:`split_basis`."""
    (ch, cl), (sh, sl) = ((hi, _tf32_rna(x - hi)) for x, hi in (
        (x, _tf32_rna(x.contiguous())) for x in (A1c, A1s)))
    return torch.stack([-sh, ch, sh, -sl, cl, sl], dim=-3)


def split_basis(A1c, A1s):
    """The column basis A1c, A1s (G, m, K) float32 split for stage 2's
    tensor cores: (G, 6, m, K) planes -hi(A1s), hi(A1c), hi(A1s),
    -lo(A1s), lo(A1c), lo(A1s) with hi = tf32(x), lo = tf32(x - hi),
    tf32 rounding to nearest with ties away from zero (cvt.rna), the
    negation a flip of the sign bit (a warpgroup's 32 columns of the
    first three planes are the rows [-s | c | s] whose windows [c | s]
    and [-s | c] the Tr and Ti products read, and likewise the lo
    planes). A CUDA tensor runs
    ``csrc/sweep.cu``'s split_basis_kernel (counted "split_basis"), a
    CPU tensor :func:`split_basis_plain`."""
    if not _on_card("split_basis", A1c):
        return split_basis_plain(A1c, A1s)
    G, m, K = A1c.shape
    for name, t in (("A1c", A1c), ("A1s", A1s)):
        _build.check_tensor("split_basis", name, t, (G, m, K),
                            torch.float32, A1c.device)
    if K % 4:
        raise ValueError(f"split_basis: K must be a multiple of 4, got {K}")
    out = torch.empty((G, 6, m, K), dtype=torch.float32, device=A1c.device)
    with torch.cuda.device(A1c.device):
        _build.check(_build.bind("sweep_split_basis", "pppiiip")(
            A1c.data_ptr(), A1s.data_ptr(), out.data_ptr(), G, m, K,
            torch.cuda.current_stream(A1c.device).cuda_stream),
            "sweep_split_basis")
    _build.launches["split_basis"] += 1
    return out


def kernel_supported(n, m, W0, Wb, P):
    """Shapes the CUDA sweep takes: n, m and the band width Wb multiples
    of TILE (any Wb: the column basis streams through shared memory),
    W0 a multiple of 16, at least one candidate."""
    return (n % TILE == 0 and m % TILE == 0 and W0 % 16 == 0
            and Wb % TILE == 0 and P >= 1)


def _check(op, Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off, kconst=None,
           grad_ops=None):
    """Raise unless the operands are what the launches of `op` take
    (windows (G, H, W0, Wb) or a stack (B, G, H, W0, Wb))."""
    if Sr.dim() not in (4, 5):
        raise ValueError(f"{op}: windows must be (G, H, W0, Wb) or (B, G, "
                         f"H, W0, Wb), got {tuple(Sr.shape)}")
    lead = tuple(Sr.shape[:-4])
    G, H, W0, Wb = Sr.shape[-4:]
    P = gx.shape[1]
    n = A0c.shape[1]
    m = A1c.shape[1]
    f32, i32 = torch.float32, torch.int32
    win = lead + (G, H, W0, Wb)
    named = [("Sr", Sr, win, f32), ("Si", Si, win, f32),
             ("gx", gx, (G, P, W0), f32), ("gy", gy, (G, P, Wb), f32),
             ("A0c", A0c, (G, n, W0), f32), ("A0s", A0s, (G, n, W0), f32),
             ("A1c", A1c, (G, m, Wb), f32), ("A1s", A1s, (G, m, Wb), f32),
             ("run", run, (G, P), i32), ("off", off, (G, P), i32)]
    if kconst is not None:
        named.append(("kconst", kconst, (G, 5), f32))
    if grad_ops is not None:
        named += [(k, t, s, f32) for k, t, s in zip(
            ("S2r", "S2i", "A1yc", "A1ys"), grad_ops,
            (win, win, (G, m, Wb), (G, m, Wb)))]
    for name, t, shape, dt in named:
        _build.check_tensor(op, name, t, shape, dt, Sr.device)
    _grid_z_ok(op, G, P)
    if not kernel_supported(n, m, W0, Wb, P):
        raise ValueError(
            f"{op} kernel needs n, m, Wb multiples of {TILE}, W0 a "
            f"multiple of 16 and P >= 1 (got n={n}, m={m}, W0={W0}, "
            f"Wb={Wb}, P={P})")


def _grid_z_ok(op, G, P):
    """Raise where one image's stage-1 grid z (G P) passes CUDA's limit
    (a stack is split into launches of whole images, an image is not)."""
    if G * P > MAX_GRID_Z:
        raise ValueError(f"{op}: G * P = {G * P} blocks on stage 1's grid z "
                         f"pass CUDA's gridDim.z limit of {MAX_GRID_Z}")


def stage1(Sr, Si, gx, gy, A0c, A0s, run, flags=None):
    """Stage 1 (checked operands): T (G, P, n, 2 Wb), or (B, G, P, n,
    2 Wb) for a stack of windows (B, G, H, W0, Wb). With band flags
    (G, n/64, P) int32, or (B, G, n/64, P) for a stack, only the rows of
    flagged (64-row band, candidate) pairs are computed (the gradient
    emission's Tx, counted as "grad_stage1"); the kernel leaves the
    others unwritten."""
    stack = Sr.dim() == 5
    if not _on_card("stage1", Sr):
        if stack:
            return torch.stack([_stage1_plain(
                Sr[b], Si[b], gx, gy, A0c, A0s, run,
                None if flags is None else flags[b])
                for b in range(Sr.shape[0])])
        return _stage1_plain(Sr, Si, gx, gy, A0c, A0s, run, flags)
    lead = tuple(Sr.shape[:-4])
    B = Sr.shape[0] if stack else 1
    G, H, W0, Wb = Sr.shape[-4:]
    P, n, dev = gx.shape[1], A0c.shape[1], Sr.device
    _grid_z_ok("stage1", G, P)
    if flags is not None:
        _build.check_tensor("stage1", "flags", flags,
                            lead + (G, n // TILE, P), torch.int32, dev)
    T = torch.empty(lead + (G, P, n, 2 * Wb), dtype=torch.float32,
                    device=dev)
    with torch.cuda.device(dev):
        _build.check(_build.bind("sweep_stage1", "pppppppppiiiiiiip")(
            Sr.data_ptr(), Si.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            A0c.data_ptr(), A0s.data_ptr(), run.data_ptr(),
            0 if flags is None else flags.data_ptr(), T.data_ptr(),
            B, G, H, P, n, W0, Wb,
            torch.cuda.current_stream(dev).cuda_stream),
            "sweep_stage1")
    if flags is not None:
        _build.launches["grad_stage1"] += 1
    return T


def stage2(T, A1c, A1s, off, dr, banded, winners=False):
    """Stage 2 on the tensor cores and the tournament (checked operands):
    the winner phase and rim-masked weight planes (G, n, m), or (B, G, n,
    m) for a stack T (B, G, P, n, 2 Wb); with winners (the gradient
    emission's tournament) also each pixel's winner: Re M, Im M
    (float32) and its candidate index (int32), shaped as the phases,
    from the same launch with a wider store."""
    stack = T.dim() == 5
    if not _on_card("stage2", T):
        if stack:
            return tuple(torch.stack(o) for o in zip(*(
                _stage2_plain(t, A1c, A1s, off, int(dr), bool(banded),
                              winners=winners)
                for t in T)))
        return _stage2_plain(T, A1c, A1s, off, int(dr), bool(banded),
                             winners=winners)
    lead = tuple(T.shape[:-4])
    B = T.shape[0] if stack else 1
    G, P, n, Wb = T.shape[-4], T.shape[-3], T.shape[-2], T.shape[-1] // 2
    m, dev = A1c.shape[1], T.device
    ph = torch.empty(lead + (G, n, m), dtype=torch.float32, device=dev)
    wt = torch.empty_like(ph)
    Bs = split_basis(A1c, A1s)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if not winners:
            _build.check(_build.bind("sweep_stage2", "pppppiiiiiiiip")(
                T.data_ptr(), Bs.data_ptr(), off.data_ptr(), ph.data_ptr(),
                wt.data_ptr(), B, G, P, n, m, Wb, int(dr),
                int(bool(banded)), stream), "sweep_stage2")
            return ph, wt
        mr = torch.empty_like(ph)
        mi = torch.empty_like(ph)
        idx = torch.empty(ph.shape, dtype=torch.int32, device=dev)
        _build.check(_build.bind("sweep_stage2_winners",
                                 "ppppppppiiiiiiiip")(
            T.data_ptr(), Bs.data_ptr(), off.data_ptr(), ph.data_ptr(),
            wt.data_ptr(), mr.data_ptr(), mi.data_ptr(), idx.data_ptr(), B,
            G, P, n, m, Wb, int(dr), int(bool(banded)), stream),
            "sweep_stage2_winners")
    return ph, wt, mr, mi, idx


def band_winners(idx, P):
    """The gradient emission's band flags: (G, n/64, P) int32, 1 where
    candidate i wins a pixel of the 64-row band of the tournament's index
    plane idx (G, n, m) int32 (values in [0, P)), else 0; a stack's
    (B, G, n, m) gives (B, G, n/64, P). One launch, counted as
    "grad_flags"; nothing waits for the host."""
    if not _on_card("band_winners", idx):
        return band_winners_plain(idx, P)
    n, m = idx.shape[-2:]
    lead = tuple(idx.shape[:-2])
    if idx.dim() < 3 or not idx.is_contiguous() \
            or idx.dtype != torch.int32:
        raise ValueError("band_winners: idx must be a contiguous int32 "
                         "tensor (G, n, m) or (B, G, n, m), got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if n % TILE or m % TILE or P < 1:
        raise ValueError(f"band_winners needs n, m multiples of {TILE} and "
                         f"P >= 1 (got n={n}, m={m}, P={P})")
    planes = idx.numel() // (n * m)
    flags = torch.empty(lead + (n // TILE, P), dtype=torch.int32,
                        device=idx.device)
    with torch.cuda.device(idx.device):
        _build.check(_build.bind("sweep_band_winners", "ppiiiip")(
            idx.data_ptr(), flags.data_ptr(), planes, P, n, m,
            torch.cuda.current_stream(idx.device).cuda_stream),
            "sweep_band_winners")
    _build.launches["grad_flags"] += 1
    return flags


def winner_products(T, Tx, A1c, A1s, A1yc, A1ys, mr, mi, idx, flags, off,
                    banded, split, out=None):
    """The gradient emission's winner products: (gx, gy) (G, n, m)
    float32, the derivatives of -angle(M) along rows and columns at
    each pixel, from its winner's M (mr, mi) and index idx (the
    tournament's store) and the products Mx = Tx_i . B1, My = T_i . B1y
    of each candidate i that wins a pixel of a tile (T, Tx (G, P, n,
    2K); A1c, A1s, A1yc, A1ys (G, m, K); flags (G, n/64, P) from
    :func:`band_winners`: only flagged rows of Tx are read); with
    `banded`, gy less off_i * 2 pi / m (off (G, P) int32). `split`
    takes the grouped sweep's tensor-core chain rounding (the small
    products in a chain of their own), else the zoom sweep's. `out`
    (two (G, n, m) float32 tensors, which may be mr and mi) receives
    the gradients. A stack carries a leading image axis on T, Tx, the
    winners, the flags and the outputs (the bases and off are shared).
    One launch, counted as "grad_products"."""
    if not _on_card("winner_products", T):
        return winner_products_plain(T, Tx, A1c, A1s, A1yc, A1ys, mr, mi,
                                     idx, flags, off, banded, out)
    lead = tuple(T.shape[:-4])
    B = T.shape[0] if lead else 1
    G, P, n, K2 = T.shape[-4:]
    m, dev = A1c.shape[1], T.device
    f32 = torch.float32
    named = [("T", T, lead + (G, P, n, K2), f32),
             ("Tx", Tx, lead + (G, P, n, K2), f32)]
    named += [(k, t, (G, m, K2 // 2), f32) for k, t in
              zip(("A1c", "A1s", "A1yc", "A1ys"), (A1c, A1s, A1yc, A1ys))]
    plane = lead + (G, n, m)
    named += [("mr", mr, plane, f32), ("mi", mi, plane, f32),
              ("idx", idx, plane, torch.int32),
              ("flags", flags, lead + (G, n // TILE, P), torch.int32)]
    if banded:
        named.append(("off", off, (G, P), torch.int32))
    gxo, gyo = out if out is not None else (torch.empty_like(mr),
                                            torch.empty_like(mr))
    named += [("gx", gxo, plane, f32), ("gy", gyo, plane, f32)]
    for name, t, shape, dt in named:
        _build.check_tensor("winner_products", name, t, shape, dt, dev)
    if n % TILE or m % TILE or K2 % (2 * TILE):
        raise ValueError(f"winner_products needs n, m, K multiples of "
                         f"{TILE} (got n={n}, m={m}, K={K2 // 2})")
    with torch.cuda.device(dev):
        _build.check(_build.bind("sweep_winner_products",
                                 "pppppppppppppiiiiiiip")(
            T.data_ptr(), Tx.data_ptr(), A1c.data_ptr(), A1s.data_ptr(),
            A1yc.data_ptr(), A1ys.data_ptr(), mr.data_ptr(), mi.data_ptr(),
            idx.data_ptr(), flags.data_ptr(),
            off.data_ptr() if banded else 0, gxo.data_ptr(), gyo.data_ptr(),
            B, G, P, n, m, K2 // 2, int(bool(split)),
            torch.cuda.current_stream(dev).cuda_stream),
            "sweep_winner_products")
    _build.launches["grad_products"] += 1
    return gxo, gyo


def winner_grads(T, S2r, S2i, gx, gy, A0c, A0s, run, A1c, A1s, A1yc, A1ys,
                 mr, mi, idx, off, banded, split, out=None):
    """Steps 2-4 of a gradient emission after its tournament (T its
    stage 1; mr, mi, idx its winners): the band flags, stage 1 of the
    row-derivative windows S2r, S2i on the flagged pairs only (Tx), and
    the winner products. Returns (gx, gy) (G, n, m), or (B, G, n, m) for
    a stack; each step runs its kernel on CUDA tensors and its plain
    twin on CPU ones."""
    P = T.shape[-3]
    flags = band_winners(idx, P)
    Tx = stage1(S2r, S2i, gx, gy, A0c, A0s, run, flags)
    return winner_products(T, Tx, A1c, A1s, A1yc, A1ys, mr, mi, idx, flags,
                           off, banded, split, out)


def epilogue(ph, wt, kconst):
    """The uv epilogue on the card: (dudx_s, dudy_s, wnorm) from the
    phase and weight planes (G, n, m), or with a leading image axis
    from a stack's (B, G, n, m)."""
    lead = tuple(ph.shape[:-3])
    G, n, m = ph.shape[-3:]
    B = ph.shape[0] if lead else 1
    if B > MAX_GRID_Z:
        raise ValueError(f"epilogue: {B} images pass CUDA's gridDim.y limit "
                         f"of {MAX_GRID_Z} (an image a row of its grid)")
    dev = ph.device
    ux = torch.empty(lead + (2, n, m), dtype=torch.float32, device=dev)
    uy = torch.empty_like(ux)
    wn = torch.empty(lead + (n, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.check(_build.bind("sweep_uv", "ppppppiiiip")(
            ph.data_ptr(), wt.data_ptr(), kconst.data_ptr(), ux.data_ptr(),
            uy.data_ptr(), wn.data_ptr(), B, G, n, m,
            torch.cuda.current_stream(dev).cuda_stream), "sweep_uv")
    return ux, uy, wn


def _on_card(op, Sr):
    """True for a CUDA tensor (the kernels), False for a CPU one (the
    twin); any other device raises."""
    if Sr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {Sr.device}")
    return Sr.device.type == "cuda"


def sweep_uv(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off, kconst, dr,
             banded):
    """Grouped banded sweep -> (dudx_s (2, n, m), dudy_s (2, n, m),
    wnorm (n, m)), float32; for a stack of B images (windows (B, G, H,
    W0, Wb)) each output has a leading image axis.

    Sr, Si : (G, H, W0, Wb) spectrum windows (pre-scaled by 1/(n*m)),
        band-sliced per run h, or a stack (B, G, H, W0, Wb).
    gx : (G, P, W0) row Gaussian factors; gy : (G, P, Wb) column
        factors band-sliced per candidate.
    A0c, A0s : (G, n, W0) row inverse-DFT bases.
    A1c, A1s : (G, m, Wb) base-band column bases.
    run, off : (G, P) int32 run index and band offset per candidate
        (candidates wy-sorted, runs consecutive).
    kconst : (G, 5) float32 (k0, k1, k0*k0, k0*k1, k1*k1) with
        (k0, k1) = 2 pi k_nominal (row, column).
    dr : interior-mask border; banded : apply the column ramp.

    Column 0 of dudx_s and row 0 of dudy_s hold no diff and are 0."""
    if not _on_card("sweep_uv", Sr):
        return sweep_uv_plain(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run,
                              off, kconst, dr, banded)
    _check("sweep_uv", Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off, kconst)
    ph, wt = stage2(stage1(Sr, Si, gx, gy, A0c, A0s, run), A1c, A1s, off,
                    dr, banded)
    out = epilogue(ph, wt, kconst)
    _build.launches["sweep_uv"] += 1
    return out


def sweep_pw(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off, dr, banded):
    """Emission (a): the winners' phase (banded column ramp applied) and
    rim-masked weight, (G, n, m) each, float32, or (B, G, n, m) for a
    stack (arguments as :func:`sweep_uv`, without kconst)."""
    if not _on_card("sweep_pw", Sr):
        return sweep_pw_plain(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off,
                              dr, banded)
    _check("sweep_pw", Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off)
    out = stage2(stage1(Sr, Si, gx, gy, A0c, A0s, run), A1c, A1s, off, dr,
                 banded)
    _build.launches["sweep_pw"] += 1
    return out


def sweep_grad(Sr, Si, S2r, S2i, gx, gy, A0c, A0s, A1c, A1s, A1yc, A1ys,
               run, off, dr, banded):
    """Emission (b): (phase, weight, grad_x, grad_y), (G, n, m) each,
    float32: emission (a) and the winners' derivatives of -angle(M)
    along rows and columns, before any rebase. S2r, S2i (G, H, W0, Wb)
    are the row-derivative windows (2 pi i f0) S band-sliced like Sr,
    Si; A1yc, A1ys (G, m, Wb) the base band's column-derivative basis
    (2 pi i f1) A1; the rest as :func:`sweep_uv`. A stack of windows
    (B, G, H, W0, Wb), S2r and S2i alike, gives (B, G, n, m) each in the
    launches of one image."""
    if not _on_card("sweep_grad", Sr):
        return sweep_grad_plain(Sr, Si, S2r, S2i, gx, gy, A0c, A0s, A1c,
                                A1s, A1yc, A1ys, run, off, dr, banded)
    _check("sweep_grad", Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off,
           grad_ops=(S2r, S2i, A1yc, A1ys))
    out = sweep_grad_steps(Sr, Si, S2r, S2i, gx, gy, A0c, A0s, A1c, A1s,
                           A1yc, A1ys, run, off, dr, banded)
    _build.launches["sweep_grad"] += 1
    return out


def sweep_grad_steps(Sr, Si, S2r, S2i, gx, gy, A0c, A0s, A1c, A1s, A1yc,
                     A1ys, run, off, dr, banded):
    """Emission (b) as its launches (arguments as :func:`sweep_grad`):
    stage 1, the tournament that stores the winners, then
    :func:`winner_grads` in the grouped sweep's chain rounding. Each
    step runs its kernel on CUDA tensors and its plain twin on CPU
    ones."""
    T = stage1(Sr, Si, gx, gy, A0c, A0s, run)
    ph, wt, mr, mi, idx = stage2(T, A1c, A1s, off, dr, banded, winners=True)
    # the gradients overwrite the winners' M, which only they read
    return (ph, wt) + tuple(winner_grads(
        T, S2r, S2i, gx, gy, A0c, A0s, run, A1c, A1s, A1yc, A1ys, mr, mi,
        idx, off, banded, True, out=(mr, mi)))
