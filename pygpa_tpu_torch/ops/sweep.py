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
   rows into a (G, P, n, 2*Wb) float32 scratch (float32 FMA); with
   gradients once more on the row-derivative windows S2 = (2 pi i f0) S,
   giving Tx;
2. stage 2 + tournament: M_i = T_i @ [A1c | -A1s], [A1s | A1c] per
   64x64 pixel tile on the tensor cores (``csrc/sweep_tc.cuh``, shared
   with the zoom sweep: 3xTF32 ``mma.sync``, tensor-core chains that
   restart every 32 columns of Wb with float32 adds between, the hi.hi
   products in a chain apart from the two small ones, T and the column
   basis streamed through a ``cp.async`` ring, so any Wb that is a
   multiple of 64 runs), looped over the candidates with the running
   best kept in registers; emits the phase and weight planes (G, n, m);
   with gradients each tile then runs Tx_i @ B1 and T_i @ B1y (the
   base band's f1-scaled basis A1y = (2 pi i f1) A1) for just the
   candidates that win one of its pixels, and the banded winner's
   column gradient takes away its ramp's slope off * 2 pi / m;
3. (uv) the uv epilogue, one thread per pixel reading its left and
   upper neighbours from device memory.

What bounds it on an H100: stage 2's G*P*n*m*Wb complex multiply-adds
(1.86 TFLOP at the 4096^2 bench shapes), three times over at the
dense TF32 rate (~11.3 ms; 27.8 ms in float32 FMA outside the tensor
cores), plus stage 1. The design keeps the (G, P, n, m) candidate
planes out of memory entirely (the tournament never leaves registers)
and schedules the column tiles of one 64-row band next to each other,
so the band's slice of T (2.4 MB per peak) is re-read from L2 rather
than device memory. The kernel's stage 2 lies nearer its float64 value
than the float32 twin's does, so chip_smoke.py holds its path to the
path with a float64 sweep. ``stage1``, ``stage2`` and ``epilogue``
launch one kernel each on checked operands (chip_smoke.py times them
apart; the zoom sweep reuses ``stage1``). Launch counts: "sweep_uv",
"sweep_pw" (a), "sweep_grad" (b).

The uv epilogue wraps its phase differences with :func:`wrap_diff`,
not the reference's (x + pi) form, which rounds a near-zero float32
difference to the spacing at pi: a coherent bias that the unwrap
integrates into a ~1e-3 px ripple on the bench fixture.

The plain twins :func:`sweep_uv_plain`, :func:`sweep_pw_plain` and
:func:`sweep_grad_plain` run the same stages with torch ops;
:func:`sweep_uv`, :func:`sweep_pw` and :func:`sweep_grad` send a CPU
tensor there and a CUDA tensor to the kernels.
"""
import torch

from . import _build

_PI = 3.14159265358979
_TWO_PI = 6.283185307179586
TILE = 64          # stage-1/2 output tile (rows x columns), csrc/sweep.cu


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
    return torch.where(interior,
                       torch.tensor(1.0 + 1e-6, dtype=dtype, device=device),
                       torch.tensor(1e-6, dtype=dtype, device=device))


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


def _stage1_plain(Sr, Si, gx, gy, A0c, A0s, run):
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
    return torch.stack(Ts)                        # (G, P, n, 2 Wb)


def _stage2_plain(T, A1c, A1s, off, dr, banded, Tx=None, A1yc=None,
                  A1ys=None):
    G, P, n, _ = T.shape
    m = A1c.shape[1]
    dev = T.device
    jj = torch.arange(m, device=dev)[None, :]
    mask = rim_weights(n, m, dr, T.dtype, dev)
    grad = Tx is not None
    phs, wts, gxs, gys = [], [], [], []
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
                if grad:
                    bgx, bgy = ggx, ggy
                continue
            sel = absq > ba
            ba = torch.where(sel, absq, ba)
            br = torch.where(sel, mr, br)
            bi = torch.where(sel, mi, bi)
            bo = torch.where(sel, offg[i], bo)
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
    out = (torch.stack(phs), torch.stack(wts))
    return out + (torch.stack(gxs), torch.stack(gys)) if grad else out


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


def sweep_uv_plain(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off, kconst,
                   dr, banded):
    """Plain PyTorch twin of the CUDA sweep (same arguments as
    :func:`sweep_uv`)."""
    T = _stage1_plain(Sr, Si, gx, gy, A0c, A0s, run)
    ph, wt = _stage2_plain(T, A1c, A1s, off, int(dr), bool(banded))
    return _uv_plain(ph, wt, kconst)


def sweep_pw_plain(Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off, dr, banded):
    """Plain PyTorch twin of emission (a) (same arguments as
    :func:`sweep_pw`)."""
    T = _stage1_plain(Sr, Si, gx, gy, A0c, A0s, run)
    return _stage2_plain(T, A1c, A1s, off, int(dr), bool(banded))


def sweep_grad_plain(Sr, Si, S2r, S2i, gx, gy, A0c, A0s, A1c, A1s, A1yc,
                     A1ys, run, off, dr, banded):
    """Plain PyTorch twin of emission (b) (same arguments as
    :func:`sweep_grad`)."""
    T = _stage1_plain(Sr, Si, gx, gy, A0c, A0s, run)
    Tx = _stage1_plain(S2r, S2i, gx, gy, A0c, A0s, run)
    return _stage2_plain(T, A1c, A1s, off, int(dr), bool(banded), Tx, A1yc,
                         A1ys)


def kernel_supported(n, m, W0, Wb, P):
    """Shapes the CUDA sweep takes: n, m and the band width Wb multiples
    of TILE (any Wb: the column basis streams through shared memory),
    W0 a multiple of 16, at least one candidate."""
    return (n % TILE == 0 and m % TILE == 0 and W0 % 16 == 0
            and Wb % TILE == 0 and P >= 1)


def _check(op, Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off, kconst=None,
           grad_ops=None):
    """Raise unless the operands are what the launches of `op` take."""
    G, H, W0, Wb = Sr.shape
    P = gx.shape[1]
    n = A0c.shape[1]
    m = A1c.shape[1]
    f32, i32 = torch.float32, torch.int32
    named = [("Sr", Sr, (G, H, W0, Wb), f32), ("Si", Si, (G, H, W0, Wb), f32),
             ("gx", gx, (G, P, W0), f32), ("gy", gy, (G, P, Wb), f32),
             ("A0c", A0c, (G, n, W0), f32), ("A0s", A0s, (G, n, W0), f32),
             ("A1c", A1c, (G, m, Wb), f32), ("A1s", A1s, (G, m, Wb), f32),
             ("run", run, (G, P), i32), ("off", off, (G, P), i32)]
    if kconst is not None:
        named.append(("kconst", kconst, (G, 5), f32))
    if grad_ops is not None:
        named += [(k, t, s, f32) for k, t, s in zip(
            ("S2r", "S2i", "A1yc", "A1ys"), grad_ops,
            ((G, H, W0, Wb), (G, H, W0, Wb), (G, m, Wb), (G, m, Wb)))]
    for name, t, shape, dt in named:
        _build.check_tensor(op, name, t, shape, dt, Sr.device)
    if not kernel_supported(n, m, W0, Wb, P):
        raise ValueError(
            f"{op} kernel needs n, m, Wb multiples of {TILE}, W0 a "
            f"multiple of 16 and P >= 1 (got n={n}, m={m}, W0={W0}, "
            f"Wb={Wb}, P={P})")


def stage1(Sr, Si, gx, gy, A0c, A0s, run):
    """Stage 1 on the card (checked operands): T (G, P, n, 2 Wb)."""
    G, H, W0, Wb = Sr.shape
    P, n, dev = gx.shape[1], A0c.shape[1], Sr.device
    T = torch.empty((G, P, n, 2 * Wb), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.check(_build.bind("sweep_stage1", "ppppppppiiiiiip")(
            Sr.data_ptr(), Si.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            A0c.data_ptr(), A0s.data_ptr(), run.data_ptr(), T.data_ptr(),
            G, H, P, n, W0, Wb, torch.cuda.current_stream(dev).cuda_stream),
            "sweep_stage1")
    return T


def stage2(T, A1c, A1s, off, dr, banded, Tx=None, A1yc=None, A1ys=None):
    """Stage 2 on the tensor cores and the tournament (checked operands):
    the winner phase and rim-masked weight planes (G, n, m), and with Tx
    (stage 1 of the row-derivative windows) and the base band's
    f1-scaled basis A1yc, A1ys also the winners' gradients (G, n, m)."""
    G, P, n, Wb = T.shape[0], T.shape[1], T.shape[2], T.shape[3] // 2
    m, dev = A1c.shape[1], T.device
    ph = torch.empty((G, n, m), dtype=torch.float32, device=dev)
    wt = torch.empty_like(ph)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if Tx is None:
            _build.check(_build.bind("sweep_stage2", "ppppppiiiiiiip")(
                T.data_ptr(), A1c.data_ptr(), A1s.data_ptr(), off.data_ptr(),
                ph.data_ptr(), wt.data_ptr(), G, P, n, m, Wb, int(dr),
                int(bool(banded)), stream), "sweep_stage2")
            return ph, wt
        gxo = torch.empty_like(ph)
        gyo = torch.empty_like(ph)
        _build.check(_build.bind("sweep_stage2_grad", "pppppppppppiiiiiiip")(
            T.data_ptr(), Tx.data_ptr(), A1c.data_ptr(), A1s.data_ptr(),
            A1yc.data_ptr(), A1ys.data_ptr(), off.data_ptr(), ph.data_ptr(),
            wt.data_ptr(), gxo.data_ptr(), gyo.data_ptr(), G, P, n, m, Wb,
            int(dr), int(bool(banded)), stream), "sweep_stage2_grad")
    return ph, wt, gxo, gyo


def epilogue(ph, wt, kconst):
    """The uv epilogue on the card: (dudx_s, dudy_s, wnorm)."""
    G, n, m = ph.shape
    dev = ph.device
    ux = torch.empty((2, n, m), dtype=torch.float32, device=dev)
    uy = torch.empty_like(ux)
    wn = torch.empty((n, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.check(_build.bind("sweep_uv", "ppppppiiip")(
            ph.data_ptr(), wt.data_ptr(), kconst.data_ptr(), ux.data_ptr(),
            uy.data_ptr(), wn.data_ptr(), G, n, m,
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
    wnorm (n, m)), float32.

    Sr, Si : (G, H, W0, Wb) spectrum windows (pre-scaled by 1/(n*m)),
        band-sliced per run h.
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
    rim-masked weight, (G, n, m) each, float32 (arguments as
    :func:`sweep_uv`, without kconst)."""
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
    (2 pi i f1) A1; the rest as :func:`sweep_uv`."""
    if not _on_card("sweep_grad", Sr):
        return sweep_grad_plain(Sr, Si, S2r, S2i, gx, gy, A0c, A0s, A1c,
                                A1s, A1yc, A1ys, run, off, dr, banded)
    _check("sweep_grad", Sr, Si, gx, gy, A0c, A0s, A1c, A1s, run, off,
           grad_ops=(S2r, S2i, A1yc, A1ys))
    T = stage1(Sr, Si, gx, gy, A0c, A0s, run)
    Tx = stage1(S2r, S2i, gx, gy, A0c, A0s, run)
    out = stage2(T, A1c, A1s, off, dr, banded, Tx, A1yc, A1ys)
    _build.launches["sweep_grad"] += 1
    return out
