"""Plain versions of the quick start's steps after the peaks' lattice:
Bragg-peak detection, k refinement by lock-in and plane fit, the
Lawler-Fujita undistortion and the unit-cell drizzle, in plain PyTorch
and NumPy, float64. Written from the methods (pyGPA's quick start):

- peaks: the Moisan periodic component's |FFT| (fftshifted), smoothed
  by a Gaussian of sigma 1 bin (less its sigma-50 smoothing for the
  difference-of-Gaussians form); the three strongest local maxima in
  the annulus 2 < r < 200 bins, one of each +/- pair, as k-vectors; in
  the sub-bin form, each shifted to the vertex of the parabola through
  its row and its column.
- refinement: three rounds of lock-in at k + corr (sigma ceil(1 / min
  |k|), 5-pixel edge trimmed), weighted least-squares unwrap (weights
  sqrt(|lock-in| / max)), Huber plane fit (f_scale 1, 60 reweighting
  steps), corr -= slope / 2 pi.
- undistortion: u_inv solves u_inv(r) = -u(r + u_inv(r)) (fixed point,
  cubic B-spline sampling of u); the image is sampled by its cubic
  B-spline at r + u_inv(r), 0 outside it. Both splines mirror the samples
  beyond the border, which moves values only within ~20 px of it.
- unit cell: every pixel at r + u(r) goes to the cell position
  ((A x) mod 1 mapped back by A^-1, less the cell's corner, times z) and
  adds its value and unit weight bilinearly to the 2 x 2 bins there.

Nothing here imports the program under test.
"""
import itertools
import math

import numpy as np
import torch

from .gpa import F64, fftfreq, ls_integrate, wrap, _dx, _dy
from .precision import Store


# --------------------------------------------------------------- peaks

def periodic_spectrum(img):
    """FFT of the Moisan periodic component of img (n, m), float64."""
    n, m = img.shape
    dev = img.device
    v = torch.zeros_like(img)
    v[0, :] += img[-1, :] - img[0, :]
    v[-1, :] += img[0, :] - img[-1, :]
    v[:, 0] += img[:, -1] - img[:, 0]
    v[:, -1] += img[:, 0] - img[:, -1]
    cq = torch.cos(2 * math.pi * fftfreq(n, dev))[:, None]
    cr = torch.cos(2 * math.pi * fftfreq(m, dev))[None, :]
    den = 2 * cq + 2 * cr - 4
    den[0, 0] = 1.0
    S = torch.fft.fft2(v) / den
    S[0, 0] = 0.0
    return torch.fft.fft2(img) - S


def gaussian_smooth(x, sigma):
    n, m = x.shape
    dev = x.device
    g = torch.exp(-2 * math.pi ** 2 * sigma ** 2
                  * (fftfreq(n, dev)[:, None] ** 2
                     + fftfreq(m, dev)[None, :] ** 2))
    return torch.fft.ifft2(torch.fft.fft2(x) * g).real


def peak_image(img, dog, store=Store()):
    img = store(torch.as_tensor(img).to(F64))
    img = img - img.mean()
    mag = store(torch.fft.fftshift(periodic_spectrum(img)).abs())
    smooth = gaussian_smooth(mag, 1.0)
    if dog:
        smooth = smooth - gaussian_smooth(mag, 50.0)
    return store(smooth)


def primary_ks(img, dog=True, subpixel=False, store=Store(), rlo=2, rhi=200):
    """The three primary k-vectors (3, 2), each turned to a non-negative
    first coordinate (the second where the first is 0)."""
    sm = peak_image(img, dog, store)
    n, m = sm.shape
    pad = torch.nn.functional.pad(sm[None, None], (1, 1, 1, 1),
                                  value=-math.inf)[0, 0]
    nb = torch.stack([pad[1 + di:n + 1 + di, 1 + dj:m + 1 + dj]
                      for di in (-1, 0, 1) for dj in (-1, 0, 1)
                      if di or dj])
    is_max = (sm >= nb.max(0).values)
    ii = torch.arange(n, device=sm.device)[:, None] - n // 2
    jj = torch.arange(m, device=sm.device)[None, :] - m // 2
    r2 = ii * ii + jj * jj
    is_max &= (r2 > rlo * rlo) & (r2 < rhi * rhi)
    vals = torch.where(is_max, sm, -math.inf).reshape(-1)
    top = torch.topk(vals, 12)
    h = sm.cpu().numpy()
    found = []
    for v, flat in zip(top.values.tolist(), top.indices.tolist()):
        i, j = divmod(flat, m)
        k = np.array([(i - n // 2) / n, (j - m // 2) / m])
        if subpixel:
            di = 0.5 * (h[i - 1, j] - h[i + 1, j]) \
                / (h[i - 1, j] - 2 * h[i, j] + h[i + 1, j])
            dj = 0.5 * (h[i, j - 1] - h[i, j + 1]) \
                / (h[i, j - 1] - 2 * h[i, j] + h[i, j + 1])
            k = k + np.array([np.clip(di, -0.5, 0.5) / n,
                              np.clip(dj, -0.5, 0.5) / m])
        k = canonical(k)
        if not any(np.allclose(k, f, atol=1e-9) for f in found):
            found.append(k)
        if len(found) == 3:
            break
    if len(found) != 3:
        raise RuntimeError(f"reference peaks: {len(found)} primary ks")
    return np.array(found)


def canonical(k):
    """k turned to a non-negative first coordinate (second where the
    first is 0)."""
    k = np.asarray(k, np.float64)
    s = np.sign(k[0]) if k[0] != 0 else np.sign(k[1])
    return k * (s if s != 0 else 1.0)


def match(got, want):
    """got (G, 2) reordered and signed to lie nearest want (G, 2); the
    distances (G,) in cycles per pixel."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    best, best_d = None, None
    for perm in itertools.permutations(range(len(got))):
        g = got[list(perm)]
        d = np.minimum(np.linalg.norm(g - want, axis=1),
                       np.linalg.norm(g + want, axis=1))
        if best_d is None or d.max() < best_d.max():
            best, best_d = g, d
    sign = np.where(np.linalg.norm(best - want, axis=1)
                    <= np.linalg.norm(best + want, axis=1), 1.0, -1.0)
    return best * sign[:, None], best_d


# --------------------------------------------------------- refinement

def lockin(img, k, sigma):
    """Lock-in of img (n, m) at k: IFFT[G_sigma FFT[img e^{2 pi i k.r}]]."""
    n, m = img.shape
    dev = img.device
    x = torch.arange(n, dtype=F64, device=dev)[:, None]
    y = torch.arange(m, dtype=F64, device=dev)[None, :]
    ph = 2 * math.pi * (float(k[0]) * x + float(k[1]) * y)
    X = torch.fft.fft2(img * torch.complex(torch.cos(ph), torch.sin(ph)))
    g = torch.exp(-2 * math.pi ** 2 * sigma ** 2
                  * (fftfreq(n, dev)[:, None] ** 2
                     + fftfreq(m, dev)[None, :] ** 2))
    return torch.fft.ifft2(X * g)


def unwrap(psi, weight):
    """Weighted least-squares unwrap of the phase psi (n, m)."""
    return ls_integrate(wrap(_dx(psi)), wrap(_dy(psi)), weight)


def huber_plane(z, iters=60, f_scale=1.0):
    """(a0, a1, a2) of the Huber-loss plane a0 x + a1 y + a2 through z
    (n, m), x and y the pixel indices along the two axes, by iteratively
    reweighted least squares (weights min(1, f_scale / |r|)), from the
    unweighted fit and `iters` reweighting steps."""
    n, m = z.shape
    dev = z.device
    x = (torch.arange(n, dtype=F64, device=dev) - (n - 1) / 2)[:, None]
    y = (torch.arange(m, dtype=F64, device=dev) - (m - 1) / 2)[None, :]
    w = torch.ones_like(z)
    p = None
    for _ in range(iters + 1):
        wx, wy = w * x, w * y
        A = torch.stack([torch.stack([(wx * x).sum(), (wx * y).sum(),
                                      wx.sum()]),
                         torch.stack([(wx * y).sum(), (wy * y).sum(),
                                      wy.sum()]),
                         torch.stack([wx.sum(), wy.sum(), w.sum()])])
        rhs = torch.stack([(wx * z).sum(), (wy * z).sum(), (w * z).sum()])
        p = torch.linalg.solve(A, rhs)
        r = z - (p[0] * x + p[1] * y + p[2])
        w = torch.clamp(f_scale / r.abs().clamp_min(1e-300), max=1.0)
    return torch.stack([p[0], p[1], p[2] - p[0] * (n - 1) / 2
                        - p[1] * (m - 1) / 2])


def refine_ks(img, kvecs, iters=3, edge=5, store=Store()):
    """k-vectors refined to sub-bin accuracy (G, 2), host float64."""
    kvecs = np.asarray(kvecs, np.float64)
    sigma = int(np.ceil(1 / np.linalg.norm(kvecs, axis=1).min()))
    img = store(torch.as_tensor(img).to(F64))
    corr = np.zeros_like(kvecs)
    for _ in range(iters):
        for g, k in enumerate(kvecs):
            rs = store(lockin(img, k + corr[g], sigma))[edge:-edge,
                                                        edge:-edge]
            w = rs.abs()
            wn = store(torch.sqrt(w / w.max()))
            phi = store(unwrap(store(torch.angle(rs)), wn))
            p = huber_plane(phi)
            corr[g] -= p[:2].cpu().numpy() / (2 * math.pi)
        corr = store.ks(corr)
    return store.ks(kvecs + corr)


# -------------------------------------------------------- resampling

def bspline_coefficients(x):
    """Cubic B-spline coefficients c of x (n, m): (c[i-1] + 4 c[i] +
    c[i+1]) / 6 = x[i] along each axis, the image mirrored (whole-sample)
    beyond its edges. Computed by the FFT of the mirrored extension."""
    for dim in (-1, -2):
        x = x.movedim(dim, -1)
        n = x.shape[-1]
        ext = torch.cat([x, x[..., 1:-1].flip(-1)], -1)      # period 2n - 2
        L = ext.shape[-1]
        w = 2 * math.pi * torch.arange(L // 2 + 1, dtype=F64,
                                       device=x.device) / L
        c = torch.fft.irfft(torch.fft.rfft(ext) * 6 / (4 + 2 * torch.cos(w)),
                            n=L)[..., :n]
        x = c.movedim(-1, dim)
    return x


def _b3(t):
    t2, t3 = t * t, t * t * t
    return ((1 - t) ** 3 / 6, (3 * t3 - 6 * t2 + 4) / 6,
            (-3 * t3 + 3 * t2 + 3 * t + 1) / 6, t3 / 6)


def _mirror(i, n):
    """Whole-sample mirrored index into [0, n - 1] (one reflection)."""
    i = i.clamp(-(n - 1), 2 * (n - 1)).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def bspline_sample(c, X, Y, fill=None):
    """The cubic B-spline with coefficients c (n, m), mirrored beyond the
    border as they were filtered, at positions (X, Y) (row, column); with
    `fill`, positions outside [0, n - 1] x [0, m - 1] give `fill`."""
    n, m = c.shape
    x0, y0 = torch.floor(X), torch.floor(Y)
    wx, wy = _b3(X - x0), _b3(Y - y0)
    x0, y0 = x0.long(), y0.long()
    out = torch.zeros_like(X)
    flat = c.reshape(-1)
    for a in range(4):
        xi = _mirror(x0 + a - 1, n)
        for b in range(4):
            yi = _mirror(y0 + b - 1, m)
            out += wx[a] * wy[b] * flat[xi * m + yi]
    if fill is not None:
        out = torch.where((X < 0) | (X > n - 1) | (Y < 0) | (Y > m - 1),
                          torch.full_like(out, fill), out)
    return out


def undistort(img, u, iters=35, store=Store()):
    """The Lawler-Fujita undistortion of img (n, m) by u (2, n, m)."""
    img = store(torch.as_tensor(img).to(F64))
    u = store(torch.as_tensor(u).to(F64))
    n, m = img.shape
    dev = img.device
    X = torch.arange(n, dtype=F64, device=dev)[:, None].expand(n, m)
    Y = torch.arange(m, dtype=F64, device=dev)[None, :].expand(n, m)
    cu = [bspline_coefficients(-u[i]) for i in (0, 1)]
    v = torch.zeros_like(u)
    for _ in range(iters + 1):
        v = torch.stack([bspline_sample(cu[i], X + v[0], Y + v[1])
                         for i in (0, 1)])
    v = store(v)
    return store(bspline_sample(bspline_coefficients(img), X + v[0],
                                Y + v[1], fill=0.0))


# --------------------------------------------------------- unit cell

def cell_shape(ks, z):
    ks = np.asarray(ks, np.float64)
    corners = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]])
    cv = corners @ np.linalg.inv(ks).T
    rmin = cv.min(axis=0)
    return rmin, tuple((z * np.ceil(cv.max(axis=0)
                                    - np.floor(rmin))).astype(int))


def unit_cell(img, ks, u, z, store=Store()):
    """(average (R0, R1), weights (R0, R1)) of the drizzle of img into
    the unit cell of ks (2, 2) at zoom z."""
    A = np.asarray(ks, np.float64)
    B = np.linalg.inv(A)
    rmin, (R0, R1) = cell_shape(A, z)
    img = store(torch.as_tensor(img).to(F64))
    u = store(torch.as_tensor(u).to(F64))
    n, m = img.shape
    dev = img.device
    X = torch.arange(n, dtype=F64, device=dev)[:, None] + u[0]
    Y = torch.arange(m, dtype=F64, device=dev)[None, :] + u[1]
    f0 = A[0, 0] * X + A[0, 1] * Y
    f1 = A[1, 0] * X + A[1, 1] * Y
    f0, f1 = f0 - torch.floor(f0), f1 - torch.floor(f1)
    P0 = (B[0, 0] * f0 + B[0, 1] * f1 - rmin[0]) * z
    P1 = (B[1, 0] * f0 + B[1, 1] * f1 - rmin[1]) * z
    r0, c0 = torch.floor(P0), torch.floor(P1)
    t0, t1 = P0 - r0, P1 - c0
    r0, c0 = r0.long(), c0.long()
    total = torch.zeros(R0 * R1, dtype=F64, device=dev)
    weight = torch.zeros_like(total)
    for a, ha in ((0, 1 - t0), (1, t0)):
        for b, hb in ((0, 1 - t1), (1, t1)):
            r, c = r0 + a, c0 + b
            ok = (r >= 0) & (r < R0) & (c >= 0) & (c < R1)
            idx = torch.where(ok, r * R1 + c, 0).reshape(-1)
            h = torch.where(ok, ha * hb, 0.0).reshape(-1)
            total.index_add_(0, idx, h * img.reshape(-1))
            weight.index_add_(0, idx, h)
    total, weight = total.reshape(R0, R1), weight.reshape(R0, R1)
    return store(total / weight), weight
