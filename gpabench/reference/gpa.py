"""Plain Geometric Phase Analysis: the displacement field u (2, n, m) of a
lattice image from its Bragg-peak k-vectors, written from the method
(Hytch et al. 1998; the windowed-Fourier-ridge sweep of pyGPA), in plain
PyTorch, float64.

Per Bragg peak k, every candidate reference vector w of a bank around k
gives a lock-in M_w = IFFT[ FFT[image](q) exp(-2 pi^2 sigma^2 |q + w|^2) ];
each pixel keeps the candidate of largest |M_w| (the first on a tie), and
its phase, relative to k, is arg(M_w e^{2 pi i k.r}). Its weight is |M_w|
inside a 2 sigma border and 1e-6 of it on the border. The wrapped phase
differences along each axis give, per pixel, the weighted least-squares
gradient of u (2 pi K grad u = d phase, weights squared), and each
component of u is the weighted least-squares integral of its gradient
(the normal equations solved by conjugate gradients to convergence,
preconditioned by the Neumann Laplacian's DCT inverse), with
min-neighbour squared weights of the peaks' weight norm.

Nothing here imports the program under test.
"""
import math

import numpy as np
import torch

from .precision import Store

F64 = torch.float64


def factory_banks(kvecs, kwscale=2.5, ksteps=3):
    """The factory's banks: a (2 ksteps)^2 grid of candidates around each
    k, spaced kw / ksteps from k - kw, kw = mean |k| / kwscale."""
    kvecs = np.asarray(kvecs, np.float64)
    kw = np.linalg.norm(kvecs, axis=1).mean() / kwscale
    steps = kw / ksteps * np.arange(2 * ksteps)
    out = []
    for k in kvecs:
        wx, wy = np.meshgrid(k[0] - kw + steps, k[1] - kw + steps,
                             indexing="ij")
        out.append(np.stack([wx.ravel(), wy.ravel()], -1))
    return out


def eager_banks(kvecs, kwscale=2.5, ksteps=3):
    """The eager call's banks: np.arange from k - kw to k + kw in steps
    of kw / ksteps along each axis."""
    kvecs = np.asarray(kvecs)
    kw = np.linalg.norm(kvecs, axis=1).mean() / kwscale
    kstep = kw / ksteps
    out = []
    for k in kvecs:
        wx, wy = np.meshgrid(np.arange(k[0] - kw, k[0] + kw, kstep),
                             np.arange(k[1] - kw, k[1] + kw, kstep),
                             indexing="ij")
        out.append(np.stack([wx.ravel(), wy.ravel()], -1).astype(np.float64))
    return out


def default_sigma(kvecs):
    return int(np.ceil(1 / np.linalg.norm(np.asarray(kvecs), axis=1).min()))


def fftfreq(n, device):
    k = torch.arange(n, dtype=F64, device=device)
    return torch.where(k < (n + 1) // 2, k, k - n) / n


def wfr_lockin(spectrum, bank, k, sigma, store=Store()):
    """The winning lock-in of one peak, rebased to k: (n, m) complex."""
    n, m = spectrum.shape
    dev = spectrum.device
    fx, fy = fftfreq(n, dev), fftfreq(m, dev)
    s2 = 2 * math.pi ** 2 * sigma ** 2
    best_a = torch.zeros((n, m), dtype=F64, device=dev)
    best = torch.zeros((n, m), dtype=torch.complex128, device=dev)
    for w in bank:
        g = torch.exp(-s2 * (fx + float(w[0])) ** 2)[:, None] \
            * torch.exp(-s2 * (fy + float(w[1])) ** 2)[None, :]
        M = store(torch.fft.ifft2(spectrum * g))
        a = M.real ** 2 + M.imag ** 2
        better = a > best_a
        best_a = torch.where(better, a, best_a)
        best = torch.where(better, M, best)
        del M, a, better
    x = torch.arange(n, dtype=F64, device=dev)[:, None]
    y = torch.arange(m, dtype=F64, device=dev)[None, :]
    ph = 2 * math.pi * (float(k[0]) * x + float(k[1]) * y)
    return store(best * torch.complex(torch.cos(ph), torch.sin(ph)))


def rim(n, m, dr, device):
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(m, device=device)[None, :]
    inside = (i >= dr) & (i < n - dr) & (j >= dr) & (j < m - dr)
    return torch.where(inside, 1.0 + 1e-6, 1e-6).to(F64)


def wrap(x):
    return x - 2 * math.pi * torch.floor(x / (2 * math.pi) + 0.5)


def lstsq_gradient(d, K, w):
    """Per pixel, x (2, ...) minimising sum_g w_g^2 (K_g . x - d_g)^2."""
    ww = w * w
    k0 = K[:, 0].reshape((-1,) + (1,) * (d.dim() - 1))
    k1 = K[:, 1].reshape((-1,) + (1,) * (d.dim() - 1))
    a00, a01, a11 = (ww * k0 * k0).sum(0), (ww * k0 * k1).sum(0), \
        (ww * k1 * k1).sum(0)
    r0, r1 = (ww * k0 * d).sum(0), (ww * k1 * d).sum(0)
    det = a00 * a11 - a01 * a01
    return torch.stack([(a11 * r0 - a01 * r1) / det,
                        (a00 * r1 - a01 * r0) / det])


def _dct(x, dim):
    """DCT-II (unnormalised, scipy's) along `dim` by a 2N real FFT."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    v = torch.cat([x, x.flip(-1)], -1)
    V = torch.fft.rfft(v)[..., :n]
    k = torch.arange(n, dtype=F64, device=x.device)
    tw = torch.exp(-1j * math.pi * k / (2 * n))
    return (V * tw).real.movedim(-1, dim)


def _idct(X, dim):
    """Inverse of _dct along `dim`."""
    X = X.movedim(dim, -1)
    n = X.shape[-1]
    k = torch.arange(n, dtype=F64, device=X.device)
    tw = torch.exp(1j * math.pi * k / (2 * n))
    V = X * tw
    V = torch.cat([V, torch.zeros_like(V[..., :1])], -1)
    return torch.fft.irfft(V, n=2 * n)[..., :n].movedim(-1, dim)


def _dx(p):
    return p[..., :, 1:] - p[..., :, :-1]


def _dy(p):
    return p[..., 1:, :] - p[..., :-1, :]


def _dxT(v):
    z = torch.zeros_like(v[..., :, :1])
    return torch.cat([z, v], -1) - torch.cat([v, z], -1)


def _dyT(v):
    z = torch.zeros_like(v[..., :1, :])
    return torch.cat([z, v], -2) - torch.cat([v, z], -2)


def ls_integrate(gx, gy, wn, iters=300, tol=1e-8):
    """Weighted least-squares integral phi (..., n, m) of the gradient
    (gx (..., n, m-1) along the last axis, gy (..., n-1, m) along the
    one before) with min-neighbour squared weights of wn (n, m): the
    normal equations by preconditioned conjugate gradients from zero,
    to a relative residual `tol` or `iters` iterations. phi is
    defined up to a constant."""
    WW = wn * wn
    WWx = torch.minimum(WW[..., :, :-1], WW[..., :, 1:])
    WWy = torch.minimum(WW[..., :-1, :], WW[..., 1:, :])
    n, m = wn.shape[-2:]
    dev = wn.device
    i = torch.arange(n, dtype=F64, device=dev)[:, None]
    j = torch.arange(m, dtype=F64, device=dev)[None, :]
    lam = 4 - 2 * torch.cos(math.pi * i / n) - 2 * torch.cos(math.pi * j / m)
    lam[0, 0] = 1.0

    def A(p):
        return _dxT(WWx * _dx(p)) + _dyT(WWy * _dy(p))

    def M(r):
        R = _dct(_dct(r, -1), -2) / lam
        R[..., 0, 0] = 0.0
        return _idct(_idct(R, -2), -1)

    b = _dxT(WWx * gx) + _dyT(WWy * gy)
    lead = (-2, -1)
    phi = torch.zeros_like(b)
    r = b.clone()
    z = M(r)
    p = z.clone()
    rz = (r * z).sum(lead, keepdim=True)
    b_norm = torch.sqrt((b * b).sum(lead, keepdim=True)).clamp_min(1e-300)
    for _ in range(iters):
        Ap = A(p)
        alpha = rz / (p * Ap).sum(lead, keepdim=True)
        phi = phi + alpha * p
        r = r - alpha * Ap
        if bool((torch.sqrt((r * r).sum(lead, keepdim=True))
                 <= tol * b_norm).all()):
            break
        z = M(r)
        rz_new = (r * z).sum(lead, keepdim=True)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return phi


def displacement(image, kvecs, banks, sigma=None, store=Store(),
                 integrate=None):
    """u (2, n, m) of one image (n, m) from its k-vectors (G, 2) and one
    candidate bank (P_g, 2) per k-vector; `integrate` (dudx, dudy, wn) ->
    u, the least-squares integral by default (reference.multigrid's for
    the factory's multigrid)."""
    kvecs = np.asarray(kvecs, np.float64)
    if sigma is None:
        sigma = default_sigma(kvecs)
    img = store(torch.as_tensor(image).to(F64))
    img = img - img.mean()
    n, m = img.shape
    spectrum = torch.fft.fft2(img)
    weight_rim = rim(n, m, 2 * sigma, img.device)
    phases, weights = [], []
    for k, bank in zip(kvecs, banks):
        L = wfr_lockin(spectrum, bank, k, sigma, store)
        phases.append(store(torch.angle(L)))
        weights.append(store(L.abs() * weight_rim))
        del L
    del spectrum
    ph, wt = torch.stack(phases), torch.stack(weights)
    K = torch.as_tensor(2 * math.pi * kvecs, dtype=F64, device=img.device)
    dudx = store(lstsq_gradient(wrap(_dx(ph)), K, wt[..., :, :-1]))
    dudy = store(lstsq_gradient(wrap(_dy(ph)), K, wt[..., :-1, :]))
    wn = torch.sqrt((wt * wt).sum(0))
    return store((integrate or ls_integrate)(dudx, dudy, wn))
