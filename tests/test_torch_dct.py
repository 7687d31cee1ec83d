"""The port's single-pass DCT (pygpa_tpu_torch.ops.dct, plain twins on
the CPU) against pygpa_tpu.ops.pallas_dct2 in interpret mode and
scipy.fft, the kernels' FFT form with their twiddle tables against
scipy through a float64 numpy emulation of the kernels' arithmetic (at
every plan: the DCT kernels' lengths and the multigrid CG's; and the
early-stopping CG's chirp-z pass at even lengths whose half has no
plan, on 1-D lines), and the dct2n/idct2n route against the reference's
_pallas_dct_ok gate."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.fft import dct as sdct
from scipy.fft import idct as sidct

import pygpa_tpu.core.fourier as JF
from pygpa_tpu.ops import pallas_dct2 as JD
from pygpa_tpu_torch.core import fourier as TF
from pygpa_tpu_torch.ops import _build
from pygpa_tpu_torch.ops import dct as TD

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [1024, 2048])
def test_twins_match_interpret_kernel_and_scipy(n):
    """Float64 (the conftest enables x64), as tests/test_core.py holds
    the Pallas kernels to scipy: forward to 1e-9, inverse to 1e-11."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, n))
    y = sdct(x, type=2, axis=-1)
    got = TD.dct_lane(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, y, atol=1e-9)
    np.testing.assert_allclose(got, np.asarray(JD.dct_lane(
        jnp.asarray(x), interpret=True)), atol=1e-9)
    back = TD.idct_lane(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(back, x, atol=1e-11)
    np.testing.assert_allclose(back, np.asarray(JD.idct_lane(
        jnp.asarray(y), interpret=True)), atol=1e-11)
    x2 = rng.normal(size=(n, 136))
    y2 = sdct(x2, type=2, axis=0)
    got = TD.dct_sub(torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(got, y2, atol=1e-9)
    np.testing.assert_allclose(got, np.asarray(JD.dct_sub(
        jnp.asarray(x2), interpret=True)), atol=1e-9)
    back = TD.idct_sub(torch.from_numpy(y2)).numpy()
    np.testing.assert_allclose(back, x2, atol=1e-11)
    np.testing.assert_allclose(back, np.asarray(JD.idct_sub(
        jnp.asarray(y2), interpret=True)), atol=1e-11)


def test_float32_twins_match_scipy():
    """The float32 twins (what the kernels are held to on the card)
    within 1e-5 normwise of the float64 transform."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 2048)).astype(np.float32)
    for fn, ref in ((TD.dct_lane, sdct(x.astype(np.float64), axis=-1)),
                    (TD.idct_lane, sidct(x.astype(np.float64), axis=-1))):
        got = fn(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def _dft(a, inverse):
    """csrc/dct.cu's in-register DFT of R in {2, 4, 8, 16} points along
    axis 0: R <= 4 directly, R = 8 and 16 as 4 x (R / 4) with the inner
    twiddles W_R^(r2 k1)."""
    R = a.shape[0]
    s = 1 if inverse else -1
    if R <= 4:
        r = np.arange(R)
        return np.tensordot(np.exp(s * 2j * np.pi * np.outer(r, r) / R), a,
                            axes=1)
    Q = R // 4
    b = np.stack([_dft(a[r2::Q], inverse) for r2 in range(Q)])
    tw = np.exp(s * 2j * np.pi * np.outer(np.arange(Q), np.arange(4)) / R)
    b = b * tw.reshape(tw.shape + (1,) * (a.ndim - 1))
    out = np.empty_like(a)
    for k1 in range(4):
        out[k1::4] = _dft(b[:, k1], inverse)
    return out


def _fft(z, tw, inverse):
    """The kernels' Stockham passes over the last axis of z (N points),
    radices TD.RADICES[N] in order: butterfly jb reads z[jb + r N/R],
    twiddles by tw[r (jb % Ns) N/(Ns R)], writes z[(jb // Ns) Ns R +
    jb % Ns + r Ns]."""
    N = z.shape[-1]
    ns = 1
    for R in TD.RADICES[N]:
        K = N // R
        jb = np.arange(K)
        kk = jb % ns
        a = np.stack([z[..., jb + r * K] for r in range(R)])
        a = a * tw[np.outer(np.arange(R), kk) * (N // (ns * R))][:, None, :]
        a = _dft(a, inverse)
        d = (jb // ns) * ns * R + kk
        z = np.empty_like(z)
        for r in range(R):
            z[..., d + r * ns] = a[r]
        ns *= R
    return z


def _vpos(n):
    """Makhoul's permutation: x_j sits at v_p, p = j/2 (j even) or
    n - 1 - (j - 1)/2 (j odd)."""
    j = np.arange(n)
    return np.where(j % 2 == 0, j // 2, n - 1 - (j - 1) // 2)


def _lowhalf(x, R):
    """csrc/cg_unwrap_czt.cu dft_lowhalf along axis 0: the R-point DFT of
    x (R / 2 entries; the upper half zero) as the half DFTs of x (even
    outputs) and of x_m W_R^m (odd outputs)."""
    m = np.arange(R // 2).reshape((-1,) + (1,) * (x.ndim - 1))
    X = np.empty((R,) + x.shape[1:], complex)
    X[0::2] = _dft(x, False)
    X[1::2] = _dft(x * np.exp(-2j * np.pi * m / R), False)
    return X


def _firsthalf(x, R):
    """csrc/cg_unwrap_czt.cu dft_firsthalf along axis 0: outputs j < R / 2
    of the R-point DFT, E_j + W_R^j O_j from the half DFTs of the even
    and odd entries."""
    j = np.arange(R // 2).reshape((-1,) + (1,) * (x.ndim - 1))
    return (_dft(x[0::2], False)
            + np.exp(-2j * np.pi * j / R) * _dft(x[1::2], False))


def _czt(z, twA, twC, bh, c):
    """csrc/cg_unwrap_czt.cu czt_kernel's N-point FFT of the last axis of
    z (the direction is the chirp's), the four-step FFT_L at L = L1 L2
    (TD.CZT_SPLIT) twice, with the tables in the kernel's order: A, per
    m2, a_(L2 m1 + m2) = z c (m1 < L1 / 2, zero from N) through the
    pruned L1-point DFT, times twA[k1 L2 + m2]; B, per k1, the L2-point
    DFT over m2 (Y_(k1 + L1 k2)), Y' = conj(Y Bh); C, the L2-point DFT
    over k2, times twC[j2 L1 + k1]; D, per j2, the L1-point DFT over k1
    pruned to j1 < L1 / 2: R_(j2 + L2 j1); Z = c conj(R) for j < N."""
    N = c.size
    L = bh.size
    L1, L2 = TD.CZT_SPLIT[L]
    lead = z.shape[:-1]
    a = np.zeros(lead + (L,), complex)
    a[..., :N] = z * c
    # (m1, ..., m2), m1 < L1 / 2
    a = np.moveaxis(a.reshape(lead + (L1, L2)), -2, 0)[:L1 // 2]
    X = _lowhalf(a, L1) * twA.reshape((L1,) + (1,) * len(lead) + (L2,))
    Y = _dft(np.moveaxis(X, -1, 0), False)          # (k2, k1, ...)
    k = np.arange(L1)[None, :] + L1 * np.arange(L2)[:, None]
    Y = np.conj(Y * bh[k].reshape((L2, L1) + (1,) * len(lead)))
    Cj = _dft(Y, False) * twC.reshape((L2, L1) + (1,) * len(lead))
    R = _firsthalf(np.moveaxis(Cj, 1, 0), L1)        # (j1, j2, ...)
    R = np.moveaxis(R.reshape((L1 // 2 * L2,) + lead), 0, -1)
    return c * np.conj(R[..., :N])


def _kernel_form(x, n, inverse, czt=False):
    """numpy float64 emulation of csrc/dct.cu along the last axis, with
    the wrapper's own tables (TD.kernel_tables): the forward permutes
    into v, packs z_m = v_2m + i v_(2m+1), runs the passes and splits
    each pair Z_k, Z_(N-k) into y_k, y_(n-k), y_(N-k), y_(N+k); the
    inverse packs F into Z' pair by pair, runs the inverse passes and
    undoes the permutation. `czt`: czt_kernel's form instead, the same
    frame (N odd or even) around the chirp-z (TD.bluestein_tables)."""
    N = n // 2
    if czt:
        twA, twC, bh, c, w, A = TD.bluestein_tables(n, inverse)

        def fft(z, inv):
            return _czt(z, twA, twC, bh, c)
    else:
        tw, w, A = TD.kernel_tables(n, inverse)

        def fft(z, inv):
            return _fft(z, tw, inv)
    x = np.asarray(x, np.float64)
    ks = range(N // 2 + 1)
    if not inverse:
        v = np.empty_like(x)
        v[..., _vpos(n)] = x
        Z = fft(v[..., 0::2] + 1j * v[..., 1::2], False)
        y = np.empty_like(x)
        for k in ks:
            Zk, Zm = Z[..., k], Z[..., (N - k) % N]
            E2, iAO = Zk + np.conj(Zm), 1j * A[k] * (Zk - np.conj(Zm))
            P1 = w[k] * (E2 - iAO)
            P2 = w[N - k] * np.conj(E2 + iAO)
            y[..., k] = P1.real
            if k:
                y[..., n - k] = -P1.imag
            if k == 0:
                y[..., N] = P2.real
            elif 2 * k != N:
                y[..., N - k] = P2.real
                y[..., N + k] = -P2.imag
        return y
    Z = np.empty(x.shape[:-1] + (N,), complex)
    for k in ks:
        ynk = x[..., n - k] if k else 0.0
        F1 = (x[..., k] - 1j * ynk) * w[k]
        F2 = (x[..., N - k] - 1j * x[..., N + k]) * w[N - k]
        S, itD = F1 + np.conj(F2), 1j * A[k] * (F1 - np.conj(F2))
        Z[..., k] = S + itD
        if k and 2 * k != N:
            Z[..., N - k] = np.conj(S - itD)
    z = fft(Z, True)
    v = np.stack([z.real, z.imag], -1).reshape(x.shape)
    return v[..., _vpos(n)]


# every line length with a Stockham plan: the DCT kernels' SIZES and
# the multigrid CG's sides 128, 256 and 512 (csrc/cg.cu)
PLAN_SIZES = sorted(2 * N for N in TD.RADICES)


def test_plans_cover_the_kernels_sizes():
    """Each plan's radices multiply to its length, and every DCT kernel
    size and power-of-two CG side has one."""
    from pygpa_tpu_torch.ops import cg as TCG
    for N, radices in TD.RADICES.items():
        assert int(np.prod(radices)) == N
        assert all(R in (2, 4, 8, 16) for R in radices)
    assert set(TD.SIZES) | set(TCG.FFT_SIDES) == set(PLAN_SIZES)


@pytest.mark.parametrize("n", PLAN_SIZES)
def test_factor_tables_reproduce_scipy(n):
    """The kernels' arithmetic in float64 with the wrapper's twiddle
    tables reproduces scipy's DCT-II and its inverse to 1e-12."""
    x = np.random.default_rng(n).normal(size=(2, n))
    for inverse, ref in ((False, sdct(x, type=2, axis=-1)),
                         (True, sidct(x, type=2, axis=-1))):
        got = _kernel_form(x, n, inverse)
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("n", PLAN_SIZES)
def test_kernel_tables_are_exact_roots(n):
    """Every table entry is the root its integer angle names (float32
    within 1 ulp of the float64 value), the FFT table's entries are
    N-th roots of unity, and the inverse's tables conjugate the
    forward's (w scaled by 1/(2n))."""
    N = n // 2
    tw, w, A = TD.kernel_tables(n, False)
    itw, iw, iA = TD.kernel_tables(n, True)
    assert tw.shape == (N,) and w.shape == (N + 1,) and A.shape == (N // 2 + 1,)
    np.testing.assert_allclose(tw ** N, 1, atol=1e-9)
    np.testing.assert_allclose(
        w, np.exp(-1j * np.pi * np.arange(N + 1) / (2 * n)), atol=1e-15)
    np.testing.assert_allclose(
        A, np.exp(-2j * np.pi * np.arange(N // 2 + 1) / n), atol=1e-15)
    np.testing.assert_array_equal(itw, np.conj(tw))
    np.testing.assert_array_equal(iw * (2 * n), np.conj(w))
    np.testing.assert_array_equal(iA, np.conj(A))
    dev = TD._device_table(n, False, torch.device("cpu")).numpy()
    flat = np.concatenate([tw, w, A])
    assert dev.shape == (flat.size, 2) and dev.dtype == np.float32
    np.testing.assert_allclose(dev[:, 0], flat.real, atol=6e-8)
    np.testing.assert_allclose(dev[:, 1], flat.imag, atol=6e-8)


# even lengths whose half has no Stockham plan: at each L = 256 ... 4096
# one with N odd and one with N even, among them those the early-stopping
# CG meets (250 x 374, config 1's 500^2, iterate_GPA's 4086^2) and the
# ends of L = 256 (130) and L = 1024 (1022)
CZT_SIZES = [130, 250, 252, 374, 500, 1000, 1022, 1500, 2046, 3000, 4086]


def test_czt_sizes_cover_every_length_and_parity():
    """CZT_SIZES holds an odd and an even N at each chirp-z length."""
    seen = {(TD.czt_length(n), n // 2 % 2) for n in CZT_SIZES}
    assert seen == {(L, p) for L in TD.CZT_SPLIT for p in (0, 1)}


@pytest.mark.parametrize("n", CZT_SIZES)
def test_bluestein_tables_reproduce_scipy(n):
    """czt_kernel's arithmetic in float64 with the wrapper's chirp-z
    tables (Makhoul's frame; the chirp, the pruned four-step FFT_L,
    conj(Y Bh) between its steps B and C, the pruned output) reproduces
    scipy's DCT-II and its inverse to 1e-12."""
    assert n // 2 not in TD.RADICES
    x = np.random.default_rng(n).normal(size=(2, n))
    for inverse, ref in ((False, sdct(x, type=2, axis=-1)),
                         (True, sidct(x, type=2, axis=-1))):
        got = _kernel_form(x, n, inverse, czt=True)
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("n", CZT_SIZES)
def test_bluestein_tables_are_exact(n):
    """L is the power of two >= 2N - 1 and splits as L1 x L2 (L1 = L2 or
    2 L2, at most 64, so the kernel's in-register DFTs take them); N <= L
    / 2, so the pruned halves hold every input and output; twA and twC
    hold the roots W_L^(k1 m2) and W_L^(j2 k1) in the kernel's order (the
    same in both directions); the chirp e^(-+ i pi m^2 / N) (the
    inverse's conjugates the forward's); Bh = FFT_L(conj chirp, laid out
    circularly) / L, so it is even (Bh_k = Bh_(L-k)); w and A are
    kernel_tables'; the float32 device table (twA, twC, Bh, c, w, A) lies
    within 1 ulp of the float64 one."""
    N = n // 2
    L = TD.czt_length(n)
    L1, L2 = TD.CZT_SPLIT[L]
    assert L in TD.RADICES and L >= 2 * N - 1 and L // 2 < 2 * N - 1
    assert L1 * L2 == L and L1 in (L2, 2 * L2) and L1 <= 64 and 2 * N <= L
    twA, twC, bh, c, w, A = TD.bluestein_tables(n, False)
    itwA, itwC, ibh, ic, iw, iA = TD.bluestein_tables(n, True)
    assert (twA.shape, twC.shape, bh.shape, c.shape) == ((L,), (L,), (L,),
                                                         (N,))
    k1, m2 = np.meshgrid(np.arange(L1), np.arange(L2), indexing="ij")
    np.testing.assert_allclose(
        twA, np.exp(-2j * np.pi * (k1 * m2).ravel() / L), atol=1e-15)
    np.testing.assert_allclose(
        twC, np.exp(-2j * np.pi * (k1 * m2).T.ravel() / L), atol=1e-15)
    np.testing.assert_array_equal(itwA, twA)
    np.testing.assert_array_equal(itwC, twC)
    m = np.arange(N, dtype=np.float64)
    np.testing.assert_allclose(c, np.exp(-1j * np.pi * m * m / N),
                               atol=1e-9)
    np.testing.assert_array_equal(ic, np.conj(c))
    b = np.zeros(L, complex)
    b[:N] = np.conj(c)
    b[L - N + 1:] = np.conj(c[1:])[::-1]
    np.testing.assert_allclose(bh, np.fft.fft(b) / L, atol=1e-15)
    np.testing.assert_allclose(bh[1:], bh[1:][::-1], atol=1e-14)
    for got, want in zip((w, A, iw, iA), TD.kernel_tables(n, False)[1:]
                         + TD.kernel_tables(n, True)[1:]):
        np.testing.assert_array_equal(got, want)
    for inverse in (False, True):
        dev = TD._device_table(n, inverse, torch.device("cpu")).numpy()
        flat = np.concatenate(TD.bluestein_tables(n, inverse))
        assert dev.shape == (flat.size, 2) and dev.dtype == np.float32
        for part, ref in ((dev[:, 0], flat.real), (dev[:, 1], flat.imag)):
            assert np.all(np.abs(part.astype(np.float64) - ref)
                          <= np.spacing(np.abs(part)))


def test_route_matches_reference_gate(monkeypatch):
    """dct2n/idct2n send an axis to the kernels exactly where the
    reference's _pallas_dct_ok would on its accelerator (read as the
    card), in float32; float64 stays on the FFT twins."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for n in (512, 1024, 2048, 4096, 8192, 4100, 16384):
        assert TF.dct_kernel_ok(n, torch.float32) == JF._pallas_dct_ok(n), n
        assert not TF.dct_kernel_ok(n, torch.float64)


def test_dct2n_pair_on_the_route_sizes():
    """A (2, 4096, 128) float32 stack: the lane axis stays on the twin
    (128 < 4096), axis -2 is a kernel-route axis (the twin on the CPU);
    the pair matches scipy's dctn/idctn."""
    from scipy.fft import dctn, idctn
    x = np.random.default_rng(5).normal(size=(2, 4096, 128))
    x32 = torch.from_numpy(x.astype(np.float32))
    _build.launches.clear()
    y = TF.dct2n(x32)
    ref = dctn(x, axes=(-2, -1))
    assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    back = TF.idct2n(torch.from_numpy(ref.astype(np.float32))).numpy()
    assert np.abs(back - idctn(ref, axes=(-2, -1))).max() <= 1e-5 * np.abs(
        x).max()
    assert sum(_build.launches.values()) == 0


def test_kernel_wrappers_refuse_other_devices():
    meta = torch.empty((2, 4096), device="meta")
    for fn in (TD.dct_lane, TD.idct_lane, TD.dct_sub, TD.idct_sub):
        with pytest.raises(ValueError, match="device"):
            fn(meta)
