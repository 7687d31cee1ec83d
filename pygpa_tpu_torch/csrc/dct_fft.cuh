// One-axis DCT-II and its exact inverse as a shared-memory FFT: the
// pass machinery shared by the DCT kernels (dct.cu), the multigrid CG's
// preconditioner (cg.cu) and the early-stopping CG's (cg_unwrap.cu). The
// method, the layouts and the tables are described in dct.cu; the tables
// come from ops/dct.py kernel_tables. cg_unwrap_czt.cu's chirp-z pass
// reuses the in-register DFTs and the complex helpers.
//
// dct_kernel<N, C, SUB, INV, Epi> transforms lines of n = 2N points:
// C lines per block, C * N / 32 threads, each holding 32 complex values
// per Stockham pass. Epi says what happens to each output value:
//   put(y, o, v, k, line)  y[o] = v for entry k of line `line` (the
//                          forward's split store and the inverse sub
//                          kernel's store);
//   put4(y, base, i, v)    float4 i of the block's rows from `base` (the
//                          inverse lane kernel's store);
//   done(scratch)          after the last store, by every thread of
//                          the block, with the block's shared memory
//                          free (only where Epi::REDUCES);
//   skip()                 at the block's start: true makes the whole
//                          block return before it loads anything (only
//                          where Epi::SKIPS is declared true).
// A lane grid is (blocks a plane, planes): `lines` rows a plane, the
// last block of a plane ragged (one plane of all the rows where grid y
// is 1).
// Store writes each value as it is; cg.cu and cg_unwrap.cu add epilogues
// that scale, reduce or skip on the way out.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 conjg(float2 a) {
  return make_float2(a.x, -a.y);
}
__device__ __forceinline__ float2 times_i(float2 a) {
  return make_float2(-a.y, a.x);
}

constexpr float kC1 = 0.92387953251128674f;  // cos(pi / 8)
constexpr float kS1 = 0.38268343236508977f;  // sin(pi / 8)
constexpr float kR2 = 0.70710678118654752f;  // cos(pi / 4)

// cos(2 pi m / 16); m is a compile-time constant after unrolling
__device__ __forceinline__ float cos16(int m) {
  switch (m & 15) {
    case 0: return 1.f;
    case 1: case 15: return kC1;
    case 2: case 14: return kR2;
    case 3: case 13: return kS1;
    case 4: case 12: return 0.f;
    case 5: case 11: return -kS1;
    case 6: case 10: return -kR2;
    default: return (m & 15) == 8 ? -1.f : -kC1;  // 7, 9 and 8
  }
}

// e^(s 2 pi i m / 16), s = +1 for the inverse and -1 for the forward
template <bool INV>
__device__ __forceinline__ float2 w16(int m) {
  const float s = cos16(m + 12);  // sin(2 pi m / 16)
  return make_float2(cos16(m), INV ? s : -s);
}

// in-register DFT of R in {2, 4, 8, 16} points, natural order in and out;
// R = 8 and 16 as 4 x (R / 4) with the inner twiddles W_R^(r2 k1)
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&a)[R]) {
  if constexpr (R == 2) {
    const float2 t = a[0];
    a[0] = cadd(t, a[1]);
    a[1] = csub(t, a[1]);
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(a[0], a[2]), t1 = csub(a[0], a[2]);
    const float2 t2 = cadd(a[1], a[3]);
    const float2 d = csub(a[1], a[3]);
    // (a1 - a3) * W_4, W_4 = -i forward, +i inverse
    const float2 t3 = INV ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
    a[0] = cadd(t0, t2);
    a[2] = csub(t0, t2);
    a[1] = cadd(t1, t3);
    a[3] = csub(t1, t3);
  } else {
    constexpr int Q = R / 4;
    float2 b[Q][4];
#pragma unroll
    for (int r2 = 0; r2 < Q; ++r2) {
      float2 t[4] = {a[r2], a[Q + r2], a[2 * Q + r2], a[3 * Q + r2]};
      dft<4, INV>(t);
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1)
        b[r2][k1] = (r2 * k1 == 0)
                        ? t[k1]
                        : cmul(t[k1], w16<INV>(r2 * k1 * (16 / R)));
    }
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      float2 t[Q];
#pragma unroll
      for (int r2 = 0; r2 < Q; ++r2) t[r2] = b[r2][k1];
      dft<Q, INV>(t);
#pragma unroll
      for (int k2 = 0; k2 < Q; ++k2) a[k1 + 4 * k2] = t[k2];
    }
  }
}

// radices of the Stockham passes, in order (N = n / 2 complex points)
template <int N> struct Plan;
template <> struct Plan<64> { static constexpr int R0 = 8, R1 = 8, R2 = 1; };
template <> struct Plan<128> { static constexpr int R0 = 16, R1 = 8, R2 = 1; };
template <> struct Plan<256> { static constexpr int R0 = 16, R1 = 16, R2 = 1; };
template <> struct Plan<512> { static constexpr int R0 = 8, R1 = 8, R2 = 8; };
template <> struct Plan<1024> { static constexpr int R0 = 16, R1 = 8, R2 = 8; };
template <> struct Plan<2048> { static constexpr int R0 = 16, R1 = 16, R2 = 8; };
template <> struct Plan<4096> { static constexpr int R0 = 16, R1 = 16, R2 = 16; };

// shared-memory slot of complex value m of line c: lines one after the
// other (lane) or interleaved (sub), one padding slot per 16
template <int N, int C, bool SUB>
__device__ __forceinline__ int slot(int m, int c) {
  const int flat = SUB ? m * C + c : c * N + m;
  return flat + (flat >> 4);
}

// float offset of v_p (the permuted real line) of line c
template <int N, int C, bool SUB>
__device__ __forceinline__ int vpos(int p, int c) {
  return 2 * slot<N, C, SUB>(p >> 1, c) + (p & 1);
}

// item i of C * K -> (line c, index k): the index runs fastest along a
// row (lane), the line fastest across a strip's columns (sub)
template <int C, int K, bool SUB>
__device__ __forceinline__ void item(int i, int& c, int& k) {
  if (SUB) {
    c = i % C;
    k = i / C;
  } else {
    c = i / K;
    k = i % K;
  }
}

// one Stockham pass of radix R after NS points' worth of earlier passes:
// butterfly jb reads z[jb + r N/R], twiddles by tw[r (jb % NS) N/(NS R)],
// and writes z[(jb / NS) NS R + jb % NS + r NS]
template <int N, int C, bool SUB, bool INV, int T, int R, int NS>
__device__ __forceinline__ void fft_pass(float2* z, const float2* tw) {
  constexpr int K = N / R;
  constexpr int BPT = C * K / T;
  float2 a[BPT][R];
  int cs[BPT], js[BPT];
#pragma unroll
  for (int q = 0; q < BPT; ++q) {
    item<C, K, SUB>(threadIdx.x + q * T, cs[q], js[q]);
#pragma unroll
    for (int r = 0; r < R; ++r)
      a[q][r] = z[slot<N, C, SUB>(js[q] + r * K, cs[q])];
  }
#pragma unroll
  for (int q = 0; q < BPT; ++q) {
    if constexpr (NS > 1) {
      const int kk = js[q] & (NS - 1);
#pragma unroll
      for (int r = 1; r < R; ++r)
        a[q][r] = cmul(a[q][r], tw[r * kk * (N / (NS * R))]);
    }
    dft<R, INV>(a[q]);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < BPT; ++q) {
    const int kk = js[q] & (NS - 1);
    const int d = (js[q] / NS) * NS * R + kk;
#pragma unroll
    for (int r = 0; r < R; ++r) z[slot<N, C, SUB>(d + r * NS, cs[q])] = a[q][r];
  }
  __syncthreads();
}

// Epi::SKIPS where the epilogue declares it, else false
template <class E, class = void>
struct epi_skips : std::false_type {};
template <class E>
struct epi_skips<E, std::void_t<decltype(E::SKIPS)>>
    : std::bool_constant<E::SKIPS> {};

// the plain epilogue: every output value stored as it is
struct Store {
  static constexpr bool REDUCES = false;  // no done()
  __device__ __forceinline__ void put(float* y, size_t o, float v, int,
                                     int) {
    y[o] = v;
  }
  __device__ __forceinline__ void put4(float* y, size_t base, int i,
                                       float4 v) {
    reinterpret_cast<float4*>(y + base)[i] = v;
  }
};

// dynamic shared memory of dct_kernel<N, C, ...>: the padded lines and
// the tables
template <int N, int C>
constexpr size_t dct_smem_bytes() {
  return (size_t)(C * N + C * N / 16 + N + (N + 1) + (N / 2 + 1)) *
         sizeof(float2);
}

// lane: blockIdx.x covers rows [C blockIdx.x, C blockIdx.x + C) of
//   `lines` rows of n of plane blockIdx.y; sub: blockIdx.x covers
//   columns [C blockIdx.x, ...) of the (n, m) plane blockIdx.y;
//   `lines` = m
template <int N, int C, bool SUB, bool INV, class Epi = Store>
__global__ void __launch_bounds__(C * N / 32) dct_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const float2* __restrict__ tab, int lines, Epi epi) {
  constexpr int n = 2 * N;
  constexpr int T = C * N / 32;
  constexpr int DATA = C * N + C * N / 16;  // padded complex slots
  constexpr int TAB = N + (N + 1) + (N / 2 + 1);
  if constexpr (epi_skips<Epi>::value) {
    if (epi.skip()) return;
  }
  extern __shared__ float2 sm[];
  float2* z = sm;
  float* zf = reinterpret_cast<float*>(sm);
  float2* tw = sm + DATA;       // [N]
  const float2* wt = tw + N;    // [N + 1]
  const float2* At = wt + N + 1;  // [N / 2 + 1]
  for (int i = threadIdx.x; i < TAB; i += T) tw[i] = tab[i];

  const int line0 = blockIdx.x * C;
  const size_t base = SUB ? (size_t)blockIdx.y * n * lines + line0
                      : ((size_t)blockIdx.y * lines + line0) * n;
  // element j of line c: x[base + goff(j, c)]
  auto goff = [&](int j, int c) -> size_t {
    return SUB ? (size_t)j * lines + c : (size_t)c * n + j;
  };
  auto live = [&](int c) { return line0 + c < lines; };

  if constexpr (INV) {
    // ---- load: pack the Hermitian F into Z' pair by pair, straight
    // from device memory (the pack reads the tables)
    __syncthreads();
    constexpr int K = N / 2;
    auto Y = [&](int p, int c) {
      return live(c) ? x[base + goff(p, c)] : 0.f;
    };
    auto pack = [&](int k, int c, float2& ok, float2& om) {
      const float ynk = k ? Y(n - k, c) : 0.f;
      const float2 F1 = cmul(make_float2(Y(k, c), -ynk), wt[k]);
      const float2 F2 = cmul(make_float2(Y(N - k, c), -Y(N + k, c)),
                             wt[N - k]);
      const float2 S = cadd(F1, conjg(F2));
      const float2 itD = times_i(cmul(At[k], csub(F1, conjg(F2))));
      ok = cadd(S, itD);
      om = conjg(csub(S, itD));
    };
#pragma unroll 4
    for (int i = threadIdx.x; i < C * K; i += T) {
      int c, k;
      item<C, K, SUB>(i, c, k);
      float2 zk, zm;
      pack(k, c, zk, zm);
      z[slot<N, C, SUB>(k, c)] = zk;
      if (k) z[slot<N, C, SUB>(N - k, c)] = zm;  // k = 0: Z'_N is Z'_0
    }
    // k = N/2 pairs with itself: one per line (C <= T)
    if (threadIdx.x < C) {
      float2 zh, unused;
      pack(K, threadIdx.x, zh, unused);
      z[slot<N, C, SUB>(K, threadIdx.x)] = zh;
    }
  } else if constexpr (SUB) {
    // ---- load: permute x into v, a strip row (C columns) at a time
#pragma unroll 8
    for (int i = threadIdx.x; i < C * n; i += T) {
      int c, j;
      item<C, n, SUB>(i, c, j);
      const float v = live(c) ? x[base + goff(j, c)] : 0.f;
      zf[vpos<N, C, SUB>((j & 1) ? n - 1 - (j >> 1) : (j >> 1), c)] = v;
    }
  } else {
    // ---- load: 16 bytes x_4t .. x_4t+3 at a time, permuted in registers:
    // z_t = x_4t + i x_4t+2 and z_(N-1-t) = x_4t+3 + i x_4t+1
#pragma unroll 8
    for (int i = threadIdx.x; i < C * N / 2; i += T) {
      int c, t;
      item<C, N / 2, SUB>(i, c, t);
      const float4 v = live(c) ? reinterpret_cast<const float4*>(x + base)[i]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      z[slot<N, C, SUB>(t, c)] = make_float2(v.x, v.z);
      z[slot<N, C, SUB>(N - 1 - t, c)] = make_float2(v.w, v.y);
    }
  }
  __syncthreads();

  // ---- the half-length complex FFT (two or three passes)
  using P = Plan<N>;
  fft_pass<N, C, SUB, INV, T, P::R0, 1>(z, tw);
  fft_pass<N, C, SUB, INV, T, P::R1, P::R0>(z, tw);
  if constexpr (P::R2 > 1)
    fft_pass<N, C, SUB, INV, T, P::R2, P::R0 * P::R1>(z, tw);

  Epi e = epi;
  if constexpr (INV && SUB) {
    // ---- store: undo the permutation
#pragma unroll 8
    for (int i = threadIdx.x; i < C * n; i += T) {
      int c, j;
      item<C, n, SUB>(i, c, j);
      const int p = (j & 1) ? n - 1 - (j >> 1) : (j >> 1);
      if (live(c))
        e.put(y, base + goff(j, c), zf[vpos<N, C, SUB>(p, c)], j, line0 + c);
    }
  } else if constexpr (INV) {
    // ---- store: the forward load's mirror, 16 bytes at a time
#pragma unroll 8
    for (int i = threadIdx.x; i < C * N / 2; i += T) {
      int c, t;
      item<C, N / 2, SUB>(i, c, t);
      if (!live(c)) continue;
      const float2 a = z[slot<N, C, SUB>(t, c)];
      const float2 b = z[slot<N, C, SUB>(N - 1 - t, c)];
      e.put4(y, base, i, make_float4(a.x, b.y, a.y, b.x));
    }
  } else {
    // ---- split Z_k, Z_(N-k) into V_k, V_(N-k), post-twiddle, store
    constexpr int K = N / 2;
    auto split = [&](int k, int c, float2& P1, float2& P2) {
      const float2 Zk = z[slot<N, C, SUB>(k, c)];
      const float2 Zm = z[slot<N, C, SUB>((N - k) & (N - 1), c)];
      const float2 E2 = cadd(Zk, conjg(Zm));
      const float2 iAO = times_i(cmul(At[k], csub(Zk, conjg(Zm))));
      P1 = cmul(wt[k], csub(E2, iAO));
      P2 = cmul(wt[N - k], conjg(cadd(E2, iAO)));
    };
#pragma unroll 4
    for (int i = threadIdx.x; i < C * K; i += T) {
      int c, k;
      item<C, K, SUB>(i, c, k);
      if (!live(c)) continue;
      float2 P1, P2;
      split(k, c, P1, P2);
      const int l = line0 + c;
      e.put(y, base + goff(k, c), P1.x, k, l);
      if (k) {
        e.put(y, base + goff(n - k, c), -P1.y, n - k, l);
        e.put(y, base + goff(N - k, c), P2.x, N - k, l);
        e.put(y, base + goff(N + k, c), -P2.y, N + k, l);
      } else {
        e.put(y, base + goff(N, c), P2.x, N, l);  // y_(N+0) is y_N
      }
    }
    // k = N/2 pairs with itself: one per line (C <= T)
    if (threadIdx.x < C && live(threadIdx.x)) {
      float2 P1, P2;
      split(K, threadIdx.x, P1, P2);
      const int l = line0 + threadIdx.x;
      e.put(y, base + goff(K, threadIdx.x), P1.x, K, l);
      e.put(y, base + goff(n - K, threadIdx.x), -P1.y, n - K, l);
    }
  }
  if constexpr (Epi::REDUCES) {
    __syncthreads();
    e.done(zf);
  }
}

}  // namespace
