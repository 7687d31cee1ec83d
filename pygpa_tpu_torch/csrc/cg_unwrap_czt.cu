// The early-stopping CG's chirp-z DCT passes for the even sides 130 ...
// 4094 that are not powers of two: the lane forward, the sub forward with
// the eigenvalue division, the sub inverse and the lane inverse with the
// r.z partials, each at L = 256 ... 4096 (20 instances). cg_unwrap.cu's
// pass_at calls them per axis; they are in a file of their own so that
// the build compiles them beside cg_unwrap.cu's 28 power-of-two passes.
//
// The function: Makhoul's DCT frame as dct_fft.cuh's dct_kernel (the
// permuted load and the split store with w and A; the inverse's pack and
// permuted store) around an N-point FFT (N = n / 2, odd or even) done as
// Bluestein's chirp-z on L points, L the power of two >= 2N - 1:
//   Z_k = c_k conj(FFT_L(conj(FFT_L(a) Bh))_k),  a = z c zero-padded to L,
//   c_m = e^(-+ i pi m^2 / N), Bh = FFT_L(conj c, laid out circularly) / L
// (the inverse FFT_L as a conjugated forward one, so both are forward).
//
// Design: each FFT_L is the four-step split L = L1 x L2 (L1 = L2 or 2 L2;
// CztSplit), done in registers, the two FFTs back to back:
//   A  thread m2 of a line holds a_(L2 m1 + m2) for m1 < L1 / 2 (the
//      chirp multiplied in on the way from shared memory; every m >= N is
//      a zero, and m1 >= L1 / 2 always is, so the L1-point DFT is pruned
//      to two half DFTs), twiddles W_L^(k1 m2) (table twA);
//   T1 exchange through shared memory to the transpose;
//   B  thread k1 (two of them where L1 = 2 L2) runs the L2-point DFT over
//      m2: Y_(k1 + L1 k2) in registers; Y' = conj(Y Bh) in place; and
//   C  the second FFT's first L2-point DFT over k2 on the same registers,
//      twiddles W_L^(j2 k1) (table twC);
//   T2 exchange to the transpose;
//   D  thread j2 runs the L1-point DFT over k1, pruned to the outputs j1
//      < L1 / 2 (every index j = j2 + L2 j1 < N lies there), and stores
//      Z_j = c_j conj(R_j) for the frame's store.
// A line makes four round trips through shared memory (the load, T1, T2
// and Z for the store) where the Stockham form made ten (the permuted
// load, the chirp sweep, three radix-16 passes, the Bh sweep, three more
// passes and the store), and a block syncs seven times. The tables
// (twA, twC, Bh, c) are read once an element a line, coalesced (a warp's
// threads read neighbouring entries), through L1; the in-register DFTs'
// roots are compile-time constants.
//
// Blocks: L2 threads a line, C lines a block (CztBlock: 128 threads, 256
// for the sub form at L >= 2048, whose lines are columns: 4 or 8 of them
// read 16 or 32 bytes of each row); shared memory C (L + L1 + 1) complex
// values, 17-135 KB (a thread holds up to L1 = 64 complex values; at L >=
// 2048 the compiler takes 255 registers, so one or two blocks an SM). A lane block is C consecutive rows; a sub block C
// adjacent columns. What bounds a pass on an H100: HBM bytes (a line of n
// read and written once, 8n bytes), then the shared-memory exchanges.
#include <cuda_runtime.h>

#include "cg_unwrap.cuh"
#include "dct_fft.cuh"

namespace cgu {

namespace {

// cos(pi i / 32), i = 0 ... 16 (i a compile-time constant after
// unrolling)
__device__ __forceinline__ float cq64(int i) {
  switch (i) {
    case 0: return 1.f;
    case 1: return 0.99518472667219688624f;
    case 2: return 0.98078528040323044913f;
    case 3: return 0.95694033573220886494f;
    case 4: return 0.92387953251128675613f;
    case 5: return 0.88192126434835502971f;
    case 6: return 0.83146961230254523708f;
    case 7: return 0.77301045336273696081f;
    case 8: return 0.70710678118654752440f;
    case 9: return 0.63439328416364549822f;
    case 10: return 0.55557023301960222474f;
    case 11: return 0.47139673682599764856f;
    case 12: return 0.38268343236508977173f;
    case 13: return 0.29028467725446236764f;
    case 14: return 0.19509032201612826785f;
    case 15: return 0.09801714032956060199f;
    default: return 0.f;
  }
}

// cos(2 pi m / 64)
__device__ __forceinline__ float cos64(int m) {
  m &= 63;
  if (m <= 16) return cq64(m);
  if (m <= 32) return -cq64(32 - m);
  if (m <= 48) return -cq64(m - 32);
  return cq64(64 - m);
}

// e^(-2 pi i m / 64), the forward root (sin(2 pi m / 64) = cos64(m - 16))
__device__ __forceinline__ float2 w64(int m) {
  return make_float2(cos64(m), -cos64(m + 48));
}

// forward in-register DFT of R in {2, ..., 64} points, natural order in
// and out: dct_fft.cuh's dft up to 16, above as 4 x (R / 4) with the
// inner twiddles W_R^(r2 k1)
template <int R>
__device__ __forceinline__ void rdft(float2 (&a)[R]) {
  if constexpr (R <= 16) {
    dft<R, false>(a);
  } else {
    constexpr int Q = R / 4;
    float2 b[Q][4];
#pragma unroll
    for (int r2 = 0; r2 < Q; ++r2) {
      float2 t[4] = {a[r2], a[Q + r2], a[2 * Q + r2], a[3 * Q + r2]};
      dft<4, false>(t);
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1)
        b[r2][k1] = (r2 * k1 == 0) ? t[k1]
                                   : cmul(t[k1], w64(r2 * k1 * (64 / R)));
    }
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      float2 t[Q];
#pragma unroll
      for (int r2 = 0; r2 < Q; ++r2) t[r2] = b[r2][k1];
      dft<Q, false>(t);
#pragma unroll
      for (int k2 = 0; k2 < Q; ++k2) a[k1 + 4 * k2] = t[k2];
    }
  }
}

// the R-point DFT of x whose upper half is zero: X_2k the half DFT of x,
// X_2k+1 that of x_m W_R^m
template <int R>
__device__ __forceinline__ void dft_lowhalf(const float2 (&x)[R / 2],
                                            float2 (&X)[R]) {
  float2 e[R / 2], o[R / 2];
#pragma unroll
  for (int m = 0; m < R / 2; ++m) {
    e[m] = x[m];
    o[m] = m ? cmul(x[m], w64(m * (64 / R))) : x[m];
  }
  rdft<R / 2>(e);
  rdft<R / 2>(o);
#pragma unroll
  for (int k = 0; k < R / 2; ++k) {
    X[2 * k] = e[k];
    X[2 * k + 1] = o[k];
  }
}

// the first R / 2 outputs of the R-point DFT of x: E_j + W_R^j O_j from the
// half DFTs of the even and odd entries
template <int R>
__device__ __forceinline__ void dft_firsthalf(const float2 (&x)[R],
                                              float2 (&X)[R / 2]) {
  float2 e[R / 2], o[R / 2];
#pragma unroll
  for (int m = 0; m < R / 2; ++m) {
    e[m] = x[2 * m];
    o[m] = x[2 * m + 1];
  }
  rdft<R / 2>(e);
  rdft<R / 2>(o);
#pragma unroll
  for (int j = 0; j < R / 2; ++j)
    X[j] = cadd(e[j], j ? cmul(o[j], w64(j * (64 / R))) : o[j]);
}

// L = L1 x L2 of the four-step FFT_L (ops/dct.py CZT_SPLIT)
template <int L> struct CztSplit;
template <> struct CztSplit<256> { static constexpr int L1 = 16, L2 = 16; };
template <> struct CztSplit<512> { static constexpr int L1 = 32, L2 = 16; };
template <> struct CztSplit<1024> { static constexpr int L1 = 32, L2 = 32; };
template <> struct CztSplit<2048> { static constexpr int L1 = 64, L2 = 32; };
template <> struct CztSplit<4096> { static constexpr int L1 = 64, L2 = 64; };

// threads a block and lines a block: 128 threads, except the sub form at
// L >= 2048, 256 threads (4 or 8 adjacent columns: a row's 16 or 32
// bytes a block)
template <int L, bool SUB>
struct CztBlock {
  static constexpr int T = (SUB && L >= 2048) ? 256 : 128;
  static constexpr int C = T / CztSplit<L>::L2;
};

// complex slots of a line's shared memory: the transposes' padded rows
// (L1 (L2 + 1) and L2 (L1 + 1) slots) and one more, so that neighbouring
// lines start on different banks
template <int L>
__host__ __device__ constexpr int czt_line_slots() {
  return L + CztSplit<L>::L1 + 1;
}

template <int L, bool SUB>
constexpr size_t czt_smem_bytes() {
  return (size_t)CztBlock<L, SUB>::C * czt_line_slots<L>() * sizeof(float2);
}

// The pass over lines of n = 2N (file comment). tab: ops/dct.py
// bluestein_tables at (n, INV): twA (L), twC (L), Bh (L), c (N), w (N + 1),
// A (N / 2 + 1), float32 pairs. Lane: blockIdx.x covers rows [C
// blockIdx.x, C blockIdx.x + C) of `lines` rows of plane blockIdx.y; sub:
// columns [C blockIdx.x, ...) of the (n, lines) plane blockIdx.y.
template <int L, bool SUB, bool INV, class Epi>
__global__ void __launch_bounds__(CztBlock<L, SUB>::T) czt_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const float2* __restrict__ tab, int N, int lines, Epi epi) {
  constexpr int L1 = CztSplit<L>::L1, L2 = CztSplit<L>::L2;
  constexpr int T = CztBlock<L, SUB>::T, C = CztBlock<L, SUB>::C;
  constexpr int H = L1 / L2;
  constexpr int S = czt_line_slots<L>();
  const int n = 2 * N;
  if constexpr (epi_skips<Epi>::value) {
    if (epi.skip()) return;
  }
  extern __shared__ float2 sm[];
  const float2* twA = tab;          // [k1 L2 + m2] = W_L^(k1 m2)
  const float2* twC = twA + L;      // [j2 L1 + k1] = W_L^(j2 k1)
  const float2* bh = twC + L;       // [L]
  const float2* ch = bh + L;        // [N]
  const float2* wt = ch + N;        // [N + 1]
  const float2* At = wt + N + 1;    // [N / 2 + 1]

  const int line0 = blockIdx.x * C;
  const size_t base = SUB ? (size_t)blockIdx.y * n * lines + line0
                          : ((size_t)blockIdx.y * lines + line0) * n;
  auto goff = [&](int j, int c) -> size_t {
    return SUB ? (size_t)j * lines + c : (size_t)c * n + j;
  };
  auto live = [&](int c) { return line0 + c < lines; };
  // line c's slots: z_m at zl(c)[m], v_p at zf(c)[p]
  auto zl = [&](int c) { return sm + c * S; };
  auto zf = [&](int c) { return reinterpret_cast<float*>(sm + c * S); };
  auto perm = [&](int j) { return (j & 1) ? n - 1 - (j >> 1) : (j >> 1); };
  const int KP = N / 2 + 1;  // pairs (k, N - k) a line
  // this thread's line and its index in the line
  const int lc = threadIdx.x / L2, t = threadIdx.x % L2;
  float2* z = zl(lc);

  // ---- the frame's load: z_m (m < N) of every line, natural order
  if constexpr (INV) {
    // pack the Hermitian F into Z' pair by pair
    auto pack = [&](int c, int k) {
      auto Y = [&](int p) { return live(c) ? x[base + goff(p, c)] : 0.f; };
      const float ynk = k ? Y(n - k) : 0.f;
      const float2 F1 = cmul(make_float2(Y(k), -ynk), __ldg(wt + k));
      const float2 F2 =
          cmul(make_float2(Y(N - k), -Y(N + k)), __ldg(wt + N - k));
      const float2 S2 = cadd(F1, conjg(F2));
      const float2 itD = times_i(cmul(__ldg(At + k), csub(F1, conjg(F2))));
      zl(c)[k] = cadd(S2, itD);
      if (k && 2 * k != N) zl(c)[N - k] = conjg(csub(S2, itD));
    };
    if constexpr (SUB) {
#pragma unroll 4
      for (int i = threadIdx.x; i < C * KP; i += T) pack(i % C, i / C);
    } else {
#pragma unroll 4
      for (int k = t; k < KP; k += L2) pack(lc, k);
    }
  } else if constexpr (SUB) {
    // permute x into v, a strip row at a time, 8 bytes (two columns) a
    // thread: `lines` is even on this route (both sides are pass sides),
    // so a column pair starts on the 8-byte grid and is live or dead whole
    constexpr int CP = C / 2;
#pragma unroll 8
    for (int i = threadIdx.x; i < CP * n; i += T) {
      const int c = 2 * (i % CP), j = i / CP;
      const float2 q =
          live(c) ? *reinterpret_cast<const float2*>(x + base + goff(j, c))
                  : make_float2(0.f, 0.f);
      zf(c)[perm(j)] = q.x;
      zf(c + 1)[perm(j)] = q.y;
    }
  } else {
    // 8 bytes x_2s, x_2s+1 at a time, into v_s and v_(n-1-s)
    const float2* row = reinterpret_cast<const float2*>(x + base) + lc * N;
    float* v = zf(lc);
    const bool on = live(lc);
#pragma unroll 8
    for (int s = t; s < N; s += L2) {
      const float2 q = on ? row[s] : make_float2(0.f, 0.f);
      v[s] = q.x;
      v[n - 1 - s] = q.y;
    }
  }
  __syncthreads();

  // ---- A: a_(L2 m1 + t) = z c, the pruned L1-point DFT over m1, twA
  float2 X[L1];
  {
    float2 a[L1 / 2];
#pragma unroll
    for (int m1 = 0; m1 < L1 / 2; ++m1) {
      const int m = L2 * m1 + t;
      a[m1] = m < N ? cmul(z[m], __ldg(ch + m)) : make_float2(0.f, 0.f);
    }
    dft_lowhalf<L1>(a, X);
  }
#pragma unroll
  for (int k1 = 1; k1 < L1; ++k1) X[k1] = cmul(X[k1], __ldg(twA + k1 * L2 + t));
  __syncthreads();
  // ---- T1: [k1][m2], rows of L2 + 1
#pragma unroll
  for (int k1 = 0; k1 < L1; ++k1) z[k1 * (L2 + 1) + t] = X[k1];
  __syncthreads();
  // ---- B and C: thread t takes k1 = t + L2 h (X[h L2 + m2])
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int m2 = 0; m2 < L2; ++m2)
      X[h * L2 + m2] = z[(t + L2 * h) * (L2 + 1) + m2];
  __syncthreads();
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int k1 = t + L2 * h;
    float2 v[L2];
#pragma unroll
    for (int m2 = 0; m2 < L2; ++m2) v[m2] = X[h * L2 + m2];
    rdft<L2>(v);  // Y_(k1 + L1 k2)
#pragma unroll
    for (int k2 = 0; k2 < L2; ++k2)
      v[k2] = conjg(cmul(v[k2], __ldg(bh + k1 + L1 * k2)));
    rdft<L2>(v);  // the second FFT's DFT over k2: j2
    // ---- T2: [j2][k1], rows of L1 + 1
#pragma unroll
    for (int j2 = 0; j2 < L2; ++j2)
      z[j2 * (L1 + 1) + k1] =
          j2 ? cmul(v[j2], __ldg(twC + j2 * L1 + k1)) : v[j2];
  }
  __syncthreads();
  // ---- D: thread t = j2, the L1-point DFT over k1 pruned to j1 < L1 / 2
  {
#pragma unroll
    for (int k1 = 0; k1 < L1; ++k1) X[k1] = z[t * (L1 + 1) + k1];
    float2 R[L1 / 2];
    dft_firsthalf<L1>(X, R);
    __syncthreads();
#pragma unroll
    for (int j1 = 0; j1 < L1 / 2; ++j1) {
      const int j = t + L2 * j1;
      if (j < N) z[j] = cmul(__ldg(ch + j), conjg(R[j1]));
    }
  }
  __syncthreads();

  // ---- the frame's store from Z_j (v_p = Z_(p/2)'s part p & 1)
  Epi e = epi;
  if constexpr (INV && SUB) {
    // undo the permutation
#pragma unroll 8
    for (int i = threadIdx.x; i < C * n; i += T) {
      const int c = i % C, j = i / C;
      if (live(c)) e.put(y, base + goff(j, c), zf(c)[perm(j)], j, line0 + c);
    }
  } else if constexpr (INV) {
    // the lane load's mirror, 8 bytes at a time
    if (live(lc)) {
      const float* v = zf(lc);
#pragma unroll 8
      for (int s = t; s < N; s += L2)
        e.put2(y, base, lc * N + s, make_float2(v[s], v[n - 1 - s]));
    }
  } else {
    // split Z_k, Z_(N-k) into V_k, V_(N-k), post-twiddle, store
    auto split = [&](int c, int k) {
      const float2 Zk = zl(c)[k], Zm = zl(c)[k ? N - k : 0];
      const float2 E2 = cadd(Zk, conjg(Zm));
      const float2 iAO = times_i(cmul(__ldg(At + k), csub(Zk, conjg(Zm))));
      const float2 P1 = cmul(__ldg(wt + k), csub(E2, iAO));
      const float2 P2 = cmul(__ldg(wt + N - k), conjg(cadd(E2, iAO)));
      const int l = line0 + c;
      e.put(y, base + goff(k, c), P1.x, k, l);
      if (k) {
        e.put(y, base + goff(n - k, c), -P1.y, n - k, l);
        if (2 * k != N) {
          e.put(y, base + goff(N - k, c), P2.x, N - k, l);
          e.put(y, base + goff(N + k, c), -P2.y, N + k, l);
        }
      } else {
        e.put(y, base + goff(N, c), P2.x, N, l);  // y_(N+0) is y_N
      }
    };
    if constexpr (SUB) {
#pragma unroll 4
      for (int i = threadIdx.x; i < C * KP; i += T)
        if (live(i % C)) split(i % C, i / C);
    } else if (live(lc)) {
#pragma unroll 4
      for (int k = t; k < KP; k += L2) split(lc, k);
    }
  }
  if constexpr (Epi::REDUCES) {
    __syncthreads();
    e.done(reinterpret_cast<float*>(sm));
  }
}

template <int L, bool SUB, bool INV, class Epi>
int czt_pass(const float* x, float* y, const float2* tab, int N, int lines,
             int B, Epi epi, cudaStream_t stream) {
  constexpr int T = CztBlock<L, SUB>::T, C = CztBlock<L, SUB>::C;
  constexpr size_t SMEM = czt_smem_bytes<L, SUB>();
  static_assert(SMEM <= 227 * 1024, "fits a block's shared memory");
  if constexpr (SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        czt_kernel<L, SUB, INV, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((lines + C - 1) / C, B);
  czt_kernel<L, SUB, INV, Epi><<<grid, T, SMEM, stream>>>(
      x, y, tab, N, lines, epi);
  return (int)cudaGetLastError();
}

}  // namespace

template <bool SUB, bool INV, class Epi>
int czt_pass_at(int side, const float* x, float* y, const float* tab,
                int lines, int B, Epi epi, cudaStream_t stream) {
  if (!czt_side(side)) return (int)cudaErrorInvalidValue;
  const float2* t = reinterpret_cast<const float2*>(tab);
  const int N = side / 2;
  int L = 256;
  while (L < 2 * N - 1) L *= 2;
  switch (L) {
    case 256: return czt_pass<256, SUB, INV>(x, y, t, N, lines, B, epi, stream);
    case 512: return czt_pass<512, SUB, INV>(x, y, t, N, lines, B, epi, stream);
    case 1024: return czt_pass<1024, SUB, INV>(x, y, t, N, lines, B, epi, stream);
    case 2048: return czt_pass<2048, SUB, INV>(x, y, t, N, lines, B, epi, stream);
    case 4096: return czt_pass<4096, SUB, INV>(x, y, t, N, lines, B, epi, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template int czt_pass_at<false, false, StoreLive>(int, const float*, float*,
                                                  const float*, int, int,
                                                  StoreLive, cudaStream_t);
template int czt_pass_at<true, false, EpiEigenLive>(int, const float*,
                                                    float*, const float*,
                                                    int, int, EpiEigenLive,
                                                    cudaStream_t);
template int czt_pass_at<true, true, StoreLive>(int, const float*, float*,
                                                const float*, int, int,
                                                StoreLive, cudaStream_t);
template int czt_pass_at<false, true, EpiDotLive>(int, const float*, float*,
                                                  const float*, int, int,
                                                  EpiDotLive, cudaStream_t);

}  // namespace cgu
