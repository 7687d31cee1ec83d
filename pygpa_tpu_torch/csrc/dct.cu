// Single-pass DCT-II and its exact inverse along one axis.
//
// Replaces the TPU kernels pygpa_tpu/ops/pallas_dct2.py _fwd_lane_kernel
// (axis -1, entries dct_lane / idct_lane) and _fwd_sub_kernel (axis -2,
// entries dct_sub / idct_sub). Wrapper and plain twins:
// pygpa_tpu_torch/ops/dct.py.
//
// The scipy DCT-II (norm=None) matrix C[k, j] = 2 cos(pi k (2j+1) / 2n)
// factorises over the digit splits j = j2*128 + j1, k = k2*128 + k1
// (q = n / 128, n in {1024, 2048, 4096, 8192}) as
//     C[k, j] = Re[2 U[k2, j1] V[k1, j1] W[k1, j2]],
// so a transform is two small complex contractions with a pointwise
// twiddle between them. Forward and inverse share one form,
//     out[s*128 + a] = 2 Re sum_b B[s][b] V'[a][b] sum_t A[a][t] in[t*128 + b],
// with the factor tables A (128, q), V' (128, 128), B (q, 128) chosen
// per direction by the wrapper (forward: A = W, V' = V, B = U; inverse:
// A = U^T, V' = V^T, B = W^T, and the input scaled by 1/(2n) with a half
// weight at k = 0). The tables are float32 values of exact integer
// angles reduced mod 4n (built on the host in float64).
//
// Neither kernel transposes the array: dct_lane_kernel keeps one row in
// shared memory and walks the 128 values of the free digit `a` in tiles;
// dct_sub_kernel works on 32-column strips, streams the 128-digit `b`
// through shared memory in chunks of 4 and keeps its (q x 256/q x 32)
// output tile in registers.
// Bound on an H100: 4 * 128 * n float32 FMAs per transformed line
// (17 GFLOP per 4096^2 plane), fed from shared memory with broadcast
// table reads; a plane is read and written once (64 MB at 4096^2 does
// not fit the 50 MB L2). No tensor cores yet.
#include <cuda_runtime.h>

namespace {

constexpr int L = 128;     // minor digit length
constexpr int NT = 256;    // threads per block
constexpr int FT = 32;     // lane kernel: free-digit tile
constexpr int HP = L + 1;  // padded H row (conflict-free column reads)
constexpr int CT = 32;     // sub kernel: columns per block
constexpr int JB = 4;      // sub kernel: b-digit chunk

// one row of n = Q * 128 per block; dynamic smem n + 2 * FT * HP floats
template <int Q>
__global__ void __launch_bounds__(NT) lane_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const float2* __restrict__ A, const float2* __restrict__ V,
    const float2* __restrict__ B, float in_scale, int half0) {
  constexpr int n = Q * L;
  constexpr int SQ = Q / 8;  // stage-B outputs per thread
  extern __shared__ float sm[];
  float* xs = sm;                 // [n]
  float* Hr = xs + n;             // [FT][HP]
  float* Hi = Hr + FT * HP;
  const size_t row = blockIdx.x;
  const float* xr = x + row * n;
  for (int e = threadIdx.x; e < n; e += NT) {
    float v = xr[e] * in_scale;
    if (half0 && e == 0) v *= 0.5f;
    xs[e] = v;
  }
  __syncthreads();
  float* yr = y + row * n;
  for (int a0 = 0; a0 < L; a0 += FT) {
    {  // stage A: H[a][b] = V'[a][b] sum_t A[a][t] xs[t*128 + b]
      const int b = threadIdx.x & (L - 1);
      const int ag = (threadIdx.x >> 7) * (FT / 2);
      float gr[FT / 2], gi[FT / 2];
#pragma unroll
      for (int i = 0; i < FT / 2; ++i) gr[i] = gi[i] = 0.f;
#pragma unroll 4
      for (int t = 0; t < Q; ++t) {
        const float xv = xs[t * L + b];
#pragma unroll
        for (int i = 0; i < FT / 2; ++i) {
          const float2 w = A[(a0 + ag + i) * Q + t];
          gr[i] = fmaf(w.x, xv, gr[i]);
          gi[i] = fmaf(w.y, xv, gi[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < FT / 2; ++i) {
        const float2 v = V[(a0 + ag + i) * L + b];
        Hr[(ag + i) * HP + b] = v.x * gr[i] - v.y * gi[i];
        Hi[(ag + i) * HP + b] = v.y * gr[i] + v.x * gi[i];
      }
    }
    __syncthreads();
    {  // stage B: y[s*128 + a] = 2 Re sum_b B[s][b] H[a][b]
      const int f = threadIdx.x & 31;
      const int sg = threadIdx.x >> 5;
      float acc[SQ];
#pragma unroll
      for (int i = 0; i < SQ; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int b = 0; b < L; ++b) {
        const float hr = Hr[f * HP + b], hi = Hi[f * HP + b];
#pragma unroll
        for (int i = 0; i < SQ; ++i) {
          const float2 u = B[(sg + 8 * i) * L + b];
          acc[i] = fmaf(u.x, hr, acc[i]);
          acc[i] = fmaf(-u.y, hi, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < SQ; ++i)
        yr[(sg + 8 * i) * L + a0 + f] = 2.f * acc[i];
    }
    __syncthreads();
  }
}

// grid (ceil(m / 32), 128 / AT, batch) with AT = 256 / Q free values per
// block; the (Q x AT x 32) output tile stays in registers (32 a thread)
template <int Q>
__global__ void __launch_bounds__(NT) sub_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const float2* __restrict__ A, const float2* __restrict__ V,
    const float2* __restrict__ B, int m, float in_scale, int half0) {
  constexpr int n = Q * L;
  constexpr int AT = 256 / Q;
  constexpr int NO = Q * AT / 8;  // outputs per thread (= 32)
  __shared__ float xs[Q][JB][CT];
  __shared__ float Hr[AT][JB][CT];
  __shared__ float Hi[AT][JB][CT];
  const int c = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int col = blockIdx.x * CT + c;
  const bool live = col < m;
  const int a0 = blockIdx.y * AT;
  const size_t plane = (size_t)blockIdx.z * n * m;
  const float* xb = x + plane;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  for (int b0 = 0; b0 < L; b0 += JB) {
    for (int r = g; r < Q * JB; r += 8) {
      const int t = r / JB, bb = r % JB;
      const int j = t * L + b0 + bb;
      float v = live ? xb[(size_t)j * m + col] * in_scale : 0.f;
      if (half0 && j == 0) v *= 0.5f;
      xs[t][bb][c] = v;
    }
    __syncthreads();
    // stage A: H[a][bb] = V'[a][b] sum_t A[a][t] xs[t][bb]
    for (int r = g; r < AT * JB; r += 8) {
      const int a = r / JB, bb = r % JB;
      float gr = 0.f, gi = 0.f;
#pragma unroll 8
      for (int t = 0; t < Q; ++t) {
        const float2 w = A[(a0 + a) * Q + t];
        const float xv = xs[t][bb][c];
        gr = fmaf(w.x, xv, gr);
        gi = fmaf(w.y, xv, gi);
      }
      const float2 v = V[(a0 + a) * L + b0 + bb];
      Hr[a][bb][c] = v.x * gr - v.y * gi;
      Hi[a][bb][c] = v.y * gr + v.x * gi;
    }
    __syncthreads();
    // stage B: acc[s, a] += Re B[s][b] H[a][bb]
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int p = g + 8 * i;
      const int s = p / AT, a = p % AT;
#pragma unroll
      for (int bb = 0; bb < JB; ++bb) {
        const float2 u = B[s * L + b0 + bb];
        acc[i] = fmaf(u.x, Hr[a][bb][c], acc[i]);
        acc[i] = fmaf(-u.y, Hi[a][bb][c], acc[i]);
      }
    }
    __syncthreads();
  }
  if (!live) return;
  float* yb = y + plane;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int p = g + 8 * i;
    const int s = p / AT, a = p % AT;
    yb[(size_t)(s * L + a0 + a) * m + col] = 2.f * acc[i];
  }
}

template <int Q>
int launch_lane(const float* x, float* y, const float2* A, const float2* V,
                const float2* B, int rows, float in_scale, int half0,
                cudaStream_t stream) {
  const size_t smem = ((size_t)Q * L + 2 * FT * HP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lane_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lane_kernel<Q><<<rows, NT, smem, stream>>>(x, y, A, V, B, in_scale, half0);
  return (int)cudaGetLastError();
}

template <int Q>
int launch_sub(const float* x, float* y, const float2* A, const float2* V,
               const float2* B, int batch, int m, float in_scale, int half0,
               cudaStream_t stream) {
  dim3 grid((m + CT - 1) / CT, L / (256 / Q), batch);
  sub_kernel<Q><<<grid, NT, 0, stream>>>(x, y, A, V, B, m, in_scale, half0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (rows, n) contiguous; tables as in the header comment
int dct_lane(const float* x, float* y, const float* A, const float* V,
             const float* B, int rows, int n, float in_scale, int half0,
             cudaStream_t stream) {
  const float2* a = reinterpret_cast<const float2*>(A);
  const float2* v = reinterpret_cast<const float2*>(V);
  const float2* b = reinterpret_cast<const float2*>(B);
  switch (n) {
    case 1024: return launch_lane<8>(x, y, a, v, b, rows, in_scale, half0, stream);
    case 2048: return launch_lane<16>(x, y, a, v, b, rows, in_scale, half0, stream);
    case 4096: return launch_lane<32>(x, y, a, v, b, rows, in_scale, half0, stream);
    case 8192: return launch_lane<64>(x, y, a, v, b, rows, in_scale, half0, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// x, y: (batch, n, m) contiguous, transformed along n
int dct_sub(const float* x, float* y, const float* A, const float* V,
            const float* B, int batch, int n, int m, float in_scale,
            int half0, cudaStream_t stream) {
  const float2* a = reinterpret_cast<const float2*>(A);
  const float2* v = reinterpret_cast<const float2*>(V);
  const float2* b = reinterpret_cast<const float2*>(B);
  switch (n) {
    case 1024: return launch_sub<8>(x, y, a, v, b, batch, m, in_scale, half0, stream);
    case 2048: return launch_sub<16>(x, y, a, v, b, batch, m, in_scale, half0, stream);
    case 4096: return launch_sub<32>(x, y, a, v, b, batch, m, in_scale, half0, stream);
    case 8192: return launch_sub<64>(x, y, a, v, b, batch, m, in_scale, half0, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
