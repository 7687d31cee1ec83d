// Periodic expansion of an averaged unit cell onto an image grid.
//
// Replaces the TPU kernel pygpa_tpu/ops/pallas_expand.py _expand_kernel
// (entry expand_cell). Wrapper and plain twin: pygpa_tpu_torch/ops/expand.py.
//
// The TPU kernel kept the cell in VMEM and resampled it with dense
// kernel-function matrices over every cell column (an MXU product) and a
// row reduction: no gathers, no coordinate arrays. Here each thread takes
// output pixels in a grid-stride loop, computes the cell position from
// the 12 scalars exactly as the TPU kernel does (x = (i, j) / z2 + u,
// f = A x mod 1 as f - floor f, X = (A^-1 f - rmin) z) and sums the 2 x 2
// (hat) or 4 x 4 (B-spline, Catmull-Rom) taps around X, each weighted by
// the kernel function at its signed distance, taps outside the cell
// weighted 0: the dense product restricted to its nonzero terms, in the
// same order (columns within a row, then rows). The cell is staged in
// shared memory when it fits (96 KB; 83 KB for the 122 x 170 padded cell
// of a 4096^2 lattice at z = 2), else read through L1. Bound on an H100
// by the output write (and u's read when given).
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int SMEM_MAX = 96 * 1024;
enum { HAT = 0, CATMULL = 1, BSPLINE = 2 };

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

struct Scalars {
  float a00, a01, a10, a11, b00, b01, b10, b11, rmin0, rmin1, z, inv_z2;
};

template <int WF>
__device__ __forceinline__ float kfun(float d) {
  const float a = fabsf(d);
  if (WF == HAT) return fmaxf(sub(1.f, a), 0.f);
  if (WF == CATMULL) {
    const float inner = add(mul(mul(sub(mul(1.5f, a), 2.5f), a), a), 1.f);
    const float outer =
        add(mul(sub(mul(add(mul(-0.5f, a), 2.5f), a), 4.f), a), 2.f);
    return a < 1.f ? inner : (a < 2.f ? outer : 0.f);
  }
  const float s = 1.0f / 6.0f;
  const float inner = mul(s, add(4.f, mul(mul(a, a), sub(mul(3.f, a), 6.f))));
  const float t = sub(2.f, a);
  const float outer = mul(mul(mul(s, t), t), t);
  return a < 1.f ? inner : (a < 2.f ? outer : 0.f);
}

template <int TAPS, int WF, bool SMEM>
__global__ void __launch_bounds__(NT) expand_kernel(
    const float* __restrict__ cell, int R0, int R1,
    const float* __restrict__ u0, const float* __restrict__ u1,
    float* __restrict__ out, int n, int m, Scalars s) {
  extern __shared__ float s_cell[];
  const float* cp = cell;
  if (SMEM) {
    for (int k = threadIdx.x; k < R0 * R1; k += NT) s_cell[k] = cell[k];
    __syncthreads();
    cp = s_cell;
  }
  const int first = TAPS == 2 ? 0 : -1;
  const size_t total = (size_t)n * m;
  for (size_t p = (size_t)blockIdx.x * NT + threadIdx.x; p < total;
       p += (size_t)gridDim.x * NT) {
    const int i = (int)(p / m), j = (int)(p % m);
    float ii = mul((float)i, s.inv_z2), jj = mul((float)j, s.inv_z2);
    if (u0 != nullptr) {
      ii = add(ii, u0[p]);
      jj = add(jj, u1[p]);
    }
    float f0 = add(mul(s.a00, ii), mul(s.a01, jj));
    float f1 = add(mul(s.a10, ii), mul(s.a11, jj));
    f0 = sub(f0, floorf(f0));
    f1 = sub(f1, floorf(f1));
    const float X0 = mul(sub(add(mul(s.b00, f0), mul(s.b01, f1)), s.rmin0), s.z);
    const float X1 = mul(sub(add(mul(s.b10, f0), mul(s.b11, f1)), s.rmin1), s.z);
    const float fl0 = floorf(X0), fl1 = floorf(X1);
    float wx[TAPS];
    int cx[TAPS];
#pragma unroll
    for (int b = 0; b < TAPS; ++b) {
      const float c = fl1 + (float)(first + b);
      const bool ok = c >= 0.f && c < (float)R1;
      wx[b] = ok ? kfun<WF>(sub(X1, c)) : 0.f;
      cx[b] = ok ? (int)c : 0;
    }
    float v = 0.f;
#pragma unroll
    for (int a = 0; a < TAPS; ++a) {
      const float r = fl0 + (float)(first + a);
      if (!(r >= 0.f && r < (float)R0)) continue;
      const float wy = kfun<WF>(sub(X0, r));
      const float* row = cp + (size_t)r * R1;
      float g = 0.f;
#pragma unroll
      for (int b = 0; b < TAPS; ++b) g = add(g, mul(wx[b], row[cx[b]]));
      v = add(v, mul(wy, g));
    }
    out[p] = v;
  }
}

template <int TAPS, int WF, bool SMEM>
int launch(const float* cell, int R0, int R1, const float* u0,
           const float* u1, float* out, int n, int m, const Scalars& s,
           cudaStream_t stream) {
  const size_t bytes = SMEM ? (size_t)R0 * R1 * sizeof(float) : 0;
  if (SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        expand_kernel<TAPS, WF, SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t total = (size_t)n * m;
  // enough blocks to fill the card; each stages the cell once
  const size_t want = (total + NT - 1) / NT;
  const unsigned blocks = (unsigned)(want < 132 * 8 ? want : 132 * 8);
  expand_kernel<TAPS, WF, SMEM><<<blocks, NT, bytes, stream>>>(
      cell, R0, R1, u0, u1, out, n, m, s);
  return (int)cudaGetLastError();
}

template <bool SMEM>
int dispatch(int order, int weight, const float* cell, int R0, int R1,
             const float* u0, const float* u1, float* out, int n, int m,
             const Scalars& s, cudaStream_t stream) {
  if (order == 1)
    return launch<2, HAT, SMEM>(cell, R0, R1, u0, u1, out, n, m, s, stream);
  if (weight == BSPLINE)
    return launch<4, BSPLINE, SMEM>(cell, R0, R1, u0, u1, out, n, m, s,
                                    stream);
  return launch<4, CATMULL, SMEM>(cell, R0, R1, u0, u1, out, n, m, s, stream);
}

}  // namespace

extern "C" {

int expand_cell(const float* cell, int R0, int R1, const float* u0,
                const float* u1, float* out, int n, int m, int order,
                int weight, int smem, float a00, float a01, float a10,
                float a11, float b00, float b01, float b10, float b11,
                float rmin0, float rmin1, float z, float inv_z2,
                cudaStream_t stream) {
  if ((size_t)n * m == 0) return 0;
  const Scalars s{a00, a01, a10, a11, b00, b01, b10, b11,
                  rmin0, rmin1, z, inv_z2};
  if (smem && (size_t)R0 * R1 * sizeof(float) <= (size_t)SMEM_MAX)
    return dispatch<true>(order, weight, cell, R0, R1, u0, u1, out, n, m, s,
                          stream);
  return dispatch<false>(order, weight, cell, R0, R1, u0, u1, out, n, m, s,
                         stream);
}

}  // extern "C"
