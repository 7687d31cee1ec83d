// Periodic expansion of an averaged unit cell onto an image grid.
//
// Replaces the TPU kernel pygpa_tpu/ops/pallas_expand.py _expand_kernel
// (entry expand_cell). Wrapper and plain twin: pygpa_tpu_torch/ops/expand.py.
//
// The TPU kernel kept the cell in VMEM and resampled it with dense
// kernel-function matrices over every cell column (an MXU product) and a
// row reduction: no gathers, no coordinate arrays. Here each thread
// computes the cell position of a pixel from the 12 scalars exactly as
// the TPU kernel does (x = (i, j) / z2 + u, f = A x mod 1 as f - floor f,
// X = (A^-1 f - rmin) z) and sums the 2 x 2 (hat) or 4 x 4 (B-spline,
// Catmull-Rom) taps around X, each weighted by the kernel function at its
// signed distance, taps outside the cell weighted 0: the dense product
// restricted to its nonzero terms, in the same order (columns within a
// row, then rows).
//
// Bound on an H100 by the output write (and u's read when given). The
// launch:
// - work items are runs of NT * 4 columns of one row; a thread takes 4
//   adjacent pixels of a run and writes them as one 16-byte store when
//   every row starts on a 16-byte boundary (m % 4 == 0, aligned planes),
//   else one scalar store each, with the row's tail masked. Row and
//   column come from the item and thread indices in 32-bit arithmetic
//   (the wrapper refuses n m >= 2^31); no pixel index is divided;
// - shared route (cells up to 227 KB): a persistent grid of as many
//   512-thread blocks as fit the card's SMs (counted on the device), each
//   staging the cell in shared memory once and walking the items;
// - L1 route (larger cells, or forced by the wrapper's route predicate):
//   no staging, the cell read through the read-only path with the L1
//   carveout at its maximum, 256-thread blocks at full occupancy.
// Function attributes, the SM count and the occupancy are set and read
// once per device and cell size, not per call.
#include <cuda_runtime.h>

namespace {

constexpr int NT_SMEM = 512;
constexpr int NT_L1 = 256;
constexpr int VEC = 4;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int MAX_DEV = 64;
enum { HAT = 0, CATMULL = 1, BSPLINE = 2 };

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

struct Scalars {
  float a00, a01, a10, a11, b00, b01, b10, b11, rmin0, rmin1, z, inv_z2;
};

// the kernel function at signed distance d of tap b (first tap at
// floor(X) - 1 of four, at floor(X) of two). kfun(|d|) takes its inner
// piece at |d| < 1, its outer piece at 1 <= |d| < 2 and 0 beyond. For a
// fraction t = X - floor(X) in [0, 1), taps 1 and 2 of four lie at
// rounded |d| in [0, 1] and taps 0 and 3 at [1, 2]; the two pieces give
// the same bits at |d| = 1 and the outer one +0 at |d| = 2, so each tap
// takes one piece, fixed when the tap loop unrolls, bit for bit kfun's.
template <int WF>
__device__ __forceinline__ float kfun(float d, bool inner) {
  const float a = fabsf(d);
  if (WF == HAT) return fmaxf(sub(1.f, a), 0.f);
  if (WF == CATMULL)
    return inner ? add(mul(mul(sub(mul(1.5f, a), 2.5f), a), a), 1.f)
                 : add(mul(sub(mul(add(mul(-0.5f, a), 2.5f), a), 4.f), a), 2.f);
  const float s = 1.0f / 6.0f;
  if (inner) return mul(s, add(4.f, mul(mul(a, a), sub(mul(3.f, a), 6.f))));
  const float t = sub(2.f, a);
  return mul(mul(mul(s, t), t), t);
}

template <bool SMEM>
__device__ __forceinline__ float ld(const float* p) {
  return SMEM ? *p : __ldg(p);
}

// one pixel at position (ii, jj) (already divided by z2, u added)
template <int TAPS, int WF, bool SMEM>
__device__ __forceinline__ float pixel(const float* cp, int R0, int R1,
                                       float ii, float jj, const Scalars& s) {
  const int first = TAPS == 2 ? 0 : -1;
  float f0 = add(mul(s.a00, ii), mul(s.a01, jj));
  float f1 = add(mul(s.a10, ii), mul(s.a11, jj));
  f0 = sub(f0, floorf(f0));
  f1 = sub(f1, floorf(f1));
  const float X0 = mul(sub(add(mul(s.b00, f0), mul(s.b01, f1)), s.rmin0), s.z);
  const float X1 = mul(sub(add(mul(s.b10, f0), mul(s.b11, f1)), s.rmin1), s.z);
  const float fl0 = floorf(X0), fl1 = floorf(X1);
  // taps inside the cell (tested on the float position, as the twin
  // does), their cell index from one conversion
  const int c0 = (int)fl1 + first, r0 = (int)fl0 + first;
  float wx[TAPS];
  int cx[TAPS];
#pragma unroll
  for (int b = 0; b < TAPS; ++b) {
    const float c = fl1 + (float)(first + b);
    const bool ok = c >= 0.f && c < (float)R1;
    wx[b] = ok ? kfun<WF>(sub(X1, c), b == 1 || b == 2) : 0.f;
    cx[b] = ok ? c0 + b : 0;
  }
  float v = 0.f;
#pragma unroll
  for (int a = 0; a < TAPS; ++a) {
    const float r = fl0 + (float)(first + a);
    if (!(r >= 0.f && r < (float)R0)) continue;
    const float wy = kfun<WF>(sub(X0, r), a == 1 || a == 2);
    const float* row = cp + (r0 + a) * R1;
    float g = 0.f;
#pragma unroll
    for (int b = 0; b < TAPS; ++b)
      g = add(g, mul(wx[b], ld<SMEM>(row + cx[b])));
    v = add(v, mul(wy, g));
  }
  return v;
}

template <int TAPS, int WF, bool SMEM, int NT>
__global__ void __launch_bounds__(NT) expand_kernel(
    const float* __restrict__ cell, int R0, int R1,
    const float* __restrict__ u0, const float* __restrict__ u1,
    float* __restrict__ out, int n, int m, int chunks, bool vec, Scalars s) {
  extern __shared__ float s_cell[];
  const float* cp = cell;
  if (SMEM) {
    for (int k = threadIdx.x; k < R0 * R1; k += NT) s_cell[k] = cell[k];
    __syncthreads();
    cp = s_cell;
  }
  const int items = n * chunks;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int i = w / chunks;
    const int j = (w - i * chunks) * (NT * VEC) + threadIdx.x * VEC;
    if (j >= m) continue;
    const int p = i * m + j;
    const float ii = mul((float)i, s.inv_z2);
    float ua[VEC], ub[VEC], v[VEC];
    if (u0 != nullptr) {
      if (vec) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(u0 + p));
        const float4 b = __ldg(reinterpret_cast<const float4*>(u1 + p));
        ua[0] = a.x; ua[1] = a.y; ua[2] = a.z; ua[3] = a.w;
        ub[0] = b.x; ub[1] = b.y; ub[2] = b.z; ub[3] = b.w;
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          ua[k] = j + k < m ? u0[p + k] : 0.f;
          ub[k] = j + k < m ? u1[p + k] : 0.f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float ik = ii, jk = mul((float)(j + k), s.inv_z2);
      if (u0 != nullptr) {
        ik = add(ik, ua[k]);
        jk = add(jk, ub[k]);
      }
      v[k] = pixel<TAPS, WF, SMEM>(cp, R0, R1, ik, jk, s);
    }
    if (vec) {
      *reinterpret_cast<float4*>(out + p) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (j + k < m) out[p + k] = v[k];
    }
  }
}

// the card's SM count, read once per device (0 <= dev < MAX_DEV)
int sm_count(int dev) {
  static int sms[MAX_DEV] = {};
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

template <int TAPS, int WF, bool SMEM>
int launch(const float* cell, int R0, int R1, const float* u0,
           const float* u1, float* out, int n, int m, const Scalars& s,
           cudaStream_t stream) {
  constexpr int NT = SMEM ? NT_SMEM : NT_L1;
  auto kern = expand_kernel<TAPS, WF, SMEM, NT>;
  const int bytes = SMEM ? R0 * R1 * (int)sizeof(float) : 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  // per instantiation: attributes set once a device; blocks an SM for the
  // last cell size seen on it
  static bool attr_set[MAX_DEV] = {};
  static int occ_bytes[MAX_DEV], occ[MAX_DEV];
  if (!attr_set[dev]) {
    const cudaError_t e =
        SMEM ? cudaFuncSetAttribute(
                   kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX)
             : cudaFuncSetAttribute(
                   kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                   (int)cudaSharedmemCarveoutMaxL1);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
    occ_bytes[dev] = -1;
  }
  if (occ_bytes[dev] != bytes) {
    int k = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, kern, NT, bytes);
    if (e != cudaSuccess) return (int)e;
    occ[dev] = k > 0 ? k : 1;
    occ_bytes[dev] = bytes;
  }
  const int chunks = (m + NT * VEC - 1) / (NT * VEC);
  const long long items = (long long)n * chunks;
  const long long cap = (long long)sm_count(dev) * occ[dev];
  const unsigned blocks = (unsigned)(items < cap ? items : cap);
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<size_t>(p) & 15) == 0;
  };
  const bool vec = m % VEC == 0 && aligned(out) &&
                   (u0 == nullptr || (aligned(u0) && aligned(u1)));
  kern<<<blocks, NT, bytes, stream>>>(cell, R0, R1, u0, u1, out, n, m,
                                      chunks, vec, s);
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

// smem != 0 takes the shared route (the cell must fit SMEM_MAX bytes)
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
