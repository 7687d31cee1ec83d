// The robust plane fit's Huber IRLS: one launch a step, the 3x3 normal
// equations summed and solved on the device.
//
// Replaces pygpa_tpu/core/mathtools.py _fit_plane_irls, the reference's
// jitted lax.fori_loop of 60 IRLS steps after a first solve, which XLA
// fuses on the TPU into a few reductions a step (no Pallas kernel).
// Wrapper, gate and plain twin: pygpa_tpu_torch/ops/fit.py.
//
// A (B, n, m) float32 stack of planes, coordinates from the grid's
// centre, x = i - (n - 1) / 2 along the rows and y = j - (m - 1) / 2
// along the columns (half integers, exact in float32), as the twin
// takes them. A step of plane b from its coefficients p (the previous
// step's, float32): plane value p0 x + (p1 y + p2), residual r = v -
// plane, weight w = mask min(1, f_scale / max(|r|, 1e-30)) (w = mask on
// the first step), rounded as the twin's torch ops round them (no FMA
// contraction). The nine normal-equation sums: S w, S w x, S w y,
// S w x^2, S w x y, S w y^2, S w v, S w v x, S w v y.
//
// A block takes TILE consecutive pixels of one plane (flat index, so any
// row length and any plane start: scalar loads, a warp's 32 on
// consecutive addresses; a 4086-float row is off the 16-byte grid). Each
// thread adds its EPT pixels in float32, the block adds its threads in
// float64 in a fixed order (warp shuffles, then the warps in order) and
// stores its nine partials. The plane's last block to finish (an integer
// counter a plane, cg_unwrap.cuh's pattern) adds the plane's partials in
// float64 in the same order every step, solves the 3x3 system in float64
// (Gaussian elimination, partial pivoting) and stores the new p as
// float32 for the next launch; on the fit's last launch it also stores
// the coefficients with the offset moved back, p2 - p0 cx - p1 cy, in
// float32 as the twin forms them. iters + 1 launches a fit, no host sync,
// no solver library; a fit repeats bit for bit.
//
// Bound on an H100: HBM bytes. A step reads the stack once (and the mask
// where there is one): (3, 4086^2) float32 is 200 MB, 0.060 ms at 3.35
// TB/s; ~20 float32 operations a pixel, 1 GFLOP, is 0.015 ms at 67
// TFLOP/s. The design reads each pixel once a step with enough loads in
// flight (EPT independent loads a thread) and keeps every other byte on
// chip: the partials are 72 bytes a block.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads a block
constexpr int EPT = 16;          // pixels a thread
constexpr int TILE = NT * EPT;   // pixels a block
constexpr int NS = 9;            // normal-equation sums
constexpr int NW = NT / 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The block's nine sums of s, in a fixed order, into tot (shared).
__device__ __forceinline__ void block_sums(const double (&s)[NS], double* sh,
                                           double* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const double v = warp_sum(s[k]);
    if (lane == 0) sh[warp * NS + k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NS) {
    double v = 0.0;
    for (int w = 0; w < NW; ++w) v += sh[w * NS + threadIdx.x];
    tot[threadIdx.x] = v;
  }
  __syncthreads();
}

// Solve [[sxx sxy sx] [sxy syy sy] [sx sy s1]] q = [bx by b1] in float64
// (Gaussian elimination with partial pivoting, as LAPACK's getrf/getrs).
__device__ void solve3(const double* t, double* q) {
  // t: S w, S wx, S wy, S wxx, S wxy, S wyy, S wv, S wvx, S wvy
  double a[3][4] = {{t[3], t[4], t[1], t[7]},
                    {t[4], t[5], t[2], t[8]},
                    {t[1], t[2], t[0], t[6]}};
  for (int c = 0; c < 3; ++c) {
    int piv = c;
    for (int r = c + 1; r < 3; ++r)
      if (fabs(a[r][c]) > fabs(a[piv][c])) piv = r;
    if (piv != c)
      for (int k = 0; k < 4; ++k) {
        const double tmp = a[c][k];
        a[c][k] = a[piv][k];
        a[piv][k] = tmp;
      }
    for (int r = c + 1; r < 3; ++r) {
      const double f = a[r][c] / a[c][c];
      for (int k = c; k < 4; ++k) a[r][k] -= f * a[c][k];
    }
  }
  for (int r = 2; r >= 0; --r) {
    double v = a[r][3];
    for (int k = r + 1; k < 3; ++k) v -= a[r][k] * q[k];
    q[r] = v / a[r][r];
  }
}

// One IRLS step of every plane: grid (blocks a plane, B). img: (B, n, m);
// mask: uint8 (0 / 1) planes, plane b at mask + b * mask_plane (0: one
// plane for all), read only when MASKED; p: (B, 3) the current
// coefficients (centred), rewritten by each plane's last block; part:
// (B, NS, nb) partials; count: (B,) zero before the first launch, left
// zero by every launch; out: (B, 3), written on the last launch.
template <bool FIRST, bool MASKED>
__global__ void __launch_bounds__(NT) irls_step_kernel(
    const float* __restrict__ img, const unsigned char* __restrict__ mask,
    int mask_plane, float* __restrict__ p, double* __restrict__ part,
    unsigned int* __restrict__ count, float* __restrict__ out, int n, int m,
    float f_scale, int last) {
  __shared__ double sh[NW * NS];
  __shared__ double tot[NS];
  __shared__ int flag;
  const int b = blockIdx.y, nb = gridDim.x;
  const long long nm = (long long)n * m;
  const float* __restrict__ v = img + (size_t)b * nm;
  const float cx = 0.5f * (float)(n - 1), cy = 0.5f * (float)(m - 1);
  float p0 = 0.f, p1 = 0.f, p2 = 0.f;
  if (!FIRST) {
    p0 = p[3 * b];
    p1 = p[3 * b + 1];
    p2 = p[3 * b + 2];
  }
  const long long e0 = (long long)blockIdx.x * TILE + threadIdx.x;
  float val[EPT];
  bool in[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const long long e = e0 + k * NT;
    in[k] = e < nm;
    if (MASKED && in[k])
      in[k] = mask[(size_t)b * mask_plane + e] != 0;
    val[k] = in[k] ? __ldg(v + e) : 0.f;
  }
  float acc[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) acc[k] = 0.f;
  int i = (int)(e0 / m), j = (int)(e0 - (long long)i * m);
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    if (in[k]) {
      const float x = __fsub_rn((float)i, cx), y = __fsub_rn((float)j, cy);
      float w = 1.f;
      if (!FIRST) {
        const float pl = __fadd_rn(__fmul_rn(p0, x),
                                   __fadd_rn(__fmul_rn(p1, y), p2));
        const float r = __fsub_rn(val[k], pl);
        w = fminf(1.f, __fdiv_rn(f_scale, fmaxf(fabsf(r), 1e-30f)));
      }
      const float wx = __fmul_rn(w, x), wy = __fmul_rn(w, y),
                  wv = __fmul_rn(w, val[k]);
      acc[0] += w;
      acc[1] += wx;
      acc[2] += wy;
      acc[3] = fmaf(wx, x, acc[3]);
      acc[4] = fmaf(wx, y, acc[4]);
      acc[5] = fmaf(wy, y, acc[5]);
      acc[6] += wv;
      acc[7] = fmaf(wv, x, acc[7]);
      acc[8] = fmaf(wv, y, acc[8]);
    }
    j += NT;
    while (j >= m) {
      j -= m;
      ++i;
    }
  }
  double s[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) s[k] = (double)acc[k];
  block_sums(s, sh, tot);
  double* pp = part + (size_t)b * NS * nb;
  if (threadIdx.x < NS) {
    pp[(size_t)threadIdx.x * nb + blockIdx.x] = tot[threadIdx.x];
    __threadfence();  // the partial is visible before the count
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int before = atomicAdd(count + b, 1u);
    const int lastb = before == (unsigned int)(nb - 1);
    if (lastb) count[b] = 0u;
    flag = lastb;
  }
  __syncthreads();
  if (!flag) return;
  // the plane's last block: its nb partials in a fixed order (read from
  // L2: other blocks stored them)
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    double a = 0.0;
    for (int t = threadIdx.x; t < nb; t += NT)
      a += __ldcg(pp + (size_t)k * nb + t);
    s[k] = a;
  }
  block_sums(s, sh, tot);
  if (threadIdx.x == 0) {
    double q[3];
    solve3(tot, q);
    const float q0 = (float)q[0], q1 = (float)q[1], q2 = (float)q[2];
    p[3 * b] = q0;
    p[3 * b + 1] = q1;
    p[3 * b + 2] = q2;
    if (last) {
      out[3 * b] = q0;
      out[3 * b + 1] = q1;
      out[3 * b + 2] = __fsub_rn(__fsub_rn(q2, __fmul_rn(q0, cx)),
                                 __fmul_rn(q1, cy));
    }
  }
}

template <bool FIRST>
cudaError_t launch(const float* img, const unsigned char* mask,
                   int mask_plane, float* p, double* part,
                   unsigned int* count, float* out, int B, int n, int m,
                   float f_scale, int last, cudaStream_t stream) {
  const dim3 grid((unsigned)(((long long)n * m + TILE - 1) / TILE), B);
  if (mask)
    irls_step_kernel<FIRST, true><<<grid, NT, 0, stream>>>(
        img, mask, mask_plane, p, part, count, out, n, m, f_scale, last);
  else
    irls_step_kernel<FIRST, false><<<grid, NT, 0, stream>>>(
        img, mask, mask_plane, p, part, count, out, n, m, f_scale, last);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// float64 partials a step needs: NS a block, blocks of TILE pixels a plane
long long fit_plane_part_doubles(int B, int n, int m) {
  return (long long)B * NS * (((long long)n * m + TILE - 1) / TILE);
}

// One IRLS step (see above). img: (B, n, m) float32; mask: null (no mask)
// or uint8 planes, plane b at mask + b * mask_plane; p, out: (B, 3)
// float32; part: fit_plane_part_doubles; count: B uints, zeroed here on
// the first step (first != 0), which ignores p; out is written when last
// != 0. Needs 1 <= B <= 65535 and 1 <= n m < 2^31.
int fit_plane_step(const float* img, const unsigned char* mask,
                   int mask_plane, float* p, double* part,
                   unsigned int* count, float* out, int B, int n, int m,
                   float f_scale, int first, int last, cudaStream_t stream) {
  if (B < 1 || B > 65535 || n < 1 || m < 1 ||
      (long long)n * m >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (first) {
    const cudaError_t err =
        cudaMemsetAsync(count, 0, B * sizeof(unsigned int), stream);
    if (err != cudaSuccess) return (int)err;
    return (int)launch<true>(img, mask, mask_plane, p, part, count, out, B,
                             n, m, f_scale, last, stream);
  }
  return (int)launch<false>(img, mask, mask_plane, p, part, count, out, B, n,
                            m, f_scale, last, stream);
}

}  // extern "C"
