// Drizzle of an image into its averaged unit cell.
//
// Replaces the TPU kernel pygpa_tpu/ops/pallas_drizzle.py _drizzle_kernel
// (entry drizzle). Wrapper and plain twin: pygpa_tpu_torch/ops/drizzle.py.
//
// The TPU kernel avoided scatters: per pixel tile it built dense hat
// matrices over every cell row and column and contracted them on the MXU
// into VMEM-resident accumulators. Here one thread per pixel computes
// its cell position from the 11 scalars (x = (i, j) + u, f = A x mod 1 as
// f - floor f, X = (A^-1 f - rmin) z) and adds its 2 x 2 hat taps into
// two int64 fixed-point planes with integer atomics (RED on L2). Integer
// adds commute, so the result is bit-identical from launch to launch,
// which float atomics would not be. The scale 2^(62 - e), N max|v| < 2^e,
// bounds every bin below 2^62 and each add's rounding by 2^(e - 63).
// The planes (2 x 8 bytes per bin; 313 KB for a 118 x 166 cell, up to
// 4 MB at 512 x 512) exceed one block's shared memory, so they live in
// device memory, mostly in L2. Bound on an H100 by L2 atomic throughput:
// 8 atomics per pixel. A second launch turns the planes into float32.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

struct Scalars {
  float a00, a01, a10, a11, b00, b01, b10, b11, rmin0, rmin1, z;
};

// fixed-point scale for sums of up to `count` terms of magnitude <= vmax
__device__ __forceinline__ double fixed_scale(float vmax, long long count) {
  const double bound = (double)count * (double)vmax;
  if (!(bound > 0.0)) return 1.0;
  int e;
  frexp(bound, &e);            // bound < 2^e
  return ldexp(1.0, 62 - e);
}

__device__ __forceinline__ void red_add(long long* p, float v, double scale) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            (unsigned long long)__double2ll_rn((double)v * scale));
}

// one thread per pixel; grid ceil(n m / NT)
__global__ void __launch_bounds__(NT) drizzle_kernel(
    const float* __restrict__ img, const float* __restrict__ u0,
    const float* __restrict__ u1, const float* __restrict__ vmax,
    long long* __restrict__ acc, int n, int m, int R0, int R1, Scalars s) {
  const size_t p = (size_t)blockIdx.x * NT + threadIdx.x;
  if (p >= (size_t)n * m) return;
  const int i = (int)(p / m), j = (int)(p % m);
  float ii = (float)i, jj = (float)j;
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
  const float t0 = sub(X0, fl0), t1 = sub(X1, fl1);
  const int r0 = (int)fminf(fmaxf(fl0, -2.f), (float)R0);
  const int c0 = (int)fminf(fmaxf(fl1, -2.f), (float)R1);
  const float v = img[p];
  const bool valid = v == v;
  const float val = valid ? v : 0.f, vw = valid ? 1.f : 0.f;
  const long long count = (long long)n * m;
  const double sv = fixed_scale(*vmax, count), sw = fixed_scale(1.f, count);
  long long* acc_v = acc;
  long long* acc_w = acc + (size_t)R0 * R1;
#pragma unroll
  for (int li = 0; li < 2; ++li) {
    const int r = r0 + li;
    if (r < 0 || r >= R0) continue;
    const float hy = li ? t0 : sub(1.f, t0);
    const float hv = mul(hy, val), hw = mul(hy, vw);
#pragma unroll
    for (int lj = 0; lj < 2; ++lj) {
      const int c = c0 + lj;
      if (c < 0 || c >= R1) continue;
      const float hx = lj ? t1 : sub(1.f, t1);
      const size_t o = (size_t)r * R1 + c;
      red_add(acc_v + o, mul(hv, hx), sv);
      red_add(acc_w + o, mul(hw, hx), sw);
    }
  }
}

__global__ void __launch_bounds__(NT) finish_kernel(
    const long long* __restrict__ acc, const float* __restrict__ vmax,
    float* __restrict__ out, int bins, long long count) {
  const int k = blockIdx.x * NT + threadIdx.x;
  if (k >= 2 * bins) return;
  const double scale = k < bins ? fixed_scale(*vmax, count)
                                : fixed_scale(1.f, count);
  out[k] = (float)((double)acc[k] / scale);
}

}  // namespace

extern "C" {

// acc: zeroed (2, R0, R1) int64; out: (2, R0, R1) float32 (sum, weights)
int drizzle(const float* img, const float* u0, const float* u1,
            const float* vmax, long long* acc, float* out, int n, int m,
            int R0, int R1, float a00, float a01, float a10, float a11,
            float b00, float b01, float b10, float b11, float rmin0,
            float rmin1, float z, cudaStream_t stream) {
  const Scalars s{a00, a01, a10, a11, b00, b01, b10, b11, rmin0, rmin1, z};
  const size_t total = (size_t)n * m;
  if (total > 0) {
    drizzle_kernel<<<(unsigned)((total + NT - 1) / NT), NT, 0, stream>>>(
        img, u0, u1, vmax, acc, n, m, R0, R1, s);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int bins = R0 * R1;
  finish_kernel<<<(2 * bins + NT - 1) / NT, NT, 0, stream>>>(
      acc, vmax, out, bins, (long long)total);
  return (int)cudaGetLastError();
}

}  // extern "C"
