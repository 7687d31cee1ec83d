// Drizzle of an image into its averaged unit cell.
//
// Replaces the TPU kernel pygpa_tpu/ops/pallas_drizzle.py _drizzle_kernel
// (entry drizzle). Wrapper, route predicate and plain twin:
// pygpa_tpu_torch/ops/drizzle.py.
//
// The TPU kernel avoided scatters: per pixel tile it built dense hat
// matrices over every cell row and column and contracted them on the MXU
// into VMEM-resident accumulators. Here each pixel computes its cell
// position from the 11 scalars (x = (i, j) + u, f = A x mod 1 as
// f - floor f, X = (A^-1 f - rmin) z) and adds its 2 x 2 hat taps into
// two int64 fixed-point planes (value and weight) with integer adds.
// Integer adds commute and are exact, so the result does not depend on
// the order of the adds: bit-identical from launch to launch and between
// the two routes, which float atomics would not be. The scale
// 2^(62 - e), N max|v| < 2^e, bounds every bin below 2^62 and each
// add's rounding by 2^(e - 63); max|v| over the non-NaN pixels comes
// from absmax_kernel, one pass over the image.
//
// Two routes, chosen by the wrapper from the cell's size:
//   shared (one int64 plane, R0 R1 x 8 bytes, fits a block's 227 KB of
//     shared memory: 157 KB at config 4's 118 x 166 cell): a grid of
//     one block per SM and plane (blockIdx.y: value or weight), each
//     taking a contiguous run of pixels, zeroes its plane in shared
//     memory, adds its taps there with 32-bit shared-memory atomics on
//     the bins' low and high words, and flushes each nonzero bin into
//     the global plane with one 64-bit atomic:
//     ~(blocks x bins) global atomics (2.6 M at config 4), not 8 per
//     pixel (134 M). Both planes (313 KB) do not fit one block, so the
//     planes split across blockIdx.y and each block computes its
//     pixels' positions itself (cheap next to the adds).
//   global (larger cells, up to the reference's 512 x 512): one thread
//     per pixel adds its 8 taps into the planes in device memory with
//     L2 atomics (RED); bound by L2 atomic throughput.
// A last launch turns the planes into float32.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int NT_SHARED = 1024;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

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

__device__ __forceinline__ unsigned long long fix(float v, double scale) {
  return (unsigned long long)__double2ll_rn((double)v * scale);
}

// pixel p's cell position and its taps inside the (R0, R1) cell:
// tap(bin, value * hat, weight * hat) for each, in float32
template <class Tap>
__device__ __forceinline__ void for_taps(size_t p, const float* img,
                                         const float* u0, const float* u1,
                                         int m, int R0, int R1,
                                         const Scalars& s, Tap tap) {
  const int i = (int)p / m, j = (int)p - i * m;  // n m < 2^31
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
      tap(r * R1 + c, mul(hv, hx), mul(hw, hx));
    }
  }
}

// max |v| over the non-NaN values of x into *out (zeroed beforehand), as
// the bits of a non-negative float, whose unsigned order is the floats'
// order: fmaxf skips NaN, and a max does not depend on the order, so
// block maxima and one atomicMax each give the same bits every run
__global__ void __launch_bounds__(NT) absmax_kernel(
    const float* __restrict__ x, size_t count, unsigned* __restrict__ out) {
  __shared__ float sh[NT / 32];
  float v = 0.f;
  for (size_t p = (size_t)blockIdx.x * NT + threadIdx.x; p < count;
       p += (size_t)gridDim.x * NT)
    v = fmaxf(v, fabsf(x[p]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) v = fmaxf(v, sh[w]);
    atomicMax(out, __float_as_uint(v));
  }
}

// global route: one thread per pixel; grid ceil(n m / NT)
__global__ void __launch_bounds__(NT) drizzle_kernel(
    const float* __restrict__ img, const float* __restrict__ u0,
    const float* __restrict__ u1, const float* __restrict__ vmax,
    unsigned long long* __restrict__ acc, int n, int m, int R0, int R1,
    Scalars s) {
  const size_t p = (size_t)blockIdx.x * NT + threadIdx.x;
  const long long count = (long long)n * m;
  if (p >= (size_t)count) return;
  const double sv = fixed_scale(*vmax, count), sw = fixed_scale(1.f, count);
  unsigned long long* acc_w = acc + (size_t)R0 * R1;
  for_taps(p, img, u0, u1, m, R0, R1, s, [&](int o, float tv, float tw) {
    atomicAdd(acc + o, fix(tv, sv));
    atomicAdd(acc_w + o, fix(tw, sw));
  });
}

// shared route: grid (G, 2); block (g, plane) adds the plane's taps of
// pixels [g P / G, (g + 1) P / G) into its copy of the plane in shared
// memory, then flushes the nonzero bins. Each int64 bin is two uint32
// words, low and high (lo[bin], hi[bin]): an int64 atomicAdd on shared
// memory compiles to a compare-and-swap loop (ATOMS.CAST.SPIN.64), a
// uint32 one to a native ATOMS.ADD. The low word's add returns its old
// value, and a carry out of it goes into the high word with the tap's
// high half, so lo + 2^32 hi is the int64 sum exactly, mod 2^64.
__device__ __forceinline__ void add_split(unsigned* lo, unsigned* hi,
                                          unsigned long long t) {
  const unsigned l = (unsigned)t;
  unsigned h = (unsigned)(t >> 32);
  if (l != 0u) {
    const unsigned old = atomicAdd(lo, l);
    h += (unsigned)(old + l < old);
  }
  if (h != 0u) atomicAdd(hi, h);
}

__global__ void __launch_bounds__(NT_SHARED) drizzle_shared_kernel(
    const float* __restrict__ img, const float* __restrict__ u0,
    const float* __restrict__ u1, const float* __restrict__ vmax,
    unsigned long long* __restrict__ acc, int n, int m, int R0, int R1,
    Scalars s) {
  extern __shared__ unsigned lo[];
  const int nbins = R0 * R1;
  unsigned* hi = lo + nbins;
  const bool weights = blockIdx.y == 1;
  for (int b = threadIdx.x; b < 2 * nbins; b += NT_SHARED) lo[b] = 0u;
  __syncthreads();
  const long long count = (long long)n * m;
  const double scale = fixed_scale(weights ? 1.f : *vmax, count);
  const size_t p0 = (size_t)(count * blockIdx.x / gridDim.x);
  const size_t p1 = (size_t)(count * (blockIdx.x + 1) / gridDim.x);
  for (size_t p = p0 + threadIdx.x; p < p1; p += NT_SHARED)
    for_taps(p, img, u0, u1, m, R0, R1, s, [&](int o, float tv, float tw) {
      add_split(lo + o, hi + o, fix(weights ? tw : tv, scale));
    });
  __syncthreads();
  unsigned long long* plane = acc + (weights ? (size_t)nbins : 0);
  for (int b = threadIdx.x; b < nbins; b += NT_SHARED) {
    const unsigned long long v = ((unsigned long long)hi[b] << 32) | lo[b];
    if (v != 0ull) atomicAdd(plane + b, v);
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

int launch_shared(const float* img, const float* u0, const float* u1,
                  const float* vmax, unsigned long long* acc, int n, int m,
                  int R0, int R1, const Scalars& s, cudaStream_t stream) {
  const size_t smem = (size_t)R0 * R1 * 2 * sizeof(unsigned);
  cudaError_t e = cudaFuncSetAttribute(
      drizzle_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, drizzle_shared_kernel, NT_SHARED, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const int per_plane = (sm_count() * per_sm + 1) / 2;
  drizzle_shared_kernel<<<dim3(per_plane, 2), NT_SHARED, smem, stream>>>(
      img, u0, u1, vmax, acc, n, m, R0, R1, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// max |v| over the non-NaN values of x[0 .. count) into *out (zeroed)
int drizzle_absmax(const float* x, int count, unsigned* out,
                   cudaStream_t stream) {
  if (count > 0) {
    const long long want = ((long long)count + NT - 1) / NT;
    const int blocks = (int)(want < 8LL * sm_count() ? want : 8LL * sm_count());
    absmax_kernel<<<blocks, NT, 0, stream>>>(x, (size_t)count, out);
  }
  return (int)cudaGetLastError();
}

// acc: zeroed (2 R0 R1 + 1) int64 (sum plane, weight plane, then a slot
// whose low 4 bytes receive max|v|); out: (2, R0, R1) float32 (sum,
// weights); shared: 1 for the shared-memory route (R0 R1 x 8 bytes must
// fit a block's opt-in shared memory), 0 for the global-atomic route
int drizzle(const float* img, const float* u0, const float* u1,
            long long* acc, float* out, int n, int m, int R0, int R1,
            int shared, float a00, float a01, float a10, float a11,
            float b00, float b01, float b10, float b11, float rmin0,
            float rmin1, float z, cudaStream_t stream) {
  const Scalars s{a00, a01, a10, a11, b00, b01, b10, b11, rmin0, rmin1, z};
  const long long total = (long long)n * m;
  const int bins = R0 * R1;
  unsigned long long* acc_u = reinterpret_cast<unsigned long long*>(acc);
  const float* vmax = reinterpret_cast<const float*>(acc + 2 * (size_t)bins);
  int err = drizzle_absmax(img, (int)total, reinterpret_cast<unsigned*>(
                                                acc + 2 * (size_t)bins),
                           stream);
  if (err != 0) return err;
  if (total > 0 && shared) {
    err = launch_shared(img, u0, u1, vmax, acc_u, n, m, R0, R1, s, stream);
    if (err != 0) return err;
  } else if (total > 0) {
    drizzle_kernel<<<(unsigned)((total + NT - 1) / NT), NT, 0, stream>>>(
        img, u0, u1, vmax, acc_u, n, m, R0, R1, s);
  }
  if ((err = (int)cudaGetLastError()) != 0) return err;
  finish_kernel<<<(2 * bins + NT - 1) / NT, NT, 0, stream>>>(
      acc, vmax, out, bins, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
