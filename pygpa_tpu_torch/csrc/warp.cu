// Bilinear and cubic resampling of a 2-D image at per-pixel coordinates.
//
// Replaces the TPU kernels pygpa_tpu/ops/pallas_warp.py _warp_kernel
// (entry warp_bilinear) and _warp_cubic_kernel (entry warp_cubic).
// Wrappers and plain twins: pygpa_tpu_torch/ops/warp.py.
//
// The TPU kernels gathered from 3 x 3 windows of (32, 128) blocks picked
// per output tile from bit-packed scalar prefetch, with a row-shift loop
// and a validity guard that fell back to a dense gather for
// discontinuous coordinates: Mosaic has no sublane gather. Here one
// thread per output pixel computes its taps and fraction from (cy, cx)
// exactly as the reference wrappers do (floor, difference, integer
// shift and clamp into the padded frame) and reads the taps through the
// read-only cache. The padded rings are index arithmetic: clamp ('edge'),
// mirror about the edge samples ('reflect'), or cval outside ('const').
// Exact for any coordinates, so there is no guard and no fallback.
// Bound on an H100 by device memory: 8 bytes of coordinates read and 4
// written per pixel and plane; neighbouring pixels sample neighbouring
// positions, so the taps hit L1/L2. The _rn intrinsics keep the twin's
// rounding (no FMA contraction) in the twin's order of operations.
//
// The bilinear kernel samples a stack of up to 4 planes at the same
// positions in one launch (the two planes of u in each Picard step of
// the displacement inversion, the four gradient planes of its Newton
// Jacobian). Its device time at the inversion's 512^2 grid is a few
// microseconds; the launch path around it, not the gather, set its time
// per call, so the stack halves (Picard) or quarters (Jacobian) the
// launches and the wrapper keeps its host work small (ops/warp.py).
//
// The cubic warp also comes in displacement form (cubic_disp_kernel),
// which is how the undistortion calls it: each Picard step of the
// displacement inversion samples both B-spline coefficient planes of u
// at r + u_it(r), and the final warp samples the image's coefficients at
// r + u_inv(r). The kernel builds the position from the grid index and
// its own pixel of u (the coordinate planes and the clamp/shift passes
// around them never exist), computes the taps and weights once for both
// planes, reads both planes' tap with one 8-byte load from coefficients
// stored planes-last (n, m, 2), and writes u_it in place. Bound per
// 4096^2 Picard step: u read (8 B/px), the two planes' coefficients
// (8 B/px, read once), u written (8 B/px), 403 MB over 3.35 TB/s = 0.120
// ms; the gather's load instructions, not those bytes, set its time
// (16 taps a pixel through L1).
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
enum { NEAREST = 0, CONSTANT = 1 };
enum { HAT = 0, CATMULL = 1, BSPLINE = 2 };
enum { EXT_EDGE = 0, EXT_REFLECT = 1, EXT_CONST = 2 };

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// floor(c) as an int (saturated far outside any image, where every
// boundary rule below gives the same result) and the fraction c - floor(c)
__device__ __forceinline__ int floor_frac(float c, float* fl, float* f) {
  *fl = floorf(c);
  *f = sub(c, *fl);
  return (int)fminf(fmaxf(*fl, -1073741824.f), 1073741824.f);
}

__device__ __forceinline__ int reflect(int i, int n) {
  if ((unsigned)i < (unsigned)n) return i;   // inside: no modulo
  const int p = 2 * n - 2;
  if (p <= 0) return 0;
  i = abs(i) % p;
  return min(i, p - i);
}

// original index of padded index p (ring `ring`), -1 where cval applies
__device__ __forceinline__ int unpad(int p, int ring, int n, int ext) {
  const int i = p - ring;
  if (ext == EXT_EDGE) return min(max(i, 0), n - 1);
  if (ext == EXT_REFLECT) return reflect(i, n);
  return (i >= 0 && i < n) ? i : -1;
}

__device__ __forceinline__ void weights(float t, int wf, float w[4]) {
  const float t2 = mul(t, t), t3 = mul(t2, t);
  if (wf == BSPLINE) {
    const float s = 1.0f / 6.0f;
    w[0] = mul(s, sub(add(sub(1.f, mul(3.f, t)), mul(3.f, t2)), t3));
    w[1] = mul(s, add(sub(4.f, mul(6.f, t2)), mul(3.f, t3)));
    w[2] = mul(s, sub(add(add(1.f, mul(3.f, t)), mul(3.f, t2)), mul(3.f, t3)));
    w[3] = mul(s, t3);
  } else {
    w[0] = sub(add(mul(-0.5f, t3), t2), mul(0.5f, t));
    w[1] = add(sub(mul(1.5f, t3), mul(2.5f, t2)), 1.f);
    w[2] = add(add(mul(-1.5f, t3), mul(2.f, t2)), mul(0.5f, t));
    w[3] = sub(mul(0.5f, t3), mul(0.5f, t2));
  }
}

__device__ __forceinline__ float tap(const float* __restrict__ img, int m,
                                     int r, int c, float cval) {
  return (r < 0 || c < 0) ? cval : __ldg(img + (size_t)r * m + c);
}

// one thread per sample position for all C planes of a stack (C <= 4):
// the taps and fractions are computed, and (cy, cx) read, once; each
// plane's arithmetic is the single-plane kernel's, so a plane of a stack
// is bit-identical to that plane warped alone. grid ceil(count / NT)
__global__ void __launch_bounds__(NT) bilinear_kernel(
    const float* __restrict__ img, int C, int n, int m,
    const float* __restrict__ cy, const float* __restrict__ cx,
    float* __restrict__ out, int count, int mode, float cval) {
  const size_t k = (size_t)blockIdx.x * NT + threadIdx.x;
  if (k >= (size_t)count) return;
  const float y = cy[k], x = cx[k];
  float fly, flx, fy, fx;
  int ty = floor_frac(y, &fly, &fy);
  int tx = floor_frac(x, &flx, &fx);
  int r0, r1, c0, c1;
  if (mode == NEAREST) {
    if (ty < 0 || ty > n - 2) fy = 0.f;
    if (tx < 0 || tx > m - 2) fx = 0.f;
    if (y >= (float)(n - 1)) fy = 1.f;
    if (x >= (float)(m - 1)) fx = 1.f;
    r0 = min(max(ty, 0), n - 2);
    c0 = min(max(tx, 0), m - 2);
    r1 = r0 + 1;
    c1 = c0 + 1;
  } else {
    // taps in the frame padded by one cval ring
    ty = min(max(ty + 1, 0), n);
    tx = min(max(tx + 1, 0), m);
    r0 = unpad(ty, 1, n, EXT_CONST);
    r1 = unpad(ty + 1, 1, n, EXT_CONST);
    c0 = unpad(tx, 1, m, EXT_CONST);
    c1 = unpad(tx + 1, 1, m, EXT_CONST);
  }
  const bool cut = mode == CONSTANT && (y <= -1.f || y >= (float)n ||
                                        x <= -1.f || x >= (float)m);
  const float gy = sub(1.f, fy), gx = sub(1.f, fx);
  const size_t plane = (size_t)n * m;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float* p = img + c * plane;
    const float v0 = tap(p, m, r0, c0, cval), v1 = tap(p, m, r0, c1, cval);
    const float v2 = tap(p, m, r1, c0, cval), v3 = tap(p, m, r1, c1, cval);
    const float v = add(mul(gy, add(mul(gx, v0), mul(fx, v1))),
                        mul(fy, add(mul(gx, v2), mul(fx, v3))));
    out[c * (size_t)count + k] = cut ? cval : v;
  }
}

// A cubic sample's taps and weights: the position (y, x) clamped and
// shifted into the padded frame exactly as the reference wrapper does,
// the fractions' weights, the tap rows and columns (-1 where cval
// applies) and whether the position lies outside (cut to cval)
template <int WF, int MODE>
struct CubicTaps {
  float wy[4], wx[4];
  int rr[4], cc[4];
  bool outside;

  __device__ __forceinline__ CubicTaps(float y, float x, int n, int m) {
    float yc, xc;
    int ring, ext;
    outside = false;
    if (MODE == NEAREST) {
      yc = fminf(fmaxf(y, -1.f), (float)n);
      xc = fminf(fmaxf(x, -1.f), (float)m);
      ring = 2;
      ext = EXT_EDGE;
    } else if (WF == BSPLINE) {
      outside = y < 0.f || y > (float)(n - 1) || x < 0.f || x > (float)(m - 1);
      yc = fminf(fmaxf(y, 0.f), (float)(n - 1));
      xc = fminf(fmaxf(x, 0.f), (float)(m - 1));
      ring = 3;
      ext = EXT_REFLECT;
    } else {
      outside = y <= -2.f || y >= (float)(n + 1) || x <= -2.f ||
                x >= (float)(m + 1);
      yc = fminf(fmaxf(y, -2.f), (float)(n + 1));
      xc = fminf(fmaxf(x, -2.f), (float)(m + 1));
      ring = 3;
      ext = EXT_CONST;
    }
    float fly, flx, fy, fx;
    int ty = floor_frac(yc, &fly, &fy);
    int tx = floor_frac(xc, &flx, &fx);
    if (MODE == NEAREST) {
      if (fly > (float)(n - 1)) fy = 1.f;
      if (flx > (float)(m - 1)) fx = 1.f;
      ty = min(ty, n - 1) + 1;   // first tap (floor - 1) in the padded frame
      tx = min(tx, m - 1) + 1;
    } else {
      ty = min(ty, n) + 2;
      tx = min(tx, m) + 2;
    }
    weights(fy, WF, wy);
    weights(fx, WF, wx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rr[a] = unpad(ty + a, ring, n, ext);
      cc[a] = unpad(tx + a, ring, m, ext);
    }
  }

  // the sample of one (n, m) plane
  __device__ __forceinline__ float sample(const float* __restrict__ img,
                                          int m, float cval) const {
    float v = 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float row = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        row = add(row, mul(wx[b], tap(img, m, rr[a], cc[b], cval)));
      v = add(v, mul(wy[a], row));
    }
    return outside ? cval : v;
  }
};

template <int WF, int MODE>
__global__ void __launch_bounds__(NT) cubic_kernel(
    const float* __restrict__ img, int n, int m, const float* __restrict__ cy,
    const float* __restrict__ cx, float* __restrict__ out, int count,
    float cval) {
  const size_t k = (size_t)blockIdx.x * NT + threadIdx.x;
  if (k >= (size_t)count) return;
  out[k] = CubicTaps<WF, MODE>(cy[k], cx[k], n, m).sample(img, m, cval);
}

// Displacement form of the B-spline cubic warp: output pixel (r, c) of
// an (h, w) grid samples the C <= 2 interleaved coefficient planes (n, m,
// C) at the grid point (r + orow, c + ocol) + u(r, c), built as the twin
// builds it (float32 adds, round to nearest): y = (r + orow) + u0,
// clamped to [-(mg - 1), n - mg - 2] and shifted by +mg when the planes
// carry a margin mg > 0 (spline_filter's 'nearest' extension), and the
// same for x. The taps, fractions and weights are computed once for both
// planes, and each tap of the two planes is one 8-byte load. Each thread
// reads u at its own pixel and then writes out there, so out may be u
// itself: the Picard step of the displacement inversion updates u in
// place. 2-D blocks (32 x 8 threads) keep a warp's taps on a few
// coefficient rows in L1.
template <int MODE, int C>
__global__ void __launch_bounds__(NT) cubic_disp_kernel(
    const float* __restrict__ coef, int n, int m, const float* u, float* out,
    int h, int w, int orow, int ocol, int mg, float cval) {
  const int r = blockIdx.y * 8 + threadIdx.y;
  const int c = blockIdx.x * 32 + threadIdx.x;
  if (r >= h || c >= w) return;
  const size_t plane = (size_t)h * w;
  const size_t o = (size_t)r * w + c;
  float y = add((float)(r + orow), u[o]);
  float x = add((float)(c + ocol), u[plane + o]);
  if (mg > 0) {
    // the twin's clamp to [-(mg - 1), n_l - 1 + mg - 1], n_l = n - 2 mg
    y = add(fminf(fmaxf(y, (float)(1 - mg)), (float)(n - mg - 2)), (float)mg);
    x = add(fminf(fmaxf(x, (float)(1 - mg)), (float)(m - mg - 2)), (float)mg);
  }
  const CubicTaps<BSPLINE, MODE> tp(y, x, n, m);
  if (C == 1) {
    out[o] = tp.sample(coef, m, cval);
    return;
  }
  // both planes, each with the single-plane sum's operations in order
  const float2* cf = reinterpret_cast<const float2*>(coef);
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float2 t = (tp.rr[a] < 0 || tp.cc[b] < 0)
                           ? make_float2(cval, cval)
                           : __ldg(cf + (size_t)tp.rr[a] * m + tp.cc[b]);
      r0 = add(r0, mul(tp.wx[b], t.x));
      r1 = add(r1, mul(tp.wx[b], t.y));
    }
    v0 = add(v0, mul(tp.wy[a], r0));
    v1 = add(v1, mul(tp.wy[a], r1));
  }
  out[o] = tp.outside ? cval : v0;
  out[plane + o] = tp.outside ? cval : v1;
}

}  // namespace

extern "C" {

// img: C contiguous (n, m) planes; out: C planes of `count` samples
int warp_bilinear(const float* img, int C, int n, int m, const float* cy,
                  const float* cx, float* out, int count, int mode,
                  float cval, cudaStream_t stream) {
  if (count == 0) return 0;
  bilinear_kernel<<<(count + NT - 1) / NT, NT, 0, stream>>>(
      img, C, n, m, cy, cx, out, count, mode, cval);
  return (int)cudaGetLastError();
}

int warp_cubic(const float* img, int n, int m, const float* cy,
               const float* cx, float* out, int count, int mode, int weight,
               float cval, cudaStream_t stream) {
  if (count == 0) return 0;
  const int blocks = (count + NT - 1) / NT;
  if (weight == BSPLINE && mode == NEAREST)
    cubic_kernel<BSPLINE, NEAREST><<<blocks, NT, 0, stream>>>(
        img, n, m, cy, cx, out, count, cval);
  else if (weight == BSPLINE)
    cubic_kernel<BSPLINE, CONSTANT><<<blocks, NT, 0, stream>>>(
        img, n, m, cy, cx, out, count, cval);
  else if (mode == NEAREST)
    cubic_kernel<CATMULL, NEAREST><<<blocks, NT, 0, stream>>>(
        img, n, m, cy, cx, out, count, cval);
  else
    cubic_kernel<CATMULL, CONSTANT><<<blocks, NT, 0, stream>>>(
        img, n, m, cy, cx, out, count, cval);
  return (int)cudaGetLastError();
}

// coef: (n, m, C) B-spline coefficients, C <= 2 planes interleaved; u:
// (2, h, w); out: (C, h, w), may be u
int warp_cubic_disp(const float* coef, int C, int n, int m, const float* u,
                    float* out, int h, int w, int orow, int ocol, int mg,
                    int mode, float cval, cudaStream_t stream) {
  if (h == 0 || w == 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  if (mode == NEAREST && C == 2)
    cubic_disp_kernel<NEAREST, 2><<<grid, block, 0, stream>>>(
        coef, n, m, u, out, h, w, orow, ocol, mg, cval);
  else if (mode == NEAREST)
    cubic_disp_kernel<NEAREST, 1><<<grid, block, 0, stream>>>(
        coef, n, m, u, out, h, w, orow, ocol, mg, cval);
  else if (C == 2)
    cubic_disp_kernel<CONSTANT, 2><<<grid, block, 0, stream>>>(
        coef, n, m, u, out, h, w, orow, ocol, mg, cval);
  else
    cubic_disp_kernel<CONSTANT, 1><<<grid, block, 0, stream>>>(
        coef, n, m, u, out, h, w, orow, ocol, mg, cval);
  return (int)cudaGetLastError();
}

}  // extern "C"
