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
// Grid (G, B): G blocks a plane (ops/fit.py fit_grid: a few blocks an SM
// over all the planes, at most one a tile), each a loop over the plane.
// A plane's pixels are its flat index e: the vector part, float4s from
// the first pixel on the 16-byte grid (e = h, h < 4), in tiles of NT LPT
// float4s; block g takes tiles g, g + G, g + 2G, ...; thread t of a tile
// loads float4s t, t + NT, t + 2 NT, t + 3 NT of it (16 pixels, one
// float32 sum each of the nine a tile, the three w v sums compensated),
// and adds the tile's float32 sums into its float64 ones. The head (e <
// h) and the tail past the last whole float4 (at most 3 pixels each) are
// block 0's first tile, one pixel a thread. Any row length and plane start: the coordinates step
// along with e (x = i - cx, y = j - cy, j wrapping at m). The weight is
// the twin's min(1, f_scale / max(|r|, 1e-30)), divided only where the
// denominator exceeds f_scale (elsewhere the quotient is >= 1 and w is 1
// exactly). Each block adds its threads' float64 sums once, in a fixed
// order (warp shuffles, then the warps in order), and stores nine
// partials; the plane's last block to finish (an integer counter a
// plane, cg_unwrap.cuh's pattern) adds the plane's G partials in float64
// in the same order every step, solves the 3x3 system in float64
// (Gaussian elimination, partial pivoting) and stores the new p as
// float32 for the next launch; on the fit's last launch it also stores
// the coefficients with the offset moved back, p2 - p0 cx - p1 cy, in
// float32 as the twin forms them. iters + 1 launches a fit, no host sync,
// no solver library; a fit repeats bit for bit on a card (G is read from
// its SM count).
//
// Bound on an H100: HBM bytes. A step reads the stack once (and the mask
// where there is one): (3, 4086^2) float32 is 200 MB, 0.060 ms at 3.35
// TB/s; ~25 float32 operations a pixel, 1.3 GFLOP, is 0.02 ms at 67
// TFLOP/s. The design keeps 16-byte loads in flight (a thread's four of
// the next tile while it sums a tile; 24 warps an SM), finds a pixel's
// coordinates by steps (one division a tile), and keeps every other byte
// on chip: the partials are
// 72 bytes a block, G blocks a plane (hundreds, not the 4077 blocks of
// 4096 pixels of a (4086^2) plane that each paid a float64 block
// reduction, a fence and an atomic).
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads a block
constexpr int LPT = 4;           // float4 loads a thread a tile
constexpr int TILE4 = NT * LPT;  // float4s a tile
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

// The plane's coordinates and step state for one IRLS step.
template <bool FIRST>
struct Pixel {
  float p0, p1, p2, f_scale, cx, cy;
  // pixel (x, y) of value v into the nine float32 sums, rounded as the
  // twin's torch ops round them (no FMA contraction in w, wx, wy, wv).
  // S w v, S w v x and S w v y are summed with Kahan's compensations cv
  // (the sum is acc[6 + k] - cv[k]): phases of order one whose plane has
  // an offset near zero cancel in them, and a float32 partial's rounding
  // would reach the offset's size (the slopes reach it through p0 cx and
  // p1 cy)
  __device__ __forceinline__ void add(float (&acc)[NS], float (&cv)[3],
                                      float v, float x, float p0x,
                                      float y) const {
    float w = 1.f;
    if (!FIRST) {
      const float pl = __fadd_rn(p0x, __fadd_rn(__fmul_rn(p1, y), p2));
      const float d = fmaxf(fabsf(__fsub_rn(v, pl)), 1e-30f);
      if (d > f_scale) w = fminf(1.f, __fdiv_rn(f_scale, d));
    }
    const float wx = __fmul_rn(w, x), wy = __fmul_rn(w, y),
                wv = __fmul_rn(w, v);
    acc[0] += w;
    acc[1] += wx;
    acc[2] += wy;
    acc[3] = fmaf(wx, x, acc[3]);
    acc[4] = fmaf(wx, y, acc[4]);
    acc[5] = fmaf(wy, y, acc[5]);
    kahan(acc[6], cv[0], __fsub_rn(wv, cv[0]));
    kahan(acc[7], cv[1], fmaf(wv, x, -cv[1]));
    kahan(acc[8], cv[2], fmaf(wv, y, -cv[2]));
  }
  // s += d (d the term less the compensation c), c the new compensation
  __device__ __forceinline__ static void kahan(float& s, float& c, float d) {
    const float t = __fadd_rn(s, d);
    c = __fsub_rn(__fsub_rn(t, s), d);
    s = t;
  }
};

// A tile's float32 sums into the thread's float64 ones (the w v sums with
// their compensations).
__device__ __forceinline__ void tile_into(double (&dacc)[NS],
                                          const float (&acc)[NS],
                                          const float (&cv)[3]) {
#pragma unroll
  for (int k = 0; k < NS; ++k) dacc[k] += (double)acc[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) dacc[6 + k] -= (double)cv[k];
}

// One IRLS step of every plane: grid (G, B). img: (B, n, m); mask: uint8
// (0 / 1) planes, plane b at mask + b * mask_plane (0: one plane for all),
// read only when MASKED; p: (B, 3) the current coefficients (centred),
// rewritten by each plane's last block; part: (B, NS, G) partials; count:
// (B,) zero before the first launch, left zero by every launch; out:
// (B, 3), written on the last launch.
template <bool FIRST, bool MASKED>
__global__ void __launch_bounds__(NT, 3) irls_step_kernel(
    const float* __restrict__ img, const unsigned char* __restrict__ mask,
    int mask_plane, float* __restrict__ p, double* __restrict__ part,
    unsigned int* __restrict__ count, float* __restrict__ out, int n, int m,
    float f_scale, int last) {
  __shared__ double sh[NW * NS];
  __shared__ double tot[NS];
  __shared__ int flag;
  const int b = blockIdx.y, G = gridDim.x, g = blockIdx.x;
  const int nm = n * m;
  const float* __restrict__ v = img + (size_t)b * nm;
  const unsigned char* __restrict__ mk =
      MASKED ? mask + (size_t)b * mask_plane : nullptr;
  const float cx = 0.5f * (float)(n - 1), cy = 0.5f * (float)(m - 1);
  Pixel<FIRST> px{0.f, 0.f, 0.f, f_scale, cx, cy};
  if (!FIRST) {
    px.p0 = p[3 * b];
    px.p1 = p[3 * b + 1];
    px.p2 = p[3 * b + 2];
  }
  // the vector part: nv float4s from pixel h
  const int h = (int)((4u - (unsigned)(((size_t)v >> 2) & 3u)) & 3u);
  const int nv = nm > h ? (nm - h) >> 2 : 0;
  const int tail0 = h + 4 * nv;
  const float4* __restrict__ v4 = reinterpret_cast<const float4*>(v + h);
  double dacc[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) dacc[k] = 0.0;
  auto inside = [&](int e) { return !MASKED || mk[e] != 0; };
  auto coords = [&](int e, int& i, int& j) {
    i = e / m;
    j = e - i * m;
  };
  // block 0's first tile: the head and the tail, a pixel a thread
  if (g == 0) {
    const int ne = (nm < h ? nm : h) + (nm - (tail0 < nm ? tail0 : nm));
    float acc[NS], cv[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] = 0.f;
    if (threadIdx.x < ne) {
      const int e = threadIdx.x < h ? threadIdx.x : tail0 + threadIdx.x - h;
      if (inside(e)) {
        int i, j;
        coords(e, i, j);
        const float x = __fsub_rn((float)i, cx);
        px.add(acc, cv, __ldg(v + e), x, __fmul_rn(px.p0, x),
               __fsub_rn((float)j, cy));
      }
    }
    tile_into(dacc, acc, cv);
  }
  // the loads of a thread's float4s in a tile lie NT float4s (4 NT
  // pixels) apart: (di, dj) rows and columns
  const int di = (4 * NT) / m, dj = (4 * NT) % m;
  auto load = [&](int s, float4 (&q)[LPT]) {
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int f = s * TILE4 + l * NT + threadIdx.x;
      q[l] = f < nv ? __ldg(v4 + f) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  float4 q[LPT];
  if (g * TILE4 < nv) load(g, q);
  for (int s = g; s * TILE4 < nv; s += G) {
    // the next tile's loads in flight while this one is summed
    float4 qn[LPT];
    if ((s + G) * TILE4 < nv) load(s + G, qn);
    float acc[NS], cv[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] = 0.f;
    const int f0 = s * TILE4 + threadIdx.x;
    int i, j;
    coords(h + 4 * f0, i, j);
    // x, y step by exact float additions (half integers)
    float x = __fsub_rn((float)i, cx), y = __fsub_rn((float)j, cy);
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int f = f0 + l * NT;
      if (f < nv) {
        const int e = h + 4 * f;
        int jj = j;
        float xx = x, yy = y, p0x = __fmul_rn(px.p0, x);
        const float vals[4] = {q[l].x, q[l].y, q[l].z, q[l].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (inside(e + c)) px.add(acc, cv, vals[c], xx, p0x, yy);
          if (c < 3) {
            yy += 1.f;
            if (++jj == m) {
              jj = 0;
              yy = -cy;
              xx += 1.f;
              p0x = __fmul_rn(px.p0, xx);
            }
          }
        }
      }
      j += dj;
      y += (float)dj;
      x += (float)di;
      if (j >= m) {
        j -= m;
        y -= (float)m;
        x += 1.f;
      }
    }
    tile_into(dacc, acc, cv);
#pragma unroll
    for (int l = 0; l < LPT; ++l) q[l] = qn[l];
  }
  block_sums(dacc, sh, tot);
  double* pp = part + (size_t)b * NS * G;
  if (threadIdx.x < NS) {
    pp[(size_t)threadIdx.x * G + g] = tot[threadIdx.x];
    __threadfence();  // the partial is visible before the count
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int before = atomicAdd(count + b, 1u);
    const int lastb = before == (unsigned int)(G - 1);
    if (lastb) count[b] = 0u;
    flag = lastb;
  }
  __syncthreads();
  if (!flag) return;
  // the plane's last block: its G partials in a fixed order (read from
  // L2: other blocks stored them)
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    double a = 0.0;
    for (int t = threadIdx.x; t < G; t += NT)
      a += __ldcg(pp + (size_t)k * G + t);
    dacc[k] = a;
  }
  block_sums(dacc, sh, tot);
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
                   unsigned int* count, float* out, int G, int B, int n,
                   int m, float f_scale, int last, cudaStream_t stream) {
  const dim3 grid(G, B);
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

// One IRLS step (see above) on a grid of G blocks a plane. img: (B, n, m)
// float32 (4-byte aligned); mask: null (no mask) or uint8 planes, plane b
// at mask + b * mask_plane; p, out: (B, 3) float32; part: B NS G doubles;
// count: B uints, zeroed here on the first step (first != 0), which
// ignores p; out is written when last != 0. Needs 1 <= B <= 65535, 1 <=
// n m < 2^31 and 1 <= G <= max(1, ceil(n m / (4 NT LPT))).
int fit_plane_step(const float* img, const unsigned char* mask,
                   int mask_plane, float* p, double* part,
                   unsigned int* count, float* out, int G, int B, int n,
                   int m, float f_scale, int first, int last,
                   cudaStream_t stream) {
  const long long nm = (long long)n * m;
  const long long tiles = (nm + 4LL * TILE4 - 1) / (4LL * TILE4);
  if (B < 1 || B > 65535 || n < 1 || m < 1 || nm >= (1LL << 31) || G < 1 ||
      G > (tiles > 1 ? tiles : 1) || ((size_t)img & 3))
    return (int)cudaErrorInvalidValue;
  if (first) {
    const cudaError_t err =
        cudaMemsetAsync(count, 0, B * sizeof(unsigned int), stream);
    if (err != cudaSuccess) return (int)err;
    return (int)launch<true>(img, mask, mask_plane, p, part, count, out, G,
                             B, n, m, f_scale, last, stream);
  }
  return (int)launch<false>(img, mask, mask_plane, p, part, count, out, G, B,
                            n, m, f_scale, last, stream);
}

}  // extern "C"
