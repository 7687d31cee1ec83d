// Grouped banded WFR sweep: the reconstruction-prologue (uv), phase/weight
// and phase-gradient emissions, and the gradient emissions' band flags and
// winner products, which the zoom sweep shares.
//
// Replaces the TPU kernel pygpa_tpu/ops/pallas_sweep.py _grouped_kernel
// (entry fused_zoom_sweep_grouped with col_groups: uv_ks, no emission flag
// (a: phase and weight) or grad_ops (b: also the winners' gradients)) and,
// for the zoom sweep's gradient emission, the grad_ops part of _kernel.
// Wrappers and plain twins: pygpa_tpu_torch/ops/sweep.py.
//
// The TPU kernel ran stage 1, stage 2, the argmax tournament and the uv
// epilogue in one grid whose steps ran in order, carrying phase/weight
// rows and columns from step to step, and made the row-derivative stage
// 1 (Tx) in the same body as T from one staged A0 . gx block. Blocks here
// run in parallel and in no order, so the op is several launches:
//   sweep_stage1: T[g,i] = ((A0c + i A0s) . gx_i) @ (Sr + i Si)_run(i),
//                 times gy_i, stored as [Re | Im] rows (G, P, n, 2 Wb),
//                 in float32 FMA (also the zoom sweep's stage 1); given
//                 band flags, only the blocks of flagged (64-row band,
//                 candidate) pairs run (the gradient emission's Tx, on
//                 the row-derivative windows S2 = (2 pi i f0) S);
//   sweep_split_basis: the base-band column basis split for the tensor
//                 cores once a call: (G, 6, m, Wb) planes -hi(A1s),
//                 hi(A1c), hi(A1s), -lo(A1s), lo(A1c), lo(A1s), hi =
//                 cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) (also the
//                 zoom sweep's);
//   sweep_stage2: per 64x64 pixel tile of group g (blockIdx.z), M_i =
//                 T_i @ A1^T for every candidate i on the tensor cores
//                 (sweep_tc.cuh, shared with the zoom sweep: 3xTF32 on
//                 Hopper's warpgroup wgmma, fed by a TMA ring over T
//                 and the split basis loaded two stages ahead, chains
//                 restarting every 32 columns of Wb, the hi.hi
//                 products in a chain apart from the two small
//                 ones (SPLIT), which lands |M| nearer its float64 value
//                 than the float32 twin's products; any Wb that is a
//                 multiple of 64 runs) with the running best |M|^2
//                 (strict '>', candidate 0 taken first) in registers;
//                 emits the winner phase (atan2 + banded column ramp)
//                 and the rim-masked weight, (G, n, m) each (emission
//                 (a) ends here); sweep_stage2_winners is the same
//                 launch that also stores each pixel's winner (Re M,
//                 Im M, index) for the gradient emission (b);
//   sweep_band_winners: which candidates win a pixel of each 64-row band
//                 (G, n/64, P), from the index plane;
//   sweep_winner_products: per tile, for each candidate that wins one of
//                 its pixels, Mx = Tx_i . A1 and My = T_i . A1y (the base
//                 band's f1-scaled basis) as two jobs of one
//                 tc_products ring, and the gradients of -angle(M) at
//                 the pixels it wins (less off * 2 pi / m on the column
//                 gradient of a banded winner), M read back from the
//                 tournament's store (mma.sync: sweep_tc.cuh says why);
//   sweep_uv:     one thread per pixel: wrapped shifted diffs against the
//                 left / upper neighbour and the 2x2 weighted lstsq.
// A stack of B images of one shape and plan (the factory's batch axis)
// runs in the same launches: stage 1's and stage 2's grids put the image
// beside the group on z, the uv epilogue runs a thread per pixel of every
// image, each image summing its own G peaks; the plan's operands (gx, gy,
// the bases, run, off, kc) are shared, and each block's arithmetic is the
// single image's, so an image's outputs are its own launch's bits. A
// stack whose grid z would pass CUDA's 65535 is split into launches of
// as many images as fit. The gradient emissions take a stack alike: the
// tournament that stores the winners, the band flags (one row of their
// grid an (image, group) pair), stage 1 on the flagged pairs and the
// winner products (image beside the group on grid z) index each image's
// planes by b G + g and share the plan's operands.
// Bound on an H100: stage 2's G*P*n*m*Wb complex MACs (1.86 TFLOP at the
// 4096^2 bench), three times over as 3xTF32 at 495 TFLOP/s dense TF32
// (~11.3 ms; 27.8 ms in float32 FMA), plus stage 1's float32 FMA. The
// gradient emission adds stage 1 on the band winners (1-2 of 36-49
// candidates a band on a lattice) and 2 * 8 * 64 * 64 * Wb FLOP per tile
// winner (~1.07 a tile): no gradient work rides in the tournament's
// registers or its P-candidate loop. Everything is float32; the TPU's
// bf16 operand splits and polynomial atan2 were Mosaic workarounds and
// are not carried over.
#include <cuda_runtime.h>
#include <math.h>

#include "sweep_tc.cuh"

namespace {

// stage 1 and the uv epilogue: 64 x 64 output tiles of 256 threads, 4 x 4
// outputs a thread, contracting in 16-deep chunks staged in shared memory
constexpr int TILE = 64;   // output tile edge (rows and columns)
constexpr int BK = 16;     // contraction chunk
constexpr int APAD = TILE + 4;
constexpr int NT = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr float PI_F = 3.14159265358979f;
constexpr float TWO_PI_F = 6.283185307179586f;
constexpr int MAX_GRID_Z = 65535;   // CUDA's gridDim.z limit

// acc(4x4 complex) += a(4, complex column slice) x b(4, complex row slice)
__device__ __forceinline__ void cmac(const float* ar_s, const float* ai_s,
                                     const float* br_s, const float* bi_s,
                                     float accr[4][4], float acci[4][4]) {
  const float4 ar = *reinterpret_cast<const float4*>(ar_s);
  const float4 ai = *reinterpret_cast<const float4*>(ai_s);
  const float4 br = *reinterpret_cast<const float4*>(br_s);
  const float4 bi = *reinterpret_cast<const float4*>(bi_s);
  const float a_r[4] = {ar.x, ar.y, ar.z, ar.w};
  const float a_i[4] = {ai.x, ai.y, ai.z, ai.w};
  const float b_r[4] = {br.x, br.y, br.z, br.w};
  const float b_i[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      accr[a][b] = fmaf(a_r[a], b_r[b], accr[a][b]);
      accr[a][b] = fmaf(-a_i[a], b_i[b], accr[a][b]);
      acci[a][b] = fmaf(a_r[a], b_i[b], acci[a][b]);
      acci[a][b] = fmaf(a_i[a], b_r[b], acci[a][b]);
    }
  }
}

__device__ __forceinline__ float wrap_pi(float x) {
  // (x + pi) mod 2 pi - pi, floor modulo; no FMA contraction so the
  // rounding matches the twin's separate torch ops
  float t = __fadd_rn(x, PI_F);
  float q = floorf(__fdiv_rn(t, TWO_PI_F));
  return __fsub_rn(__fsub_rn(t, __fmul_rn(TWO_PI_F, q)), PI_F);
}

// x - 2 pi floor(x / 2 pi + 1/2): wrap_pi in exact arithmetic, but an x
// with |x| < pi comes back exactly. The phase differences of the uv
// epilogue are small; wrap_pi's x + pi would round them to the float32
// spacing at pi (2.4e-7 rad), a bias the unwrap integrates.
__device__ __forceinline__ float wrap_diff(float x) {
  const float q = floorf(__fadd_rn(__fdiv_rn(x, TWO_PI_F), 0.5f));
  return __fsub_rn(x, __fmul_rn(TWO_PI_F, q));
}

// grid (Wb/64, n/64, B*G*P): z = (b G + g) P + i for image b of the
// stack (its windows Sr, Si (B, G, H, W0, Wb) and its T rows; the other
// operands are the images' shared plan). flags (B, G, n/64, P) or null:
// with flags, only the blocks of flagged (64-row band, candidate) pairs
// run; the rows of the others are left unwritten. One image is the
// stack of B = 1.
__global__ void __launch_bounds__(NT) stage1_kernel(
    const float* __restrict__ Sr, const float* __restrict__ Si,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ A0c, const float* __restrict__ A0s,
    const int* __restrict__ run, const int* __restrict__ flags,
    float* __restrict__ T, int G, int H, int P, int n, int W0, int Wb) {
  __shared__ __align__(16) float Ar[BK][APAD];
  __shared__ __align__(16) float Ai[BK][APAD];
  __shared__ __align__(16) float Br[BK][TILE];
  __shared__ __align__(16) float Bi[BK][TILE];
  const int c0 = blockIdx.x * TILE;
  const int r0 = blockIdx.y * TILE;
  const int bg = blockIdx.z / P;       // b * G + g
  const int i = blockIdx.z - bg * P;
  const int g = bg % G;
  const int gi = g * P + i;            // the shared operands' row
  if (flags && !flags[((size_t)bg * gridDim.y + blockIdx.y) * P + i])
    return;
  const int h = run[gi];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* a0c = A0c + (size_t)g * n * W0;
  const float* a0s = A0s + (size_t)g * n * W0;
  const float* gxi = gx + (size_t)gi * W0;
  const size_t so = ((size_t)bg * H + h) * W0 * Wb;
  const float* sr = Sr + so;
  const float* si = Si + so;

  float accr[4][4], acci[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) accr[a][b] = acci[a][b] = 0.f;

  for (int k0 = 0; k0 < W0; k0 += BK) {
    for (int e = threadIdx.x; e < TILE * BK; e += NT) {
      const int r = e / BK, k = e % BK;
      const float gk = gxi[k0 + k];
      const size_t idx = (size_t)(r0 + r) * W0 + k0 + k;
      Ar[k][r] = a0c[idx] * gk;
      Ai[k][r] = a0s[idx] * gk;
    }
    for (int e = threadIdx.x; e < TILE * BK; e += NT) {
      const int k = e / TILE, c = e % TILE;
      const size_t idx = (size_t)(k0 + k) * Wb + c0 + c;
      Br[k][c] = sr[idx];
      Bi[k][c] = si[idx];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k)
      cmac(&Ar[k][ty * 4], &Ai[k][ty * 4], &Br[k][tx * 4], &Bi[k][tx * 4],
           accr, acci);
    __syncthreads();
  }
  const float* gyi = gy + (size_t)gi * Wb;
  const size_t ld = 2 * (size_t)Wb;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float* trow = T + ((size_t)blockIdx.z * n + r0 + ty * 4 + a) * ld;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + tx * 4 + b;
      const float gyv = gyi[c];
      trow[c] = accr[a][b] * gyv;
      trow[Wb + c] = acci[a][b] * gyv;
    }
  }
}

// grid (m/64, n/64, B*G), z = b G + g; T (B, G, P, n, 2 Wb) the map tmT
// (rows of 2 Wb); tmB the split base-band column basis (G, 6, m, Wb) as
// 6 G planes, and off (G, P), the band offsets, shared by the stack's
// images; dynamic smem WSMEM. WIN (the gradient emission's tournament):
// also each pixel's winner, Re M, Im M and candidate index, to mro, mio,
// ixo (B, G, n, m); the store alone differs, not the products or the
// tournament. One image is the stack of B = 1.
template <bool WIN>
__global__ void __launch_bounds__(WNT, 1) grouped_stage2_kernel(
    const __grid_constant__ CUtensorMap tmT,
    const __grid_constant__ CUtensorMap tmB, const int* __restrict__ off,
    float* __restrict__ ph, float* __restrict__ wt, int G, int P, int n,
    int m, int Wb, int dr, int banded, float* __restrict__ mro,
    float* __restrict__ mio, int* __restrict__ ixo) {
  extern __shared__ __align__(16) float smem[];   // aligned to 1024 inside
  const int c0 = blockIdx.x * ZT, r0 = blockIdx.y * ZT;
  const int bg = blockIdx.z;           // b * G + g
  const int g = bg % G;
  float br[16], bi[16];
  int bx[16];
  wg_sweep_tile<true, true>(&tmT, &tmB, bg * P * n + r0, n, P, Wb, c0,
                            6 * g, reinterpret_cast<unsigned char*>(smem), br,
                            bi, bx);
  int rw, cl;
  wg_pixel(r0, c0, &rw, &cl);

  const float inv_m = (float)(1.0 / (double)m);
  const float ramp = (float)(6.283185307179586 / (double)m);
  const float inside = (float)(1.0 + 1e-6);
  const float rim = 1e-6f;
  const size_t plane = (size_t)bg * n * m;
#pragma unroll
  for (int jc = 0; jc < 4; ++jc)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // results 4 jc + 2 h + j: row rw + 8 h, columns cl + 8 jc + j
      const int r = rw + 8 * h;
      float pv[2], wv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * jc + 2 * h + j;
        const int c = cl + 8 * jc + j;
        const float mr = br[e], mi = bi[e];
        float pht = atan2f(mi, mr);
        if (banded) {
          // winner lock-in = base-band value x e^{2 pi i c off / m};
          // off * c < 2^24 is exact in float32
          const int oi = __ldg(off + g * P + bx[e]);
          float rr = __fmul_rn((float)oi, (float)c);
          rr = __fsub_rn(rr,
                         __fmul_rn((float)m, floorf(__fmul_rn(rr, inv_m))));
          pht = wrap_pi(__fadd_rn(pht, __fmul_rn(rr, ramp)));
        }
        const bool interior = r >= dr && r < n - dr && c >= dr && c < m - dr;
        pv[j] = pht;
        wv[j] = __fmul_rn(sqrtf(fmaxf(absq(mr, mi), 0.f)),
                          interior ? inside : rim);
      }
      const int e = 4 * jc + 2 * h;
      const size_t o = plane + (size_t)r * m + cl + 8 * jc;
      *reinterpret_cast<float2*>(ph + o) = make_float2(pv[0], pv[1]);
      *reinterpret_cast<float2*>(wt + o) = make_float2(wv[0], wv[1]);
      if (WIN) {
        *reinterpret_cast<float2*>(mro + o) = make_float2(br[e], br[e + 1]);
        *reinterpret_cast<float2*>(mio + o) = make_float2(bi[e], bi[e + 1]);
        *reinterpret_cast<int2*>(ixo + o) = make_int2(bx[e], bx[e + 1]);
      }
    }
}

// the column basis split for the tensor cores: bc, bs (G, m, K) as G
// planes of per = m K / 4 float4s -> out (G, 6, m, K): -hi(bs), hi(bc),
// hi(bs), -lo(bs), lo(bc), lo(bs) with split()'s rounding, the negation
// a flip of the sign bit; a float4 of each input a thread
__device__ __forceinline__ float4 tf32x4(const uint32_t (&v)[4],
                                         uint32_t sign) {
  return make_float4(
      __uint_as_float(v[0] ^ sign), __uint_as_float(v[1] ^ sign),
      __uint_as_float(v[2] ^ sign), __uint_as_float(v[3] ^ sign));
}

__global__ void __launch_bounds__(NT) split_basis_kernel(
    const float4* __restrict__ bc, const float4* __restrict__ bs,
    float4* __restrict__ out, size_t per, size_t total) {
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  if (e >= total) return;
  const size_t g = e / per;
  float4* o = out + g * 5 * per + e;   // (g 6 + 0) per + (e - g per)
  const float4 c = bc[e], s = bs[e];
  uint32_t ch[4], cl[4], sh[4], sl[4];
  split(c.x, ch[0], cl[0]);
  split(c.y, ch[1], cl[1]);
  split(c.z, ch[2], cl[2]);
  split(c.w, ch[3], cl[3]);
  split(s.x, sh[0], sl[0]);
  split(s.y, sh[1], sl[1]);
  split(s.z, sh[2], sl[2]);
  split(s.w, sh[3], sl[3]);
  o[0] = tf32x4(sh, SIGN);
  o[per] = tf32x4(ch, 0);
  o[2 * per] = tf32x4(sh, 0);
  o[3 * per] = tf32x4(sl, SIGN);
  o[4 * per] = tf32x4(cl, 0);
  o[5 * per] = tf32x4(sl, 0);
}

// grid (ceil(n m / NT), B): one thread per pixel of image blockIdx.y;
// ph, wt (B, G, n, m), each image summing its own G peaks; kc = (G, 5):
// k0, k1, k0*k0, k0*k1, k1*k1, shared; ux, uy (B, 2, n, m), wn (B, n, m)
__global__ void __launch_bounds__(NT) uv_kernel(
    const float* __restrict__ ph, const float* __restrict__ wt,
    const float* __restrict__ kc, float* __restrict__ ux,
    float* __restrict__ uy, float* __restrict__ wn, int G, int n, int m) {
  const size_t nm = (size_t)n * m;
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  if (idx >= nm) return;
  const size_t b = blockIdx.y;
  ph += b * G * nm;
  wt += b * G * nm;
  ux += b * 2 * nm;
  uy += b * 2 * nm;
  wn += b * nm;
  const int r = (int)(idx / m), c = (int)(idx % m);
  float a00x = 0.f, a01x = 0.f, a11x = 0.f, r0x = 0.f, r1x = 0.f;
  float a00y = 0.f, a01y = 0.f, a11y = 0.f, r0y = 0.f, r1y = 0.f;
  float wsq = 0.f;
  for (int g = 0; g < G; ++g) {
    const float* p = ph + (size_t)g * nm;
    const float* w = wt + (size_t)g * nm;
    const float k0 = kc[g * 5 + 0], k1 = kc[g * 5 + 1];
    const float k00 = kc[g * 5 + 2], k01 = kc[g * 5 + 3], k11 = kc[g * 5 + 4];
    const float pc = p[idx], wc = w[idx];
    if (c > 0) {
      const float wl = w[idx - 1];
      const float d = wrap_diff(__fadd_rn(__fsub_rn(pc, p[idx - 1]), k1));
      const float ww = __fmul_rn(wl, wl);
      a00x = __fadd_rn(a00x, __fmul_rn(ww, k00));
      a01x = __fadd_rn(a01x, __fmul_rn(ww, k01));
      a11x = __fadd_rn(a11x, __fmul_rn(ww, k11));
      r0x = __fadd_rn(r0x, __fmul_rn(__fmul_rn(ww, k0), d));
      r1x = __fadd_rn(r1x, __fmul_rn(__fmul_rn(ww, k1), d));
    }
    if (r > 0) {
      const float wu = w[idx - m];
      const float d = wrap_diff(__fadd_rn(__fsub_rn(pc, p[idx - m]), k0));
      const float ww = __fmul_rn(wu, wu);
      a00y = __fadd_rn(a00y, __fmul_rn(ww, k00));
      a01y = __fadd_rn(a01y, __fmul_rn(ww, k01));
      a11y = __fadd_rn(a11y, __fmul_rn(ww, k11));
      r0y = __fadd_rn(r0y, __fmul_rn(__fmul_rn(ww, k0), d));
      r1y = __fadd_rn(r1y, __fmul_rn(__fmul_rn(ww, k1), d));
    }
    wsq = __fadd_rn(wsq, __fmul_rn(wc, wc));
  }
  float ux0 = 0.f, ux1 = 0.f, uy0 = 0.f, uy1 = 0.f;
  if (c > 0) {
    const float det = fmaxf(
        __fsub_rn(__fmul_rn(a00x, a11x), __fmul_rn(a01x, a01x)), 1e-30f);
    ux0 = __fdiv_rn(__fsub_rn(__fmul_rn(a11x, r0x), __fmul_rn(a01x, r1x)), det);
    ux1 = __fdiv_rn(__fsub_rn(__fmul_rn(a00x, r1x), __fmul_rn(a01x, r0x)), det);
  }
  if (r > 0) {
    const float det = fmaxf(
        __fsub_rn(__fmul_rn(a00y, a11y), __fmul_rn(a01y, a01y)), 1e-30f);
    uy0 = __fdiv_rn(__fsub_rn(__fmul_rn(a11y, r0y), __fmul_rn(a01y, r1y)), det);
    uy1 = __fdiv_rn(__fsub_rn(__fmul_rn(a00y, r1y), __fmul_rn(a01y, r0y)), det);
  }
  ux[idx] = ux0;
  ux[nm + idx] = ux1;
  uy[idx] = uy0;
  uy[nm + idx] = uy1;
  wn[idx] = sqrtf(wsq);
}

// grid (n/64, G): flags[g][band][i] = 1 where candidate i wins a pixel
// of the 64-row band of idx (G, n, m), else 0; dynamic smem P ints. The
// tournament's indices lie in [0, P). A stack's (B, G, n, m) planes are
// B G such planes, g = b G + g on the grid's y.
__global__ void __launch_bounds__(NT) band_flags_kernel(
    const int* __restrict__ idx, int* __restrict__ flags, int P, int m) {
  extern __shared__ int seen[];
  for (int i = threadIdx.x; i < P; i += NT) seen[i] = 0;
  __syncthreads();
  const size_t band = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int4* px = reinterpret_cast<const int4*>(idx + band * TILE * m);
  for (int e = threadIdx.x; e < TILE * m / 4; e += NT) {
    const int4 v = __ldg(px + e);
    seen[v.x] = 1;
    seen[v.y] = 1;
    seen[v.z] = 1;
    seen[v.w] = 1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P; i += NT) flags[band * P + i] = seen[i];
}

// dynamic shared memory of winner_products_kernel: the ring, the tile's
// winners (Re M, Im M, index) and its list of winning candidates
size_t products_smem(int P) {
  return ZSMEM + 3 * ZT * ZT * sizeof(float) +
         (size_t)(P < ZT * ZT ? P : ZT * ZT) * sizeof(int);
}

// The winner products of the gradient emission: grid (m/64, n/64, B G),
// z = b G + g (one image: B = 1).
// T, Tx (G, P, n, 2K) stage 1 of S and of the row-derivative window S2;
// Bc, Bs the column basis and Byc, Bys the f1-scaled one, (G, m, K); mr,
// mi, idx (G, n, m) the winners the tournament stored; flags (G, n/64, P)
// the band winners (only flagged rows of Tx are read); off (G, P) band
// offsets or null. A stack's T, Tx, winners, flags and outputs carry the
// image axis before G, the bases and off are shared. For each candidate i that wins a pixel of the
// tile, in order, two jobs through one tc_products ring, Mx = Tx_i . B1
// and My = T_i . B1y, and at the pixels i wins
//   gx = (Im M Re Mx - Re M Im Mx) / max(|M|^2, 1e-30),  gy alike from My,
// the derivatives of -angle(M) along rows and columns, gy less
// off_i * 2 pi / m when off is given (the banded column ramp's slope).
// Written to gxo, gyo (G, n, m), which may be mr and mi themselves: the
// tile's winners are read into shared memory before any store.
template <bool SPLIT>
__global__ void __launch_bounds__(ZNT, 1) winner_products_kernel(
    const float* T, const float* Tx, const float* __restrict__ Bc,
    const float* __restrict__ Bs, const float* __restrict__ Byc,
    const float* __restrict__ Bys, const float* mr, const float* mi,
    const int* __restrict__ idx, const int* __restrict__ flags,
    const int* __restrict__ off, float* gxo, float* gyo, int G, int P,
    int n, int m, int K) {
  extern __shared__ __align__(16) float smem[];
  float* s_mr = smem + ZSTAGES * ZSTAGE;
  float* s_mi = s_mr + ZT * ZT;
  int* s_ix = reinterpret_cast<int*>(s_mi + ZT * ZT);
  int* s_win = s_ix + ZT * ZT;
  const int c0 = blockIdx.x * ZT, r0 = blockIdx.y * ZT;
  const int bg = blockIdx.z;           // b * G + g
  const int g = bg % G;                // the shared operands' group
  const size_t plane = (size_t)bg * n * m;
  for (int e = threadIdx.x; e < ZT * ZT; e += ZNT) {
    const size_t o = plane + (size_t)(r0 + (e >> 6)) * m + c0 + (e & 63);
    s_mr[e] = mr[o];
    s_mi[e] = mi[o];
    s_ix[e] = idx[o];
  }
  __syncthreads();
  int rw, cl;  // the thread's pixels in the tile (tc_pixel's layout)
  tc_pixel(0, 0, &rw, &cl);
  auto at = [&](int a, int b, int e) {
    return (rw + a * 16 + (e >> 1) * 8) * ZT + cl + b * 8 + (e & 1);
  };
  // the tile's winning candidates, in order: a block vote on each of the
  // band's winners
  const int* fl = flags + ((size_t)bg * gridDim.y + blockIdx.y) * P;
  int nw = 0;
  for (int i = 0; i < P; ++i) {
    if (!__ldg(fl + i)) continue;
    bool mine = false;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine |= s_ix[at(a, b, e)] == i;
    if (__syncthreads_or(mine)) {
      if (threadIdx.x == 0) s_win[nw] = i;
      ++nw;
    }
  }
  __syncthreads();
  const size_t cand = (size_t)n * 2 * K;
  const size_t basis = (size_t)g * m * K;
  const float* Tg = T + (size_t)bg * P * cand;
  const float* Txg = Tx + (size_t)bg * P * cand;
  const float ramp = (float)(6.283185307179586 / (double)m);
  // job 2w: Mx of the w-th winner, job 2w + 1: its My
  tc_products<SPLIT>(
      [&](int j, const float*& a, const float*& bc, const float*& bs) {
        const bool y = j & 1;
        a = (y ? Tg : Txg) + s_win[j >> 1] * cand;
        bc = (y ? Byc : Bc) + basis;
        bs = (y ? Bys : Bs) + basis;
      },
      2 * nw, K, K, r0, c0, smem,
      [&](int j, const float (&dr)[2][2][4], const float (&di)[2][2][4]) {
        const int i = s_win[j >> 1];
        const bool y = j & 1;
        float* out = (y ? gyo : gxo) + plane;
        // x - 0 is exact, so gx and the unbanded gy take 0
        const float sub =
            y && off ? __fmul_rn((float)__ldg(off + g * P + i), ramp) : 0.f;
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int p = at(a, b, e);
              if (s_ix[p] != i) continue;
              const float wr = s_mr[p], wi = s_mi[p];
              const float den = fmaxf(absq(wr, wi), 1e-30f);
              const float gv = __fdiv_rn(
                  __fsub_rn(__fmul_rn(wi, dr[a][b][e]),
                            __fmul_rn(wr, di[a][b][e])), den);
              out[(size_t)(r0 + (p >> 6)) * m + c0 + (p & 63)] =
                  __fsub_rn(gv, sub);
            }
      });
}

// images a launch takes so that its grid's z = images * per_image stays
// within CUDA's gridDim.z limit (0: one image is already over it)
int images_per_launch(int per_image) {
  return per_image > MAX_GRID_Z ? 0 : MAX_GRID_Z / per_image;
}

// a stack goes in launches of as many images as gridDim.z allows
template <bool WIN>
int launch_stage2(const float* T, const float* Bsplit, const int* off,
                  float* ph, float* wt, int B, int G, int P, int n, int m,
                  int Wb, int dr, int banded, float* mro, float* mio,
                  int* ixo, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      grouped_stage2_kernel<WIN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WSMEM);
  if (err != cudaSuccess) return (int)err;
  const int per = images_per_launch(G);
  if (per == 0) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tmB;
  if ((err = basis_map(&tmB, Bsplit, WPLANES * G, m, Wb)) != cudaSuccess)
    return (int)err;
  const size_t tb = (size_t)G * P * n * 2 * Wb, pb = (size_t)G * n * m;
  for (int b0 = 0; b0 < B; b0 += per) {
    const int bc = B - b0 < per ? B - b0 : per;
    CUtensorMap tmT;
    if ((err = t_map(&tmT, T + b0 * tb, (uint64_t)bc * G * P * n, Wb)) !=
        cudaSuccess)
      return (int)err;
    dim3 grid(m / ZT, n / ZT, bc * G);
    grouped_stage2_kernel<WIN><<<grid, WNT, WSMEM, stream>>>(
        tmT, tmB, off, ph + b0 * pb, wt + b0 * pb, G, P, n, m, Wb, dr,
        banded, WIN ? mro + b0 * pb : nullptr, WIN ? mio + b0 * pb : nullptr,
        WIN ? ixo + b0 * pb : nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// a stack goes in launches of as many images as gridDim.z allows
template <bool SPLIT>
int launch_products(const float* T, const float* Tx, const float* Bc,
                    const float* Bs, const float* Byc, const float* Bys,
                    const float* mr, const float* mi, const int* idx,
                    const int* flags, const int* off, float* gxo, float* gyo,
                    int B, int G, int P, int n, int m, int K,
                    cudaStream_t stream) {
  const size_t smem = products_smem(P);
  cudaError_t err = cudaFuncSetAttribute(
      winner_products_kernel<SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per = images_per_launch(G);
  if (per == 0) return (int)cudaErrorInvalidConfiguration;
  const size_t tb = (size_t)G * P * n * 2 * K, pb = (size_t)G * n * m;
  const size_t fb = (size_t)G * (n / TILE) * P;
  for (int b0 = 0; b0 < B; b0 += per) {
    const int bc = B - b0 < per ? B - b0 : per;
    winner_products_kernel<SPLIT>
        <<<dim3(m / ZT, n / ZT, bc * G), ZNT, smem, stream>>>(
            T + b0 * tb, Tx + b0 * tb, Bc, Bs, Byc, Bys, mr + b0 * pb,
            mi + b0 * pb, idx + b0 * pb, flags + b0 * fb, off, gxo + b0 * pb,
            gyo + b0 * pb, G, P, n, m, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// B images: Sr, Si (B, G, H, W0, Wb), flags (B, G, n/64, P) or null, T
// (B, G, P, n, 2 Wb); the rest is shared. Stacks whose B G P is over the
// gridDim.z limit go in launches of as many images as it allows
int sweep_stage1(const float* Sr, const float* Si, const float* gx,
                 const float* gy, const float* A0c, const float* A0s,
                 const int* run, const int* flags, float* T, int B, int G,
                 int H, int P, int n, int W0, int Wb, cudaStream_t stream) {
  const int per = images_per_launch(G * P);
  if (per == 0) return (int)cudaErrorInvalidConfiguration;
  const size_t sb = (size_t)G * H * W0 * Wb, tb = (size_t)G * P * n * 2 * Wb;
  const size_t fb = (size_t)G * (n / TILE) * P;
  for (int b0 = 0; b0 < B; b0 += per) {
    const int bc = B - b0 < per ? B - b0 : per;
    dim3 grid(Wb / TILE, n / TILE, bc * G * P);
    stage1_kernel<<<grid, NT, 0, stream>>>(
        Sr + b0 * sb, Si + b0 * sb, gx, gy, A0c, A0s, run,
        flags ? flags + b0 * fb : nullptr, T + b0 * tb, G, H, P, n, W0, Wb);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// A1c, A1s (G, m, K) -> out (G, 6, m, K), all contiguous float32, K a
// multiple of 4: the planes -hi(A1s), hi(A1c), hi(A1s), -lo(A1s),
// lo(A1c), lo(A1s) that stage 2's tensor cores read
int sweep_split_basis(const float* A1c, const float* A1s, float* out, int G,
                      int m, int K, cudaStream_t stream) {
  const size_t per = (size_t)m * K / 4, total = (size_t)G * per;
  if (total == 0) return 0;
  split_basis_kernel<<<(unsigned)((total + NT - 1) / NT), NT, 0, stream>>>(
      reinterpret_cast<const float4*>(A1c),
      reinterpret_cast<const float4*>(A1s), reinterpret_cast<float4*>(out),
      per, total);
  return (int)cudaGetLastError();
}

// T (B, G, P, n, 2 Wb) and Bsplit (G, 6, m, Wb) (sweep_split_basis of A1c,
// A1s), all contiguous float32; n, m and Wb multiples of 64; ph, wt (B,
// G, n, m)
int sweep_stage2(const float* T, const float* Bsplit, const int* off,
                 float* ph, float* wt, int B, int G, int P, int n, int m,
                 int Wb, int dr, int banded, cudaStream_t stream) {
  return launch_stage2<false>(T, Bsplit, off, ph, wt, B, G, P, n, m, Wb, dr,
                              banded, nullptr, nullptr, nullptr, stream);
}

// the same launch that also stores each pixel's winner (Re M, Im M,
// index) to mro, mio, ixo (B, G, n, m)
int sweep_stage2_winners(const float* T, const float* Bsplit, const int* off,
                         float* ph, float* wt, float* mro, float* mio,
                         int* ixo, int B, int G, int P, int n, int m, int Wb,
                         int dr, int banded, cudaStream_t stream) {
  return launch_stage2<true>(T, Bsplit, off, ph, wt, B, G, P, n, m, Wb, dr,
                             banded, mro, mio, ixo, stream);
}

// idx (G, n, m) int32 in [0, P), flags (G, n/64, P) int32; n, m multiples
// of 64; a stack passes its B G planes as G (bands of more than 65535
// planes go in several launches)
int sweep_band_winners(const int* idx, int* flags, int G, int P, int n,
                       int m, cudaStream_t stream) {
  const size_t smem = (size_t)P * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      band_flags_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t ib = (size_t)n * m, fb = (size_t)(n / TILE) * P;
  for (int g0 = 0; g0 < G; g0 += MAX_GRID_Z) {
    const int gc = G - g0 < MAX_GRID_Z ? G - g0 : MAX_GRID_Z;
    band_flags_kernel<<<dim3(n / TILE, gc), NT, smem, stream>>>(
        idx + g0 * ib, flags + g0 * fb, P, m);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// the winner products (winner_products_kernel) of B images; split
// selects the grouped sweep's chain rounding (SPLIT), else the zoom
// sweep's
int sweep_winner_products(const float* T, const float* Tx, const float* Bc,
                          const float* Bs, const float* Byc,
                          const float* Bys, const float* mr, const float* mi,
                          const int* idx, const int* flags, const int* off,
                          float* gxo, float* gyo, int B, int G, int P, int n,
                          int m, int K, int split, cudaStream_t stream) {
  return split ? launch_products<true>(T, Tx, Bc, Bs, Byc, Bys, mr, mi, idx,
                                       flags, off, gxo, gyo, B, G, P, n, m,
                                       K, stream)
               : launch_products<false>(T, Tx, Bc, Bs, Byc, Bys, mr, mi, idx,
                                        flags, off, gxo, gyo, B, G, P, n, m,
                                        K, stream);
}

// ph, wt (B, G, n, m); ux, uy (B, 2, n, m), wn (B, n, m); B <= 65535
int sweep_uv(const float* ph, const float* wt, const float* kc, float* ux,
             float* uy, float* wn, int B, int G, int n, int m,
             cudaStream_t stream) {
  const size_t nm = (size_t)n * m;
  const dim3 grid((unsigned)((nm + NT - 1) / NT), B);
  uv_kernel<<<grid, NT, 0, stream>>>(ph, wt, kc, ux, uy, wn, G, n, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
