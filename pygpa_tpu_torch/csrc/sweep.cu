// Grouped banded WFR sweep: the reconstruction-prologue (uv), phase/weight
// and phase-gradient emissions.
//
// Replaces the TPU kernel pygpa_tpu/ops/pallas_sweep.py _grouped_kernel
// (entry fused_zoom_sweep_grouped with col_groups: uv_ks, no emission flag
// (a: phase and weight) or grad_ops (b: also the winners' gradients)).
// Wrapper and plain twin: pygpa_tpu_torch/ops/sweep.py.
//
// The TPU kernel ran stage 1, stage 2, the argmax tournament and the uv
// epilogue in one grid whose steps ran in order, carrying phase/weight
// rows and columns from step to step. Blocks here run in parallel and
// in no order, so the op is two or three launches:
//   sweep_stage1: T[g,i] = ((A0c + i A0s) . gx_i) @ (Sr + i Si)_run(i),
//                 times gy_i, stored as [Re | Im] rows (G, P, n, 2 Wb),
//                 in float32 FMA (also the zoom sweep's stage 1); with
//                 gradients a second launch on the row-derivative
//                 windows S2 = (2 pi i f0) S gives Tx;
//   sweep_stage2: per 64x64 pixel tile of group g (blockIdx.z), M_i =
//                 T_i @ A1^T for every candidate i on the tensor cores
//                 (sweep_tc.cuh, shared with the zoom sweep: 3xTF32
//                 mma.sync, chains restarting every 32 columns of Wb,
//                 the hi.hi products in a chain apart from the two small
//                 ones (SPLIT), which lands |M| nearer its float64 value
//                 than the float32 twin's products; the column basis
//                 streamed with T through a cp.async ring, so any Wb
//                 that is a multiple of 64 runs) with the running best
//                 |M|^2 (strict '>', candidate 0 taken first) in
//                 registers; emits the winner phase (atan2 + banded
//                 column ramp) and the rim-masked weight, (G, n, m) each
//                 (emission (a) ends here); sweep_stage2_grad then adds
//                 the winners' gradients (winner_grads(): Tx_i and T_i
//                 against the base band's A1 and A1y for each candidate
//                 that wins a pixel of the tile, less off * 2 pi / m on
//                 the column gradient of a banded winner);
//   sweep_uv:     one thread per pixel: wrapped shifted diffs against the
//                 left / upper neighbour and the 2x2 weighted lstsq.
// Bound on an H100: stage 2's G*P*n*m*Wb complex MACs (1.86 TFLOP at the
// 4096^2 bench), three times over as 3xTF32 at 495 TFLOP/s dense TF32
// (~11.3 ms; 27.8 ms in float32 FMA), plus stage 1's float32 FMA.
// Everything is float32; the TPU's bf16 operand splits and polynomial
// atan2 were Mosaic workarounds and are not carried over.
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

// grid (Wb/64, n/64, G*P)
__global__ void __launch_bounds__(NT) stage1_kernel(
    const float* __restrict__ Sr, const float* __restrict__ Si,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ A0c, const float* __restrict__ A0s,
    const int* __restrict__ run, float* __restrict__ T,
    int H, int P, int n, int W0, int Wb) {
  __shared__ __align__(16) float Ar[BK][APAD];
  __shared__ __align__(16) float Ai[BK][APAD];
  __shared__ __align__(16) float Br[BK][TILE];
  __shared__ __align__(16) float Bi[BK][TILE];
  const int c0 = blockIdx.x * TILE;
  const int r0 = blockIdx.y * TILE;
  const int gi = blockIdx.z;  // g * P + i
  const int g = gi / P;
  const int h = run[gi];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* a0c = A0c + (size_t)g * n * W0;
  const float* a0s = A0s + (size_t)g * n * W0;
  const float* gxi = gx + (size_t)gi * W0;
  const size_t so = ((size_t)g * H + h) * W0 * Wb;
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
    float* trow = T + ((size_t)gi * n + r0 + ty * 4 + a) * ld;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + tx * 4 + b;
      const float gyv = gyi[c];
      trow[c] = accr[a][b] * gyv;
      trow[Wb + c] = acci[a][b] * gyv;
    }
  }
}

// grid (m/64, n/64, G); T (G, P, n, 2 Wb); A1c, A1s (G, m, Wb), the
// base-band column basis; off (G, P) band offsets; dynamic smem ZSMEM.
// GRAD (emission (b)): also Tx (G, P, n, 2 Wb), stage 1 of the
// row-derivative windows, and A1yc, A1ys (G, m, Wb), the f1-scaled
// base-band basis; the winners' gradients go to gxo, gyo (G, n, m)
template <bool GRAD>
__global__ void __launch_bounds__(ZNT, 1) grouped_stage2_kernel(
    const float* __restrict__ T, const float* __restrict__ A1c,
    const float* __restrict__ A1s, const int* __restrict__ off,
    float* __restrict__ ph, float* __restrict__ wt,
    int P, int n, int m, int Wb, int dr, int banded,
    const float* __restrict__ Tx, const float* __restrict__ A1yc,
    const float* __restrict__ A1ys, float* __restrict__ gxo,
    float* __restrict__ gyo) {
  extern __shared__ __align__(16) float smem[];
  const int c0 = blockIdx.x * ZT, r0 = blockIdx.y * ZT;
  const int g = blockIdx.z;
  float br[2][2][4], bi[2][2][4];
  int bx[2][2][4];
  sweep_tc_tile<true, true>(T + (size_t)g * P * n * 2 * Wb,
                      A1c + (size_t)g * m * Wb, A1s + (size_t)g * m * Wb,
                      P, n, Wb, Wb, r0, c0, smem, br, bi, bx);
  int rw, cl;
  tc_pixel(r0, c0, &rw, &cl);

  const float inv_m = (float)(1.0 / (double)m);
  const float ramp = (float)(6.283185307179586 / (double)m);
  const float inside = (float)(1.0 + 1e-6);
  const float rim = 1e-6f;
  const size_t plane = (size_t)g * n * m;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rw + a * 16 + h * 8;
        float pv[2], wv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * h + j;
          const int c = cl + b * 8 + j;
          const float mr = br[a][b][e], mi = bi[a][b][e];
          float pht = atan2f(mi, mr);
          if (banded) {
            // winner lock-in = base-band value x e^{2 pi i c off / m};
            // off * c < 2^24 is exact in float32
            const int oi = __ldg(off + g * P + bx[a][b][e]);
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
        const size_t o = plane + (size_t)r * m + cl + b * 8;
        *reinterpret_cast<float2*>(ph + o) = make_float2(pv[0], pv[1]);
        *reinterpret_cast<float2*>(wt + o) = make_float2(wv[0], wv[1]);
      }
  // the column gradient of a banded winner takes away its ramp's slope,
  // off * 2 pi / m (the TPU kernel's gyo - ro * (2 pi / m))
  if (GRAD) {
    const size_t cand = (size_t)g * P * n * 2 * Wb;
    const size_t basis = (size_t)g * m * Wb;
    winner_grads<true>(T + cand, Tx + cand, A1c + basis, A1s + basis,
                       A1yc + basis, A1ys + basis, P, n, Wb, Wb, r0, c0,
                       smem, br, bi, bx, gxo + plane, gyo + plane, m,
                       banded ? off + g * P : nullptr, ramp);
  }
}

// one thread per pixel; kc = (G, 5): k0, k1, k0*k0, k0*k1, k1*k1
__global__ void __launch_bounds__(NT) uv_kernel(
    const float* __restrict__ ph, const float* __restrict__ wt,
    const float* __restrict__ kc, float* __restrict__ ux,
    float* __restrict__ uy, float* __restrict__ wn, int G, int n, int m) {
  const size_t nm = (size_t)n * m;
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  if (idx >= nm) return;
  const int r = (int)(idx / m), c = (int)(idx % m);
  float a00x = 0.f, a01x = 0.f, a11x = 0.f, r0x = 0.f, r1x = 0.f;
  float a00y = 0.f, a01y = 0.f, a11y = 0.f, r0y = 0.f, r1y = 0.f;
  float wsq = 0.f;
  for (int g = 0; g < G; ++g) {
    const float* p = ph + g * nm;
    const float* w = wt + g * nm;
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

template <bool GRAD>
int launch_stage2(const float* T, const float* A1c, const float* A1s,
                  const int* off, float* ph, float* wt, int G, int P, int n,
                  int m, int Wb, int dr, int banded, const float* Tx,
                  const float* A1yc, const float* A1ys, float* gxo,
                  float* gyo, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      grouped_stage2_kernel<GRAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ZSMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(m / ZT, n / ZT, G);
  grouped_stage2_kernel<GRAD><<<grid, ZNT, ZSMEM, stream>>>(
      T, A1c, A1s, off, ph, wt, P, n, m, Wb, dr, banded, Tx, A1yc, A1ys, gxo,
      gyo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sweep_stage1(const float* Sr, const float* Si, const float* gx,
                 const float* gy, const float* A0c, const float* A0s,
                 const int* run, float* T, int G, int H, int P, int n, int W0,
                 int Wb, cudaStream_t stream) {
  dim3 grid(Wb / TILE, n / TILE, G * P);
  stage1_kernel<<<grid, NT, 0, stream>>>(Sr, Si, gx, gy, A0c, A0s, run, T, H,
                                         P, n, W0, Wb);
  return (int)cudaGetLastError();
}

// T (G, P, n, 2 Wb), A1c and A1s (G, m, Wb), all contiguous float32; n,
// m and Wb multiples of 64
int sweep_stage2(const float* T, const float* A1c, const float* A1s,
                 const int* off, float* ph, float* wt, int G, int P, int n,
                 int m, int Wb, int dr, int banded, cudaStream_t stream) {
  return launch_stage2<false>(T, A1c, A1s, off, ph, wt, G, P, n, m, Wb, dr,
                              banded, nullptr, nullptr, nullptr, nullptr,
                              nullptr, stream);
}

// emission (b): also Tx (G, P, n, 2 Wb), A1yc and A1ys (G, m, Wb); the
// winners' gradients to gxo, gyo (G, n, m)
int sweep_stage2_grad(const float* T, const float* Tx, const float* A1c,
                      const float* A1s, const float* A1yc, const float* A1ys,
                      const int* off, float* ph, float* wt, float* gxo,
                      float* gyo, int G, int P, int n, int m, int Wb, int dr,
                      int banded, cudaStream_t stream) {
  return launch_stage2<true>(T, A1c, A1s, off, ph, wt, G, P, n, m, Wb, dr,
                             banded, Tx, A1yc, A1ys, gxo, gyo, stream);
}

int sweep_uv(const float* ph, const float* wt, const float* kc, float* ux,
             float* uy, float* wn, int G, int n, int m, cudaStream_t stream) {
  const size_t nm = (size_t)n * m;
  const unsigned blocks = (unsigned)((nm + NT - 1) / NT);
  uv_kernel<<<blocks, NT, 0, stream>>>(ph, wt, kc, ux, uy, wn, G, n, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
