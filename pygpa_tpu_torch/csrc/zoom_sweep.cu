// Single-peak zoom WFR sweep: stage 2 of every candidate's lock-in, the
// |M|^2 argmax tournament and the optional phase/weight emission.
//
// Replaces the TPU kernel pygpa_tpu/ops/pallas_sweep.py _kernel (reached via
// fused_zoom_sweep_chunk / fused_zoom_sweep). Wrapper and plain twin:
// pygpa_tpu_torch/ops/zoom_sweep.py. Stage 1, T_i = ((A0c + i A0s) . gx_i)
// @ (Sr + i Si) . gy_i as [Re | Im] rows (P, n, 2 W1), is the grouped
// sweep's sweep_stage1 launched with one group and one band run
// (sweep.cu); this file holds the second launch:
//   per 64 x 64 pixel tile, for every candidate i in order,
//   M_i = T_i @ [A1c | -A1s ; A1s | A1c]^T, then the running best |M|^2
//   with strict '>' from a zero start (a tie keeps the earlier
//   candidate; a pixel where every |M|^2 is 0 keeps index 0 and M = 0),
//   which is the reference's chunked carry merge done in one pass.
//   Outputs best |M|^2, Re M, Im M, index; with dr >= 0 also the phase
//   atan2f(Im, Re) and the weight sqrt(|M|^2) * (1 + 1e-6 inside the
//   dr-pixel border, 1e-6 on it).
// Bound on an H100: P * n * m * W1 complex MACs in float32 FMA (4.4 TFLOP
// for the three 4096^2 bench peaks, W1 = 256). Unlike sweep.cu's stage 2,
// which keeps a tile's whole column basis in shared memory (Wb <= 256),
// this kernel streams T and the column basis through shared memory in
// 16-deep chunks per candidate, so W1 is bounded only by memory (512 at
// 8192^2); the extra basis traffic is served from L2 (the basis is
// 2 W1 m floats). The (P, n, m) candidate planes never exist: the
// tournament stays in registers.
#include <cuda_runtime.h>
#include <math.h>

#include "sweep_tile.cuh"

namespace {

// grid (m/64, n/64); T (P, n, 2 W1); A1cT, A1sT (W1, m)
__global__ void __launch_bounds__(NT, 2) zoom_stage2_kernel(
    const float* __restrict__ T, const float* __restrict__ A1cT,
    const float* __restrict__ A1sT, float* __restrict__ best_absq,
    float* __restrict__ best_r, float* __restrict__ best_i,
    int* __restrict__ best_idx, float* __restrict__ ph,
    float* __restrict__ wt, int P, int n, int m, int W1, int dr) {
  __shared__ __align__(16) float Tr[BK][APAD];
  __shared__ __align__(16) float Ti[BK][APAD];
  __shared__ __align__(16) float Bc[BK][TILE];
  __shared__ __align__(16) float Bs[BK][TILE];
  const int c0 = blockIdx.x * TILE;
  const int r0 = blockIdx.y * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t ld = 2 * (size_t)W1;

  float ba[4][4], br[4][4], bi[4][4];
  int bx[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      ba[a][b] = br[a][b] = bi[a][b] = 0.f;
      bx[a][b] = 0;
    }

  for (int i = 0; i < P; ++i) {
    const float* Tg = T + ((size_t)i * n + r0) * ld;
    float accr[4][4], acci[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) accr[a][b] = acci[a][b] = 0.f;
    for (int k0 = 0; k0 < W1; k0 += BK) {
      __syncthreads();
      for (int e = threadIdx.x; e < TILE * BK; e += NT) {
        const int r = e / BK, k = e % BK;
        Tr[k][r] = Tg[(size_t)r * ld + k0 + k];
        Ti[k][r] = Tg[(size_t)r * ld + W1 + k0 + k];
      }
      for (int e = threadIdx.x; e < TILE * BK; e += NT) {
        const int k = e / TILE, c = e % TILE;
        const size_t idx = (size_t)(k0 + k) * m + c0 + c;
        Bc[k][c] = A1cT[idx];
        Bs[k][c] = A1sT[idx];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        // M_r = Tr A1c - Ti A1s, M_i = Tr A1s + Ti A1c
        cmac(&Tr[k][ty * 4], &Ti[k][ty * 4], &Bc[k][tx * 4], &Bs[k][tx * 4],
             accr, acci);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float mr = accr[a][b], mi = acci[a][b];
        const float absq = __fadd_rn(__fmul_rn(mr, mr), __fmul_rn(mi, mi));
        if (absq > ba[a][b]) {
          ba[a][b] = absq;
          br[a][b] = mr;
          bi[a][b] = mi;
          bx[a][b] = i;
        }
      }
    }
  }

  const float inside = (float)(1.0 + 1e-6);
  const float rim = 1e-6f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + tx * 4 + b;
      const size_t o = (size_t)r * m + c;
      best_absq[o] = ba[a][b];
      best_r[o] = br[a][b];
      best_i[o] = bi[a][b];
      best_idx[o] = bx[a][b];
      if (dr >= 0) {
        const bool interior = r >= dr && r < n - dr && c >= dr && c < m - dr;
        ph[o] = atan2f(bi[a][b], br[a][b]);
        wt[o] = __fmul_rn(sqrtf(fmaxf(ba[a][b], 0.f)), interior ? inside : rim);
      }
    }
  }
}

}  // namespace

extern "C" {

int zoom_sweep_stage2(const float* T, const float* A1cT, const float* A1sT,
                      float* best_absq, float* best_r, float* best_i,
                      int* best_idx, float* ph, float* wt, int P, int n,
                      int m, int W1, int dr, cudaStream_t stream) {
  dim3 grid(m / TILE, n / TILE);
  zoom_stage2_kernel<<<grid, NT, 0, stream>>>(T, A1cT, A1sT, best_absq,
                                              best_r, best_i, best_idx, ph,
                                              wt, P, n, m, W1, dr);
  return (int)cudaGetLastError();
}

}  // extern "C"
