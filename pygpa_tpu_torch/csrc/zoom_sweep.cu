// Single-peak zoom WFR sweep: stage 2 of every candidate's lock-in on the
// tensor cores (3xTF32), the |M|^2 argmax tournament and the optional
// phase/weight emission.
//
// Replaces the TPU kernel pygpa_tpu/ops/pallas_sweep.py _kernel (reached via
// fused_zoom_sweep_chunk / fused_zoom_sweep, with and without grad_ops).
// Wrapper and plain twin: pygpa_tpu_torch/ops/zoom_sweep.py. Stage 1, T_i =
// ((A0c + i A0s) . gx_i) @ (Sr + i Si) . gy_i as [Re | Im] rows (P, n, 2 W1),
// is the grouped sweep's sweep_stage1 launched with one group and one band
// run (sweep.cu), and the column basis is split for the tensor cores once
// a call by sweep.cu's split_basis_kernel ((6, m, W1): -s_hi, c_hi,
// s_hi, -s_lo, c_lo, s_lo). This file holds the stage-2 launch: per 64
// x 64 pixel tile, wg_sweep_tile() (sweep_tc.cuh: Hopper's tensor-core
// path, warpgroup wgmma m64n64k8 TF32 fed by a TMA ring over T and the
// split basis, loaded two stages ahead, 3xTF32 with one tensor-core
// chain per 32 columns of W1, the tournament in registers with strict
// '>' from a zero start, so a pixel where every |M|^2 is 0 keeps index
// 0 and M = 0), then this epilogue: best |M|^2, Re M, Im M, index; with dr >= 0
// also the phase atan2f(Im, Re) and the weight sqrt(|M|^2) * (1 + 1e-6
// inside the dr-pixel border, 1e-6 on it). The gradient emission runs
// this same launch as its tournament and then sweep.cu's band flags,
// stage 1 of the row-derivative window S2 = (2 pi i f0) S on the flagged
// (64-row band, candidate) pairs only (Tx), and the winner products (Mx
// = Tx_i . A1, My = T_i . A1y with A1y = (2 pi i f1) A1, for each
// candidate that wins a pixel of a tile), so this kernel holds no
// gradient state.
//
// Bound on an H100. Stage 2 is P * n * m * 8 W1 FLOP: 4.36 TFLOP for the
// three 4096^2 bench peaks (P = 42, 49, 36; W1 = 256). In float32 FMA on
// the SIMT cores (67 TFLOP/s) that is 65 ms; as 3xTF32 on the tensor
// cores, 13.1 TFLOP over 495 TFLOP/s dense TF32, about 26 ms. The TPU
// kernel met the same problem with a bf16 hi/lo split on the MXU
// (_split_bf16); 3xTF32 is its Hopper analogue. The former design of this
// stage (mma.sync m16n8k8 with cp.async loads) ran at ~30% of that bound;
// what the wgmma design changes, and why, is in sweep_tc.cuh's note. Any
// W1 that is a multiple of 64; n, m multiples of 64.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sweep_tc.cuh"

namespace {

// grid (m/64, n/64, B), image z of a stack whose T (B, P, n, 2 W1) is the
// map tmT (rows of 2 W1) and whose outputs are (B, n, m) (one image: B =
// 1); tmB the split column basis (6, m, W1), shared; a block's
// arithmetic is one image's, so an image's outputs are its own launch's
// bits; dynamic smem WSMEM
__global__ void __launch_bounds__(WNT, 1) zoom_stage2_kernel(
    const __grid_constant__ CUtensorMap tmT,
    const __grid_constant__ CUtensorMap tmB, float* __restrict__ best_absq,
    float* __restrict__ best_r, float* __restrict__ best_i,
    int* __restrict__ best_idx, float* __restrict__ ph,
    float* __restrict__ wt, int P, int n, int m, int W1, int dr) {
  extern __shared__ __align__(16) float smem[];   // aligned to 1024 inside
  const size_t z = blockIdx.z, plane = z * n * m;
  best_absq += plane;
  best_r += plane;
  best_i += plane;
  best_idx += plane;
  if (dr >= 0) {   // else ph, wt alias best_absq and are not written
    ph += plane;
    wt += plane;
  }
  const int c0 = blockIdx.x * ZT, r0 = blockIdx.y * ZT;
  float br[16], bi[16];
  int bx[16];
  wg_sweep_tile<false, false>(&tmT, &tmB, (int)z * P * n + r0, n, P, W1,
                              c0, 0, reinterpret_cast<unsigned char*>(smem),
                              br, bi, bx);
  int rw, cl;
  wg_pixel(r0, c0, &rw, &cl);

  const float inside = (float)(1.0 + 1e-6);
  const float rim = 1e-6f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // results 4 j + 2 h and 4 j + 2 h + 1: two neighbouring columns
      const int e = 4 * j + 2 * h;
      const int r = rw + 8 * h;
      const int c = cl + 8 * j;
      const size_t o = (size_t)r * m + c;
      const float xr0 = br[e], xr1 = br[e + 1];
      const float xi0 = bi[e], xi1 = bi[e + 1];
      const float q0 = absq(xr0, xi0), q1 = absq(xr1, xi1);
      *reinterpret_cast<float2*>(best_absq + o) = make_float2(q0, q1);
      *reinterpret_cast<float2*>(best_r + o) = make_float2(xr0, xr1);
      *reinterpret_cast<float2*>(best_i + o) = make_float2(xi0, xi1);
      *reinterpret_cast<int2*>(best_idx + o) = make_int2(bx[e], bx[e + 1]);
      if (dr >= 0) {
        const bool row_in = r >= dr && r < n - dr;
        const float f0 = row_in && c >= dr && c < m - dr ? inside : rim;
        const float f1 =
            row_in && c + 1 >= dr && c + 1 < m - dr ? inside : rim;
        *reinterpret_cast<float2*>(ph + o) =
            make_float2(atan2f(xi0, xr0), atan2f(xi1, xr1));
        *reinterpret_cast<float2*>(wt + o) =
            make_float2(__fmul_rn(sqrtf(fmaxf(q0, 0.f)), f0),
                        __fmul_rn(sqrtf(fmaxf(q1, 0.f)), f1));
      }
    }
}

constexpr int MAX_GRID_Z = 65535;   // CUDA's gridDim.z limit

}  // namespace

extern "C" {

// B images: T (B, P, n, 2 W1), the outputs (B, n, m); Bsplit (6, m, W1)
// the split column basis (sweep_split_basis), shared; all contiguous
// float32; n, m and W1 multiples of 64. Stacks past gridDim.z go in
// launches of whole images
int zoom_sweep_stage2(const float* T, const float* Bsplit, float* best_absq,
                      float* best_r, float* best_i, int* best_idx, float* ph,
                      float* wt, int B, int P, int n, int m, int W1, int dr,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      zoom_stage2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WSMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmB;
  if ((err = basis_map(&tmB, Bsplit, WPLANES, m, W1)) != cudaSuccess)
    return (int)err;
  const size_t tb = (size_t)P * n * 2 * W1, pb = (size_t)n * m;
  const size_t eb = dr >= 0 ? pb : 0;   // ph, wt alias best_absq when off
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Z) {
    const int bc = B - b0 < MAX_GRID_Z ? B - b0 : MAX_GRID_Z;
    CUtensorMap tmT;
    if ((err = t_map(&tmT, T + b0 * tb, (uint64_t)bc * P * n, W1)) !=
        cudaSuccess)
      return (int)err;
    zoom_stage2_kernel<<<dim3(m / ZT, n / ZT, bc), WNT, WSMEM, stream>>>(
        tmT, tmB, best_absq + b0 * pb, best_r + b0 * pb, best_i + b0 * pb,
        best_idx + b0 * pb, ph + b0 * eb, wt + b0 * eb, P, n, m, W1, dr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
