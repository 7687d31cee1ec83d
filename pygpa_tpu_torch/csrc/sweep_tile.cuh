// Tile constants and the complex 4x4 multiply-accumulate shared by the
// sweep kernels (sweep.cu: grouped sweep; zoom_sweep.cu: single-peak
// zoom sweep). Each block computes a 64 x 64 output tile with 256
// threads, 4 x 4 outputs a thread, contracting in 16-deep chunks staged
// in shared memory.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;   // output tile edge (rows and columns)
constexpr int BK = 16;     // contraction chunk
constexpr int APAD = TILE + 4;
constexpr int NT = 256;    // 16 x 16 threads, 4 x 4 outputs each

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

}  // namespace
