// The early-stopping CG's per-plane state, its block reductions and the
// epilogues of its DCT passes, shared by cg_unwrap.cu (the solve, the
// power-of-two passes) and cg_unwrap_czt.cu (the chirp-z passes, compiled
// apart so that the build runs both side by side). The file comment of
// cg_unwrap.cu describes the solve.
#pragma once

#include <cuda_runtime.h>

namespace cgu {

// the per-plane state, B entries each
struct State {
  float* rz;      // <r, z> of the iteration
  float* pq;      // <p, Qp>
  float* rzprev;  // rz of the plane's last iteration (1 before its first)
  float* thr;     // 1e-6 ||rk0||
  float* rnorm;   // ||r|| after the plane's last iteration (||rk0|| before)
  int* done;
  int* k;
  unsigned int* count;  // blocks of the running launch that have finished
};

// sc: (5, B) floats rz, pq, rzprev, thr, rnorm; si: (3, B) ints done, k,
// count
inline State state(float* sc, int* si, int B) {
  return {sc, sc + B, sc + 2 * B, sc + 3 * B, sc + 4 * B, si, si + B,
          reinterpret_cast<unsigned int*>(si + 2 * B)};
}

// fixed-order tree over the block (blockDim.x a power of two)
__device__ __forceinline__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const float out = sh[0];
  __syncthreads();
  return out;
}

// Called by every thread after thread 0 stored the block's partial: true
// in the block that finished last of the plane's nb (which then resets
// the counter for the next launch).
__device__ __forceinline__ bool last_block(unsigned int* count, int nb,
                                           float* sh) {
  int* flag = reinterpret_cast<int*>(sh);
  if (threadIdx.x == 0) {
    __threadfence();  // the partial is visible before the count
    const unsigned int before = atomicAdd(count, 1u);
    const int last = before == (unsigned int)(nb - 1);
    if (last) *count = 0u;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  __syncthreads();
  return last;
}

// the plane's nb partials added in the same order in every solve (read
// from L2: other blocks stored them)
__device__ __forceinline__ float sum_partials(const float* part, int nb,
                                              float* sh) {
  float v = 0.f;
  for (int t = threadIdx.x; t < nb; t += blockDim.x) v += __ldcg(part + t);
  return block_sum(v, sh);
}

// 2 (cos(pi i / n) + cos(pi j / m) - 2) from the axes' cosines cn, cm
// (ops/cg.py _cos_axis: the twin's own float32 cos values), added and
// scaled as ops/cg.py poisson_scale does, so the eigenvalues are the
// twin's bits; the caller keeps [0, 0]
__device__ __forceinline__ float eigen(const float* __restrict__ cn,
                                       const float* __restrict__ cm, int i,
                                       int j) {
  return __fmul_rn(2.0f, __fsub_rn(__fadd_rn(cn[i], cm[j]), 2.0f));
}

// ---- epilogues of the DCT passes (dct_fft.cuh): a block of a done plane
// returns at its start; every pass's grid has the plane on y (a lane pass
// is a row of blocks a plane)

// plain stores (lane forward, sub inverse)
struct StoreLive {
  static constexpr bool REDUCES = false;
  static constexpr bool SKIPS = true;
  const int* done;
  __device__ __forceinline__ bool skip() const {
    return done[blockIdx.y] != 0;
  }
  __device__ __forceinline__ void put(float* y, size_t o, float v, int,
                                      int) {
    y[o] = v;
  }
};

// sub forward: y / eigenvalue (i, j), [0, 0] as it is
struct EpiEigenLive {
  static constexpr bool REDUCES = false;
  static constexpr bool SKIPS = true;
  const int* done;
  const float* cn;  // cos(pi i / n), i < n
  const float* cm;  // cos(pi j / m), j < m
  __device__ __forceinline__ bool skip() const {
    return done[blockIdx.y] != 0;
  }
  __device__ __forceinline__ void put(float* y, size_t o, float v, int i,
                                      int j) {
    y[o] = (i == 0 && j == 0) ? v : __fdiv_rn(v, eigen(cn, cm, i, j));
  }
};

// lane inverse: store z, add r.z into the thread's sum (16 bytes at a time
// on the power-of-two passes, 8 on the chirp-z ones); done() stores the
// block's partial and, in the plane's last block, rz
struct EpiDotLive {
  static constexpr bool REDUCES = true;
  static constexpr bool SKIPS = true;
  const float* r;
  float* part;
  State S;
  float acc;
  __device__ __forceinline__ bool skip() const {
    return S.done[blockIdx.y] != 0;
  }
  __device__ __forceinline__ void put4(float* y, size_t base, int i,
                                       float4 v) {
    reinterpret_cast<float4*>(y + base)[i] = v;
    const float4 q = reinterpret_cast<const float4*>(r + base)[i];
    acc = fmaf(q.x, v.x, acc);
    acc = fmaf(q.y, v.y, acc);
    acc = fmaf(q.z, v.z, acc);
    acc = fmaf(q.w, v.w, acc);
  }
  __device__ __forceinline__ void put2(float* y, size_t base, int i,
                                       float2 v) {
    reinterpret_cast<float2*>(y + base)[i] = v;
    const float2 q = reinterpret_cast<const float2*>(r + base)[i];
    acc = fmaf(q.x, v.x, acc);
    acc = fmaf(q.y, v.y, acc);
  }
  __device__ __forceinline__ void done(float* sh) {
    const float s = block_sum(acc, sh);
    const int b = blockIdx.y, nb = gridDim.x;
    float* own = part + (size_t)b * nb;
    if (threadIdx.x == 0) own[blockIdx.x] = s;
    if (last_block(S.count + b, nb, sh)) {
      const float rz = sum_partials(own, nb, sh);
      if (threadIdx.x == 0) S.rz[b] = rz;
    }
  }
};

// sides whose lines the chirp-z pass takes: even, 130 ... 4094, not a
// power of two (L = 256 ... 4096, cg_unwrap_czt.cu's CztSplit)
inline bool czt_side(int s) {
  return s > 128 && s < 4096 && s % 2 == 0 && (s & (s - 1)) != 0;
}

// The chirp-z pass along the lane (SUB false) or sub axis at a czt_side:
// `lines` rows a plane (lane) or columns (sub), B planes on grid y; tab:
// ops/dct.py bluestein_tables at (side, INV). Defined in cg_unwrap_czt.cu
// for the four passes of an iteration.
template <bool SUB, bool INV, class Epi>
int czt_pass_at(int side, const float* x, float* y, const float* tab,
                int lines, int B, Epi epi, cudaStream_t stream);

}  // namespace cgu
