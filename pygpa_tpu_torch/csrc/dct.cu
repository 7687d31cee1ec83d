// Single-pass DCT-II and its exact inverse along one axis, as a
// shared-memory FFT.
//
// Replaces the TPU kernels pygpa_tpu/ops/pallas_dct2.py _fwd_lane_kernel
// (axis -1, entries dct_lane / idct_lane) and _fwd_sub_kernel (axis -2,
// entries dct_sub / idct_sub). Wrapper, twiddle tables and plain twins:
// pygpa_tpu_torch/ops/dct.py. The kernel itself (radix DFTs, Stockham
// pass, load and store) is in dct_fft.cuh, which the multigrid CG
// (cg.cu) and the early-stopping CG (cg_unwrap.cu) share for their
// preconditioners; this file sets the line counts per block for n >= 1024
// and binds the entries.
//
// What bounds it on an H100: memory. A (2, 4096, 4096) float32 call
// reads 134 MB and writes 134 MB, 0.080 ms at 3.35 TB/s; the FFT form
// does ~1 GFLOP, 0.015 ms at the 67 TFLOP/s float32 peak. (The TPU
// kernels' digit-split contraction did 4 * 128 * n FMAs per line, 34
// GFLOP per call: 0.51 ms on this card's float32 units even at peak.)
//
// The design does each line's whole transform in shared memory, so each
// element is read from device memory once and written once:
//
// forward (scipy dct type 2, norm=None; Makhoul), for a line x of n:
//   1. load with the permutation v_j = x_2j, v_(n-1-j) = x_(2j+1), and
//      read v as N = n/2 complex points z_m = v_2m + i v_(2m+1);
//   2. Z = FFT_N(z): radix-8/16 Stockham passes, each thread holding its
//      butterflies in registers between two __syncthreads;
//   3. split Z into V_k, V_(N-k) (the real FFT of v) and store
//      y_k = 2 Re(e^(-i pi k / 2n) V_k) and y_(n-k), y_(N-k), y_(N+k)
//      from the same pair of loads;
// inverse (scipy idct type 2, norm=None): the mirror image. The load
//   reads y_k, y_(n-k), y_(N-k), y_(N+k) together, builds
//   F_k = (y_k - i y_(n-k)) e^(i pi k / 2n) / (2n) and packs the
//   Hermitian F into Z'_k = (F_k + F_(k+N)) + i e^(2 pi i k / n)
//   (F_k - F_(k+N)) and Z'_(N-k); an unnormalised inverse FFT_N gives
//   z, whose real and imaginary parts are v_2m and v_(2m+1); the store
//   undoes the permutation.
//
// Twiddles come from one float32 table per (n, direction), built on the
// host in float64 from integer angles reduced mod 4n: tw (N: the FFT's
// roots of unity), w (N + 1: e^(-+ i pi k / 2n), scaled by 1/(2n) for the
// inverse) and A (N/2 + 1: e^(-+ 2 pi i k / n)). Each block copies it to
// shared memory once.
//
// lane kernel (axis -1): C = 16384 / n rows per block (64 KB of complex
//   data), rows laid out one after the other; ragged row counts masked.
//   The forward's load and the inverse's store move 16 bytes per thread
//   (x_4t .. x_4t+3 are z_t and z_(N-1-t)); the forward's split store
//   and the inverse's pack load are coalesced 4-byte accesses.
// sub kernel (axis -2, no transpose): a strip of C adjacent columns of
//   one plane per block, C = 32768 / n (128 KB of complex data; 8
//   columns, one 32-byte sector per row, at n = 4096), columns
//   interleaved; ragged column counts are masked.
// Threads per block C * N / 32 (256 lane, 512 sub).
// Both keep one padding slot per 16 complex values in shared memory, so
// the stride-R writes of the first Stockham pass do not conflict on
// banks. 32 complex values per thread in registers per pass.
#include <cuda_runtime.h>

#include "dct_fft.cuh"

namespace {

template <int N, int C, bool SUB, bool INV>
int launch(const float* x, float* y, const float* tab, int lines, int batch,
           cudaStream_t stream) {
  constexpr int T = C * N / 32;
  constexpr size_t smem = dct_smem_bytes<N, C>();
  cudaError_t err = cudaFuncSetAttribute(
      dct_kernel<N, C, SUB, INV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lines + C - 1) / C, SUB ? batch : 1);
  dct_kernel<N, C, SUB, INV><<<grid, T, smem, stream>>>(
      x, y, reinterpret_cast<const float2*>(tab), lines, Store{});
  return (int)cudaGetLastError();
}

template <int N, int C, bool SUB>
int launch_dir(const float* x, float* y, const float* tab, int lines,
               int batch, int inverse, cudaStream_t stream) {
  return inverse ? launch<N, C, SUB, true>(x, y, tab, lines, batch, stream)
                 : launch<N, C, SUB, false>(x, y, tab, lines, batch, stream);
}

}  // namespace

extern "C" {

// x, y: (rows, n) contiguous, 16-byte aligned; tab: the (n, direction)
// table of ops/dct.py (tw, w, A as interleaved float32 pairs)
int dct_lane(const float* x, float* y, const float* tab, int rows, int n,
             int inverse, cudaStream_t stream) {
  switch (n) {
    case 1024: return launch_dir<512, 16, false>(x, y, tab, rows, 1, inverse, stream);
    case 2048: return launch_dir<1024, 8, false>(x, y, tab, rows, 1, inverse, stream);
    case 4096: return launch_dir<2048, 4, false>(x, y, tab, rows, 1, inverse, stream);
    case 8192: return launch_dir<4096, 2, false>(x, y, tab, rows, 1, inverse, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// x, y: (batch, n, m) contiguous, transformed along n
int dct_sub(const float* x, float* y, const float* tab, int batch, int n,
            int m, int inverse, cudaStream_t stream) {
  switch (n) {
    case 1024: return launch_dir<512, 32, true>(x, y, tab, m, batch, inverse, stream);
    case 2048: return launch_dir<1024, 16, true>(x, y, tab, m, batch, inverse, stream);
    case 4096: return launch_dir<2048, 8, true>(x, y, tab, m, batch, inverse, stream);
    case 8192: return launch_dir<4096, 4, true>(x, y, tab, m, batch, inverse, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
