// The early-stopping CG's chirp-z DCT passes (dct_fft.cuh czt_kernel) for
// the even sides 130 ... 4094 that are not powers of two: the lane
// forward, the sub forward with the eigenvalue division, the sub inverse
// and the lane inverse with the r.z partials, each at L = 256 ... 4096
// (20 instances). cg_unwrap.cu's pass_at calls them per axis; they are in
// a file of their own so that the build compiles them beside
// cg_unwrap.cu's 28 power-of-two passes.
//
// Lines a block: C = 16384 / L (512 threads, 32 complex values a thread
// a Stockham pass), so a block holds C padded lines of L (139 KB) and
// tw_L (2-32 KB): 141-171 KB of shared memory, one block an SM. At L =
// 4096 (sides 2050 ... 4094) a sub block covers 4 columns: 16 bytes of
// each row's 32-byte sector. Half the lines (256 threads, two blocks an
// SM) took 10% longer at (3, 4086^2), with or without a second block's
// register budget (PERF.md, the kernel table).
#include <cuda_runtime.h>

#include "cg_unwrap.cuh"
#include "dct_fft.cuh"

namespace cgu {

namespace {

template <int L, bool SUB, bool INV, class Epi>
int czt_pass(const float* x, float* y, const float2* tab, int N, int lines,
             int B, Epi epi, cudaStream_t stream) {
  constexpr int C = 16384 / L;
  constexpr int T = C * L / 32;
  constexpr size_t SMEM = czt_smem_bytes<L, C>();
  static_assert(SMEM <= 227 * 1024, "fits a block's shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      czt_kernel<L, C, SUB, INV, Epi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lines + C - 1) / C, B);
  czt_kernel<L, C, SUB, INV, Epi><<<grid, T, SMEM, stream>>>(
      x, y, tab, N, lines, epi);
  return (int)cudaGetLastError();
}

}  // namespace

template <bool SUB, bool INV, class Epi>
int czt_pass_at(int side, const float* x, float* y, const float* tab,
                int lines, int B, Epi epi, cudaStream_t stream) {
  if (!czt_side(side)) return (int)cudaErrorInvalidValue;
  const float2* t = reinterpret_cast<const float2*>(tab);
  const int N = side / 2;
  int L = 256;
  while (L < 2 * N - 1) L *= 2;
  switch (L) {
    case 256: return czt_pass<256, SUB, INV>(x, y, t, N, lines, B, epi, stream);
    case 512: return czt_pass<512, SUB, INV>(x, y, t, N, lines, B, epi, stream);
    case 1024: return czt_pass<1024, SUB, INV>(x, y, t, N, lines, B, epi, stream);
    case 2048: return czt_pass<2048, SUB, INV>(x, y, t, N, lines, B, epi, stream);
    case 4096: return czt_pass<4096, SUB, INV>(x, y, t, N, lines, B, epi, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template int czt_pass_at<false, false, StoreLive>(int, const float*, float*,
                                                  const float*, int, int,
                                                  StoreLive, cudaStream_t);
template int czt_pass_at<true, false, EpiEigenLive>(int, const float*,
                                                    float*, const float*,
                                                    int, int, EpiEigenLive,
                                                    cudaStream_t);
template int czt_pass_at<true, true, StoreLive>(int, const float*, float*,
                                                const float*, int, int,
                                                StoreLive, cudaStream_t);
template int czt_pass_at<false, true, EpiDotLive>(int, const float*, float*,
                                                  const float*, int, int,
                                                  EpiDotLive, cudaStream_t);

}  // namespace cgu
