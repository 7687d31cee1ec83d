// Single-peak zoom WFR sweep: stage 2 of every candidate's lock-in on the
// tensor cores (3xTF32), the |M|^2 argmax tournament and the optional
// phase/weight emission.
//
// Replaces the TPU kernel pygpa_tpu/ops/pallas_sweep.py _kernel (reached via
// fused_zoom_sweep_chunk / fused_zoom_sweep). Wrapper and plain twin:
// pygpa_tpu_torch/ops/zoom_sweep.py. Stage 1, T_i = ((A0c + i A0s) . gx_i)
// @ (Sr + i Si) . gy_i as [Re | Im] rows (P, n, 2 W1), is the grouped
// sweep's sweep_stage1 launched with one group and one band run
// (sweep.cu); this file holds the second launch: per 64 x 64 pixel tile,
// for every candidate i in order,
//   M_r = [Tr | Ti] . [A1c^T ; -A1s^T],  M_i = [Tr | Ti] . [A1s^T ; A1c^T]
// (depth K = 2 W1), then the running best |M|^2 with strict '>' from a
// zero start (a tie keeps the earlier candidate; a pixel where every
// |M|^2 is 0 keeps index 0 and M = 0), the reference's chunked carry
// merge done in one pass. Outputs best |M|^2, Re M, Im M, index; with
// dr >= 0 also the phase atan2f(Im, Re) and the weight sqrt(|M|^2) *
// (1 + 1e-6 inside the dr-pixel border, 1e-6 on it).
//
// Bound on an H100. Stage 2 is P * n * m * 8 W1 FLOP: 4.36 TFLOP for the
// three 4096^2 bench peaks (P = 42, 49, 36; W1 = 256). In float32 FMA on
// the SIMT cores (67 TFLOP/s) that is 65 ms, which the kernel this one
// replaced approached to within 2x. Here it runs on the tensor cores as
// 3xTF32: three TF32 products per float32 product, 13.1 TFLOP over 495
// TFLOP/s dense TF32, about 26 ms. The TPU kernel met the same problem
// with a bf16 hi/lo split on the MXU (_split_bf16); this is its Hopper
// analogue.
//
// Design, and what it does about the bound:
// - 3xTF32. Each operand is split once, as its fragment loads from shared
//   memory: hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) (x - hi is
//   exact). Every float32 product a*b is taken as three mma.sync
//   m16n8k8 TF32 products into one float32 accumulator, in this order:
//   lo(a) hi(b), then hi(a) lo(b), then hi(a) hi(b); lo(a) lo(b) (2^-22
//   of the product) is dropped. One TF32 pass would keep 10 mantissa
//   bits: a phase error near 1e-3 rad, where the sweep's phase needs
//   1e-5 (tests/test_torch_zoom_sweep.py emulates both).
// - Accumulation. The tensor cores add an mma's products into their
//   float32 accumulator and truncate, where a float32 add rounds to
//   nearest; over a long chain the truncation shrinks |M| (one chain of
//   384 mma at W1 = 512 misses the weight's 1e-5 rtol). So each stage
//   (32 columns of W1, 24 mma per accumulator) is its own tensor-core
//   chain from zero, and the stage sums are added into float32 registers
//   with one round-to-nearest add each. Of the chain lengths tried on the
//   card (1, 8 and 64 stages) this one puts the displacement path
//   nearest the path with a float64 zoom sweep, nearer than the float32
//   twin's; chip_smoke.py's phase 5 holds the path to that float64 path.
//   The extra adds cost ~1% of stage 2.
// - Complex as real products. One A fragment (a Tr or a Ti row slice)
//   feeds both M_r and M_i; -A1s is A1s's split with the sign bit
//   flipped, which is exact.
// - mma.sync, not wgmma: simple and right on sm_90a; wgmma with TMA
//   loads is the next step (PERF.md, ROADMAP.md "Next"). On the card this
//   kernel reaches ~150 TFLOP/s of TF32 products, 30% of the dense rate,
//   and two blocks per SM were only ~5% faster: not occupancy but, most
//   likely, the mma.sync rate holds it there.
// - Asynchronous staging: a ring of 3 stages, each holding 32 columns of
//   W1 for the tile's Tr, Ti, A1c and A1s rows (4 x 64 x 32 floats),
//   filled with 16-byte cp.async.cg while the tensor cores work on the
//   previous stage; the ring runs across candidate boundaries. Rows are
//   padded to 36 floats so every fragment load is bank-conflict free.
// - The tile. 64 x 64 pixels per 256 threads (8 warps, 2 x 4, each 32 x
//   16 pixels: 2 x 2 m16n8 tiles for M_r and 2 x 2 for M_i), one block
//   per SM (108 KB of shared memory). Each candidate's T row band
//   (64 rows x 2 W1) is read from L2 by the m/64 blocks of a tile row, and
//   each column-basis slice by the n/64 blocks of a tile column, so the
//   tile's L2 traffic is P n m 8 W1 (1/64 + 1/64) bytes: 32 FLOP per byte,
//   about 1.6 TB/s at the bench's measured ~88 ms, under the L2's rate. Blocks
//   of one tile row run side by side (blockIdx.x is the column), so each
//   T band comes from device memory about once. A 128 x 64 tile would
//   halve the basis traffic but needs 32 pixels of state per thread,
//   past the 255-register limit with the float32 sums.
// - Tournament state in registers, in the accumulator's fragment layout:
//   (Re, Im, index) per pixel; |M|^2 of the best is recomputed with the
//   same _rn operations at each compare, which is exact and saves a
//   register per pixel. 16 pixels a thread: 32 tensor-core accumulators,
//   32 float32 stage sums, 48 state, so one block per SM (up to 255
//   registers; chip_smoke.py prints ptxas's count and spills in phase
//   2); at two blocks per SM (128 registers) the stage sums spill.
// - Any W1 that is a multiple of 64 (the ring's stage is 32 deep and the
//   wrapper keeps the 64 rule); n, m multiples of 64. The (P, n, m)
//   candidate planes never exist.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ZT = 64;            // output tile edge (rows and columns)
constexpr int ZNT = 256;          // 8 warps: 2 (rows) x 4 (columns)
constexpr int ZBK = 32;           // W1 columns per stage, for Tr and Ti
constexpr int ZLD = ZBK + 4;      // padded row: conflict-free fragments
constexpr int ZSTAGES = 3;
constexpr int ZOP = ZT * ZLD;     // floats of one operand in a stage
constexpr int ZSTAGE = 4 * ZOP;   // Tr, Ti, A1c, A1s
constexpr size_t ZSMEM = (size_t)ZSTAGES * ZSTAGE * sizeof(float);
constexpr uint32_t SIGN = 0x80000000u;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a b, one m16n8k8 TF32 product (a: row-major 16 x 8, b: 8 x 8)
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: lo.hi, hi.lo, then hi.hi (this order sets the
// rounding; the twin and the CPU emulation follow it)
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4],
                                     const uint32_t al[4],
                                     const uint32_t bh[2],
                                     const uint32_t bl[2]) {
  mma(c, al, bh);
  mma(c, ah, bl);
  mma(c, ah, bh);
}

__device__ __forceinline__ float absq(float r, float i) {
  return __fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i));
}

// grid (m/64, n/64); T (P, n, 2 W1); A1c, A1s (m, W1); dynamic smem ZSMEM
__global__ void __launch_bounds__(ZNT, 1) zoom_stage2_kernel(
    const float* __restrict__ T, const float* __restrict__ A1c,
    const float* __restrict__ A1s, float* __restrict__ best_absq,
    float* __restrict__ best_r, float* __restrict__ best_i,
    int* __restrict__ best_idx, float* __restrict__ ph,
    float* __restrict__ wt, int P, int n, int m, int W1, int dr) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;     // mma group and thread in it
  const int wm = warp >> 2, wn = warp & 3;   // warp's 32 x 16 pixel block
  const int c0 = blockIdx.x * ZT, r0 = blockIdx.y * ZT;
  const size_t ld = 2 * (size_t)W1;
  const int nk = W1 / ZBK;
  const int total = P * nk;

  // tensor-core accumulators (one stage's chain), their float32 sums over
  // the candidate's stages, and the tournament state of the thread's 16
  // pixels, in the m16n8 layout: [row tile][column tile][c0..c3]
  float accr[2][2][4], acci[2][2][4], sumr[2][2][4], sumi[2][2][4];
  float br[2][2][4], bi[2][2][4];
  int bx[2][2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accr[a][b][e] = acci[a][b][e] = sumr[a][b][e] = sumi[a][b][e] = 0.f;
        br[a][b][e] = bi[a][b][e] = 0.f;
        bx[a][b][e] = 0;
      }

  // stage s: candidate s / nk, W1 columns [k0, k0 + 32) of Tr, Ti (rows
  // r0..r0+63 of T_i) and of A1c, A1s (rows c0..c0+63)
  auto load = [&](int s) {
    const int i = s / nk;
    const int k0 = (s - i * nk) * ZBK;
    float* st = smem + (s % ZSTAGES) * ZSTAGE;
    const float* tg = T + ((size_t)i * n + r0) * ld + k0;
    const float* cg = A1c + (size_t)c0 * W1 + k0;
    const float* sg = A1s + (size_t)c0 * W1 + k0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + j * ZNT;
      const int row = e >> 3, q = (e & 7) * 4;
      float* d = st + row * ZLD + q;
      cp_async16(d, tg + row * ld + q);
      cp_async16(d + ZOP, tg + row * ld + W1 + q);
      cp_async16(d + 2 * ZOP, cg + (size_t)row * W1 + q);
      cp_async16(d + 3 * ZOP, sg + (size_t)row * W1 + q);
    }
  };

#pragma unroll
  for (int s = 0; s < ZSTAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  for (int s = 0; s < total; ++s) {
    cp_async_wait<ZSTAGES - 2>();
    __syncthreads();  // stage s landed; every warp is done with stage s-1
    if (s + ZSTAGES - 1 < total) load(s + ZSTAGES - 1);
    cp_async_commit();

    const float* st = smem + (s % ZSTAGES) * ZSTAGE;
    // fragment bases: A (row g of the warp's rows, column t), B (pixel
    // column g of the warp's columns, depth t)
    const float* sTr = st + (wm * 32 + g) * ZLD + t;
    const float* sTi = sTr + ZOP;
    const float* sBc = st + 2 * ZOP + (wn * 16 + g) * ZLD + t;
    const float* sBs = sBc + ZOP;
#pragma unroll
    for (int kk = 0; kk < ZBK; kk += 8) {
      // B fragments: b0 (depth t, column g), b1 (depth t + 4, column g)
      uint32_t ch[2][2], cl[2][2], sh[2][2], sl[2][2];
#pragma unroll
      for (int pt = 0; pt < 2; ++pt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          split(sBc[pt * 8 * ZLD + kk + 4 * h], ch[pt][h], cl[pt][h]);
          split(sBs[pt * 8 * ZLD + kk + 4 * h], sh[pt][h], sl[pt][h]);
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // A fragments: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
        // a3 (g + 8, t + 4)
        uint32_t rh[4], rl[4], ih[4], il[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int off = (mt * 16 + (q & 1) * 8) * ZLD + kk + (q >> 1) * 4;
          split(sTr[off], rh[q], rl[q]);
          split(sTi[off], ih[q], il[q]);
        }
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
          const uint32_t nsh[2] = {sh[pt][0] ^ SIGN, sh[pt][1] ^ SIGN};
          const uint32_t nsl[2] = {sl[pt][0] ^ SIGN, sl[pt][1] ^ SIGN};
          mma3(accr[mt][pt], rh, rl, ch[pt], cl[pt]);   // + Tr A1c
          mma3(accr[mt][pt], ih, il, nsh, nsl);         // - Ti A1s
          mma3(acci[mt][pt], rh, rl, sh[pt], sl[pt]);   // + Tr A1s
          mma3(acci[mt][pt], ih, il, ch[pt], cl[pt]);   // + Ti A1c
        }
      }
    }

    // the stage's chain ends: its sums go into the float32 sums, rounded
    // to nearest, and the tensor cores restart from zero
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sumr[a][b][e] = __fadd_rn(sumr[a][b][e], accr[a][b][e]);
          sumi[a][b][e] = __fadd_rn(sumi[a][b][e], acci[a][b][e]);
          accr[a][b][e] = acci[a][b][e] = 0.f;
        }

    if (s % nk == nk - 1) {  // candidate s / nk complete: tournament
      const int i = s / nk;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float mr = sumr[a][b][e], mi = sumi[a][b][e];
            if (absq(mr, mi) > absq(br[a][b][e], bi[a][b][e])) {
              br[a][b][e] = mr;
              bi[a][b][e] = mi;
              bx[a][b][e] = i;
            }
            sumr[a][b][e] = sumi[a][b][e] = 0.f;
          }
    }
  }

  const float inside = (float)(1.0 + 1e-6);
  const float rim = 1e-6f;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // c0, c1 at (g, 2t), (g, 2t + 1); c2, c3 eight rows down
        const int r = r0 + wm * 32 + a * 16 + g + h * 8;
        const int c = c0 + wn * 16 + b * 8 + 2 * t;
        const size_t o = (size_t)r * m + c;
        const float xr0 = br[a][b][2 * h], xr1 = br[a][b][2 * h + 1];
        const float xi0 = bi[a][b][2 * h], xi1 = bi[a][b][2 * h + 1];
        const float q0 = absq(xr0, xi0), q1 = absq(xr1, xi1);
        *reinterpret_cast<float2*>(best_absq + o) = make_float2(q0, q1);
        *reinterpret_cast<float2*>(best_r + o) = make_float2(xr0, xr1);
        *reinterpret_cast<float2*>(best_i + o) = make_float2(xi0, xi1);
        *reinterpret_cast<int2*>(best_idx + o) =
            make_int2(bx[a][b][2 * h], bx[a][b][2 * h + 1]);
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

}  // namespace

extern "C" {

// T (P, n, 2 W1), A1c and A1s (m, W1), all contiguous float32; n, m and
// W1 multiples of 64
int zoom_sweep_stage2(const float* T, const float* A1c, const float* A1s,
                      float* best_absq, float* best_r, float* best_i,
                      int* best_idx, float* ph, float* wt, int P, int n,
                      int m, int W1, int dr, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      zoom_stage2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ZSMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(m / ZT, n / ZT);
  zoom_stage2_kernel<<<grid, ZNT, ZSMEM, stream>>>(
      T, A1c, A1s, best_absq, best_r, best_i, best_idx, ph, wt, P, n, m, W1,
      dr);
  return (int)cudaGetLastError();
}

}  // extern "C"
