// Stage 2 of a WFR sweep tile on the tensor cores (3xTF32), with the
// per-pixel |M|^2 tournament: the part shared by the single-peak zoom
// sweep (zoom_sweep.cu) and the grouped banded sweep (sweep.cu). Each
// tournament kernel calls sweep_tc_tile() for its 64 x 64 pixel tile and
// then writes its own epilogue from the winners it returns. The
// gradient emissions' winner products (sweep.cu) run the same product
// loop, tc_products(), over a list of jobs instead of the candidates.
//
// For P candidates i in order, with T_i (n, 2K) the stage-1 rows
// [Tr | Ti] and the column basis A1c, A1s (m rows, K columns):
//   M_r = [Tr | Ti] . [A1c^T ; -A1s^T],  M_i = [Tr | Ti] . [A1s^T ; A1c^T]
// and the running best (Re M, Im M, index) by |M|^2 with strict '>'
// from a zero start (a tie keeps the earlier candidate); with
// TAKE_FIRST, candidate 0 is taken unconditionally, as the grouped
// reference kernel seeds its tournament with candidate 0.
//
// Bound on an H100: 8 P n m K FLOP per tile set, three times over as
// 3xTF32 at the 495 TFLOP/s dense TF32 rate (in float32 FMA outside the
// tensor cores the same products bound at 67 TFLOP/s). Design:
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
//   384 mma at K = 512 misses the weight's 1e-5 rtol). So each stage
//   (32 columns of K, 24 mma per accumulator) is its own tensor-core
//   chain from zero, and the stage sums are added into float32 registers
//   with one round-to-nearest add each. Of the chain lengths tried on the
//   card (1, 8 and 64 stages) this one puts the zoom sweep's path
//   nearest the path with a float64 sweep, nearer than the float32
//   twin's (chip_smoke.py phase 5). The extra adds cost ~1% of stage 2.
//   With SPLIT (the grouped sweep) the two small products of each
//   stage run in a chain of their own, so the hi.hi chain truncates a
//   third as often: the grouped kernel's |M| then lies nearer its
//   float64 value than a float32 product's (chip_smoke.py phase 3),
//   for ~1% of the call and 20 registers.
// - Complex as real products. One A fragment (a Tr or a Ti row slice)
//   feeds both M_r and M_i; -A1s is A1s's split with the sign bit
//   flipped, which is exact.
// - mma.sync, not wgmma: simple and right on sm_90a; wgmma with TMA
//   loads is the next step (PERF.md, ROADMAP.md). On the card the zoom
//   kernel reaches ~150 TFLOP/s of TF32 products, 30% of the dense rate,
//   and two blocks per SM were only ~5% faster: not occupancy but, most
//   likely, the mma.sync rate holds it there.
// - Asynchronous staging: a ring of 3 stages, each holding 32 columns of
//   K for the tile's Tr, Ti, A1c and A1s rows (4 x 64 x 32 floats),
//   filled with 16-byte cp.async.cg while the tensor cores work on the
//   previous stage; the ring runs across candidate (job) boundaries,
//   and the column basis streams through it with T, so no K is too wide
//   for shared memory. Rows are padded to 36 floats so every fragment
//   load is bank-conflict free.
// - The tile. 64 x 64 pixels per 256 threads (8 warps, 2 x 4, each 32 x
//   16 pixels: 2 x 2 m16n8 tiles for M_r and 2 x 2 for M_i), one block
//   per SM (108 KB of shared memory). Each candidate's T row band
//   (64 rows x 2K) is read from L2 by the m/64 blocks of a tile row, and
//   each column-basis slice by the n/64 blocks of a tile column, so the
//   tile's L2 traffic is P n m 8 K (1/64 + 1/64) bytes: 32 FLOP per byte.
//   Blocks of one tile row run side by side (blockIdx.x is the column),
//   so each T band comes from device memory about once. A 128 x 64 tile
//   would halve the basis traffic but needs 32 pixels of state per
//   thread, past the 255-register limit with the float32 sums.
// - Tournament state in registers, in the accumulator's fragment layout:
//   (Re, Im, index) per pixel; |M|^2 of the best is recomputed with the
//   same _rn operations at each compare, which is exact and saves a
//   register per pixel. 16 pixels a thread: 32 tensor-core accumulators,
//   32 float32 stage sums, 48 state, so one block per SM (up to 255
//   registers; chip_smoke.py prints ptxas's count and spills in phase
//   2); at two blocks per SM (128 registers) the stage sums spill.
// - Any K that is a multiple of 32 (the callers keep multiples of 64);
//   n, m multiples of 64. The (P, n, m) candidate planes never exist.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ZT = 64;            // output tile edge (rows and columns)
constexpr int ZNT = 256;          // 8 warps: 2 (rows) x 4 (columns)
constexpr int ZBK = 32;           // K columns per stage, for Tr and Ti
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
// rounding; the CPU emulation follows it). With a separate accumulator s
// for the two small products (SPLIT), c takes hi.hi alone: its chain
// then truncates a third as often, and s's truncations are 2^-11 of its
// size.
template <bool SPLIT>
__device__ __forceinline__ void mma3(float c[4], float s[4],
                                     const uint32_t ah[4],
                                     const uint32_t al[4],
                                     const uint32_t bh[2],
                                     const uint32_t bl[2]) {
  mma(SPLIT ? s : c, al, bh);
  mma(SPLIT ? s : c, ah, bl);
  mma(c, ah, bh);
}

__device__ __forceinline__ float absq(float r, float i) {
  return __fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i));
}

// Tile position of the calling thread's results [a][b][h * 2 + j] (the
// m16n8 accumulator layout): (row, column) = (*row + a * 16 + h * 8,
// *col + b * 8 + j)
__device__ __forceinline__ void tc_pixel(int r0, int c0, int* row,
                                         int* col) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  *row = r0 + (warp >> 2) * 32 + (lane >> 2);
  *col = c0 + (warp & 3) * 16 + 2 * (lane & 3);
}

// The stage-2 products of the 64 x 64 tile at (r0, c0), job after job:
// job j's operands come from operands(j, a, bc, bs): a the row-major
// (n, 2K) [Re | Im] rows of its T (tile rows r0..r0+63 are read), bc and
// bs its column basis, row c at bc + c * ldb (K columns used); smem
// ZSMEM bytes of dynamic shared memory. When job j's sums are complete,
// done(j, sumr, sumi) gets its Re M and Im M in the fragment layout of
// tc_pixel(), and the sums restart from zero. The ring runs across job
// boundaries, so the jobs share one pipeline fill and one drain. SPLIT
// keeps the small products in their own chain (see mma3), which costs
// ~20 registers a thread and lands |M| nearer its float64 value than a
// float32 product does; the zoom sweep keeps one chain, the design its
// path check was measured with.
template <bool SPLIT, class Operands, class Done>
__device__ __forceinline__ void tc_products(Operands operands, int jobs,
                                            int K, int ldb, int r0, int c0,
                                            float* smem, Done done) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;     // mma group and thread in it
  const int wm = warp >> 2, wn = warp & 3;   // warp's 32 x 16 pixel block
  const size_t ld = 2 * (size_t)K;
  const int nk = K / ZBK;
  const int total = jobs * nk;

  // tensor-core accumulators (one stage's chain) and their float32 sums
  // over the job's stages, in the m16n8 layout: [row tile][column
  // tile][c0..c3]
  float accr[2][2][4], acci[2][2][4], sumr[2][2][4], sumi[2][2][4];
  float smlr[2][2][4], smli[2][2][4];   // SPLIT: the small products
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accr[a][b][e] = acci[a][b][e] = sumr[a][b][e] = sumi[a][b][e] = 0.f;
        smlr[a][b][e] = smli[a][b][e] = 0.f;
      }

  // stage s: job s / nk, K columns [k0, k0 + 32) of its Tr, Ti (rows
  // r0..r0+63) and of its bc, bs (rows c0..c0+63)
  auto load = [&](int s) {
    const int job = s / nk;
    const int k0 = (s - job * nk) * ZBK;
    float* st = smem + (s % ZSTAGES) * ZSTAGE;
    const float *a, *bc, *bs;
    operands(job, a, bc, bs);
    const float* tg = a + (size_t)r0 * ld + k0;
    const float* cg = bc + (size_t)c0 * ldb + k0;
    const float* sg = bs + (size_t)c0 * ldb + k0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + j * ZNT;
      const int row = e >> 3, q = (e & 7) * 4;
      float* d = st + row * ZLD + q;
      cp_async16(d, tg + row * ld + q);
      cp_async16(d + ZOP, tg + row * ld + K + q);
      cp_async16(d + 2 * ZOP, cg + (size_t)row * ldb + q);
      cp_async16(d + 3 * ZOP, sg + (size_t)row * ldb + q);
    }
  };

  __syncthreads();  // every warp is done with an earlier call's ring
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
          float* ar = accr[mt][pt];
          float* ai = acci[mt][pt];
          float* sr = smlr[mt][pt];
          float* si = smli[mt][pt];
          mma3<SPLIT>(ar, sr, rh, rl, ch[pt], cl[pt]);   // + Tr A1c
          mma3<SPLIT>(ar, sr, ih, il, nsh, nsl);         // - Ti A1s
          mma3<SPLIT>(ai, si, rh, rl, sh[pt], sl[pt]);   // + Tr A1s
          mma3<SPLIT>(ai, si, ih, il, ch[pt], cl[pt]);   // + Ti A1c
        }
      }
    }

    // the stage's chain ends: its sums go into the float32 sums, rounded
    // to nearest (SPLIT: the two chains' sums added first), and the
    // tensor cores restart from zero
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (SPLIT) {
            accr[a][b][e] = __fadd_rn(accr[a][b][e], smlr[a][b][e]);
            acci[a][b][e] = __fadd_rn(acci[a][b][e], smli[a][b][e]);
            smlr[a][b][e] = smli[a][b][e] = 0.f;
          }
          sumr[a][b][e] = __fadd_rn(sumr[a][b][e], accr[a][b][e]);
          sumi[a][b][e] = __fadd_rn(sumi[a][b][e], acci[a][b][e]);
          accr[a][b][e] = acci[a][b][e] = 0.f;
        }

    if (s % nk == nk - 1) {  // job s / nk complete
      done(s / nk, sumr, sumi);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) sumr[a][b][e] = sumi[a][b][e] = 0.f;
    }
  }
}

// Stage 2 and the tournament of the 64 x 64 tile at (r0, c0): tc_products
// over the P candidates of T (P, n, 2K) row-major against one column
// basis Bc, Bs (job i is candidate i); the winners' Re, Im and candidate
// index in the fragment layout of tc_pixel().
template <bool TAKE_FIRST, bool SPLIT>
__device__ __forceinline__ void sweep_tc_tile(
    const float* __restrict__ T, const float* __restrict__ Bc,
    const float* __restrict__ Bs, int P, int n, int K, int ldb, int r0,
    int c0, float* smem, float br[2][2][4], float bi[2][2][4],
    int bx[2][2][4]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        br[a][b][e] = bi[a][b][e] = 0.f;
        bx[a][b][e] = 0;
      }
  const size_t cand = (size_t)n * 2 * K;
  tc_products<SPLIT>(
      [&](int i, const float*& a, const float*& bc, const float*& bs) {
        a = T + i * cand;
        bc = Bc;
        bs = Bs;
      },
      P, K, ldb, r0, c0, smem,
      [&](int i, const float (&mr)[2][2][4], const float (&mi)[2][2][4]) {
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if ((TAKE_FIRST && i == 0) ||
                  absq(mr[a][b][e], mi[a][b][e]) >
                      absq(br[a][b][e], bi[a][b][e])) {
                br[a][b][e] = mr[a][b][e];
                bi[a][b][e] = mi[a][b][e];
                bx[a][b][e] = i;
              }
            }
      });
}

}  // namespace
