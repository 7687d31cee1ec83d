// Stage 2 of a WFR sweep tile on the tensor cores (3xTF32), with the
// per-pixel |M|^2 tournament: the part shared by the single-peak zoom
// sweep (zoom_sweep.cu) and the grouped banded sweep (sweep.cu). Each
// tournament kernel calls wg_sweep_tile() for its 64 x 64 pixel tile and
// then writes its own epilogue from the winners it returns. The
// gradient emissions' winner products (sweep.cu) run an older product
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
// tensor cores the same products bound at 67 TFLOP/s).
//
// The numerics (unchanged since the products moved to the tensor cores):
// - 3xTF32. Each operand is split as hi = cvt.rna.tf32(x), lo =
//   cvt.rna.tf32(x - hi) (x - hi is exact). Every float32 product a*b is
//   taken as three TF32 products into one float32 accumulator, in this
//   order: lo(a) hi(b), then hi(a) lo(b), then hi(a) hi(b); lo(a) lo(b)
//   (2^-22 of the product) is dropped. One TF32 pass would keep 10
//   mantissa bits: a phase error near 1e-3 rad, where the sweep's phase
//   needs 1e-5 (tests/test_torch_zoom_sweep.py emulates both).
// - Accumulation. The tensor cores add a product's 8 terms into their
//   float32 accumulator and truncate, where a float32 add rounds to
//   nearest; over a long chain the truncation shrinks |M| (one chain of
//   384 products at K = 512 misses the weight's 1e-5 rtol). So each
//   stage (32 columns of K) is its own tensor-core chain, started from
//   zero (scale-d = 0), and the stage sums are added into float32
//   registers with one round-to-nearest add each. With SPLIT (the
//   grouped sweep) the two small products of each stage run in a chain
//   of their own, so the hi.hi chain truncates a third as often: the
//   grouped kernel's |M| then lies nearer its float64 value than a
//   float32 product's (chip_smoke.py phase 3).
// - Complex as real products. One A fragment (a Tr or a Ti row slice)
//   feeds both M_r and M_i; -A1s is A1s's split with the sign bit
//   flipped, which is exact.
//
// The tournaments' design (wg_sweep_tile), for Hopper's tensor-core
// path. The former design ran mma.sync m16n8k8 (Ampere's warp-level
// instruction) with cp.async loads issued by all threads and reached
// ~30% of the 3xTF32 bound; two blocks per SM gained only ~5%, so the
// mma.sync issue rate held it there. Now (~50% of the bound; PERF.md):
// - wgmma. Two warpgroups, each a 64 x 32 pixel half of the tile, issue
//   wgmma.mma_async m64n64k8 TF32 into one 32-register accumulator a
//   thread, [M_r | M_i] side by side: Tr against the basis rows [c | s],
//   Ti against [-s | c], six per 8-deep slice of K. Each column of the
//   accumulator takes its products in the former chain's order and a
//   TF32 wgmma takes K = 8 as mma.sync m16n8k8 did, so the tile keeps
//   the former arithmetic bit for bit (tests/test_torch_cuda.py's
//   KEPT_BITS hold the outputs to the mma.sync kernels' digests). Two
//   m64n32k8 per product plane, twelve a slice (the first build), were
//   ~7% slower on the card.
// - Operand majors. wgmma wants its shared-memory TF32 operands K-major.
//   A is the T row band (64 rows x K, K contiguous in T) and B the column
//   basis (rows of K contiguous): both already are; nothing is
//   transposed.
// - The split. The tensor cores cannot split an operand they read from
//   shared memory, so the column basis is split once a call by its own
//   kernel (split_basis_kernel, sweep.cu) into -s_hi, c_hi, s_hi, -s_lo,
//   c_lo, s_lo planes: (G, 6, m, K), a few MB; -s is the split of s with
//   the sign bit flipped, as the former kernel took it. A comes from
//   registers: each thread loads its A fragment words from the staged T
//   box and splits them as the former kernel did, so T is not doubled
//   and stage 1 and the eager stack's memory plan
//   (parallel/sharded.py EAGER_BYTES_PER_PIXEL) stay as they were. Two
//   slices' fragments are in flight: wgmma.wait_group 1 frees a slice's
//   registers two slices later.
// - TMA. A ring of 3 slots of 64 KB: per 32 columns of K, the Tr and Ti
//   boxes (64 rows x 128 bytes) and, for each warpgroup, one box of its
//   32 columns of the six basis planes, so that its rows [-s | c | s]
//   lie in one run and the two 64-row windows are plain descriptors;
//   all under the 128-byte swizzle, which a 32-float stage fits
//   exactly; the wgmma descriptors use the same swizzle, and the A
//   fragment reads are bank-conflict free under it. mbarriers: full
//   (the loading thread's expect_tx) and empty (one arrival per warp
//   once its wgmma of the stage are done). The ring runs across
//   candidate boundaries, so the P candidates share one fill and one
//   drain. The maps are encoded on the host per launch
//   (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the
//   library still links no libcuda) and passed as __grid_constant__
//   CUtensorMap; the grouped kernel's image and group are box
//   coordinates (T row, basis plane).
// - No producer warp. The first build had one (8 consumer warps and a
//   producer warp, 288 threads): ptxas capped every thread at 168
//   registers, the share of 384 threads, and the grouped kernel (SPLIT:
//   more accumulators) spilled ~360 bytes. Under __maxnreg__(224) ptxas
//   gave it 204-206 registers and no spills, but its launch failed
//   (cudaErrorLaunchOutOfResources): the card, too, sets a block's
//   registers aside by whole warpgroups. setmaxnreg did not help either:
//   with a producer warpgroup (384 threads), its .dec to 40 or 24 and
//   the consumers' .inc to 232 or 240, ptxas kept 168 for the
//   consumers' code and every kernel spilled 360-940 bytes (nvcc 12.9).
//   So the block is the two warpgroups alone (256 threads, up to 255
//   registers a thread for 32 accumulators, 32 float32 stage sums, 48 of
//   tournament state, two slices' A fragments and, with SPLIT, 32 more
//   accumulators), and thread 0 issues each stage's loads two stages
//   ahead, once its warpgroup's products of the stage before are issued.
//   chip_smoke.py phase 2 fails if any of these kernels spills.
// - What holds it near half the bound (scripts/stage2_clock.py: clock64
//   around each wait, the zoom kernel at P = 42, W1 = 256): a consumer
//   thread spends about a third of its cycles loading and splitting its
//   A fragments; thread 0 a quarter issuing the next stage's loads (its
//   wait for the slot included), and the second warpgroup a fifth
//   waiting for a stage's loads. Loading three stages ahead (4 slots of
//   the first build's 48 KB stages), the next stage's first fragments
//   loaded early, or the last warp done with a slot refilling it did
//   not move the time beyond the spread between runs; a producer warp
//   made the first build's zoom kernel faster, but the grouped kernel's
//   registers do not fit beside one (above).
// - Any K that is a multiple of 32 (the callers keep multiples of 64);
//   n, m multiples of 64. The (P, n, m) candidate planes never exist.
//
// The winner products (tc_products, winner_products_kernel) keep the
// mma.sync loop: their job lists are short (1.03-1.11 winners a tile,
// two jobs each), so a ring's fill and drain would be most of a tile's
// time, and on wgmma they would need two more split bases (the
// f1-scaled basis A1y) a call. The loop: 256 threads, 8 warps of 32 x 16
// pixels (2 x 2 m16n8 tiles for M_r and M_i each), a ring of 3 stages
// of Tr, Ti, A1c and A1s rows filled with 16-byte cp.async, rows padded
// to 36 floats so every fragment load is bank-conflict free, each
// operand split as its fragment loads from shared memory.
#pragma once

#include <cuda.h>
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

// ---- The tournaments' stage 2 on Hopper's tensor-core path: warpgroup
// wgmma fed by TMA (the design is in the note at the top of this file).

constexpr int WNT = 256;                 // two warpgroups
constexpr int WSTAGES = 3;               // ring slots
constexpr int WAHEAD = 2;                // stages loaded ahead
constexpr int WBOX = ZT * ZBK * 4;       // a 64-row x 32-column T box, bytes
constexpr int WROWS = 32 * ZBK * 4;      // 32 basis rows of a stage, bytes
constexpr int WPLANES = 6;               // split basis planes a group
// a stage: the Tr and Ti boxes, then each warpgroup's basis box: its 32
// columns of -s_hi, c_hi, s_hi, -s_lo, c_lo, s_lo
constexpr int WBASIS = WPLANES * WROWS;
constexpr int WSTAGE_BYTES = 2 * WBOX + 2 * WBASIS;
// the ring (1024-byte aligned, the 128-byte swizzle's period) and its
// full and empty barriers
constexpr size_t WSMEM = 1024 + (size_t)WSTAGES * WSTAGE_BYTES +
                         2 * WSTAGES * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of `parity` to complete. A barrier that never
// completes (a fault) traps after some seconds instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators
// across a fence or wait (their values change asynchronously in between)
__device__ __forceinline__ void wg_hold(float (&d)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// The descriptor of a B operand in shared memory: rows of 128 bytes (32
// float32 of K, K-major) under the 128-byte swizzle, 8-row groups 1024
// bytes apart (the leading-dimension offset is unused for this layout).
// Adding 32 bytes to the address steps to the next 8 columns of K.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d = (ACC ? d : 0) + a . b^T: one m64n64k8 TF32 product, a (64 x 8,
// this thread's fragment in registers), b (64 rows x 8 of K at desc); d
// this thread's 32 of the 64 x 64 float32 tile
template <int ACC>
__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(ACC));
}

// One 8-deep slice of K into d = [M_r | M_i] (64 x 64: the warpgroup's
// 32 pixel columns of each): Tr against [A1c | A1s] (rh, rl; descriptors
// ch, cl: the hi and lo planes' rows [c | s]) and Ti against [-A1s |
// A1c] (ih, il; nh, nl: rows [-s | c]), each column's products in the
// order of the former mma.sync chain (lo.hi, hi.lo, hi.hi of the Tr
// product, then of the Ti one), so each sum takes the same products in
// the same order. With SPLIT, x takes the two small products and d
// hi.hi alone. FIRST (a stage's first slice): each chain's first
// product starts it from zero.
template <bool SPLIT, bool FIRST>
__device__ __forceinline__ void wg_slice(
    float (&d)[32], float (&x)[32], const uint32_t (&rh)[4],
    const uint32_t (&rl)[4], const uint32_t (&ih)[4],
    const uint32_t (&il)[4], uint64_t ch, uint64_t cl, uint64_t nh,
    uint64_t nl) {
  constexpr int A = FIRST ? 0 : 1;
  if (SPLIT) {
    wgmma64<A>(x, rl, ch);
    wgmma64<1>(x, rh, cl);
    wgmma64<A>(d, rh, ch);
    wgmma64<1>(x, il, nh);
    wgmma64<1>(x, ih, nl);
  } else {
    wgmma64<A>(d, rl, ch);
    wgmma64<1>(d, rh, cl);
    wgmma64<1>(d, rh, ch);
    wgmma64<1>(d, il, nh);
    wgmma64<1>(d, ih, nl);
  }
  wgmma64<1>(d, ih, nh);
}

// The position of a consumer thread's result e of its 16 ([4 j + 2 h +
// q], the wgmma accumulator layout): (row, column) = (*row + 8 h, *col +
// 8 j + q) in the 64 x 64 tile at (r0, c0)
__device__ __forceinline__ void wg_pixel(int r0, int c0, int* row,
                                         int* col) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  *row = r0 + (warp & 3) * 16 + (lane >> 2);
  *col = c0 + (warp >> 2) * 32 + 2 * (lane & 3);
}

// Stage 2 and the tournament of a 64 x 64 tile on the tensor cores: for
// candidates i = 0 .. P-1, T rows [row0 + i n, + 64) of the map tmT
// (rows of 2K float32: [Tr | Ti]) against the split column basis at rows
// [c0, c0 + 64) of planes [plane, plane + 6) of tmB (-s_hi, c_hi, s_hi,
// -s_lo, c_lo, s_lo, each (rows, K)); smem WSMEM bytes of dynamic shared
// memory. The winners' Re, Im and candidate index in wg_pixel()'s
// layout.
template <bool TAKE_FIRST, bool SPLIT>
__device__ __forceinline__ void wg_sweep_tile(
    const CUtensorMap* tmT, const CUtensorMap* tmB, int row0, int n, int P,
    int K, int c0, int plane, unsigned char* smem, float (&br)[16],
    float (&bi)[16], int (&bx)[16]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* ring = smem + (base - raw);
  const uint32_t full = base + WSTAGES * WSTAGE_BYTES;
  const uint32_t empty = full + WSTAGES * sizeof(uint64_t);
  const int nk = K / ZBK, total = P * nk;
  // stage s's loads into its slot, once the warps are done with the
  // slot's previous stage (thread 0 only)
  auto load = [&](int s) {
    const int slot = s % WSTAGES;
    if (s >= WSTAGES) mbar_wait(empty + 8 * slot, (s / WSTAGES - 1) & 1);
    const int i = s / nk, k0 = (s - i * nk) * ZBK;
    const uint32_t st = base + slot * WSTAGE_BYTES;
    const uint32_t bar = full + 8 * slot;
    mbar_expect_tx(bar, WSTAGE_BYTES);
    tma_2d(st, tmT, k0, row0 + i * n, bar);
    tma_2d(st + WBOX, tmT, K + k0, row0 + i * n, bar);
    tma_3d(st + 2 * WBOX, tmB, k0, c0, plane, bar);
    tma_3d(st + 2 * WBOX + WBASIS, tmB, k0, c0 + 32, plane, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WNT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < WAHEAD && s < total; ++s) load(s);
  }
  __syncthreads();

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  // this thread's A fragment words in a T box: row 16 (warp & 3) + g
  // (+ 8), column t (+ 4) of each 8-column slice, 16-byte chunks swizzled
  // by the row's low three bits (g)
  const uint32_t arow = ((warp & 3) * 16 + g) * 128 + t * 4;
  // d: [M_r | M_i] of the stage's chains (x: SPLIT's small products)
  float d[32], x[32], sr[16], si[16];
#pragma unroll
  for (int e = 0; e < 32; ++e) d[e] = x[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    sr[e] = si[e] = br[e] = bi[e] = 0.f;
    bx[e] = 0;
  }
  for (int s = 0; s < total; ++s) {
    const int slot = s % WSTAGES;
    mbar_wait(full + 8 * slot, (s / WSTAGES) & 1);
    const unsigned char* tr = ring + slot * WSTAGE_BYTES;
    // this warpgroup's basis rows: [-s | c | s] of hi, then of lo
    const uint32_t bb = base + slot * WSTAGE_BYTES + 2 * WBOX + wg * WBASIS;
    wg_hold(d);
    if (SPLIT) wg_hold(x);
#pragma unroll
    for (int kk = 0; kk < ZBK / 8; ++kk) {
      // the slice two back is done before its registers are reused
      if (kk >= 2) wg_wait<1>();
      uint32_t rh[4], rl[4], ih[4], il[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t off =
            arow + (q & 1) * 1024 + (((2 * kk + (q >> 1)) ^ g) << 4);
        split(*reinterpret_cast<const float*>(tr + off), rh[q], rl[q]);
        split(*reinterpret_cast<const float*>(tr + WBOX + off), ih[q],
              il[q]);
      }
      wg_fence();
      const uint32_t b = bb + kk * 32;
      const uint64_t nh = wg_desc(b), ch = wg_desc(b + WROWS);
      const uint64_t nl = wg_desc(b + 3 * WROWS), cl = wg_desc(b + 4 * WROWS);
      if (kk == 0)
        wg_slice<SPLIT, true>(d, x, rh, rl, ih, il, ch, cl, nh, nl);
      else
        wg_slice<SPLIT, false>(d, x, rh, rl, ih, il, ch, cl, nh, nl);
      wg_commit();
    }
    // WAHEAD stages ahead, into the slot of the stage before this one,
    // while this warpgroup's products of this stage run
    if (tid == 0 && s + WAHEAD < total) load(s + WAHEAD);
    __syncwarp();
    wg_wait<0>();
    wg_hold(d);
    if (SPLIT) wg_hold(x);
    // the stage is read: its slot may be refilled
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
    // the stage's chains end: their sums go into the float32 sums,
    // rounded to nearest (SPLIT: the two chains' sums added first)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      sr[e] = __fadd_rn(sr[e], SPLIT ? __fadd_rn(d[e], x[e]) : d[e]);
      si[e] = __fadd_rn(si[e],
                        SPLIT ? __fadd_rn(d[16 + e], x[16 + e]) : d[16 + e]);
    }
    if (s % nk == nk - 1) {  // candidate s / nk complete
      const int i = s / nk;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if ((TAKE_FIRST && i == 0) ||
            absq(sr[e], si[e]) > absq(br[e], bi[e])) {
          br[e] = sr[e];
          bi[e] = si[e];
          bx[e] = i;
        }
        sr[e] = si[e] = 0.f;
      }
    }
  }
}

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point query (the library links no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A TMA map of the contiguous float32 array `base` with `rank` axes
// dims[0] (contiguous) .. dims[rank - 1], read in boxes of box[] under
// the 128-byte swizzle (box[0] * 4 = 128 bytes)
inline cudaError_t tile_map(CUtensorMap* map, const float* base, int rank,
                            const uint64_t* dims, const uint32_t* box) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  cuuint64_t gd[3], gs[2];
  cuuint32_t bd[3], es[3] = {1, 1, 1};
  uint64_t stride = sizeof(float);
  for (int d = 0; d < rank; ++d) {
    if (dims[d] >= (1ull << 31)) return cudaErrorInvalidValue;
    gd[d] = dims[d];
    bd[d] = box[d];
    if (d > 0) gs[d - 1] = stride;
    stride *= dims[d];
  }
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
             const_cast<float*>(base), gd, gs, bd, es,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// the maps of stage 2: T's [Tr | Ti] rows (rows of 2K) in 64 x 32 boxes,
// and the split basis (planes, m, K) in 6-plane boxes of 32 x 32
inline cudaError_t t_map(CUtensorMap* map, const float* T, uint64_t rows,
                         int K) {
  const uint64_t dims[2] = {2 * (uint64_t)K, rows};
  const uint32_t box[2] = {ZBK, ZT};
  return tile_map(map, T, 2, dims, box);
}

inline cudaError_t basis_map(CUtensorMap* map, const float* Bsplit,
                             int planes, int m, int K) {
  const uint64_t dims[3] = {(uint64_t)K, (uint64_t)m, (uint64_t)planes};
  const uint32_t box[3] = {ZBK, 32, WPLANES};
  return tile_map(map, Bsplit, 3, dims, box);
}

}  // namespace
