// V-branch stencil passes of the multigrid phase unwrap.
//
// Replaces the TPU kernels pygpa_tpu/ops/pallas_vcycle.py
// _presmooth_kernel (entry presmooth) and _applyq_kernel (entry applyq).
// Wrappers and plain twins: pygpa_tpu_torch/ops/vcycle.py.
//
// The TPU kernels walked full-width row strips with 8-row halo blocks.
// presmooth here walks column strips down the rows: a block of PT = 128
// threads owns PT consecutive columns (its PT - 4 output columns and a
// halo of 2 on the left and 2 on the right, wrapped cyclically), and
// marches over a strip of output rows chosen by the wrapper so the grid
// fills the card in one wave. Each step loads one input row of w and of
// phi, dxc, dyc for every batch plane (the next row is prefetched into
// registers) and finishes output row k - 2: r = rk - Q(Dinv rk) needs
// neighbours of neighbours, so row k's gradients give rk and d on row
// k - 1 and the Q fluxes of d on row k - 2. Values used only by their own
// column (row lags, the y fluxes) stay in registers; the x neighbours
// (phi, WW, the x fluxes, d, Q's x flux) go through small shared rows,
// two barriers a step. w, the weights, D and Dinv are built once a tile
// for the block's planes (up to 2 of one image). Each input element is read
// about (PT / (PT - 4)) (1 + 4 / rows) times, more where the last column
// tile overhangs the plane: 1.11 at the bench's (2, 4096^2)
// (ops/vcycle.presmooth_traffic counts it).
// Columns wrap (a modulo) once per thread and only in tiles touching the
// image edge; rows wrap with one compare a step.
// applyq marches the same way over a +-1 neighbourhood: each warp owns
// QCOLS = 128 consecutive columns (4 a lane, one 16-byte load where m % 4
// == 0 and the pointers are aligned, four scalar loads elsewhere) and a
// strip of rows chosen by the wrapper (ops/vcycle.applyq_tiling) so the
// grid fills the card in one wave. Step k loads row k of w and of every
// batch plane (the next row is prefetched into registers) and writes row
// k - 1; the row above, its WW and its y fluxes stay in registers, the x
// neighbours come from the neighbouring lanes by warp shuffles, and lanes
// 0 and 31 load one halo column each. No shared memory, no barrier. w and
// the weights are built once a pixel for the block's planes (up to 2).
// Each input element is read (QCOLS + 2) / QCOLS (1 + 2 / rows) times
// (ops/vcycle.applyq_traffic counts it). Three rows live in registers
// (the row above, the current one, the prefetched next), 96-113 registers
// for two planes, so the launch bounds allow 4 blocks an SM (16 warps)
// without spills; at 6 or 8 blocks the two-plane instances spill and run
// slower (0.14, 0.20 ms against 0.12 at the bench's shape).
// Image axis: the planes are I images of C planes each (the multigrid's
// two displacement components), image i with its own weight plane w[i]
// (a weight shared by every plane is one image of all of them). A block
// takes BP <= 2 planes of one image, a group, on grid axis z (presmooth)
// or y (applyq), so a stack of images runs in one launch (C odd: one more
// launch for every image's last plane); presmooth's first group of an
// image writes that image's Dinv. Plane offsets are size_t.
// Neighbours wrap cyclically, as in the aligned forms (zero tails +
// the global last-row mask). Bound on an H100: device memory. All
// arithmetic uses the _rn intrinsics so no FMA contraction changes the
// twin's rounding, and every output element is the same chain of
// operations whatever the tiling, so the bits do not depend on it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int PT = 128;                   // presmooth threads = staged columns
constexpr int PC = PT - 4;                // output columns a block
constexpr int PMIN_BLOCKS = 8;            // blocks an SM (launch bounds)
constexpr int MAXB = 2;                   // planes a block (of one image)

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// the first plane of grid group z (of gpi groups an image): image z /
// gpi's planes start at (z / gpi) cpi; the group's at BP (z % gpi) +
// poff past them
__device__ __forceinline__ size_t group_plane(int z, int gpi, int cpi,
                                              int bp, int poff) {
  const int img = z / gpi;
  return (size_t)img * cpi + (size_t)(z - img * gpi) * bp + poff;
}

// grid (ceil(m / PC), ceil(n / rows), images * gpi), PT threads; BP
// planes a block, from plane group_plane(blockIdx.z, ...) on, with image
// blockIdx.z / gpi's weight w and (its group 0, dinv_out given) Dinv.
// Thread s owns column j = j0 - 2 + s; step k loads row k and writes
// row k - 2, for k from r0 - 2 to r1 + 1.
template <int BP>
__global__ void __launch_bounds__(PT, PMIN_BLOCKS) presmooth_kernel(
    const float* __restrict__ phi, const float* __restrict__ dxc,
    const float* __restrict__ dyc, const float* __restrict__ w,
    float* __restrict__ r_out, float* __restrict__ d_out,
    float* __restrict__ dinv_out, float* __restrict__ rrow,
    int n, int m, int rows, int cr, float omega, int cpi, int gpi,
    int poff) {
  __shared__ float s_phi[BP][PT], s_ww[PT], s_d[BP][PT];
  __shared__ float s_tx[2][BP][PT], s_wwx[2][PT], s_qx[2][BP][PT];
  const int s = threadIdx.x;
  const int sl = s > 0 ? s - 1 : 0, sr = s < PT - 1 ? s + 1 : PT - 1;
  const int j0 = blockIdx.x * PC;
  const int j = j0 - 2 + s;
  int gj = j;
  if (j0 < 2 || j0 + PC + 2 > m) gj = (j % m + m) % m;   // edge tiles only
  const bool lane = gj < m - 1;
  const bool out_col = s >= 2 && s < PC + 2 && j < m;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(r0 + rows, n);
  const size_t nm = (size_t)n * m;
  const size_t mr = (size_t)(n / cr) * m;
  {
    const size_t p0 = group_plane(blockIdx.z, gpi, cpi, BP, poff);
    const size_t img = blockIdx.z / gpi;
    phi += p0 * nm;
    dxc += p0 * nm;
    dyc += p0 * nm;
    r_out += p0 * nm;
    d_out += p0 * nm;
    rrow += p0 * mr;
    w += img * nm;
    dinv_out = dinv_out && blockIdx.z % gpi == 0 ? dinv_out + img * nm
                                                 : nullptr;
  }

  float nphi[BP], ndx[BP], ndy[BP], nw;
  auto load = [&](int k) {
    const int gk = k < 0 ? k + n : (k >= n ? k - n : k);
    const size_t o = (size_t)gk * m + gj;
    nw = __ldg(w + o);
#pragma unroll
    for (int b = 0; b < BP; ++b) {
      nphi[b] = __ldg(phi + b * nm + o);
      ndx[b] = __ldg(dxc + b * nm + o);
      ndy[b] = __ldg(dyc + b * nm + o);
    }
  };
  // row lags: name1 is row k - 1, name2 row k - 2, name3 row k - 3
  float WW1 = 0.f, wx1 = 0.f, wy2 = 0.f, di2 = 0.f;
  float phi1[BP], dy1[BP], tx1[BP], ty2[BP], rk2[BP], d2[BP], qx2[BP];
  float qy3[BP], acc[BP];
#pragma unroll
  for (int b = 0; b < BP; ++b)
    phi1[b] = dy1[b] = tx1[b] = ty2[b] = rk2[b] = d2[b] = qx2[b] = qy3[b] =
        acc[b] = 0.f;
  int grp = 0, orow = r0 / cr;

  load(r0 - 2);
  for (int k = r0 - 2; k < r1 + 2; ++k) {
    float cphi[BP], cdx[BP], cdy[BP];
    const float cw = nw;
#pragma unroll
    for (int b = 0; b < BP; ++b) {
      cphi[b] = nphi[b];
      cdx[b] = ndx[b];
      cdy[b] = ndy[b];
    }
    if (k + 1 < r1 + 2) load(k + 1);
    const int par = k & 1;
    const int gk1 = k - 1 < 0 ? k - 1 + n : (k - 1 >= n ? k - 1 - n : k - 1);
    const bool row1 = gk1 != n - 1;

    // publish row k
    const float WW = mul(cw, cw);
    s_ww[s] = WW;
#pragma unroll
    for (int b = 0; b < BP; ++b) s_phi[b][s] = cphi[b];
    __syncthreads();

    // weights of row k (x) and k - 1 (y); D, Dinv, rk, d of row k - 1
    const float wx0 = lane ? fminf(WW, s_ww[sr]) : 0.f;
    const float wy1 = row1 ? fminf(WW1, WW) : 0.f;
    const float D = -add(add(add(wx1, s_wwx[par ^ 1][sl]), wy1), wy2);
    const float di1 =
        fabsf(D) > 1e-8f ? __fdiv_rn(omega, D != 0.f ? D : 1.f) : 0.f;
    s_wwx[par][s] = wx0;
    float tx0[BP], ty1[BP], rk1[BP], d1[BP];
#pragma unroll
    for (int b = 0; b < BP; ++b) {
      tx0[b] = mul(wx0, sub(cdx[b], lane ? sub(s_phi[b][sr], cphi[b]) : 0.f));
      ty1[b] = mul(wy1, sub(dy1[b], row1 ? sub(cphi[b], phi1[b]) : 0.f));
      rk1[b] = sub(add(sub(tx1[b], s_tx[par ^ 1][b][sl]), ty1[b]), ty2[b]);
      d1[b] = mul(rk1[b], di1);
      s_tx[par][b][s] = tx0[b];
      s_d[b][s] = d1[b];
    }
    __syncthreads();

    // Q fluxes of d; outputs of row k - 2
    const int i = k - 2;
    const bool out = out_col && i >= r0;
    const size_t o = (size_t)i * m + j;
#pragma unroll
    for (int b = 0; b < BP; ++b) {
      const float qx1 = mul(wx1, sub(s_d[b][sr], d1[b]));
      const float qy2 = mul(wy2, sub(d1[b], d2[b]));
      const float q = sub(add(sub(qx2[b], s_qx[par ^ 1][b][sl]), qy2), qy3[b]);
      s_qx[par][b][s] = qx1;
      const float rv = sub(rk2[b], q);
      if (out) {
        r_out[b * nm + o] = rv;
        d_out[b * nm + o] = d2[b];
        acc[b] = grp == 0 ? rv : add(acc[b], rv);
        if (grp == cr - 1)
          rrow[b * mr + (size_t)orow * m + j] = __fdiv_rn(acc[b], (float)cr);
      }
      qx2[b] = qx1;
      qy3[b] = qy2;
      rk2[b] = rk1[b];
      d2[b] = d1[b];
      ty2[b] = ty1[b];
      tx1[b] = tx0[b];
      phi1[b] = cphi[b];
      dy1[b] = cdy[b];
    }
    if (out && dinv_out != nullptr) dinv_out[o] = di2;
    if (i >= r0 && ++grp == cr) {
      grp = 0;
      ++orow;
    }
    WW1 = WW;
    wx1 = wx0;
    wy2 = wy1;
    di2 = di1;
  }
}

template <int BP>
void launch_presmooth(const float* phi, const float* dxc, const float* dyc,
                      const float* w, float* r, float* d, float* dinv,
                      float* rrow, int I, int C, int gpi, int poff, int n,
                      int m, int rows, int cr, float omega,
                      cudaStream_t stream) {
  dim3 grid((m + PC - 1) / PC, (n + rows - 1) / rows, I * gpi);
  presmooth_kernel<BP><<<grid, PT, 0, stream>>>(
      phi, dxc, dyc, w, r, d, dinv, rrow, n, m, rows, cr, omega, C, gpi,
      poff);
}

// torch.minimum's rule: a NaN operand wins
__device__ __forceinline__ float wmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

constexpr int QW = 4;                     // applyq columns a lane
constexpr int QCOLS = 32 * QW;            // applyq columns a warp
constexpr int QT = 128;                   // applyq threads a block
constexpr int QWARPS = QT / 32;
constexpr int QMIN_BLOCKS = 4;            // blocks an SM (launch bounds)

// QW columns of one row from column index cw[0] (VEC: one 16-byte load)
template <bool VEC>
__device__ __forceinline__ void load_cols(const float* __restrict__ row,
                                          const int (&cw)[QW],
                                          float (&v)[QW]) {
  if (VEC) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(row + cw[0]));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int t = 0; t < QW; ++t) v[t] = __ldg(row + cw[t]);
  }
}

// grid (ceil(tiles * strips / QWARPS), images * gpi) blocks of QT
// threads; BP planes a block, from plane group_plane(blockIdx.y, ...)
// on, with image blockIdx.y / gpi's weight w. Warp g owns column tile
// g % tiles and row strip g / tiles;
// lane l its columns c0 = tile * QCOLS + QW l .. c0 + QW - 1 (loaded
// wrapped, stored where < m). Step k loads row k and writes row k - 1,
// for k from r0 - 1 to r1.
template <int BP, bool VEC>
__global__ void __launch_bounds__(QT, QMIN_BLOCKS) applyq_strip_kernel(
    const float* __restrict__ p, const float* __restrict__ w,
    float* __restrict__ q, int n, int m, int rows, int tiles, int strips,
    int cpi, int gpi, int poff) {
  const int g = blockIdx.x * QWARPS + (threadIdx.x >> 5);
  if (g >= tiles * strips) return;          // whole warps only
  {
    const size_t nm = (size_t)n * m;
    const size_t p0 = group_plane(blockIdx.y, gpi, cpi, BP, poff);
    p += p0 * nm;
    q += p0 * nm;
    w += (size_t)(blockIdx.y / gpi) * nm;
  }
  const int lane = threadIdx.x & 31;
  const int j0 = (g % tiles) * QCOLS, c0 = j0 + lane * QW;
  const int r0 = (g / tiles) * rows, r1 = min(r0 + rows, n);
  const size_t nm = (size_t)n * m;
  int cw[QW];
#pragma unroll
  for (int t = 0; t < QW; ++t)
    cw[t] = c0 + t < m ? c0 + t : (c0 + t) % m;   // overhanging tile only
  // halo: lane 0 the column left of the tile, lane 31 the one right of it
  const bool halo = lane == 0 || lane == 31;
  const int jh = lane == 0 ? (j0 > 0 ? j0 - 1 : m - 1)
                           : (j0 + QCOLS < m ? j0 + QCOLS : (j0 + QCOLS) % m);
  const bool hlane = j0 > 0;                // lane 0's halo column < m - 1

  float nw[QW], np[BP][QW], nhw = 0.f, nhp[BP];
  auto load = [&](int k) {
    const int gk = k < 0 ? k + n : (k >= n ? k - n : k);
    const size_t o = (size_t)gk * m;
    load_cols<VEC>(w + o, cw, nw);
#pragma unroll
    for (int b = 0; b < BP; ++b) load_cols<VEC>(p + b * nm + o, cw, np[b]);
    if (halo) {
      nhw = __ldg(w + o + jh);
#pragma unroll
      for (int b = 0; b < BP; ++b) nhp[b] = __ldg(p + b * nm + o + jh);
    }
  };
  // row k - 1: WW1, p1, the halo column's hw1, hp1; ty2: y fluxes of row
  // k - 2
  float WW1[QW], p1[BP][QW], hw1 = 0.f, hp1[BP], ty2[BP][QW];
#pragma unroll
  for (int b = 0; b < BP; ++b) {
    nhp[b] = hp1[b] = 0.f;
#pragma unroll
    for (int t = 0; t < QW; ++t) ty2[b][t] = 0.f;
  }

  load(r0 - 1);
  for (int k = r0 - 1; k <= r1; ++k) {
    float WWc[QW], pc[BP][QW], hpc[BP];
#pragma unroll
    for (int t = 0; t < QW; ++t) WWc[t] = mul(nw[t], nw[t]);
    const float hwc = mul(nhw, nhw);
#pragma unroll
    for (int b = 0; b < BP; ++b) {
      hpc[b] = nhp[b];
#pragma unroll
      for (int t = 0; t < QW; ++t) pc[b][t] = np[b][t];
    }
    if (k < r1) load(k + 1);

    if (k >= r0) {
      // y fluxes of row k - 1 (zero weight on the last row)
      const bool rowy = (k - 1 < 0 ? k - 1 + n : k - 1) != n - 1;
      float ty1[BP][QW];
#pragma unroll
      for (int t = 0; t < QW; ++t) {
        const float wy = rowy ? wmin(WW1[t], WWc[t]) : 0.f;
#pragma unroll
        for (int b = 0; b < BP; ++b)
          ty1[b][t] = mul(wy, sub(pc[b][t], p1[b][t]));
      }
      if (k - 1 >= r0) {
        // x fluxes of row k - 1: the right neighbour of the last column
        // from lane + 1 (lane 31: its halo), the left flux of the first
        // from lane - 1 (lane 0: from its halo)
        float WWr = __shfl_down_sync(0xffffffffu, WW1[0], 1);
        if (lane == 31) WWr = hw1;
        float wx[QW];
#pragma unroll
        for (int t = 0; t < QW; ++t)
          wx[t] = c0 + t < m - 1 ? wmin(WW1[t], t < QW - 1 ? WW1[t + 1] : WWr)
                                 : 0.f;
        const float wxh = lane == 0 && hlane ? wmin(hw1, WW1[0]) : 0.f;
        const size_t o = (size_t)(k - 1) * m + c0;
#pragma unroll
        for (int b = 0; b < BP; ++b) {
          float pr = __shfl_down_sync(0xffffffffu, p1[b][0], 1);
          if (lane == 31) pr = hp1[b];
          float tx[QW];
#pragma unroll
          for (int t = 0; t < QW; ++t)
            tx[t] = mul(wx[t], sub(t < QW - 1 ? p1[b][t + 1] : pr, p1[b][t]));
          float txl = __shfl_up_sync(0xffffffffu, tx[QW - 1], 1);
          if (lane == 0) txl = mul(wxh, sub(p1[b][0], hp1[b]));
          float qv[QW];
#pragma unroll
          for (int t = 0; t < QW; ++t)
            qv[t] = sub(add(sub(tx[t], t > 0 ? tx[t - 1] : txl), ty1[b][t]),
                        ty2[b][t]);
          float* qo = q + b * nm + o;
          if (VEC) {
            if (c0 < m)
              *reinterpret_cast<float4*>(qo) =
                  make_float4(qv[0], qv[1], qv[2], qv[3]);
          } else {
#pragma unroll
            for (int t = 0; t < QW; ++t)
              if (c0 + t < m) qo[t] = qv[t];
          }
        }
      }
#pragma unroll
      for (int b = 0; b < BP; ++b)
#pragma unroll
        for (int t = 0; t < QW; ++t) ty2[b][t] = ty1[b][t];
    }
#pragma unroll
    for (int t = 0; t < QW; ++t) WW1[t] = WWc[t];
    hw1 = hwc;
#pragma unroll
    for (int b = 0; b < BP; ++b) {
      hp1[b] = hpc[b];
#pragma unroll
      for (int t = 0; t < QW; ++t) p1[b][t] = pc[b][t];
    }
  }
}

template <int BP>
void launch_applyq(const float* p, const float* w, float* q, int I, int C,
                   int gpi, int poff, int n, int m, int rows, bool vec,
                   cudaStream_t stream) {
  const int tiles = (m + QCOLS - 1) / QCOLS, strips = (n + rows - 1) / rows;
  const dim3 grid((tiles * strips + QWARPS - 1) / QWARPS, I * gpi);
  if (vec)
    applyq_strip_kernel<BP, true><<<grid, QT, 0, stream>>>(
        p, w, q, n, m, rows, tiles, strips, C, gpi, poff);
  else
    applyq_strip_kernel<BP, false><<<grid, QT, 0, stream>>>(
        p, w, q, n, m, rows, tiles, strips, C, gpi, poff);
}

}  // namespace

extern "C" {

// I images of C planes (phi, dxc, dyc, r, d (I, C, n, m); rrow (I, C,
// n / cr, m)), image i with weight w[i] and Dinv dinv[i] (I, n, m).
// rows: output rows a block (a multiple of 16, so of cr). One launch
// takes every image's pairs of planes (or its plane, C = 1) and writes
// Dinv; with C odd and > 1 a second takes every image's last plane
int vcycle_presmooth(const float* phi, const float* dxc, const float* dyc,
                     const float* w, float* r, float* d, float* dinv,
                     float* rrow, int I, int C, int n, int m, int rows,
                     int cr, float omega, cudaStream_t stream) {
  if (C == 1)
    launch_presmooth<1>(phi, dxc, dyc, w, r, d, dinv, rrow, I, 1, 1, 0, n,
                        m, rows, cr, omega, stream);
  else
    launch_presmooth<MAXB>(phi, dxc, dyc, w, r, d, dinv, rrow, I, C,
                           C / MAXB, 0, n, m, rows, cr, omega, stream);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || C == 1 || C % MAXB == 0) return (int)e;
  launch_presmooth<1>(phi, dxc, dyc, w, r, d, nullptr, rrow, I, C, 1, C - 1,
                      n, m, rows, cr, omega, stream);
  return (int)cudaGetLastError();
}

// I images of C planes (p, q (I, C, n, m)), image i with weight w[i]
// (I, n, m); launches as vcycle_presmooth's. rows: output rows a warp.
// 16-byte loads and stores where m % 4 == 0 and every pointer is 16-byte
// aligned
int vcycle_applyq(const float* p, const float* w, float* q, int I, int C,
                  int n, int m, int rows, cudaStream_t stream) {
  const bool vec = m % QW == 0 &&
                   (((uintptr_t)p | (uintptr_t)w | (uintptr_t)q) & 15) == 0;
  if (C == 1)
    launch_applyq<1>(p, w, q, I, 1, 1, 0, n, m, rows, vec, stream);
  else
    launch_applyq<MAXB>(p, w, q, I, C, C / MAXB, 0, n, m, rows, vec, stream);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || C == 1 || C % MAXB == 0) return (int)e;
  launch_applyq<1>(p, w, q, I, C, 1, C - 1, n, m, rows, vec, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
