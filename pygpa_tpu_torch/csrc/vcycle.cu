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
// for all batch planes (up to 2 a launch). Each input element is read
// about (PT / (PT - 4)) (1 + 4 / rows) times, more where the last column
// tile overhangs the plane: 1.11 at the bench's (2, 4096^2)
// (ops/vcycle.presmooth_traffic counts it).
// Columns wrap (a modulo) once per thread and only in tiles touching the
// image edge; rows wrap with one compare a step. applyq needs only the
// five-point neighbourhood and is one thread per pixel reading through
// L1. Neighbours wrap cyclically, as in the aligned forms (zero tails +
// the global last-row mask). Bound on an H100: device memory. All
// arithmetic uses the _rn intrinsics so no FMA contraction changes the
// twin's rounding, and every output element is the same chain of
// operations whatever the tiling, so the bits do not depend on it.
#include <cuda_runtime.h>

namespace {

constexpr int PT = 128;                   // presmooth threads = staged columns
constexpr int PC = PT - 4;                // output columns a block
constexpr int PMIN_BLOCKS = 8;            // blocks an SM (launch bounds)
constexpr int MAXB = 2;                   // batch planes a launch
constexpr int NT = 256;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// grid (ceil(m / PC), ceil(n / rows)), PT threads; BP batch planes.
// Thread s owns column j = j0 - 2 + s; step k loads row k and writes
// row k - 2, for k from r0 - 2 to r1 + 1.
template <int BP>
__global__ void __launch_bounds__(PT, PMIN_BLOCKS) presmooth_kernel(
    const float* __restrict__ phi, const float* __restrict__ dxc,
    const float* __restrict__ dyc, const float* __restrict__ w,
    float* __restrict__ r_out, float* __restrict__ d_out,
    float* __restrict__ dinv_out, float* __restrict__ rrow,
    int n, int m, int rows, int cr, float omega) {
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
                      float* rrow, int n, int m, int rows, int cr,
                      float omega, cudaStream_t stream) {
  dim3 grid((m + PC - 1) / PC, (n + rows - 1) / rows);
  presmooth_kernel<BP><<<grid, PT, 0, stream>>>(phi, dxc, dyc, w, r, d, dinv,
                                                rrow, n, m, rows, cr, omega);
}

__device__ __forceinline__ float wmin(float a, float b) { return fminf(a, b); }

// one thread per pixel of (B, n, m)
__global__ void __launch_bounds__(NT) applyq_kernel(
    const float* __restrict__ p, const float* __restrict__ w,
    float* __restrict__ q, int B, int n, int m) {
  const size_t nm = (size_t)n * m;
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  if (idx >= (size_t)B * nm) return;
  const size_t b = idx / nm, o = idx % nm;
  const int i = (int)(o / m), j = (int)(o % m);
  const int jr = (j + 1) % m, jl = (j + m - 1) % m;
  const int id = (i + 1) % n, iu = (i + n - 1) % n;
  const float* pb = p + b * nm;
  const float wc = w[o], wr = w[(size_t)i * m + jr], wl = w[(size_t)i * m + jl];
  const float wd = w[(size_t)id * m + j], wu = w[(size_t)iu * m + j];
  const float WWc = mul(wc, wc), WWr = mul(wr, wr), WWl = mul(wl, wl);
  const float WWd = mul(wd, wd), WWu = mul(wu, wu);
  const float wwx_c = j < m - 1 ? wmin(WWc, WWr) : 0.f;
  const float wwx_l = jl < m - 1 ? wmin(WWl, WWc) : 0.f;
  const float wwy_c = i != n - 1 ? wmin(WWc, WWd) : 0.f;
  const float wwy_u = iu != n - 1 ? wmin(WWu, WWc) : 0.f;
  const float pc = pb[o];
  const float tx_c = mul(wwx_c, sub(pb[(size_t)i * m + jr], pc));
  const float tx_l = mul(wwx_l, sub(pc, pb[(size_t)i * m + jl]));
  const float ty_c = mul(wwy_c, sub(pb[(size_t)id * m + j], pc));
  const float ty_u = mul(wwy_u, sub(pc, pb[(size_t)iu * m + j]));
  q[idx] = sub(add(sub(tx_c, tx_l), ty_c), ty_u);
}

}  // namespace

extern "C" {

// rows: output rows a block (a multiple of 16, so of cr); planes go in
// launches of up to MAXB, the first of which writes dinv
int vcycle_presmooth(const float* phi, const float* dxc, const float* dyc,
                     const float* w, float* r, float* d, float* dinv,
                     float* rrow, int B, int n, int m, int rows, int cr,
                     float omega, cudaStream_t stream) {
  const size_t nm = (size_t)n * m, mr = (size_t)(n / cr) * m;
  for (int b0 = 0; b0 < B; b0 += MAXB) {
    const int bp = B - b0 < MAXB ? B - b0 : MAXB;
    const size_t o = (size_t)b0 * nm, orr = (size_t)b0 * mr;
    float* di = b0 == 0 ? dinv : nullptr;
    if (bp == 1)
      launch_presmooth<1>(phi + o, dxc + o, dyc + o, w, r + o, d + o, di,
                          rrow + orr, n, m, rows, cr, omega, stream);
    else
      launch_presmooth<2>(phi + o, dxc + o, dyc + o, w, r + o, d + o, di,
                          rrow + orr, n, m, rows, cr, omega, stream);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

int vcycle_applyq(const float* p, const float* w, float* q, int B, int n,
                  int m, cudaStream_t stream) {
  const size_t total = (size_t)B * n * m;
  applyq_kernel<<<(unsigned)((total + NT - 1) / NT), NT, 0, stream>>>(
      p, w, q, B, n, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
