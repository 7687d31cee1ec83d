// The early-stopping DCT-preconditioned CG on the weighted Poisson system:
// the exact unwrap's solve and the multigrid's levels past ops/cg.py
// MAX_SIDE, every float32 side from 2 to 8192.
//
// Replaces pygpa_tpu/solvers/unwrap.py _cg_unwrap_body, the reference's
// lax.while_loop, which XLA fuses on the TPU (its Pallas CG kernel,
// pallas_cg._cg_kernel, ported in cg.cu, takes only levels that fit in
// VMEM). Wrapper, gate and plain twin: pygpa_tpu_torch/ops/cg.py
// cg_unwrap.
//
// Per plane b of the batch: phi = 0, r = rk0, thr = 1e-6 ||rk0||; a plane
// whose rk0 is all zero starts done (k 0). An iteration of a live plane:
// z = P^-1 r (the Neumann-Poisson DCT preconditioner), rz = <r, z>, beta
// = rz / rzprev (0 where rzprev == 0), p = z (first iteration) or z +
// beta p, Qp with the weighted stencil, pq = <p, Qp>, alpha = rz / pq (0
// where pq == 0), phi += alpha p, r -= alpha Qp, k += 1, rzprev = rz; the
// plane is done after the iteration in which k >= kmax, ||r|| < thr or
// rz == 0 (that iteration's update applied). The host enqueues max(kmax,
// 1) iterations with no sync; every block of a done plane returns before
// it loads anything, so the plane's phi, r, p, rzprev and k stay frozen
// while the other planes run on (the twin's torch.where, done by not
// writing).
//
// Routes (ops/cg.py unwrap_fft_route):
//   FFT route, each side a power of two from 128 to 8192 or an even side
//     from 130 to 4094 (pass_side): six launches an iteration. The four
//     one-axis DCT passes of dct_fft.cuh: lane forward; sub forward, its
//     store dividing by the eigenvalue; sub inverse; lane inverse, its
//     store forming the r.z partials. Then step_p (p at each point and
//     its four neighbours, Qp, the p.Qp partials) and step_x (phi, r, the
//     ||r||^2 partials and the plane's stop test). Each pass is dispatched
//     by its own side, not by the pair of sides: at a power of two
//     dct_kernel's Stockham pass (shared with dct.cu and cg.cu; 7 sides x
//     4 passes), at another even side czt_kernel's chirp-z pass
//     (cg_unwrap_czt.cu: Makhoul's frame around an L-point convolution,
//     L = 256 ... 4096, its two FFT_Ls four-step in registers; 5 lengths
//     x 4 passes). Every pass's grid has the
//     plane on y, so a lane pass's last block of a plane may be ragged
//     (e.g. 4086 rows under a 4096-point lane pass).
//   Other sides (odd, under 128, or past 4094 and not a power of two):
//     the DCT pair stays core.fourier's (the DCT
//     kernels on the axes they take, their twins elsewhere), driven from
//     the wrapper; eigen_rz divides the transform by the eigenvalues and
//     forms rz from the spectrum, <r, idct2n(y / lambda)> = sum_kl w_k w_l
//     y_kl^2 / lambda_kl / (4 n m) (w = 1/2 at index 0, else 1: scipy's
//     unnormalised pair has C^-1 = C^T W / 2n), then step_p and step_x:
//     three launches besides the DCTs.
// Stencil: ops/vcycle._q's aligned cyclic one on (n, m) weights with a
// zero last column (WWx) and row (WWy). The wrapper pads the exact path's
// unaligned weights (n, m-1), (n-1, m) so once a solve, which gives
// solvers/unwrap._apply_q's values; ALIGNED = false adds the four terms in
// _apply_q's order ((tx - txl) + (ty - tyu)), true in _q's. Products and
// sums round as the twin's torch ops do (__fmul_rn and friends: no FMA
// contraction), so only the DCTs' and the dots' summation orders differ.
// Reductions: each block stores its partial; the block of a plane that
// finishes last (an integer counter per plane, no float atomics) adds the
// plane's partials in a fixed order and stores the scalar, which the next
// launch reads as one value. No scalar leaves the device, and a solve
// repeats bit for bit. In-plane offsets are int (n m <= 2^26), plane
// offsets size_t.
// Bound on an H100: HBM bytes. At the eager call's (2, 4096, 4096) the
// state (~0.8 GB) does not fit the 50 MB L2, so an iteration moves about
// 20 passes of a plane pair (134 MB each): 9 through the four DCT passes,
// 5 in step_p, 6 in step_x; ~0.8 ms at 3.35 TB/s. A chirp-z pass moves the
// same bytes as a Stockham pass but does two L-point FFTs of a line's N =
// n / 2 points (L ~ 2N), held in registers between four shared-memory
// exchanges a line.
#include <cuda_runtime.h>
#include <math.h>

#include "cg_unwrap.cuh"
#include "dct_fft.cuh"

namespace {

using namespace cgu;

constexpr int NT = 256;         // threads of the elementwise kernels
constexpr int RED = 16;         // elements a thread
constexpr int TILE = NT * RED;  // elements a block

// lines a block of a pass over lines of n = 2N: at N <= 512 as cg.cu's
// passes (4096 complex values, 32 KB, within the default 48 KB); above,
// as dct.cu launches the same lengths (lane 8192 / N, sub 16384 / N, up
// to 221 KB of dynamic shared memory)
template <int N, bool SUB>
struct Lines {
  static constexpr int C = N <= 512 ? 4096 / N : (SUB ? 16384 : 8192) / N;
  static constexpr int T = C * N / 32;
  static constexpr size_t SMEM = dct_smem_bytes<N, C>();
  static_assert(SMEM <= 227 * 1024, "fits a block's shared memory");
};

// one pass over B planes: lane (`lines` rows of 2N a plane) or sub (2N
// rows, `lines` columns a plane); grid (blocks a plane, B)
template <int N, bool SUB, bool INV, class Epi>
int pass(const float* x, float* y, const float2* tab, int lines, int B,
         Epi epi, cudaStream_t stream) {
  using L = Lines<N, SUB>;
  if constexpr (L::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dct_kernel<N, L::C, SUB, INV, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((lines + L::C - 1) / L::C, B);
  dct_kernel<N, L::C, SUB, INV, Epi><<<grid, L::T, L::SMEM, stream>>>(
      x, y, tab, lines, epi);
  return (int)cudaGetLastError();
}

// the pass at a side: the Stockham pass at a power of two in 128 ... 8192,
// the chirp-z pass at an even side in 130 ... 4094 (cg_unwrap_czt.cu)
template <bool SUB, bool INV, class Epi>
int pass_at(int side, const float* x, float* y, const float* tab, int lines,
            int B, Epi epi, cudaStream_t stream) {
  const float2* t = reinterpret_cast<const float2*>(tab);
  switch (side) {
    case 128: return pass<64, SUB, INV>(x, y, t, lines, B, epi, stream);
    case 256: return pass<128, SUB, INV>(x, y, t, lines, B, epi, stream);
    case 512: return pass<256, SUB, INV>(x, y, t, lines, B, epi, stream);
    case 1024: return pass<512, SUB, INV>(x, y, t, lines, B, epi, stream);
    case 2048: return pass<1024, SUB, INV>(x, y, t, lines, B, epi, stream);
    case 4096: return pass<2048, SUB, INV>(x, y, t, lines, B, epi, stream);
    case 8192: return pass<4096, SUB, INV>(x, y, t, lines, B, epi, stream);
  }
  return czt_pass_at<SUB, INV>(side, x, y, tab, lines, B, epi, stream);
}

// sides whose lines have a pass of their own (ops/cg.py unwrap_pass_side)
bool pass_side(int s) {
  return (s >= 128 && s <= 8192 && (s & (s - 1)) == 0) || czt_side(s);
}

// ---- the elementwise kernels, grid (ceil(n m / TILE), B)

// r = rk0, phi = 0; the plane's ||rk0||, whether it is all zero, k 0,
// rzprev 1
__global__ void __launch_bounds__(NT) init_kernel(
    const float* __restrict__ rk0, float* __restrict__ r,
    float* __restrict__ phi, float* __restrict__ part,
    int* __restrict__ part_nz, State S, int nm) {
  __shared__ float sh[NT];
  const int b = blockIdx.y, nb = gridDim.x;
  const size_t off = (size_t)b * nm;
  const int base = blockIdx.x * TILE;
  float v = 0.f;
  int nz = 0;
#pragma unroll 4
  for (int t = 0; t < RED; ++t) {
    const int o = base + t * NT + threadIdx.x;
    if (o < nm) {
      const float x = rk0[off + o];
      r[off + o] = x;
      phi[off + o] = 0.f;
      v = fmaf(x, x, v);
      nz |= x != 0.f;
    }
  }
  const float s = block_sum(v, sh);
  const int any = __syncthreads_or(nz);
  if (threadIdx.x == 0) {
    part[(size_t)b * nb + blockIdx.x] = s;
    part_nz[(size_t)b * nb + blockIdx.x] = any;
  }
  if (last_block(S.count + b, nb, sh)) {
    const float rr = sum_partials(part + (size_t)b * nb, nb, sh);
    int a = 0;
    for (int t = threadIdx.x; t < nb; t += NT)
      a |= __ldcg(part_nz + (size_t)b * nb + t);
    a = __syncthreads_or(a);
    if (threadIdx.x == 0) {
      const float nr = sqrtf(rr);
      S.thr[b] = __fmul_rn(1e-6f, nr);
      S.rnorm[b] = nr;
      S.rzprev[b] = 1.f;
      S.k[b] = 0;
      S.done[b] = a == 0;
    }
  }
}

// the other sides' eigenvalue division, in place on the 2D DCT y, with rz
// from the spectrum (file comment); inv4nm = 1 / (4 n m)
__global__ void __launch_bounds__(NT) eigen_rz_kernel(
    float* __restrict__ y, float* __restrict__ part,
    const float* __restrict__ cn, const float* __restrict__ cm, State S,
    int n, int m, float inv4nm) {
  __shared__ float sh[NT];
  const int b = blockIdx.y, nb = gridDim.x;
  if (S.done[b]) return;
  const int nm = n * m;
  y += (size_t)b * nm;
  const int base = blockIdx.x * TILE;
  float v = 0.f;
#pragma unroll 4
  for (int t = 0; t < RED; ++t) {
    const int o = base + t * NT + threadIdx.x;
    if (o < nm) {
      const int i = o / m, j = o - i * m;
      const float x = y[o];
      const float zh =
          (i == 0 && j == 0) ? x : __fdiv_rn(x, eigen(cn, cm, i, j));
      y[o] = zh;
      const float w = (i == 0 ? 0.5f : 1.f) * (j == 0 ? 0.5f : 1.f);
      v = fmaf(w * x, zh, v);
    }
  }
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0) part[(size_t)b * nb + blockIdx.x] = s;
  if (last_block(S.count + b, nb, sh)) {
    const float rz = sum_partials(part + (size_t)b * nb, nb, sh);
    if (threadIdx.x == 0) S.rz[b] = __fmul_rn(rz, inv4nm);
  }
}

// beta from rz and rzprev; p = z (first) or z + beta p_old at each point
// and its four neighbours (the same rounding, so a neighbour's value is
// the one its own thread stores) into p_new; Qp with the cyclic stencil
// (plane b with weight pair b / cpw) into qp; p.Qp partials and, in the
// plane's last block, pq
template <bool ALIGNED>
__global__ void __launch_bounds__(NT) step_p_kernel(
    const float* __restrict__ z, const float* __restrict__ p_old,
    float* __restrict__ p_new, const float* __restrict__ WWx,
    const float* __restrict__ WWy, float* __restrict__ qp,
    float* __restrict__ part, State S, int first, int n, int m, int cpw) {
  __shared__ float sh[NT];
  const int b = blockIdx.y, nb = gridDim.x;
  if (S.done[b]) return;
  const int nm = n * m;
  const size_t off = (size_t)b * nm;
  WWx += (size_t)(b / cpw) * nm;
  WWy += (size_t)(b / cpw) * nm;
  z += off;
  p_old += off;
  const float rz = S.rz[b], rzprev = S.rzprev[b];
  const float beta = rzprev != 0.f ? __fdiv_rn(rz, rzprev) : 0.f;
  auto pat = [&](int q) {
    return first ? z[q] : __fadd_rn(z[q], __fmul_rn(beta, p_old[q]));
  };
  const int base = blockIdx.x * TILE;
  float v = 0.f;
#pragma unroll 4
  for (int t = 0; t < RED; ++t) {
    const int o = base + t * NT + threadIdx.x;
    if (o < nm) {
      const int i = o / m, j = o - i * m;
      const int jr = j + 1 == m ? 0 : j + 1, jl = j == 0 ? m - 1 : j - 1;
      const int id = i + 1 == n ? 0 : i + 1, iu = i == 0 ? n - 1 : i - 1;
      const float pc = pat(o);
      const float tx = __fmul_rn(WWx[o], __fsub_rn(pat(i * m + jr), pc));
      const float txl =
          __fmul_rn(WWx[i * m + jl], __fsub_rn(pc, pat(i * m + jl)));
      const float ty = __fmul_rn(WWy[o], __fsub_rn(pat(id * m + j), pc));
      const float tyu =
          __fmul_rn(WWy[iu * m + j], __fsub_rn(pc, pat(iu * m + j)));
      const float q =
          ALIGNED ? __fsub_rn(__fadd_rn(__fsub_rn(tx, txl), ty), tyu)
                  : __fadd_rn(__fsub_rn(tx, txl), __fsub_rn(ty, tyu));
      qp[off + o] = q;
      p_new[off + o] = pc;
      v = fmaf(pc, q, v);
    }
  }
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0) part[(size_t)b * nb + blockIdx.x] = s;
  if (last_block(S.count + b, nb, sh)) {
    const float pq = sum_partials(part + (size_t)b * nb, nb, sh);
    if (threadIdx.x == 0) S.pq[b] = pq;
  }
}

// alpha from rz and pq; phi += alpha p, r -= alpha Qp, ||r||^2 partials;
// the plane's last block settles the iteration: k, rzprev, ||r|| and the
// stop test (k >= kmax, ||r|| < thr or rz == 0)
__global__ void __launch_bounds__(NT) step_x_kernel(
    float* __restrict__ phi, float* __restrict__ r,
    const float* __restrict__ p, const float* __restrict__ qp,
    float* __restrict__ part, State S, int nm, int kmax) {
  __shared__ float sh[NT];
  const int b = blockIdx.y, nb = gridDim.x;
  if (S.done[b]) return;
  const size_t off = (size_t)b * nm;
  const float rz = S.rz[b], pq = S.pq[b];
  const float alpha = pq != 0.f ? __fdiv_rn(rz, pq) : 0.f;
  const int base = blockIdx.x * TILE;
  float v = 0.f;
#pragma unroll 4
  for (int t = 0; t < RED; ++t) {
    const int o = base + t * NT + threadIdx.x;
    if (o < nm) {
      const size_t g = off + o;
      phi[g] = __fadd_rn(phi[g], __fmul_rn(alpha, p[g]));
      const float rn = __fsub_rn(r[g], __fmul_rn(alpha, qp[g]));
      r[g] = rn;
      v = fmaf(rn, rn, v);
    }
  }
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0) part[(size_t)b * nb + blockIdx.x] = s;
  if (last_block(S.count + b, nb, sh)) {
    const float rr = sum_partials(part + (size_t)b * nb, nb, sh);
    if (threadIdx.x == 0) {
      const float rn = sqrtf(rr);
      const int k = S.k[b] + 1;
      S.k[b] = k;
      S.rzprev[b] = rz;
      S.rnorm[b] = rn;
      S.done[b] = k >= kmax || rn < S.thr[b] || rz == 0.f;
    }
  }
}

int step(const float* z, const float* p_old, float* p_new, float* qp,
         float* r, float* phi, const float* WWx, const float* WWy,
         float* part, State S, int B, int cpw, int n, int m, int first,
         int kmax, int aligned, cudaStream_t stream) {
  const int nm = n * m;
  const dim3 grid((nm + TILE - 1) / TILE, B);
  if (aligned)
    step_p_kernel<true><<<grid, NT, 0, stream>>>(
        z, p_old, p_new, WWx, WWy, qp, part, S, first, n, m, cpw);
  else
    step_p_kernel<false><<<grid, NT, 0, stream>>>(
        z, p_old, p_new, WWx, WWy, qp, part, S, first, n, m, cpw);
  step_x_kernel<<<grid, NT, 0, stream>>>(phi, r, p_new, qp, part, S, nm,
                                         kmax);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int cpw, int n, int m) {
  return B >= 1 && B <= 65535 && cpw >= 1 && B % cpw == 0 && n >= 2 &&
         m >= 2 && n <= 8192 && m <= 8192;
}

}  // namespace

extern "C" {

// floats of the partials buffer (B planes at n x m): a plane's blocks of
// the elementwise kernels or of a lane pass (at most n)
long long cg_unwrap_part_floats(int B, int n, int m) {
  const long long nb = ((long long)n * m + TILE - 1) / TILE;
  return (long long)B * (nb > n ? nb : n);
}

// The solve's start. rk0, r, phi: (B, n, m); part: cg_unwrap_part_floats;
// part_nz: B ceil(n m / 4096) ints; sc: (5, B) floats, si: (3, B) ints
// (the state; the counters are zeroed here)
int cg_unwrap_init(const float* rk0, float* r, float* phi, float* part,
                   int* part_nz, float* sc, int* si, int B, int n, int m,
                   cudaStream_t stream) {
  if (!shape_ok(B, 1, n, m)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(si + 2 * B, 0, B * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int nm = n * m;
  init_kernel<<<dim3((nm + TILE - 1) / TILE, B), NT, 0, stream>>>(
      rk0, r, phi, part, part_nz, state(sc, si, B), nm);
  return (int)cudaGetLastError();
}

// The FFT route's max(kmax, 1) iterations after cg_unwrap_init. WWx, WWy:
// (B / cpw, n, m) aligned (zero last column / row); z, x1, p0, p1, qp:
// (B, n, m) scratch; tabs: the ops/dct.py tables (lane forward at m, sub
// forward at n, sub inverse at n, lane inverse at m: kernel_tables at a
// power of two, bluestein_tables at a chirp-z side); cn, cm: the axes'
// cosines (ops/cg.py _cos_axis); n, m pass sides (pass_side)
int cg_unwrap_fft(const float* WWx, const float* WWy, float* r, float* phi,
                  float* z, float* x1, float* p0, float* p1, float* qp,
                  float* part, float* sc, int* si, const float* tab_lane_f,
                  const float* tab_sub_f, const float* tab_sub_i,
                  const float* tab_lane_i, const float* cn, const float* cm,
                  int B, int cpw, int n, int m, int kmax, int aligned,
                  cudaStream_t stream) {
  if (!shape_ok(B, cpw, n, m) || !pass_side(n) || !pass_side(m))
    return (int)cudaErrorInvalidValue;
  const State S = state(sc, si, B);
  float* pbuf[2] = {p0, p1};
  const int iters = kmax > 1 ? kmax : 1;
  int code;
  for (int it = 0; it < iters; ++it) {
    float* p_old = pbuf[it & 1];
    float* p_new = pbuf[(it + 1) & 1];
    if ((code = pass_at<false, false>(m, r, x1, tab_lane_f, n, B,
                                      StoreLive{S.done}, stream)))
      return code;
    if ((code = pass_at<true, false>(n, x1, z, tab_sub_f, m, B,
                                     EpiEigenLive{S.done, cn, cm}, stream)))
      return code;
    if ((code = pass_at<true, true>(n, z, x1, tab_sub_i, m, B,
                                    StoreLive{S.done}, stream)))
      return code;
    if ((code = pass_at<false, true>(m, x1, z, tab_lane_i, n, B,
                                     EpiDotLive{r, part, S, 0.f}, stream)))
      return code;
    if ((code = step(z, p_old, p_new, qp, r, phi, WWx, WWy, part, S, B, cpw,
                     n, m, it == 0, kmax, aligned, stream)))
      return code;
  }
  return 0;
}

// The other sides' eigenvalue division and rz, in place on y = dct2n(r)
// (B, n, m); cn, cm as cg_unwrap_fft's
int cg_unwrap_eigen(float* y, float* part, float* sc, int* si,
                    const float* cn, const float* cm, int B, int n, int m,
                    cudaStream_t stream) {
  if (!shape_ok(B, 1, n, m)) return (int)cudaErrorInvalidValue;
  const int nm = n * m;
  eigen_rz_kernel<<<dim3((nm + TILE - 1) / TILE, B), NT, 0, stream>>>(
      y, part, cn, cm, state(sc, si, B), n, m,
      (float)(1.0 / (4.0 * n * m)));
  return (int)cudaGetLastError();
}

// The rest of an iteration on the other sides, from z = idct2n(...):
// step_p and step_x (first: the solve's first iteration)
int cg_unwrap_step(const float* z, const float* p_old, float* p_new,
                   float* qp, float* r, float* phi, const float* WWx,
                   const float* WWy, float* part, float* sc, int* si, int B,
                   int cpw, int n, int m, int first, int kmax, int aligned,
                   cudaStream_t stream) {
  if (!shape_ok(B, cpw, n, m)) return (int)cudaErrorInvalidValue;
  return step(z, p_old, p_new, qp, r, phi, WWx, WWy, part, state(sc, si, B),
              B, cpw, n, m, first, kmax, aligned, stream);
}

}  // extern "C"
