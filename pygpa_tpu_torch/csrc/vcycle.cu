// V-branch stencil passes of the multigrid phase unwrap.
//
// Replaces the TPU kernels pygpa_tpu/ops/pallas_vcycle.py
// _presmooth_kernel (entry presmooth) and _applyq_kernel (entry applyq).
// Wrappers and plain twins: pygpa_tpu_torch/ops/vcycle.py.
//
// The TPU kernels walked full-width row strips with 8-row halo blocks.
// Here presmooth works on 16 x 32 output tiles whose 2-pixel halo is
// staged in shared memory: r = rk - Q(Dinv rk) needs neighbours of
// neighbours, and staging turns the five stencil passes into reads of
// shared memory. applyq needs only the five-point neighbourhood and is
// one thread per pixel reading through L1. Neighbours wrap cyclically,
// as in the aligned forms (zero tails + the global last-row mask).
// Bound on an H100: device memory (each input plane read about once,
// each output written once). All arithmetic uses the _rn intrinsics so
// no FMA contraction changes the twin's rounding.
#include <cuda_runtime.h>

namespace {

constexpr int TR = 16, TC = 32;           // output tile
constexpr int ER = TR + 4, EC = TC + 4;   // staged region [-2, T+2)
constexpr int LD = EC + 1;                // padded shared row
constexpr int NT = 256;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// grid (m/TC, n/TR, B), 256 threads
__global__ void __launch_bounds__(NT) presmooth_kernel(
    const float* __restrict__ phi, const float* __restrict__ dxc,
    const float* __restrict__ dyc, const float* __restrict__ w,
    float* __restrict__ r_out, float* __restrict__ d_out,
    float* __restrict__ dinv_out, float* __restrict__ rrow,
    int n, int m, int cr, float omega) {
  __shared__ float s_phi[ER][LD], s_dx[ER][LD], s_dy[ER][LD], s_ww[ER][LD];
  __shared__ float s_wwx[ER][LD], s_wwy[ER][LD], s_tx[ER][LD], s_ty[ER][LD];
  __shared__ float s_rk[ER][LD], s_di[ER][LD], s_d[ER][LD];
  __shared__ float s_r[TR][TC];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TR, j0 = blockIdx.x * TC;
  const size_t nm = (size_t)n * m;
  const float* ph = phi + b * nm;
  const float* dx = dxc + b * nm;
  const float* dy = dyc + b * nm;
  const int tid = threadIdx.x;

  // local (li, lj) <-> global ((i0 - 2 + li) mod n, (j0 - 2 + lj) mod m)
  for (int e = tid; e < ER * EC; e += NT) {
    const int li = e / EC, lj = e % EC;
    const int gi = (i0 - 2 + li + n) % n, gj = (j0 - 2 + lj + m) % m;
    const size_t o = (size_t)gi * m + gj;
    s_phi[li][lj] = ph[o];
    s_dx[li][lj] = dx[o];
    s_dy[li][lj] = dy[o];
    const float wv = w[o];
    s_ww[li][lj] = mul(wv, wv);
  }
  __syncthreads();
  // weights, weighted residual gradients on [0, ER-1) x [0, EC-1)
  for (int e = tid; e < (ER - 1) * (EC - 1); e += NT) {
    const int li = e / (EC - 1), lj = e % (EC - 1);
    const int gi = (i0 - 2 + li + n) % n, gj = (j0 - 2 + lj + m) % m;
    const bool lane = gj < m - 1, row = gi != n - 1;
    const float wwx = lane ? fminf(s_ww[li][lj], s_ww[li][lj + 1]) : 0.f;
    const float wwy = row ? fminf(s_ww[li][lj], s_ww[li + 1][lj]) : 0.f;
    const float rdx = sub(s_dx[li][lj],
                          lane ? sub(s_phi[li][lj + 1], s_phi[li][lj]) : 0.f);
    const float rdy = sub(s_dy[li][lj],
                          row ? sub(s_phi[li + 1][lj], s_phi[li][lj]) : 0.f);
    s_wwx[li][lj] = wwx;
    s_wwy[li][lj] = wwy;
    s_tx[li][lj] = mul(wwx, rdx);
    s_ty[li][lj] = mul(wwy, rdy);
  }
  __syncthreads();
  // rk, Dinv, d on [1, ER-1) x [1, EC-1)
  for (int e = tid; e < (ER - 2) * (EC - 2); e += NT) {
    const int li = 1 + e / (EC - 2), lj = 1 + e % (EC - 2);
    const float rk = sub(add(sub(s_tx[li][lj], s_tx[li][lj - 1]), s_ty[li][lj]),
                         s_ty[li - 1][lj]);
    const float D = -add(add(add(s_wwx[li][lj], s_wwx[li][lj - 1]),
                             s_wwy[li][lj]), s_wwy[li - 1][lj]);
    const float di = fabsf(D) > 1e-8f ? __fdiv_rn(omega, D != 0.f ? D : 1.f)
                                      : 0.f;
    s_rk[li][lj] = rk;
    s_di[li][lj] = di;
    s_d[li][lj] = mul(rk, di);
  }
  __syncthreads();
  // Q-stencil fluxes of d on [1, ER-2) x [1, EC-2)
  for (int e = tid; e < (ER - 3) * (EC - 3); e += NT) {
    const int li = 1 + e / (EC - 3), lj = 1 + e % (EC - 3);
    const float dc = s_d[li][lj];
    s_tx[li][lj] = mul(s_wwx[li][lj], sub(s_d[li][lj + 1], dc));
    s_ty[li][lj] = mul(s_wwy[li][lj], sub(s_d[li + 1][lj], dc));
  }
  __syncthreads();
  // outputs on the tile [2, TR+2) x [2, TC+2)
  for (int e = tid; e < TR * TC; e += NT) {
    const int ti = e / TC, tj = e % TC;
    const int li = ti + 2, lj = tj + 2;
    const float q = sub(add(sub(s_tx[li][lj], s_tx[li][lj - 1]), s_ty[li][lj]),
                        s_ty[li - 1][lj]);
    const float rv = sub(s_rk[li][lj], q);
    const size_t o = b * nm + (size_t)(i0 + ti) * m + j0 + tj;
    r_out[o] = rv;
    d_out[o] = s_d[li][lj];
    if (b == 0) dinv_out[(size_t)(i0 + ti) * m + j0 + tj] = s_di[li][lj];
    s_r[ti][tj] = rv;
  }
  __syncthreads();
  // row half of the restriction: mean over cr consecutive rows
  const int rr = TR / cr;
  const size_t mr = (size_t)(n / cr) * m;
  for (int e = tid; e < rr * TC; e += NT) {
    const int k = e / TC, tj = e % TC;
    float s = s_r[k * cr][tj];
    for (int q = 1; q < cr; ++q) s = add(s, s_r[k * cr + q][tj]);
    rrow[b * mr + (size_t)(i0 / cr + k) * m + j0 + tj] = __fdiv_rn(s, (float)cr);
  }
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

int vcycle_presmooth(const float* phi, const float* dxc, const float* dyc,
                     const float* w, float* r, float* d, float* dinv,
                     float* rrow, int B, int n, int m, int cr, float omega,
                     cudaStream_t stream) {
  dim3 grid(m / TC, n / TR, B);
  presmooth_kernel<<<grid, NT, 0, stream>>>(phi, dxc, dyc, w, r, d, dinv,
                                            rrow, n, m, cr, omega);
  return (int)cudaGetLastError();
}

int vcycle_applyq(const float* p, const float* w, float* q, int B, int n,
                  int m, cudaStream_t stream) {
  const size_t total = (size_t)B * n * m;
  applyq_kernel<<<(unsigned)((total + NT - 1) / NT), NT, 0, stream>>>(
      p, w, q, B, n, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
