// Fixed-iteration DCT-preconditioned CG on the weighted Poisson system of
// the multigrid unwrap's coarse levels.
//
// Replaces the TPU kernel pygpa_tpu/ops/pallas_cg.py _cg_kernel (entries
// cg_poisson_fft and cg_poisson). Wrapper, route predicate and plain
// twin: pygpa_tpu_torch/ops/cg.py.
//
// The TPU kernel held the whole solve (a 1024^2 float32 plane is 4 MB)
// in VMEM for one launch, its preconditioner as dense DCT matrices on
// the MXU (Mosaic could not lower the FFT form's reshapes). One SM's
// shared memory cannot hold a plane, but the 50 MB L2 holds the solver
// state, so here each iteration is a short chain of launches over
// L2-resident planes. Two routes, chosen by the side lengths:
//
// FFT route (cg_poisson_fft: n, m powers of two, 128 ... 1024), six
// launches per iteration:
//   lane fwd       DCT-II along m (dct_fft.cuh, shared with dct.cu);
//   sub fwd        DCT-II along n, the store dividing by the Neumann
//                  eigenvalue 2 (cos(pi i / n) + cos(pi j / m) - 2),
//                  computed from (i, j) ([0, 0] kept);
//   sub inv        inverse DCT along n;
//   lane inv       inverse DCT along m, giving z; the store also forms
//                  the block partials of r.z;
//   p_applyq       rz, beta (guarded), p = z + beta p_old at each point
//                  and its four neighbours into a second p buffer, Q p
//                  with the aligned cyclic stencil, p.Qp partials;
//   update_x       pq, alpha (guarded), phi += alpha p, r -= alpha Qp.
//   Each pass moves a plane of L2-resident state, O(n m log(n m)) work,
//   where the dense form did 4 n m (n + m) FMAs per plane and iteration.
//   Lines per block C = 4096 / N (N = side / 2): 32 KB of complex data,
//   128 threads, and at (2, 1024, 1024) 256 blocks a pass.
// Dense route (cg_poisson: the other sides that are multiples of 128,
// 384, 640, 768, 896, which no radix-8/16 plan covers), eight launches:
//   4 x sgemm      the dense DCT-II / scipy-inverse preconditioner
//                  (rows then columns, 1/eigenvalue fused into the
//                  epilogue of the forward pair), matrices built on the
//                  device from exact integer angles mod 4k;
//   dot_partials   r.z block partials;
//   update_p       rz, beta (guarded), p = z + beta p;
//   applyq_pq      Q p with the aligned cyclic stencil, p.Qp partials;
//   update_x       as above.
// The weights WWx, WWy are one (n, m) pair per cpw consecutive planes:
// cpw = B shares one pair with every plane; a stack of images whose
// components are cpw planes each gives each image its own pair (plane b
// reads pair b / cpw).
// rz, pq, alpha and beta never leave the device: every block of the
// update kernels reduces the same partials in the same fixed order, so
// a solve needs no host sync, no float atomics, and repeats bit for bit.
// Bound on an H100: the FFT route's passes, each a read and a write of
// the (B, n, m) planes through L2 (2 x 8 MB at the bench's (2, 1024,
// 1024)); the dense route's four n^3 products per plane and iteration
// (fp32 FMA, ~17 GFLOP per iteration for two 1024^2 planes).
#include <cuda_runtime.h>
#include <math.h>

#include "dct_fft.cuh"

namespace {

constexpr int NT = 256;
constexpr int RED = 16;   // elements per thread in the partial sums

// ---- C[b] = (A[b] @ B[b]) (* E), row-major, M, N % 128 == 0, K % 8 == 0
constexpr int GM = 128, GN = 128, GK = 8;

__global__ void __launch_bounds__(NT) sgemm_kernel(
    int M, int N, int K, const float* __restrict__ A, long long sA,
    const float* __restrict__ B, long long sB, float* __restrict__ C,
    long long sC, const float* __restrict__ E) {
  __shared__ __align__(16) float As[GK][GM];
  __shared__ __align__(16) float Bs[GK][GN];
  const int bz = blockIdx.z;
  A += bz * sA;
  B += bz * sB;
  C += bz * sC;
  const int row0 = blockIdx.y * GM, col0 = blockIdx.x * GN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int a_r = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_c = (tid & 31) * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GK) {
    const float4 a = *reinterpret_cast<const float4*>(
        &A[(size_t)(row0 + a_r) * K + k0 + a_k]);
    As[a_k + 0][a_r] = a.x;
    As[a_k + 1][a_r] = a.y;
    As[a_k + 2][a_r] = a.z;
    As[a_k + 3][a_r] = a.w;
    *reinterpret_cast<float4*>(&Bs[b_k][b_c]) =
        *reinterpret_cast<const float4*>(&B[(size_t)(k0 + b_k) * N + col0 + b_c]);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      float4 v = make_float4(acc[i][h * 4], acc[i][h * 4 + 1],
                             acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      if (E != nullptr) {
        const float4 e = *reinterpret_cast<const float4*>(&E[(size_t)r * N + c]);
        v.x *= e.x; v.y *= e.y; v.z *= e.z; v.w *= e.w;
      }
      *reinterpret_cast<float4*>(&C[(size_t)r * N + c]) = v;
    }
  }
}

// ---- dense DCT matrices and the Poisson eigenvalue reciprocals
// C[i,j] = 2 cos(pi (i (2j+1) mod 4k) / 2k); CI = C^T diag(w) / 2k with
// w = [1/2, 1, ...]. Built: Cn = C(n), CnI = CI(n), CmT = C(m)^T,
// CmIT = CI(m)^T.
__global__ void dct_mats_kernel(int k, float fac, float inv2k, float* C,
                                float* CI, int transposed) {
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  if (idx >= (size_t)k * k) return;
  const int i = (int)(idx / k), j = (int)(idx % k);
  // entry [i, j] of C (or of C^T: swap)
  const int a = transposed ? j : i, b = transposed ? i : j;
  const long long prod = ((long long)a * (2 * b + 1)) % (4LL * k);
  C[idx] = 2.0f * cosf((float)prod * fac);
  // CI[i, j] = C[j, i] * w[j] / 2k; CI^T[i, j] = C[i, j] * w[i] / 2k
  const int p = transposed ? i : j, q = transposed ? j : i;  // C[p', q']
  const long long prod2 = ((long long)p * (2 * q + 1)) % (4LL * k);
  const float wv = (transposed ? i : j) == 0 ? 0.5f * inv2k : inv2k;
  CI[idx] = (2.0f * cosf((float)prod2 * fac)) * wv;
}

__global__ void inv_scale_kernel(int n, int m, float fn, float fm,
                                 float* inv) {
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  if (idx >= (size_t)n * m) return;
  const int i = (int)(idx / m), j = (int)(idx % m);
  const float s = 2.0f * (cosf((float)i * fn) + cosf((float)j * fm) - 2.0f);
  inv[idx] = (i == 0 && j == 0) ? 1.0f : 1.0f / s;
}

// ---- fixed-order block reductions
__device__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const float out = sh[0];
  __syncthreads();
  return out;
}

// sum of nb partials, same order in every block
__device__ float reduce_partials(const float* part, int nb, float* sh) {
  float v = 0.f;
  for (int t = threadIdx.x; t < nb; t += NT) v += part[t];
  return block_sum(v, sh);
}

// grid (nb, B): partial[b, blk] = sum over the block's RED*NT elements
__global__ void __launch_bounds__(NT) dot_partials_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    float* __restrict__ part, size_t nm) {
  __shared__ float sh[NT];
  const int b = blockIdx.y;
  const size_t base = (size_t)b * nm + (size_t)blockIdx.x * NT * RED;
  float v = 0.f;
#pragma unroll
  for (int t = 0; t < RED; ++t) {
    const size_t o = base + t * NT + threadIdx.x;
    v = fmaf(x[o], y[o], v);
  }
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0) part[b * gridDim.x + blockIdx.x] = s;
}

// rz = sum(part); beta = rzprev != 0 ? rz / rzprev : 0;
// p = (k == 0) ? z : z + beta p; block 0 stores rz as rzhist[b, k]
__global__ void __launch_bounds__(NT) update_p_kernel(
    const float* __restrict__ z, float* __restrict__ p,
    const float* __restrict__ part, float* __restrict__ rzhist, int k,
    int kmax, size_t nm) {
  __shared__ float sh[NT];
  const int b = blockIdx.y, nb = gridDim.x;
  const float rz = reduce_partials(part + b * nb, nb, sh);
  const float rzprev = k == 0 ? 1.0f : rzhist[b * kmax + k - 1];
  const float beta = rzprev != 0.f ? rz / rzprev : 0.f;
  const size_t base = (size_t)b * nm + (size_t)blockIdx.x * NT * RED;
#pragma unroll
  for (int t = 0; t < RED; ++t) {
    const size_t o = base + t * NT + threadIdx.x;
    p[o] = k == 0 ? z[o] : z[o] + beta * p[o];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) rzhist[b * kmax + k] = rz;
}

// Q p with the aligned cyclic stencil (plane b with weight pair b / cpw)
// and the p.Qp partials; grid (nb, B)
__global__ void __launch_bounds__(NT) applyq_pq_kernel(
    const float* __restrict__ p, const float* __restrict__ WWx,
    const float* __restrict__ WWy, float* __restrict__ qp,
    float* __restrict__ part, int n, int m, int cpw) {
  __shared__ float sh[NT];
  const int b = blockIdx.y;
  const size_t nm = (size_t)n * m;
  WWx += (size_t)(b / cpw) * nm;
  WWy += (size_t)(b / cpw) * nm;
  const float* pb = p + b * nm;
  const size_t base = (size_t)blockIdx.x * NT * RED;
  float v = 0.f;
#pragma unroll 4
  for (int t = 0; t < RED; ++t) {
    const size_t o = base + t * NT + threadIdx.x;
    const int i = (int)(o / m), j = (int)(o % m);
    const int jr = (j + 1) % m, jl = (j + m - 1) % m;
    const int id = (i + 1) % n, iu = (i + n - 1) % n;
    const float pc = pb[o];
    const float tx = WWx[o] * (pb[(size_t)i * m + jr] - pc);
    const float txl = WWx[(size_t)i * m + jl] * (pc - pb[(size_t)i * m + jl]);
    const float ty = WWy[o] * (pb[(size_t)id * m + j] - pc);
    const float tyu = WWy[(size_t)iu * m + j] * (pc - pb[(size_t)iu * m + j]);
    const float q = tx - txl + ty - tyu;
    qp[b * nm + o] = q;
    v = fmaf(pc, q, v);
  }
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0) part[b * gridDim.x + blockIdx.x] = s;
}

// pq = sum(part); alpha = pq != 0 ? rz / pq : 0; phi += alpha p;
// r -= alpha Qp
__global__ void __launch_bounds__(NT) update_x_kernel(
    float* __restrict__ phi, float* __restrict__ r,
    const float* __restrict__ p, const float* __restrict__ qp,
    const float* __restrict__ part, const float* __restrict__ rzhist, int k,
    int kmax, size_t nm) {
  __shared__ float sh[NT];
  const int b = blockIdx.y, nb = gridDim.x;
  const float pq = reduce_partials(part + b * nb, nb, sh);
  const float rz = rzhist[b * kmax + k];
  const float alpha = pq != 0.f ? rz / pq : 0.f;
  const size_t base = (size_t)b * nm + (size_t)blockIdx.x * NT * RED;
#pragma unroll
  for (int t = 0; t < RED; ++t) {
    const size_t o = base + t * NT + threadIdx.x;
    phi[o] = phi[o] + alpha * p[o];
    r[o] = r[o] - alpha * qp[o];
  }
}

// ---- FFT route

// sub fwd epilogue: y / eigenvalue (i, j), the [0, 0] entry as it is
struct EpiEigen {
  static constexpr bool REDUCES = false;
  float fn, fm;  // pi / n, pi / m
  __device__ __forceinline__ void put(float* y, size_t o, float v, int i,
                                      int j) {
    const float s = 2.0f * (cosf((float)i * fn) + cosf((float)j * fm) - 2.0f);
    y[o] = (i == 0 && j == 0) ? v : v / s;
  }
};

// lane inv epilogue: store z and add r.z into the thread's sum; done()
// writes the block's partial (fixed-order tree) to part[blockIdx.x]
struct EpiDot {
  static constexpr bool REDUCES = true;
  const float* r;
  float* part;
  float acc;
  __device__ __forceinline__ void put4(float* y, size_t base, int i,
                                       float4 v) {
    reinterpret_cast<float4*>(y + base)[i] = v;
    const float4 q = reinterpret_cast<const float4*>(r + base)[i];
    acc = fmaf(q.x, v.x, acc);
    acc = fmaf(q.y, v.y, acc);
    acc = fmaf(q.z, v.z, acc);
    acc = fmaf(q.w, v.w, acc);
  }
  __device__ __forceinline__ void done(float* sh) {
    sh[threadIdx.x] = acc;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
      __syncthreads();
    }
    if (threadIdx.x == 0) part[blockIdx.x] = sh[0];
  }
};

// rz = sum(part_rz); beta = rzprev != 0 ? rz / rzprev : 0; p = z (k = 0)
// or z + beta p_old, formed at each point and at its four neighbours
// (the same fmaf, so a neighbour's value is the one its own thread
// stores); Q p with the aligned cyclic stencil (plane b with weight pair
// b / cpw) into qp, p into p_new, p.Qp partials; block 0 stores rz as
// rzhist[b, k]. grid (nb, B)
__global__ void __launch_bounds__(NT) p_applyq_kernel(
    const float* __restrict__ z, const float* __restrict__ p_old,
    float* __restrict__ p_new, const float* __restrict__ WWx,
    const float* __restrict__ WWy, float* __restrict__ qp,
    const float* __restrict__ part_rz, int nb_rz, float* __restrict__ rzhist,
    float* __restrict__ part_pq, int k, int kmax, int n, int m, int cpw) {
  __shared__ float sh[NT];
  const int b = blockIdx.y;
  const size_t nm = (size_t)n * m;
  WWx += (size_t)(b / cpw) * nm;
  WWy += (size_t)(b / cpw) * nm;
  const float rz = reduce_partials(part_rz + b * nb_rz, nb_rz, sh);
  const float rzprev = k == 0 ? 1.0f : rzhist[b * kmax + k - 1];
  const float beta = rzprev != 0.f ? rz / rzprev : 0.f;
  const float* zb = z + b * nm;
  const float* qb = p_old + b * nm;
  auto pat = [&](int o) { return k == 0 ? zb[o] : fmaf(beta, qb[o], zb[o]); };
  const int base = blockIdx.x * NT * RED;  // n m <= 2^20
  float v = 0.f;
#pragma unroll 4
  for (int t = 0; t < RED; ++t) {
    const int o = base + t * NT + threadIdx.x;
    const int i = o / m, j = o - i * m;
    const int jr = j + 1 == m ? 0 : j + 1, jl = j == 0 ? m - 1 : j - 1;
    const int id = i + 1 == n ? 0 : i + 1, iu = i == 0 ? n - 1 : i - 1;
    const float pc = pat(o);
    const float tx = WWx[o] * (pat(i * m + jr) - pc);
    const float txl = WWx[i * m + jl] * (pc - pat(i * m + jl));
    const float ty = WWy[o] * (pat(id * m + j) - pc);
    const float tyu = WWy[iu * m + j] * (pc - pat(iu * m + j));
    const float q = tx - txl + ty - tyu;
    qp[b * nm + o] = q;
    p_new[b * nm + o] = pc;
    v = fmaf(pc, q, v);
  }
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0) part_pq[b * gridDim.x + blockIdx.x] = s;
  if (blockIdx.x == 0 && threadIdx.x == 0) rzhist[b * kmax + k] = rz;
}

// lines per block of a pass at N = side / 2 complex points: 4096
// complex values (32 KB) and 128 threads per block at every side
template <int N>
struct Pass {
  static constexpr int C = 4096 / N;
  static constexpr int T = C * N / 32;
  static constexpr size_t SMEM = dct_smem_bytes<N, C>();
  static_assert(SMEM <= 48 * 1024, "fits without the opt-in attribute");
};

// the FFT-route solve at sides n = 2 NN, m = 2 NM; r holds rk0, phi 0
template <int NN, int NM>
int fft_solve(const float* WWx, const float* WWy, float* phi, float* ws,
              const float* const* tabs, int B, int cpw, int kmax,
              cudaStream_t stream) {
  using L = Pass<NM>;
  using S = Pass<NN>;
  constexpr int n = 2 * NN, m = 2 * NM;
  constexpr size_t nm = (size_t)n * m;
  constexpr int nb = (int)(nm / (NT * RED));
  float* r = ws;
  float* z = r + B * nm;
  float* x1 = z + B * nm;
  float* pbuf[2] = {x1 + B * nm, x1 + 2 * B * nm};
  float* qp = x1 + 3 * B * nm;
  float* part_rz = qp + B * nm;
  float* part_pq = part_rz + (size_t)B * (n / L::C);
  float* rzhist = part_pq + (size_t)B * nb;
  const float2* lane_f = reinterpret_cast<const float2*>(tabs[0]);
  const float2* sub_f = reinterpret_cast<const float2*>(tabs[1]);
  const float2* sub_i = reinterpret_cast<const float2*>(tabs[2]);
  const float2* lane_i = reinterpret_cast<const float2*>(tabs[3]);
  const double PI = 3.14159265358979323846;
  const EpiEigen eig{(float)(PI / n), (float)(PI / m)};
  const dim3 glane(B * n / L::C), gsub(m / S::C, B), gred(nb, B);
  for (int k = 0; k < kmax; ++k) {
    float* p_old = pbuf[k & 1];
    float* p = pbuf[(k + 1) & 1];
    dct_kernel<NM, L::C, false, false><<<glane, L::T, L::SMEM, stream>>>(
        r, x1, lane_f, B * n, Store{});
    dct_kernel<NN, S::C, true, false, EpiEigen>
        <<<gsub, S::T, S::SMEM, stream>>>(x1, z, sub_f, m, eig);
    dct_kernel<NN, S::C, true, true><<<gsub, S::T, S::SMEM, stream>>>(
        z, x1, sub_i, m, Store{});
    dct_kernel<NM, L::C, false, true, EpiDot>
        <<<glane, L::T, L::SMEM, stream>>>(x1, z, lane_i, B * n,
                                           EpiDot{r, part_rz, 0.f});
    p_applyq_kernel<<<gred, NT, 0, stream>>>(z, p_old, p, WWx, WWy, qp,
                                             part_rz, n / L::C, rzhist,
                                             part_pq, k, kmax, n, m, cpw);
    update_x_kernel<<<gred, NT, 0, stream>>>(phi, r, p, qp, part_pq, rzhist,
                                             k, kmax, nm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int NN>
int fft_solve_m(int m, const float* WWx, const float* WWy, float* phi,
                float* ws, const float* const* tabs, int B, int cpw,
                int kmax, cudaStream_t stream) {
  switch (m) {
    case 128: return fft_solve<NN, 64>(WWx, WWy, phi, ws, tabs, B, cpw, kmax, stream);
    case 256: return fft_solve<NN, 128>(WWx, WWy, phi, ws, tabs, B, cpw, kmax, stream);
    case 512: return fft_solve<NN, 256>(WWx, WWy, phi, ws, tabs, B, cpw, kmax, stream);
    case 1024: return fft_solve<NN, 512>(WWx, WWy, phi, ws, tabs, B, cpw, kmax, stream);
  }
  return (int)cudaErrorInvalidValue;
}

bool fft_side(int s) { return s == 128 || s == 256 || s == 512 || s == 1024; }

size_t plane(int n, int m) { return (size_t)n * m; }

}  // namespace

extern "C" {

// floats of workspace cg_poisson_fft needs
long long cg_fft_workspace_floats(int B, int n, int m, int kmax) {
  const size_t nm = plane(n, m);
  const size_t nb = nm / (NT * RED);
  // r.z partials: one per lane block of 4096 / (m / 2) rows
  const size_t lane_parts = nm / 8192;
  return (long long)(6 * B * nm + B * lane_parts + B * nb +
                     (size_t)B * kmax);
}

// The FFT route. rk0, phi: (B, n, m); WWx, WWy: (B / cpw, n, m), plane
// b's pair b / cpw; tabs: the ops/dct.py tables (lane forward at m, sub
// forward at n, sub inverse at n, lane inverse at m); n, m in {128, 256,
// 512, 1024}
int cg_poisson_fft(const float* rk0, const float* WWx, const float* WWy,
                   float* phi, float* ws, const float* tab_lane_f,
                   const float* tab_sub_f, const float* tab_sub_i,
                   const float* tab_lane_i, int B, int cpw, int n, int m,
                   int kmax, cudaStream_t stream) {
  if (!fft_side(n) || !fft_side(m) || B < 1 || kmax < 1 || cpw < 1 ||
      B % cpw)
    return (int)cudaErrorInvalidValue;
  const size_t nm = plane(n, m);
  cudaError_t err;
  if ((err = cudaMemcpyAsync(ws, rk0, B * nm * sizeof(float),
                             cudaMemcpyDeviceToDevice, stream)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(phi, 0, B * nm * sizeof(float), stream)) !=
      cudaSuccess)
    return (int)err;
  const float* tabs[4] = {tab_lane_f, tab_sub_f, tab_sub_i, tab_lane_i};
  switch (n) {
    case 128: return fft_solve_m<64>(m, WWx, WWy, phi, ws, tabs, B, cpw, kmax, stream);
    case 256: return fft_solve_m<128>(m, WWx, WWy, phi, ws, tabs, B, cpw, kmax, stream);
    case 512: return fft_solve_m<256>(m, WWx, WWy, phi, ws, tabs, B, cpw, kmax, stream);
    default: return fft_solve_m<512>(m, WWx, WWy, phi, ws, tabs, B, cpw, kmax, stream);
  }
}

// floats of workspace cg_poisson (the dense route) needs
long long cg_workspace_floats(int B, int n, int m, int kmax) {
  const size_t nm = plane(n, m);
  const size_t nb = nm / (NT * RED);
  return (long long)(5 * B * nm + 2 * (size_t)n * n + 2 * (size_t)m * m + nm +
                     2 * B * nb + (size_t)B * kmax);
}

// The dense route. rk0, phi: (B, n, m); WWx, WWy: (B / cpw, n, m), plane
// b's pair b / cpw; n, m % 128 == 0 and n * m % (NT * RED) == 0
int cg_poisson(const float* rk0, const float* WWx, const float* WWy,
               float* phi, float* ws, int B, int cpw, int n, int m,
               int kmax, cudaStream_t stream) {
  if (B < 1 || cpw < 1 || B % cpw) return (int)cudaErrorInvalidValue;
  const size_t nm = plane(n, m);
  const int nb = (int)(nm / (NT * RED));
  float* r = ws;
  float* p = r + B * nm;
  float* z = p + B * nm;
  float* qp = z + B * nm;
  float* x1 = qp + B * nm;
  float* Cn = x1 + B * nm;
  float* CnI = Cn + (size_t)n * n;
  float* CmT = CnI + (size_t)n * n;
  float* CmIT = CmT + (size_t)m * m;
  float* inv = CmIT + (size_t)m * m;
  float* part_rz = inv + nm;
  float* part_pq = part_rz + (size_t)B * nb;
  float* rzhist = part_pq + (size_t)B * nb;
  cudaError_t err;

  const double PI = 3.14159265358979323846;
  dct_mats_kernel<<<(unsigned)(((size_t)n * n + NT - 1) / NT), NT, 0, stream>>>(
      n, (float)(PI / (2.0 * n)), (float)(1.0 / (2.0 * n)), Cn, CnI, 0);
  dct_mats_kernel<<<(unsigned)(((size_t)m * m + NT - 1) / NT), NT, 0, stream>>>(
      m, (float)(PI / (2.0 * m)), (float)(1.0 / (2.0 * m)), CmT, CmIT, 1);
  inv_scale_kernel<<<(unsigned)((nm + NT - 1) / NT), NT, 0, stream>>>(
      n, m, (float)(PI / n), (float)(PI / m), inv);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = cudaMemcpyAsync(r, rk0, B * nm * sizeof(float),
                             cudaMemcpyDeviceToDevice, stream)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(phi, 0, B * nm * sizeof(float), stream)) !=
      cudaSuccess)
    return (int)err;

  const dim3 gmm(m / GN, n / GM, B);
  const dim3 gred(nb, B);
  const long long snm = (long long)nm;
  for (int k = 0; k < kmax; ++k) {
    // z = CnI ((Cn (r CmT)) . inv) CmIT
    sgemm_kernel<<<gmm, NT, 0, stream>>>(n, m, m, r, snm, CmT, 0, x1, snm,
                                         nullptr);
    sgemm_kernel<<<gmm, NT, 0, stream>>>(n, m, n, Cn, 0, x1, snm, z, snm, inv);
    sgemm_kernel<<<gmm, NT, 0, stream>>>(n, m, m, z, snm, CmIT, 0, x1, snm,
                                         nullptr);
    sgemm_kernel<<<gmm, NT, 0, stream>>>(n, m, n, CnI, 0, x1, snm, z, snm,
                                         nullptr);
    dot_partials_kernel<<<gred, NT, 0, stream>>>(r, z, part_rz, nm);
    update_p_kernel<<<gred, NT, 0, stream>>>(z, p, part_rz, rzhist, k, kmax,
                                             nm);
    applyq_pq_kernel<<<gred, NT, 0, stream>>>(p, WWx, WWy, qp, part_pq, n, m,
                                              cpw);
    update_x_kernel<<<gred, NT, 0, stream>>>(phi, r, p, qp, part_pq, rzhist, k,
                                             kmax, nm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
