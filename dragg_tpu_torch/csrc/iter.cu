// One check window of the ReLU-QP solver, fused into one kernel launch,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of dragg_tpu/ops/pallas_iter.py:
//   fused_window ← _fused_window_t / _iter_kernel
//
// For each home independently, k times (D = Dinv, Â the Ruiz-scaled dense
// equality matrix, S⁻¹ the home's selected rho-bank inverse):
//
//   rhs = σx − q̂ + w∘(ρz − y)
//   ν   = S⁻¹(Â(D∘rhs) − b̂)
//   x̃   = D∘(rhs − Âᵀν)
//   x  ← αx̃ + (1−α)x
//   zc  = αw∘x̃ + (1−α)z
//   z  ← clip(zc + y/ρ, l, u)
//   y  += ρ(zc − z)
//
// then Âx and Âᵀν once more and the four residual maxima (r_prim, r_dual,
// p_sc, d_sc) of ops/reluqp.py's check.  Only (x, z, ν, y) and the four
// (B,) scalars are written; nothing of the k iterations reaches device
// memory.  Same function and operation order as the plain PyTorch version
// (ops/iter_kernels.fused_window_plain, a port of reference_window); the
// dot products sum in another order, so the two agree to float32 rounding
// of the sums, not bit for bit.
//
// Layout: batch first, as the solver holds the arrays — Â (B, m, n),
// S⁻¹ (B, m, m), vectors (B, n) or (B, m), ρ (B,), all float32 and
// contiguous.  One thread block per home (grid = B, so there is no ragged
// edge to mask), 256 threads.  A block's result depends only on its home's
// inputs: no atomics, no sum across blocks, so any slice of homes
// reproduces the full batch bit for bit.
//
// What bounds it: memory and operations about equally.  Per window a home
// reads Â and S⁻¹ once (4(mn + m²) bytes) and does k(4mn + 2m²) + 4mn
// float32 operations; at the main path's buckets (m = 52..77, n = 124..221,
// k = 25) both bounds come to ≈ 30-60 µs per bucket on an H100.  What the
// design does about it: the block stages its home's Â and S⁻¹ in dynamic
// shared memory ONCE per window together with every vector (pv_battery,
// m = 77, n = 221: 91.8 KB of operators + 9.8 KB of vectors, under the
// 227 KB opt-in), and runs all k iterations out of shared memory; Â is
// never re-read from device memory (a kernel that re-read it three times
// per iteration would read it 75 times a window).  Âv and S⁻¹t are a row
// dot per warp (lanes stride the row, a shuffle sum closes it), Âᵀν a
// column sum per thread (neighbouring threads read neighbouring columns).
// Three block barriers per iteration.  What holds this simple design
// back: at 102 KB a block, two pv_battery homes fit on
// an SM, so 8 warps × 2 per SM hide little latency, and the column sums
// are a serial m-long chain.  Tensor cores (wgmma), TMA staging and more
// homes per SM are later work.
//
// Arithmetic: every multiply, add and divide is an explicitly rounded
// intrinsic (and -fmad=false), so the elementwise work rounds as the plain
// version does; max is NaN-propagating, as jnp.max / torch.amax.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory on sm_90

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// NaN-propagating max / min (jnp.maximum, torch.maximum).
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float absmax(float acc, float v) { return maxp(acc, fabsf(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = maxp(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out[i] = Σ_j M[i, j] v[j] (minus sub[i] when given), one warp per row.
__device__ void rows_dot(const float* M, const float* v, int rows, int cols,
                         const float* sub_i, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < rows; i += kWarps) {
    const float* row = M + static_cast<long>(i) * cols;
    float s = 0.0f;
    for (int j = lane; j < cols; j += 32) s = add(s, mul(row[j], v[j]));
    s = warp_sum(s);
    if (lane == 0) out[i] = sub_i ? sub(s, sub_i[i]) : s;
  }
}

// Σ_i A[i, j] u[i] for column j of the (m, n) matrix A.
__device__ __forceinline__ float col_dot(const float* A, const float* u, int m, int n,
                                         int j) {
  float s = 0.0f;
  for (int i = 0; i < m; ++i) s = add(s, mul(A[static_cast<long>(i) * n + j], u[i]));
  return s;
}

__global__ void __launch_bounds__(kThreads)
fused_window_kernel(const float* __restrict__ A, const float* __restrict__ Sinv,
                    const float* __restrict__ Dinv, const float* __restrict__ w,
                    const float* __restrict__ qs, const float* __restrict__ bs,
                    const float* __restrict__ ls, const float* __restrict__ us,
                    const float* __restrict__ rho, const float* __restrict__ x0,
                    const float* __restrict__ z0, const float* __restrict__ nu0,
                    const float* __restrict__ y0, const float* __restrict__ eeq,
                    const float* __restrict__ ebox, const float* __restrict__ cd,
                    const float* __restrict__ pd,
                    float* __restrict__ xo, float* __restrict__ zo,
                    float* __restrict__ nuo, float* __restrict__ yo,
                    float* __restrict__ rp, float* __restrict__ rd,
                    float* __restrict__ ps, float* __restrict__ ds,
                    int m, int n, int k, float sigma, float alpha, float beta) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const long mn = static_cast<long>(m) * n, mm = static_cast<long>(m) * m;
  float* A_s = smem;                 // (m, n)
  float* S_s = A_s + mn;             // (m, m)
  float* x_s = S_s + mm;             // n-vectors
  float* z_s = x_s + n;
  float* y_s = z_s + n;
  float* dinv_s = y_s + n;
  float* w_s = dinv_s + n;
  float* qs_s = w_s + n;
  float* ls_s = qs_s + n;
  float* us_s = ls_s + n;
  float* rhs_s = us_s + n;
  float* v_s = rhs_s + n;            // D∘rhs, later Âᵀν
  float* bs_s = v_s + n;             // m-vectors
  float* t_s = bs_s + m;             // Â(D∘rhs) − b̂, later Âx
  float* nu_s = t_s + m;
  float* red = nu_s + m;             // (5, kWarps) partial maxima

  // --- Stage the home's operators and vectors once.
  const float* Ab = A + b * mn;
  const float* Sb = Sinv + b * mm;
  for (long e = tid; e < mn; e += kThreads) A_s[e] = Ab[e];
  for (long e = tid; e < mm; e += kThreads) S_s[e] = Sb[e];
  const long vn = static_cast<long>(b) * n, vm = static_cast<long>(b) * m;
  for (int j = tid; j < n; j += kThreads) {
    x_s[j] = x0[vn + j];
    z_s[j] = z0[vn + j];
    y_s[j] = y0[vn + j];
    dinv_s[j] = Dinv[vn + j];
    w_s[j] = w[vn + j];
    qs_s[j] = qs[vn + j];
    ls_s[j] = ls[vn + j];
    us_s[j] = us[vn + j];
  }
  for (int i = tid; i < m; i += kThreads) {
    bs_s[i] = bs[vm + i];
    nu_s[i] = nu0[vm + i];
  }
  const float r = rho[b];
  __syncthreads();

  for (int it = 0; it < k; ++it) {
    for (int j = tid; j < n; j += kThreads) {
      // rhs = (σx − q̂) + w(ρz − y)
      const float rhs = add(sub(mul(sigma, x_s[j]), qs_s[j]),
                            mul(w_s[j], sub(mul(r, z_s[j]), y_s[j])));
      rhs_s[j] = rhs;
      v_s[j] = mul(dinv_s[j], rhs);
    }
    __syncthreads();
    rows_dot(A_s, v_s, m, n, bs_s, t_s);           // t = Â(D∘rhs) − b̂
    __syncthreads();
    rows_dot(S_s, t_s, m, m, nullptr, nu_s);       // ν = S⁻¹t
    __syncthreads();
    for (int j = tid; j < n; j += kThreads) {
      const float xt = mul(dinv_s[j], sub(rhs_s[j], col_dot(A_s, nu_s, m, n, j)));
      const float zt = mul(w_s[j], xt);
      const float z = z_s[j], y = y_s[j];
      x_s[j] = add(mul(alpha, xt), mul(beta, x_s[j]));
      const float zc = add(mul(alpha, zt), mul(beta, z));
      const float zn = minp(maxp(add(zc, dvd(y, r)), ls_s[j]), us_s[j]);
      z_s[j] = zn;
      y_s[j] = add(y, mul(r, sub(zc, zn)));
    }
    // Thread j alone reads and writes entry j of x, z, y and rhs, and the
    // next write of ν comes two barriers later: no barrier needed here.
  }
  __syncthreads();

  // --- Residual maxima (ops/reluqp.py residuals), f32.
  rows_dot(A_s, x_s, m, n, nullptr, t_s);          // Âx
  for (int j = tid; j < n; j += kThreads) v_s[j] = col_dot(A_s, nu_s, m, n, j);
  __syncthreads();
  float a_peq = 0.0f, a_pbox = 0.0f, a_dual = 0.0f, a_psc = 0.0f, a_dsc = 0.0f;
  const float* eeq_b = eeq + vm;
  for (int i = tid; i < m; i += kThreads) {
    const float e = eeq_b[i], ax = t_s[i];
    a_peq = absmax(a_peq, dvd(sub(ax, bs_s[i]), e));
    a_psc = absmax(absmax(a_psc, dvd(ax, e)), dvd(bs_s[i], e));
  }
  for (int j = tid; j < n; j += kThreads) {
    const float eb = ebox[vn + j], c = cd[vn + j];
    const float x = x_s[j], z = z_s[j], y = y_s[j], atnu = v_s[j];
    const float wx = mul(w_s[j], x), wy = mul(w_s[j], y);
    a_pbox = absmax(a_pbox, dvd(sub(wx, z), eb));
    // dual = (p_diag x + q̂ + Âᵀν + w y) / (c d)
    a_dual = absmax(a_dual, dvd(add(add(add(mul(pd[vn + j], x), qs_s[j]), atnu), wy), c));
    a_psc = absmax(absmax(a_psc, dvd(wx, eb)), dvd(z, eb));
    a_dsc = absmax(absmax(absmax(a_dsc, dvd(atnu, c)), dvd(wy, c)), dvd(qs_s[j], c));
  }
  const int warp = tid / 32, lane = tid % 32;
  a_peq = warp_max(a_peq);
  a_pbox = warp_max(a_pbox);
  a_dual = warp_max(a_dual);
  a_psc = warp_max(a_psc);
  a_dsc = warp_max(a_dsc);
  if (lane == 0) {
    red[0 * kWarps + warp] = a_peq;
    red[1 * kWarps + warp] = a_pbox;
    red[2 * kWarps + warp] = a_dual;
    red[3 * kWarps + warp] = a_psc;
    red[4 * kWarps + warp] = a_dsc;
  }
  for (int j = tid; j < n; j += kThreads) {
    xo[vn + j] = x_s[j];
    zo[vn + j] = z_s[j];
    yo[vn + j] = y_s[j];
  }
  for (int i = tid; i < m; i += kThreads) nuo[vm + i] = nu_s[i];
  __syncthreads();
  if (tid == 0) {
    float q[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      q[c] = red[c * kWarps];
      for (int i = 1; i < kWarps; ++i) q[c] = maxp(q[c], red[c * kWarps + i]);
    }
    rp[b] = maxp(q[0], q[1]);
    rd[b] = q[2];
    ps[b] = q[3];
    ds[b] = q[4];
  }
}

// Shared-memory bytes one block needs at (m, n): Â, S⁻¹, ten n-vectors,
// three m-vectors and the partial maxima.
long smem_bytes(int m, int n) {
  return 4L * (static_cast<long>(m) * n + static_cast<long>(m) * m + 10L * n + 3L * m +
               5L * kWarps);
}

}  // namespace

extern "C" {

int fused_window(const float* A, const float* Sinv, const float* Dinv, const float* w,
                 const float* qs, const float* bs, const float* ls, const float* us,
                 const float* rho, const float* x, const float* z, const float* nu,
                 const float* y, const float* eeq, const float* ebox, const float* cd,
                 const float* pd, float* xo, float* zo, float* nuo, float* yo, float* rp,
                 float* rd, float* ps, float* ds, int B, int m, int n, int k,
                 double sigma, double alpha, cudaStream_t stream) {
  const long smem = smem_bytes(m, n);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_window_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1 − α is formed in double and rounded once, as Python forms it.
  fused_window_kernel<<<B, kThreads, smem, stream>>>(
      A, Sinv, Dinv, w, qs, bs, ls, us, rho, x, z, nu, y, eeq, ebox, cd, pd, xo, zo, nuo,
      yo, rp, rd, ps, ds, m, n, k, static_cast<float>(sigma), static_cast<float>(alpha),
      static_cast<float>(1.0 - alpha));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
