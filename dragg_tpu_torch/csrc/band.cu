// Batched band Cholesky and refined band solves for the interior-point
// solver's Schur complement S = A Θ⁻¹ Aᵀ, hand-written for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of dragg_tpu/ops/pallas_band.py:
//   band_cholesky_t      ← _chol_kernel / _chol_body         (banded_cholesky_t)
//   band_refined_solve_t ← _refined_solve_kernel, _solve_into,
//                          _band_matvec_body                 (refined_banded_solve_t)
//   band_factor_solve_t  ← _factor_solve_kernel              (factor_refined_solve_t)
//
// Layout: transposed band storage, homes last — S[i][k][b] = S_perm(i, i-k)
// of home b, so an (m, bw+1, B) float32 array; vectors are (m, B).  One
// thread per home: neighbouring threads read neighbouring addresses, and
// each thread runs its home's m-row recurrence serially.  Rows above row 0
// are virtual unit rows.  Homes b >= B are masked, never padded.
//
// Arithmetic: the same recurrences and operation order as the Pallas
// kernels and the plain PyTorch versions (ops/banded.py).  Every multiply,
// add, divide and square root is an explicitly rounded intrinsic
// (__fmul_rn, __fsub_rn, ...), so nothing is contracted into an FMA and
// the kernels match the plain versions bit for bit.
//
// What bounds them: memory.  Per call the factor reads S and writes L,
// 2·m·(bw+1)·B·4 bytes (at B = 10,000, m = 77, bw = 4: 30.8 MB, 9.2 µs
// at 3.35 TB/s); the FLOPs are O(m·bw²) per home, far below the card's
// rate.  What holds this simple design back instead is the serial
// m-row dependency chain per thread at low occupancy (10,000 homes are
// 157 blocks of 64 threads on 132 SMs): each row waits on the previous
// one's global-memory round trip.  Blocks of 64 threads spread the homes
// over the most SMs; a warp-per-home or shared-memory-staged redesign is
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

struct Band {
  // Element (row i, band offset k) of home b in (m, bw+1, B) storage.
  const float* p;
  int bwp1, B;
  __device__ float at(int i, int k, int b) const {
    return p[(static_cast<long>(i) * bwp1 + k) * B + b];
  }
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// L ← factor(S) for home b (Pallas _chol_body; banded.banded_cholesky).
template <int BW>
__device__ void chol_home(const float* __restrict__ S, float* __restrict__ L,
                          int m, int B, int b) {
  constexpr int W = BW + 1;
  // prev[d-1][j] = L(i-d, j); virtual unit rows above the top.
  float prev[BW][W];
#pragma unroll
  for (int d = 0; d < BW; ++d) {
#pragma unroll
    for (int j = 0; j < W; ++j) prev[d][j] = (j == 0) ? 1.0f : 0.0f;
  }
  for (int i = 0; i < m; ++i) {
    const long base = static_cast<long>(i) * W * B + b;
    float row[W];
#pragma unroll
    for (int k = BW; k >= 1; --k) {
      float s = S[base + static_cast<long>(k) * B];
#pragma unroll
      for (int j = 1; j <= BW - k; ++j) s = sub(s, mul(row[k + j], prev[k - 1][j]));
      row[k] = dvd(s, prev[k - 1][0]);
    }
    float diag = S[base];
#pragma unroll
    for (int j = 1; j <= BW; ++j) diag = sub(diag, mul(row[j], row[j]));
    // jnp.maximum semantics: a NaN diagonal stays NaN.
    const float dm = (diag != diag) ? diag : fmaxf(diag, 1e-20f);
    row[0] = __fsqrt_rn(dm);
#pragma unroll
    for (int k = 0; k < W; ++k) L[base + static_cast<long>(k) * B] = row[k];
#pragma unroll
    for (int d = BW - 1; d >= 1; --d) {
#pragma unroll
      for (int j = 0; j < W; ++j) prev[d][j] = prev[d - 1][j];
    }
#pragma unroll
    for (int j = 0; j < W; ++j) prev[0][j] = row[j];
  }
}

// x ← (L Lᵀ)⁻¹ rhs for home b (Pallas _solve_into): forward substitution
// into y, then backward substitution into x.  x may alias rhs: the
// backward pass never re-reads the rhs.
template <int BW>
__device__ void solve_home(const float* L, const float* rhs, float* y, float* x,
                           int m, int B, int b) {
  constexpr int W = BW + 1;
  const Band Lb{L, W, B};
  float ring[BW];  // ring[k-1] = y(i-k) forward, x(i+k) backward
#pragma unroll
  for (int k = 0; k < BW; ++k) ring[k] = 0.0f;
  for (int i = 0; i < m; ++i) {
    float acc = rhs[static_cast<long>(i) * B + b];
#pragma unroll
    for (int k = 1; k <= BW; ++k) {
      if (i - k >= 0) acc = sub(acc, mul(Lb.at(i, k, b), ring[k - 1]));
    }
    const float yi = dvd(acc, Lb.at(i, 0, b));
    y[static_cast<long>(i) * B + b] = yi;
#pragma unroll
    for (int k = BW - 1; k >= 1; --k) ring[k] = ring[k - 1];
    ring[0] = yi;
  }
#pragma unroll
  for (int k = 0; k < BW; ++k) ring[k] = 0.0f;
  for (int i = m - 1; i >= 0; --i) {
    float acc = y[static_cast<long>(i) * B + b];
#pragma unroll
    for (int k = 1; k <= BW; ++k) {
      if (i + k < m) acc = sub(acc, mul(Lb.at(i + k, k, b), ring[k - 1]));
    }
    const float xi = dvd(acc, Lb.at(i, 0, b));
    x[static_cast<long>(i) * B + b] = xi;
#pragma unroll
    for (int k = BW - 1; k >= 1; --k) ring[k] = ring[k - 1];
    ring[0] = xi;
  }
}

// t ← r − S x for home b (Pallas _band_matvec_body; banded.band_matvec):
// out = S(i,0)·x(i), then for k = 1..bw the lower term then the upper
// term, adding an exact 0 where the term falls off the band, as the
// Pallas kernel's zero-padded shifts do.
template <int BW>
__device__ void residual_home(const float* __restrict__ S, const float* r,
                              const float* x, float* t, int m, int B, int b) {
  const Band Sb{S, BW + 1, B};
  for (int i = 0; i < m; ++i) {
    float out = mul(Sb.at(i, 0, b), x[static_cast<long>(i) * B + b]);
#pragma unroll
    for (int k = 1; k <= BW; ++k) {
      const float lo = (i >= k) ? mul(Sb.at(i, k, b), x[static_cast<long>(i - k) * B + b]) : 0.0f;
      out = add(out, lo);
      const float up = (i + k < m) ? mul(Sb.at(i + k, k, b), x[static_cast<long>(i + k) * B + b]) : 0.0f;
      out = add(out, up);
    }
    t[static_cast<long>(i) * B + b] = sub(r[static_cast<long>(i) * B + b], out);
  }
}

// x ← solve(r), then `refine` passes of t = r − S x, t ← solve(t), x += t.
template <int BW>
__device__ void refined_solve_home(const float* L, const float* __restrict__ S,
                                   const float* __restrict__ r, float* x, float* y,
                                   float* t, int m, int B, int b, int refine) {
  solve_home<BW>(L, r, y, x, m, B, b);
  for (int p = 0; p < refine; ++p) {
    residual_home<BW>(S, r, x, t, m, B, b);
    solve_home<BW>(L, t, y, t, m, B, b);
    for (int i = 0; i < m; ++i) {
      const long o = static_cast<long>(i) * B + b;
      x[o] = add(x[o], t[o]);
    }
  }
}

// Replaces dragg_tpu/ops/pallas_band.py _chol_kernel (banded_cholesky_t).
// Bound: bytes — reads S and writes L, 2·m·(bw+1)·B·4.
template <int BW>
__global__ void __launch_bounds__(kThreads)
chol_kernel(const float* __restrict__ S, float* __restrict__ L, int m, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) chol_home<BW>(S, L, m, B, b);
}

// Replaces pallas_band.py _refined_solve_kernel (refined_banded_solve_t).
// Bound: bytes — reads L, S and r, writes x, (2·m·(bw+1) + 2·m)·B·4.
template <int BW>
__global__ void __launch_bounds__(kThreads)
refined_solve_kernel(const float* L, const float* __restrict__ S,
                     const float* __restrict__ r, float* x, float* y, float* t,
                     int m, int B, int refine) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) refined_solve_home<BW>(L, S, r, x, y, t, m, B, b, refine);
}

// Replaces pallas_band.py _factor_solve_kernel (factor_refined_solve_t):
// the factor, then the first refined solve, in one launch — the thread
// reuses the factor it has just written.  Bound: bytes — reads S and r,
// writes L and x, (2·m·(bw+1) + 2·m)·B·4.  L, x, y
// and t are written and re-read inside the launch, so none of them is
// declared __restrict__ (no read-only-cache loads of fresh data).
template <int BW>
__global__ void __launch_bounds__(kThreads)
factor_solve_kernel(const float* __restrict__ S, const float* __restrict__ r,
                    float* L, float* x, float* y, float* t, int m, int B, int refine) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) {
    chol_home<BW>(S, L, m, B, b);
    refined_solve_home<BW>(L, S, r, x, y, t, m, B, b, refine);
  }
}

dim3 grid_for(int B) { return dim3((B + kThreads - 1) / kThreads); }

// Instantiates LAUNCH with the compile-time constant BW for the runtime
// bandwidth 1..12 (ops/banded.py MAX_BAND), so each kernel's bw² loops
// unroll; evaluates to the launch's CUDA error code.
#define BAND_CASE(N, LAUNCH) \
  case N: {                  \
    constexpr int BW = N;    \
    LAUNCH;                  \
    break;                   \
  }
#define BAND_DISPATCH(bw, LAUNCH)                                           \
  do {                                                                     \
    switch (bw) {                                                          \
      BAND_CASE(1, LAUNCH) BAND_CASE(2, LAUNCH) BAND_CASE(3, LAUNCH)       \
      BAND_CASE(4, LAUNCH) BAND_CASE(5, LAUNCH) BAND_CASE(6, LAUNCH)       \
      BAND_CASE(7, LAUNCH) BAND_CASE(8, LAUNCH) BAND_CASE(9, LAUNCH)       \
      BAND_CASE(10, LAUNCH) BAND_CASE(11, LAUNCH) BAND_CASE(12, LAUNCH)    \
      default: return static_cast<int>(cudaErrorInvalidValue);             \
    }                                                                      \
    return static_cast<int>(cudaGetLastError());                           \
  } while (0)

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns the CUDA error code
// of its launch (0 = success); nothing synchronises, nothing allocates.

extern "C" int band_cholesky_t(const float* S, float* L, int m, int bw, int B,
                               void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BAND_DISPATCH(bw, (chol_kernel<BW><<<grid_for(B), kThreads, 0, s>>>(S, L, m, B)));
}

extern "C" int band_refined_solve_t(const float* L, const float* S, const float* r,
                                    float* x, float* y, float* t, int m, int bw,
                                    int B, int refine, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BAND_DISPATCH(bw, (refined_solve_kernel<BW><<<grid_for(B), kThreads, 0, s>>>(
                        L, S, r, x, y, t, m, B, refine)));
}

extern "C" int band_factor_solve_t(const float* S, const float* r, float* L, float* x,
                                   float* y, float* t, int m, int bw, int B,
                                   int refine, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BAND_DISPATCH(bw, (factor_solve_kernel<BW><<<grid_for(B), kThreads, 0, s>>>(
                        S, r, L, x, y, t, m, B, refine)));
}
