// Batched band Cholesky and refined band solves for the interior-point
// solver's Schur complement S = A Θ⁻¹ Aᵀ, hand-written for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of dragg_tpu/ops/pallas_band.py:
//   chol_kernel          ← _chol_kernel / _chol_body         (banded_cholesky_t)
//   refined_solve_kernel ← _refined_solve_kernel, _solve_into,
//                          _band_matvec_body                 (refined_banded_solve_t)
//   factor_solve_kernel  ← _factor_solve_kernel              (factor_refined_solve_t)
//
// Layout: transposed band storage, homes last — S[i][k][b] = S_perm(i, i-k)
// of home b, so an (m, bw+1, B) float32 array; vectors are (m, B).  One
// thread per home runs its home's m-row recurrence serially: the
// recurrence is serial across rows, and inside a factor row serial over k
// (row[k] needs row[k+1..bw]), so more lanes per home would only split a
// row's few products and put shuffle latency on the chain.  Rows above
// row 0 are virtual unit rows.  Homes b >= B are masked, never padded.
//
// Arithmetic: the same recurrences and operation order as the Pallas
// kernels and the plain PyTorch versions (ops/banded.py), written once per
// row (chol_row, fwd_row, bwd_row, band_row) and shared by all three
// kernels.  Every multiply, add, divide and square root is an explicitly
// rounded intrinsic (__fmul_rn, __fsub_rn, ...) and the build passes
// -fmad=false, so nothing is contracted into an FMA and the kernels match
// the plain versions bit for bit.
//
// What bounds them.  By bytes (bench_band.band_bounds): the factor reads
// S and writes L, 2·m·(bw+1)·B·4 bytes; the refined solve reads L, S and r
// and writes x, (2·m·(bw+1) + 2·m)·B·4 — at m = 77, bw = 4, B = 1,000:
// 3.1 MB and 3.7 MB, about 1 µs at 3.35 TB/s.  Far above that sits the chain
// floor: the dependent instructions of one row times m, at the SM clock
// (1.98 GHz at most).  Counted from the code with 4 cycles per dependent
// add or multiply, ~36 per divide sequence and ~30 per square root (not
// measured), at bw = 4:
//   factor row: the four divides, each after the products and
//     subtractions that feed it (36 + 44 + 48 + 52), then the diagonal's
//     square and four subtractions (20), the NaN-preserving max (8) and
//     the square root (30): ≈ 238 cycles; m = 77 → ≈ 9.3 µs;
//   forward or backward row: one product on the previous result, four
//     subtractions, one divide: ≈ 56 cycles;
//   residual row (no recurrence, issued in order): ≈ 40 cycles;
//   refined solve at refine 1: 4 · 56 + 40 ≈ 264 cycles a row; m = 77 →
//     ≈ 10.3 µs.
// Measured on an H100 80GB HBM3 card (700 W) over 32 homes, m = 52..149
// (bench_band, chip_smoke.py): 0.21-0.22 µs a factor row and 0.37-0.38 µs
// a refine-1 solve row with the whole band staged, 0.51-0.53 µs through
// the ring (≈ 415-435, 735-750 and 1,010-1,050 cycles at 1.98 GHz), plus
// ≈ 3 µs a launch.  The chain runs about twice the count above (each
// divide and square root, with its range check and branch, costs more
// than assumed, and the warp issues the row's moves and predicates in
// order with it), and the kernel's time at the main path's batches is
// that chain: 32 homes a block leave most SMs idle at B = 1,000 and still
// fit one wave at 4,000.
// The first design ran 75 / 124 µs of device time per call at m = 77,
// B = 1,000: every row's loads came from device memory, behind the
// previous row's stores (x aliases t, y is re-read), so each row paid a
// device-memory round trip.
//
// What the design does about it: a block of hb homes stages its rows in
// shared memory, layout [row][k][home] (home fastest: no bank conflicts,
// and the copy from the homes-last device layout is a coalesced stream),
// with cp.async.  Each thread copies only its own home's column, so it
// waits on its own copies (cp.async.wait_group) and no barrier is needed.
// Where the home's band fits, it is staged whole at launch (depth 0);
// otherwise it streams through a ring of kRingDepth chunks of R rows,
// issued kRingDepth - 2 chunks ahead of the chunk the chain is on.  The
// chain itself reads registers only: each row's values are loaded from
// shared memory one row ahead, and the values a row needs from the rows
// below it (backward sweep, residual) are carried in registers.  The row
// loops are unrolled by 4, which turns most of the carried rows' moves
// into renaming (faster on the H100 than by 2 or not at all).  In the
// refined solve, L is staged once and read by all 2 + 2·refine sweeps
// (whole band) or streamed once per sweep (ring), and r, x and y/t live in
// shared memory for the whole launch: only x goes back to device memory,
// once.  Which (hb, depth, R) runs is a host-side plan from (m, bw), the
// batch and the SM count (ops/band_kernels.band_plan: the fewest waves of
// blocks, then the whole band, then the larger block — every plan gives
// the same bits); the entry points validate it against BAND_KERNELS and
// refuse any other.
//
// factor_solve_kernel keeps the first design (one thread per home reading
// and writing device memory, 64-thread blocks); it runs the same row
// arithmetic, so it equals the split route bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;        // factor_solve_kernel's block
constexpr int kRingDepth = 4;       // ring slots; chunks issued kRingDepth - 2 ahead
constexpr int kMaxHomes = 32;       // largest block of the staged kernels
constexpr int kMaxSmem = 232448;    // dynamic shared memory of one block on sm_90

// The accepted (homes per block, ring depth) pairs, in the order
// ops/band_kernels.BAND_KERNELS lists them; depth 0 stages the whole band.
#define BAND_KERNELS(X) \
  X(32, 0)              \
  X(32, 4)              \
  X(16, 0)              \
  X(16, 4)

#define DRAGG_BAND_PLAN(H, D)                                    \
  static_assert(H <= kMaxHomes && (D == 0 || D == kRingDepth), \
                "BAND_KERNELS: a block beyond the launch bound or an unknown ring depth");
BAND_KERNELS(DRAGG_BAND_PLAN)
#undef DRAGG_BAND_PLAN

bool plan_accepted(int hb, int depth) {
#define DRAGG_BAND_PLAN(H, D) \
  if (hb == H && depth == D) return true;
  BAND_KERNELS(DRAGG_BAND_PLAN)
#undef DRAGG_BAND_PLAN
  return false;
}

// Shared-memory bytes of a plan (ops/band_kernels.band_smem): the band
// rows held (all m, or the ring's depth · R) of one array (the factor; the
// solve's ring) or two (the solve's whole L and S), plus the solve's r, x
// and y/t vectors.
int plan_smem(bool solve, int m, int bw, int hb, int depth, int rows) {
  const long band_rows = depth == 0 ? m : static_cast<long>(depth) * rows;
  const long arrays = (solve && depth == 0) ? 2 : 1;
  const long words = arrays * band_rows * (bw + 1) + (solve ? 3L * m : 0L);
  const long bytes = 4L * hb * words;
  return bytes > kMaxSmem ? -1 : static_cast<int>(bytes);
}

bool plan_ok(bool solve, int m, int bw, int hb, int depth, int rows, int smem) {
  if (!plan_accepted(hb, depth)) return false;
  if (depth == 0 ? rows != m : (rows < 1 || rows > m)) return false;
  return smem >= 0 && smem == plan_smem(solve, m, bw, hb, depth, rows);
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// ------------------------------------------------------ async copies
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------- row arithmetic
template <int BW>
__device__ __forceinline__ void chol_init(float (&prev)[BW][BW + 1]) {
#pragma unroll
  for (int d = 0; d < BW; ++d) {
#pragma unroll
    for (int j = 0; j <= BW; ++j) prev[d][j] = (j == 0) ? 1.0f : 0.0f;
  }
}

// Row i of the factor (Pallas _chol_body; banded.banded_cholesky) from
// s[k] = S(i, i-k): row[k] = L(i, i-k).  prev[d-1] holds L row i-d
// (virtual unit rows above the top) and is shifted to take row i.
template <int BW>
__device__ __forceinline__ void chol_row(const float (&s)[BW + 1], float (&prev)[BW][BW + 1],
                                         float (&row)[BW + 1]) {
#pragma unroll
  for (int k = BW; k >= 1; --k) {
    float a = s[k];
#pragma unroll
    for (int j = 1; j <= BW - k; ++j) a = sub(a, mul(row[k + j], prev[k - 1][j]));
    row[k] = dvd(a, prev[k - 1][0]);
  }
  float diag = s[0];
#pragma unroll
  for (int j = 1; j <= BW; ++j) diag = sub(diag, mul(row[j], row[j]));
  // jnp.maximum semantics: a NaN diagonal stays NaN.
  const float dm = (diag != diag) ? diag : fmaxf(diag, 1e-20f);
  row[0] = __fsqrt_rn(dm);
#pragma unroll
  for (int d = BW - 1; d >= 1; --d) {
#pragma unroll
    for (int j = 0; j <= BW; ++j) prev[d][j] = prev[d - 1][j];
  }
#pragma unroll
  for (int j = 0; j <= BW; ++j) prev[0][j] = row[j];
}

template <int BW>
__device__ __forceinline__ void push(float (&ring)[BW], float v) {
#pragma unroll
  for (int k = BW - 1; k >= 1; --k) ring[k] = ring[k - 1];
  ring[0] = v;
}

// Forward substitution, row i (Pallas _solve_into): y_i from acc = rhs_i
// and l[k] = L(i, i-k); ring[k-1] = y_{i-k}, shifted to take y_i.
template <int BW>
__device__ __forceinline__ float fwd_row(float acc, const float (&l)[BW + 1], float (&ring)[BW],
                                         int i) {
#pragma unroll
  for (int k = 1; k <= BW; ++k) {
    if (i - k >= 0) acc = sub(acc, mul(l[k], ring[k - 1]));
  }
  const float y = dvd(acc, l[0]);
  push<BW>(ring, y);
  return y;
}

// Backward substitution, row i: x_i from acc = y_i, the diagonal L(i, i)
// and below[k-1] = L(i+k, i); ring[k-1] = x_{i+k}, shifted to take x_i.
template <int BW>
__device__ __forceinline__ float bwd_row(float acc, float diag, const float (&below)[BW],
                                         float (&ring)[BW], int i, int m) {
#pragma unroll
  for (int k = 1; k <= BW; ++k) {
    if (i + k < m) acc = sub(acc, mul(below[k - 1], ring[k - 1]));
  }
  const float x = dvd(acc, diag);
  push<BW>(ring, x);
  return x;
}

// (S x)_i (Pallas _band_matvec_body; banded.band_matvec): out = S(i,0)·x_i,
// then for k = 1..bw the lower term then the upper term, adding an exact 0
// where the term falls off the band, as the Pallas kernel's zero-padded
// shifts do.  s[k] = S(i, i-k), below[k-1] = S(i+k, i), xw[BW + j] = x_{i+j}.
template <int BW>
__device__ __forceinline__ float band_row(const float (&s)[BW + 1], const float (&below)[BW],
                                          const float (&xw)[2 * BW + 1], int i, int m) {
  float out = mul(s[0], xw[BW]);
#pragma unroll
  for (int k = 1; k <= BW; ++k) {
    const float lo = (i >= k) ? mul(s[k], xw[BW - k]) : 0.0f;
    out = add(out, lo);
    const float up = (i + k < m) ? mul(below[k - 1], xw[BW + k]) : 0.0f;
    out = add(out, up);
  }
  return out;
}

// ---------------------- the first design's device-memory functions
// (factor_solve_kernel): the same rows, loaded from and stored to device
// memory directly.
struct Band {
  // Element (row i, band offset k) of home b in (m, bw+1, B) storage.
  const float* p;
  int bwp1, B;
  __device__ float at(int i, int k, int b) const {
    return p[(static_cast<long>(i) * bwp1 + k) * B + b];
  }
};

template <int BW>
__device__ void chol_home(const float* __restrict__ S, float* L, int m, int B, int b) {
  constexpr int W = BW + 1;
  const Band Sb{S, W, B};
  float prev[BW][W];
  chol_init<BW>(prev);
  for (int i = 0; i < m; ++i) {
    float s[W], row[W];
#pragma unroll
    for (int k = 0; k < W; ++k) s[k] = Sb.at(i, k, b);
    chol_row<BW>(s, prev, row);
#pragma unroll
    for (int k = 0; k < W; ++k) L[(static_cast<long>(i) * W + k) * B + b] = row[k];
  }
}

// x ← (L Lᵀ)⁻¹ rhs for home b: forward substitution into y, then backward
// substitution into x.  x may alias rhs: the backward pass never re-reads
// the rhs.
template <int BW>
__device__ void solve_home(const float* L, const float* rhs, float* y, float* x, int m, int B,
                           int b) {
  constexpr int W = BW + 1;
  const Band Lb{L, W, B};
  float ring[BW] = {};
  for (int i = 0; i < m; ++i) {
    float l[W];
#pragma unroll
    for (int k = 0; k < W; ++k) l[k] = (i - k >= 0 || k == 0) ? Lb.at(i, k, b) : 0.0f;
    y[static_cast<long>(i) * B + b] = fwd_row<BW>(rhs[static_cast<long>(i) * B + b], l, ring, i);
  }
#pragma unroll
  for (int k = 0; k < BW; ++k) ring[k] = 0.0f;
  for (int i = m - 1; i >= 0; --i) {
    float below[BW];
#pragma unroll
    for (int k = 1; k <= BW; ++k) below[k - 1] = (i + k < m) ? Lb.at(i + k, k, b) : 0.0f;
    x[static_cast<long>(i) * B + b] =
        bwd_row<BW>(y[static_cast<long>(i) * B + b], Lb.at(i, 0, b), below, ring, i, m);
  }
}

// t ← r − S x for home b.
template <int BW>
__device__ void residual_home(const float* __restrict__ S, const float* r, const float* x,
                              float* t, int m, int B, int b) {
  constexpr int W = BW + 1;
  const Band Sb{S, W, B};
  for (int i = 0; i < m; ++i) {
    float s[W], below[BW], xw[2 * BW + 1];
#pragma unroll
    for (int k = 0; k < W; ++k) s[k] = Sb.at(i, k, b);
#pragma unroll
    for (int k = 1; k <= BW; ++k) below[k - 1] = (i + k < m) ? Sb.at(i + k, k, b) : 0.0f;
#pragma unroll
    for (int j = -BW; j <= BW; ++j) {
      xw[BW + j] = (i + j >= 0 && i + j < m) ? x[static_cast<long>(i + j) * B + b] : 0.0f;
    }
    t[static_cast<long>(i) * B + b] =
        sub(r[static_cast<long>(i) * B + b], band_row<BW>(s, below, xw, i, m));
  }
}

// ----------------------------------------- staged row sources
// A band array staged in shared memory: element (row i, offset k) of this
// thread's home at col[(i·W + k)·hb].  next() is called once per chunk of
// R rows, in the order the sweeps take them, and returns the chunk's first
// row; row lo + q of the chunk is at next() + q·W·hb.

// The whole band, staged at launch; next() first waits until at most WAIT
// copy groups are pending.
template <int WAIT>
struct Whole {
  const float* col;
  __device__ const float* next() const {
    cp_wait<WAIT>();
    return col;
  }
};

// A ring of kRingDepth slots of R rows.  The launch's chunks form one
// stream: the factor takes S ascending; the solve takes L ascending
// (forward), L descending (backward), then per refinement S descending
// (residual), L ascending, L descending.  Stream chunk q lands in slot
// q mod kRingDepth; next() issues chunk p + kRingDepth - 2 into the slot
// that chunk p - 2 held, which is long consumed, then waits for chunk p.
template <int W>
struct Ring {
  float* slots;                 // this thread's column of the ring
  const float *gL, *gS;         // this home's columns in device memory
  int hb, B, m, R, nc, n, p;    // n: chunks in the stream; p: next chunk
  bool solve;

  __device__ void issue(int q) {
    if (q < n) {
      const int s = q / nc, j = q - s * nc;
      // 0: ascending over L (S for the factor); 1: descending over L;
      // 2: descending over S.
      const int kind = !solve ? 0 : s < 2 ? s : ((s - 2) % 3 == 0 ? 2 : (s - 2) % 3 - 1);
      const float* g = (!solve || kind == 2) ? gS : gL;
      const int c = kind == 0 ? j : nc - 1 - j;
      const int lo = c * R, hi = min(lo + R, m);
      float* dst = slots + (q % kRingDepth) * R * W * hb;
#pragma unroll 4
      for (int i = lo; i < hi; ++i) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          cp_async4(dst + ((i - lo) * W + k) * hb, g + static_cast<long>(i * W + k) * B);
        }
      }
    }
    cp_commit();
  }
  __device__ void start() {
    p = 0;
#pragma unroll
    for (int q = 0; q < kRingDepth - 2; ++q) issue(q);
  }
  __device__ const float* next() {
    issue(p + kRingDepth - 2);
    cp_wait<kRingDepth - 2>();
    const float* rows = slots + (p % kRingDepth) * R * W * hb;
    ++p;
    return rows;
  }
};

template <int W>
__device__ __forceinline__ void load_row(float (&v)[W], const float* row, int hb) {
#pragma unroll
  for (int k = 0; k < W; ++k) v[k] = row[k * hb];
}

// ------------------------------------------------- staged sweeps
// Each reads its rows from a staged source, one row ahead of the chain,
// and vectors from shared memory (element i of this thread's column at
// [i·hb]); R is the source's chunk (m for a whole band).

// L ← factor(S), rows ascending; L goes straight to device memory.
template <int BW, class Src>
__device__ void factor_sweep(Src& src, float* __restrict__ gL, int m, int R, int hb, int B) {
  constexpr int W = BW + 1;
  float prev[BW][W];
  chol_init<BW>(prev);
  for (int lo = 0; lo < m; lo += R) {
    const int hi = min(lo + R, m);
    const float* rows = src.next();
    float cur[W];
    load_row<W>(cur, rows, hb);
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
      float nxt[W], row[W];
      load_row<W>(nxt, rows + (min(i + 1, hi - 1) - lo) * W * hb, hb);
      chol_row<BW>(cur, prev, row);
#pragma unroll
      for (int k = 0; k < W; ++k) gL[static_cast<long>(i * W + k) * B] = row[k];
#pragma unroll
      for (int k = 0; k < W; ++k) cur[k] = nxt[k];
    }
  }
}

// y ← L⁻¹ rhs, rows ascending; y may alias rhs (each rhs_i is read before
// y_i is stored).
template <int BW, class Src>
__device__ void forward_sweep(Src& src, const float* rhs, float* y, int m, int R, int hb) {
  constexpr int W = BW + 1;
  float ring[BW] = {};
  for (int lo = 0; lo < m; lo += R) {
    const int hi = min(lo + R, m);
    const float* rows = src.next();
    float cur[W];
    load_row<W>(cur, rows, hb);
    float a = rhs[lo * hb];
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
      const int nx = min(i + 1, hi - 1);
      float nxt[W];
      load_row<W>(nxt, rows + (nx - lo) * W * hb, hb);
      const float an = rhs[nx * hb];
      y[i * hb] = fwd_row<BW>(a, cur, ring, i);
#pragma unroll
      for (int k = 0; k < W; ++k) cur[k] = nxt[k];
      a = an;
    }
  }
}

// d ← L⁻ᵀ y, rows descending, into x (x_i = d_i) or added to it
// (x_i = x_i + d_i); with gx, x also goes to device memory.  The L rows
// below the current one are carried in registers (below[d] = row i+1+d).
template <int BW, class Src>
__device__ void backward_sweep(Src& src, const float* y, float* x, bool accumulate,
                               float* __restrict__ gx, int m, int R, int hb, int B) {
  constexpr int W = BW + 1;
  float ring[BW] = {};
  float below[BW][W] = {};
  const int nc = (m + R - 1) / R;
  for (int c = nc - 1; c >= 0; --c) {
    const int lo = c * R, hi = min(lo + R, m);
    const float* rows = src.next();
    float cur[W];
    load_row<W>(cur, rows + (hi - 1 - lo) * W * hb, hb);
    float a = y[(hi - 1) * hb];
    float xo = accumulate ? x[(hi - 1) * hb] : 0.0f;
#pragma unroll 4
    for (int i = hi - 1; i >= lo; --i) {
      const int nx = max(i - 1, lo);
      float nxt[W];
      load_row<W>(nxt, rows + (nx - lo) * W * hb, hb);
      const float an = y[nx * hb];
      const float xn = accumulate ? x[nx * hb] : 0.0f;
      float bl[BW];
#pragma unroll
      for (int k = 1; k <= BW; ++k) bl[k - 1] = below[k - 1][k];
      const float d = bwd_row<BW>(a, cur[0], bl, ring, i, m);
      const float v = accumulate ? add(xo, d) : d;
      x[i * hb] = v;
      if (gx != nullptr) gx[static_cast<long>(i) * B] = v;
#pragma unroll
      for (int e = BW - 1; e >= 1; --e) {
#pragma unroll
        for (int k = 0; k < W; ++k) below[e][k] = below[e - 1][k];
      }
#pragma unroll
      for (int k = 0; k < W; ++k) {
        below[0][k] = cur[k];
        cur[k] = nxt[k];
      }
      a = an;
      xo = xn;
    }
  }
}

// t ← r − S x, rows descending: the S rows below the current one and the
// window x_{i-bw..i+bw} are carried in registers.
template <int BW, class Src>
__device__ void residual_sweep(Src& src, const float* r, const float* x, float* t, int m, int R,
                               int hb) {
  constexpr int W = BW + 1;
  float below[BW][W] = {};
  float xw[2 * BW + 1];
#pragma unroll
  for (int j = -BW; j <= BW; ++j) {
    const int e = m - 1 + j;
    xw[BW + j] = (e >= 0 && e < m) ? x[e * hb] : 0.0f;
  }
  const int nc = (m + R - 1) / R;
  for (int c = nc - 1; c >= 0; --c) {
    const int lo = c * R, hi = min(lo + R, m);
    const float* rows = src.next();
    float cur[W];
    load_row<W>(cur, rows + (hi - 1 - lo) * W * hb, hb);
    float rr = r[(hi - 1) * hb];
#pragma unroll 4
    for (int i = hi - 1; i >= lo; --i) {
      const int nx = max(i - 1, lo);
      float nxt[W];
      load_row<W>(nxt, rows + (nx - lo) * W * hb, hb);
      const float rn = r[nx * hb];
      const int e = i - 1 - BW;
      const float xe = e >= 0 ? x[e * hb] : 0.0f;
      float bl[BW];
#pragma unroll
      for (int k = 1; k <= BW; ++k) bl[k - 1] = below[k - 1][k];
      t[i * hb] = sub(rr, band_row<BW>(cur, bl, xw, i, m));
#pragma unroll
      for (int q = BW - 1; q >= 1; --q) {
#pragma unroll
        for (int k = 0; k < W; ++k) below[q][k] = below[q - 1][k];
      }
#pragma unroll
      for (int k = 0; k < W; ++k) {
        below[0][k] = cur[k];
        cur[k] = nxt[k];
      }
#pragma unroll
      for (int q = 2 * BW; q >= 1; --q) xw[q] = xw[q - 1];
      xw[0] = xe;
      rr = rn;
    }
  }
}

// x ← solve(r), then `refine` passes of t = r − S x, t ← solve(t), x += t;
// x goes to device memory in the last backward sweep.
template <int BW, class LSrc, class SSrc>
__device__ void solve_sweeps(LSrc& Ls, SSrc& Ss, const float* rs, float* xs, float* ts,
                             float* __restrict__ gx, int m, int R, int hb, int B, int refine) {
  forward_sweep<BW>(Ls, rs, ts, m, R, hb);
  backward_sweep<BW>(Ls, ts, xs, false, refine == 0 ? gx : nullptr, m, R, hb, B);
  for (int p = 0; p < refine; ++p) {
    residual_sweep<BW>(Ss, rs, xs, ts, m, R, hb);
    forward_sweep<BW>(Ls, ts, ts, m, R, hb);
    backward_sweep<BW>(Ls, ts, xs, true, p == refine - 1 ? gx : nullptr, m, R, hb, B);
  }
}

// Copies rows [0, rows) of this home's band column g into col.
template <int W>
__device__ void stage(float* col, const float* g, int rows, int hb, int B) {
  for (int i = 0; i < rows; ++i) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      cp_async4(col + (i * W + k) * hb, g + static_cast<long>(i * W + k) * B);
    }
  }
}

// ------------------------------------------------------------ kernels
// banded_cholesky_t.  One block of hb homes; dynamic shared memory holds
// S (whole, depth 0) or the ring (depth kRingDepth).
template <int BW, int D>
__global__ void __launch_bounds__(kMaxHomes)
chol_kernel(const float* __restrict__ S, float* __restrict__ L, int m, int B, int R) {
  constexpr int W = BW + 1;
  extern __shared__ float smem[];
  const int hb = blockDim.x, tid = threadIdx.x;
  const int b = blockIdx.x * hb + tid;
  if (b >= B) return;
  float* col = smem + tid;
  if constexpr (D == 0) {
    stage<W>(col, S + b, m, hb, B);
    cp_commit();
    Whole<0> src{col};
    factor_sweep<BW>(src, L + b, m, m, hb, B);
  } else {
    const int nc = (m + R - 1) / R;
    Ring<W> src{col, nullptr, S + b, hb, B, m, R, nc, nc, 0, false};
    src.start();
    factor_sweep<BW>(src, L + b, m, R, hb, B);
  }
  cp_wait<0>();
}

// refined_banded_solve_t.  Shared memory: r, x and y/t (m · hb floats
// each), then L and S (whole, depth 0; S only when refine > 0) or the ring.
template <int BW, int D>
__global__ void __launch_bounds__(kMaxHomes)
refined_solve_kernel(const float* __restrict__ L, const float* __restrict__ S,
                     const float* __restrict__ r, float* __restrict__ x, int m, int B, int R,
                     int refine) {
  constexpr int W = BW + 1;
  extern __shared__ float smem[];
  const int hb = blockDim.x, tid = threadIdx.x;
  const int b = blockIdx.x * hb + tid;
  if (b >= B) return;
  float* rs = smem + tid;
  float* xs = rs + m * hb;
  float* ts = xs + m * hb;
  float* band = ts + m * hb;
  for (int i = 0; i < m; ++i) cp_async4(rs + i * hb, r + static_cast<long>(i) * B + b);
  if constexpr (D == 0) {
    stage<W>(band, L + b, m, hb, B);
    cp_commit();                                  // group: r and L
    if (refine > 0) stage<W>(band + m * W * hb, S + b, m, hb, B);
    cp_commit();                                  // group: S (empty at refine 0)
    Whole<1> Ls{band};
    Whole<0> Ss{band + m * W * hb};
    solve_sweeps<BW>(Ls, Ss, rs, xs, ts, x + b, m, m, hb, B, refine);
  } else {
    cp_commit();                                  // group: r
    const int nc = (m + R - 1) / R;
    Ring<W> ring{band, L + b, S + b, hb, B, m, R, nc, nc * (2 + 3 * refine), 0, true};
    ring.start();
    solve_sweeps<BW>(ring, ring, rs, xs, ts, x + b, m, R, hb, B, refine);
  }
  cp_wait<0>();
}

// factor_refined_solve_t: the factor, then the first refined solve, in one
// launch — the thread reuses the factor it has just written (the first
// design).  L, x, y and t are written and re-read inside the launch, so
// none of them is declared __restrict__.
template <int BW>
__global__ void __launch_bounds__(kThreads)
factor_solve_kernel(const float* __restrict__ S, const float* __restrict__ r, float* L,
                    float* x, float* y, float* t, int m, int B, int refine) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  chol_home<BW>(S, L, m, B, b);
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

// Launches kernel over B homes in blocks of hb with smem bytes of dynamic
// shared memory; returns the launch's CUDA error code.
template <class Kernel, class... Args>
int launch_blocks(Kernel kernel, int B, int hb, int smem, cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(B + hb - 1) / hb, hb, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Instantiates LAUNCH with the compile-time constant BW for the runtime
// bandwidth 1..12 (ops/banded.py MAX_BAND), so each kernel's bw² loops
// unroll; LAUNCH evaluates to the launch's CUDA error code.
#define BAND_CASE(N, LAUNCH) \
  case N: {                  \
    constexpr int BW = N;    \
    return LAUNCH;           \
  }
#define BAND_DISPATCH(bw, LAUNCH)                                     \
  switch (bw) {                                                      \
    BAND_CASE(1, LAUNCH) BAND_CASE(2, LAUNCH) BAND_CASE(3, LAUNCH)   \
    BAND_CASE(4, LAUNCH) BAND_CASE(5, LAUNCH) BAND_CASE(6, LAUNCH)   \
    BAND_CASE(7, LAUNCH) BAND_CASE(8, LAUNCH) BAND_CASE(9, LAUNCH)   \
    BAND_CASE(10, LAUNCH) BAND_CASE(11, LAUNCH) BAND_CASE(12, LAUNCH) \
    default: return static_cast<int>(cudaErrorInvalidValue);         \
  }

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns the CUDA error code
// of its launch (0 = success); nothing synchronises, nothing allocates.
// The staged kernels take the plan of ops/band_kernels.band_plan (homes
// per block, ring depth, rows per chunk, shared-memory bytes) and return
// cudaErrorInvalidValue for a plan that is not one of BAND_KERNELS or does
// not match (m, bw).

extern "C" int band_cholesky_t(const float* S, float* L, int m, int bw, int B, int hb,
                               int depth, int rows, int smem, void* stream) {
  if (B == 0) return 0;
  if (!plan_ok(false, m, bw, hb, depth, rows, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BAND_DISPATCH(bw, (depth == 0
                         ? launch_blocks(chol_kernel<BW, 0>, B, hb, smem, s, S, L, m, B, rows)
                         : launch_blocks(chol_kernel<BW, kRingDepth>, B, hb, smem, s, S, L, m,
                                         B, rows)));
}

extern "C" int band_refined_solve_t(const float* L, const float* S, const float* r, float* x,
                                    int m, int bw, int B, int refine, int hb, int depth,
                                    int rows, int smem, void* stream) {
  if (B == 0) return 0;
  if (refine < 0 || !plan_ok(true, m, bw, hb, depth, rows, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BAND_DISPATCH(bw, (depth == 0 ? launch_blocks(refined_solve_kernel<BW, 0>, B, hb, smem, s, L,
                                                S, r, x, m, B, rows, refine)
                                : launch_blocks(refined_solve_kernel<BW, kRingDepth>, B, hb,
                                                smem, s, L, S, r, x, m, B, rows, refine)));
}

extern "C" int band_factor_solve_t(const float* S, const float* r, float* L, float* x,
                                   float* y, float* t, int m, int bw, int B, int refine,
                                   void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BAND_DISPATCH(bw, launch_blocks(factor_solve_kernel<BW>, B, kThreads, 0, s, S, r, L, x, y, t,
                                  m, B, refine));
}
