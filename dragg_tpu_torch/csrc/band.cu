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
// the plain versions, and each other, bit for bit.
//
// What bounds them.  By bytes (bench_band.band_bounds): the factor reads
// S and writes L, 2·m·(bw+1)·B·4 bytes; the refined solve reads L, S and r
// and writes x, (2·m·(bw+1) + 2·m)·B·4; the fused kernel reads S and r and
// writes L and x, the same — at m = 77, bw = 4, B = 1,000: 3.1 MB and
// 3.7 MB, about 1 µs at 3.35 TB/s.  Far above that sits the chain floor:
// the dependent instructions of one row times m, at the SM clock (1.98 GHz
// at most).  Counted from the code with 4 cycles per dependent add or
// multiply, ~36 per divide sequence and ~30 per square root (not
// measured), at bw = 4:
//   factor row: the four divides, each after the products and
//     subtractions that feed it (36 + 44 + 48 + 52), then the diagonal's
//     square and four subtractions (20), the NaN-preserving max (8) and
//     the square root (30): ≈ 238 cycles; m = 77 → ≈ 9.3 µs;
//   forward or backward row: one product on the previous result, four
//     subtractions, one divide: ≈ 56 cycles;
//   residual row (no recurrence, issued in order): ≈ 40 cycles;
//   refined solve at refine 1: 4 · 56 + 40 ≈ 264 cycles a row; m = 77 →
//     ≈ 10.3 µs;
//   fused factor and solve at refine 0: the factor's 238 cycles a row,
//     with the forward row's 56 beside them in another warp, then one
//     backward sweep's 56: ≈ 294 cycles a row (350 with the forward on
//     the factor's chain); m = 77 → ≈ 11.4 µs.
// Measured on an H100 80GB HBM3 card (700 W) over 32 homes, m = 52..149
// (bench_band, chip_smoke.py): 0.21-0.22 µs a factor row and 0.37-0.38 µs
// a refine-1 solve row with the whole band staged, 0.51-0.53 µs through
// the ring (≈ 415-435, 735-750 and 1,010-1,050 cycles at 1.98 GHz), plus
// ≈ 3 µs a launch; the fused kernel at refine 0, 0.335-0.346 µs a row
// (≈ 665-685 cycles), where a factor row and a backward row take ≈ 0.30
// (the split route's refine-0 solve runs ≈ 0.08 µs a sweep row).  The
// chain runs about twice the count above (each divide and square root,
// with its range check and branch, costs more than assumed, and the warp
// issues the row's moves and predicates in order with it), and the
// kernel's time at the main path's batches is that chain: 32 homes a
// block leave most SMs idle at B = 1,000 and still fit one wave at 4,000.
// The first design (one thread per home, 64-thread blocks, no shared
// memory) ran 75 / 124 µs of device time per call at m = 77, B = 1,000:
// every row's loads came from device memory, behind the previous row's
// stores (x aliases t, y is re-read), so each row paid a device-memory
// round trip.
//
// What the design does about it: a block of hb homes stages its rows in
// shared memory, layout [row][k][home] (home fastest: no bank conflicts,
// and the copy from the homes-last device layout is a coalesced stream),
// with cp.async.  Each thread copies only its own home's column, so it
// waits on its own copies (cp.async.wait_group) and needs no barrier.
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
// once.  The fused kernel keeps L on the chip and takes the forward
// substitution off the factor's chain.  With the whole band a block is two
// warps: lane l of the first stages S and factors home l, writing L row i
// over S row i in shared memory once S row i is in registers (refining, L
// goes to an array of its own beside S), and publishes the rows done in a
// progress word (a release store; the reader's loads are acquires); lane
// l of the second stages r and runs the forward substitution a row
// behind, on another scheduler, storing L to device memory on the way,
// then the backward sweep and the refinements, with one vector for r, y
// and x at refine 0.  (In one thread the forward rows did not overlap the
// factor's: the pass took the time of both chains on the card, likely as
// each divide and square root ends in a branch to its slow path, which
// splits the loop into blocks scheduled apart.)  Through the ring,
// one thread runs the passes in turn, and L comes back from device
// memory, where the thread wrote it earlier in the launch: the ring holds
// those copies back until the factor pass has ended and a fence orders
// the stores before them (Ring::release).  Which (hb, depth, R) runs is a
// host-side plan from (m, bw), refine, the batch and the SM count
// (ops/band_kernels.band_plan: the fewest waves of blocks, then the whole
// band, then the larger block — every plan gives the same bits); the
// entry points validate it against BAND_KERNELS and BAND_SMEM and refuse
// any other.

#include <cuda_runtime.h>

namespace {

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

// The staged kernels, in the order of ops/band_kernels.KERNEL_NAMES.
enum Kernel { kCholesky = 0, kSolve = 1, kFactorSolve = 2 };

// What a block holds in shared memory (ops/band_kernels.SMEM_TERMS), per
// (kernel, refine > 0): band arrays staged whole, vectors of m floats and
// single words, each per home.  The factor: S.  The solve: L and S (S
// filled only when refining); r, x and y/t.  The fused kernel: S, turning
// into L row by row, one vector (r, then y, then x) and the factor's
// progress word; refining, L and S apart, r, x and y/t, and the word.  A
// ring holds depth · R rows of one array in place of the whole arrays.
#define BAND_SMEM(X)  \
  X(0, 0, 1, 0, 0)    \
  X(0, 1, 1, 0, 0)    \
  X(1, 0, 2, 3, 0)    \
  X(1, 1, 2, 3, 0)    \
  X(2, 0, 1, 1, 1)    \
  X(2, 1, 2, 3, 1)

// Shared-memory bytes of a plan (ops/band_kernels.band_smem), or -1
// beyond one block's.
int plan_smem(int kernel, int m, int bw, int hb, int depth, int rows, int refine) {
  long arrays = -1, vecs = 0, words = 0;
#define DRAGG_BAND_SMEM(K, F, A, V, E) \
  if (kernel == K && (refine > 0) == F) arrays = A, vecs = V, words = E;
  BAND_SMEM(DRAGG_BAND_SMEM)
#undef DRAGG_BAND_SMEM
  if (arrays < 0) return -1;
  const long band_rows = depth == 0 ? arrays * m : static_cast<long>(depth) * rows;
  const long bytes = 4L * hb * (band_rows * (bw + 1) + vecs * m + words);
  return bytes > kMaxSmem ? -1 : static_cast<int>(bytes);
}

bool plan_ok(int kernel, int m, int bw, int hb, int depth, int rows, int smem, int refine) {
  if (refine < 0 || !plan_accepted(hb, depth)) return false;
  if (depth == 0 ? rows != m : (rows < 1 || rows > m)) return false;
  return smem >= 0 && smem == plan_smem(kernel, m, bw, hb, depth, rows, refine);
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

// A home's progress word in shared memory, passed from one thread to
// another: the release store orders this thread's earlier shared-memory
// stores before it, the acquire load the reader's later loads after it.
__device__ __forceinline__ void publish(int* word, int v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(word));
  asm volatile("st.release.cta.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ int observe(const int* word) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(word));
  int v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
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
// (residual), L ascending, L descending; the fused kernel takes S
// ascending (factor and forward), then as the solve from its backward
// sweep on.  Stream chunk q lands in slot q mod kRingDepth; next() issues
// chunk p + kRingDepth - 2 into the slot that chunk p - 2 held, which is
// long consumed, then waits for chunk p.  Chunks from `hold` on read L
// that this launch writes: they are issued only by release(), once it
// has been written.
template <int W>
struct Ring {
  float* slots;                 // this thread's column of the ring
  const float *gL, *gS;         // this home's columns in device memory
  int hb, B, m, R, nc, n, p;    // n: chunks in the stream; p: next chunk
  bool s_first;                 // chunk set 0 streams S (else L)
  int hold;                     // first chunk held back until release()

  __device__ void issue(int q) {
    if (q < n && q < hold) {
      const int s = q / nc, j = q - s * nc;
      // 0: ascending; 1: descending over L; 2: descending over S.
      const int kind = s < 2 ? s : ((s - 2) % 3 == 0 ? 2 : (s - 2) % 3 - 1);
      const float* g = (kind == 2 || (s == 0 && s_first)) ? gS : gL;
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
  // Issues the held chunks that next() has passed over, after a fence
  // that orders this thread's stores of L before the copies that read it
  // back; each passed chunk committed an empty group, so the groups stay
  // in stream order for cp.async.wait_group.
  __device__ void release() {
    __threadfence();
    const int from = hold;
    hold = n;
    for (int q = from; q < p + kRingDepth - 2; ++q) issue(q);
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

// L ← factor(S), rows ascending, to device memory; with SHARE (the
// whole band, R = m), to Ls in the source's layout instead, each row's
// progress published after it.  Ls may be the source's own rows, as row i
// is stored after row i and the look-ahead row i+1 are loaded.  Nothing
// goes to device memory then, so the release store waits on no global
// store.
template <int BW, bool SHARE, class Src>
__device__ void factor_sweep(Src& src, float* __restrict__ gL, int m, int R, int hb, int B,
                             float* Ls = nullptr, int* progress = nullptr) {
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
      if constexpr (SHARE) {
#pragma unroll
        for (int k = 0; k < W; ++k) Ls[(i * W + k) * hb] = row[k];
        publish(progress, i + 1);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) gL[static_cast<long>(i * W + k) * B] = row[k];
      }
#pragma unroll
      for (int k = 0; k < W; ++k) cur[k] = nxt[k];
    }
  }
}

// y ← L⁻¹ rhs, rows ascending, each row once the factor's thread has
// published it (L whole in Ls), which also goes to device memory from
// here; y may alias rhs.  While it waits, the thread sleeps, leaving its
// scheduler's issue slots to the factor.
template <int BW>
__device__ void forward_behind(const float* Ls, const int* progress, float* __restrict__ gL,
                               const float* rhs, float* y, int m, int hb, int B) {
  constexpr int W = BW + 1;
  float ring[BW] = {};
  int ready = 0;
  for (int i = 0; i < m; ++i) {
    while (ready <= i) {
      ready = observe(progress);
      if (ready <= i) __nanosleep(20);
    }
    float l[W];
    load_row<W>(l, Ls + i * W * hb, hb);
#pragma unroll
    for (int k = 0; k < W; ++k) gL[static_cast<long>(i * W + k) * B] = l[k];
    y[i * hb] = fwd_row<BW>(rhs[i * hb], l, ring, i);
  }
}

// L ← factor(S) and y ← L⁻¹ rhs in one ascending pass of one thread (the
// ring plan); L goes to device memory.  y may alias rhs.
template <int BW, class Src>
__device__ void factor_forward_sweep(Src& src, float* gL, const float* rhs, float* y, int m,
                                     int R, int hb, int B) {
  constexpr int W = BW + 1;
  float prev[BW][W];
  chol_init<BW>(prev);
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
      float nxt[W], row[W];
      load_row<W>(nxt, rows + (nx - lo) * W * hb, hb);
      const float an = rhs[nx * hb];
      chol_row<BW>(cur, prev, row);
#pragma unroll
      for (int k = 0; k < W; ++k) gL[static_cast<long>(i * W + k) * B] = row[k];
      y[i * hb] = fwd_row<BW>(a, row, ring, i);
#pragma unroll
      for (int k = 0; k < W; ++k) cur[k] = nxt[k];
      a = an;
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

// The backward sweep of a first solve whose forward sweep left y in ts,
// into xs, then `refine` passes of t = r − S x, t ← solve(t), x += t; x
// goes to device memory in the last backward sweep.
template <int BW, class LSrc, class SSrc>
__device__ void solve_tail(LSrc& Ls, SSrc& Ss, const float* rs, float* xs, float* ts,
                           float* __restrict__ gx, int m, int R, int hb, int B, int refine) {
  backward_sweep<BW>(Ls, ts, xs, false, refine == 0 ? gx : nullptr, m, R, hb, B);
  for (int p = 0; p < refine; ++p) {
    residual_sweep<BW>(Ss, rs, xs, ts, m, R, hb);
    forward_sweep<BW>(Ls, ts, ts, m, R, hb);
    backward_sweep<BW>(Ls, ts, xs, true, p == refine - 1 ? gx : nullptr, m, R, hb, B);
  }
}

// x ← solve(r), then `refine` refinement passes.
template <int BW, class LSrc, class SSrc>
__device__ void solve_sweeps(LSrc& Ls, SSrc& Ss, const float* rs, float* xs, float* ts,
                             float* __restrict__ gx, int m, int R, int hb, int B, int refine) {
  forward_sweep<BW>(Ls, rs, ts, m, R, hb);
  solve_tail<BW>(Ls, Ss, rs, xs, ts, gx, m, R, hb, B, refine);
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
    factor_sweep<BW, false>(src, L + b, m, m, hb, B);
  } else {
    const int nc = (m + R - 1) / R;
    Ring<W> src{col, nullptr, S + b, hb, B, m, R, nc, nc, 0, true, nc};
    src.start();
    factor_sweep<BW, false>(src, L + b, m, R, hb, B);
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
    const int n = nc * (2 + 3 * refine);
    Ring<W> ring{band, L + b, S + b, hb, B, m, R, nc, n, 0, false, n};
    ring.start();
    solve_sweeps<BW>(ring, ring, rs, xs, ts, x + b, m, R, hb, B, refine);
  }
  cp_wait<0>();
}

// factor_refined_solve_t: the factor, the forward and backward
// substitutions and `refine` refinement passes in one launch.  Shared
// memory, per home: r, which at refine 0 becomes y and then x (or r, x
// and y/t when refining), then the whole band (S, turned into L row by
// row; refining, L then S) or the ring, then the factor's progress word.
// With the whole band (D = 0) a block is two warps: lane l of warp 0
// stages S and factors home l, storing each L row in shared memory and
// publishing it; lane l of warp 1 stages r and runs the forward
// substitution a row behind, on another scheduler's issue slots (storing
// L to device memory on the way), then the backward sweep and the
// refinements.  Through the ring, one thread runs
// the passes in turn (factor_forward_sweep, then solve_tail).  L is re-read
// inside the launch, so it is not declared __restrict__.
template <int BW, int D>
__global__ void __launch_bounds__(D == 0 ? 2 * kMaxHomes : kMaxHomes)
factor_solve_kernel(const float* __restrict__ S, const float* __restrict__ r, float* L,
                    float* __restrict__ x, int m, int B, int R, int refine, int hb) {
  constexpr int W = BW + 1;
  extern __shared__ float smem[];
  const int lane = D == 0 ? threadIdx.x % kMaxHomes : threadIdx.x;
  const int b = blockIdx.x * hb + lane;
  float* rs = smem + lane;
  float* xs = refine > 0 ? rs + m * hb : rs;
  float* ts = refine > 0 ? xs + m * hb : rs;
  float* band = (refine > 0 ? ts : rs) + m * hb;
  if constexpr (D == 0) {
    float* Sc = refine > 0 ? band + m * W * hb : band;
    int* progress = reinterpret_cast<int*>(Sc + m * W * hb);   // this home's word
    const bool factor = threadIdx.x < kMaxHomes;
    if (factor && lane < hb) *progress = 0;
    __syncthreads();                              // before any thread leaves
    if (lane >= hb || b >= B) return;
    Whole<0> Ss{Sc}, Ls{band};
    if (factor) {
      stage<W>(Sc, S + b, m, hb, B);
      cp_commit();
      factor_sweep<BW, true>(Ss, nullptr, m, m, hb, B, band, progress);
    } else {
      for (int i = 0; i < m; ++i) cp_async4(rs + i * hb, r + static_cast<long>(i) * B + b);
      cp_commit();
      cp_wait<0>();
      forward_behind<BW>(band, progress, L + b, rs, ts, m, hb, B);
      solve_tail<BW>(Ls, Ss, rs, xs, ts, x + b, m, m, hb, B, refine);
    }
  } else {
    if (b >= B) return;
    for (int i = 0; i < m; ++i) cp_async4(rs + i * hb, r + static_cast<long>(i) * B + b);
    cp_commit();                                  // group: r
    const int nc = (m + R - 1) / R;
    Ring<W> ring{band, L + b, S + b, hb, B, m, R, nc, nc * (2 + 3 * refine), 0, true, nc};
    ring.start();
    factor_forward_sweep<BW>(ring, L + b, rs, ts, m, R, hb, B);
    ring.release();
    solve_tail<BW>(ring, ring, rs, xs, ts, x + b, m, R, hb, B, refine);
  }
  cp_wait<0>();
}

// Launches kernel over B homes in blocks of hb homes and `threads`
// threads with smem bytes of dynamic shared memory; returns the launch's
// CUDA error code.
template <class Kernel, class... Args>
int launch_blocks(Kernel kernel, int B, int hb, int threads, int smem, cudaStream_t s,
                  Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(B + hb - 1) / hb, threads, smem, s>>>(args...);
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
// Each takes the plan of ops/band_kernels.band_plan (homes per block,
// ring depth, rows per chunk, shared-memory bytes) and returns
// cudaErrorInvalidValue for a plan that is not one of BAND_KERNELS or does
// not match (m, bw, refine).

extern "C" int band_cholesky_t(const float* S, float* L, int m, int bw, int B, int hb,
                               int depth, int rows, int smem, void* stream) {
  if (B == 0) return 0;
  if (!plan_ok(kCholesky, m, bw, hb, depth, rows, smem, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BAND_DISPATCH(bw, (depth == 0
                         ? launch_blocks(chol_kernel<BW, 0>, B, hb, hb, smem, s, S, L, m, B,
                                         rows)
                         : launch_blocks(chol_kernel<BW, kRingDepth>, B, hb, hb, smem, s, S, L,
                                         m, B, rows)));
}

extern "C" int band_refined_solve_t(const float* L, const float* S, const float* r, float* x,
                                    int m, int bw, int B, int refine, int hb, int depth,
                                    int rows, int smem, void* stream) {
  if (B == 0) return 0;
  if (!plan_ok(kSolve, m, bw, hb, depth, rows, smem, refine)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BAND_DISPATCH(bw, (depth == 0 ? launch_blocks(refined_solve_kernel<BW, 0>, B, hb, hb, smem, s,
                                                L, S, r, x, m, B, rows, refine)
                                : launch_blocks(refined_solve_kernel<BW, kRingDepth>, B, hb,
                                                hb, smem, s, L, S, r, x, m, B, rows, refine)));
}

extern "C" int band_factor_solve_t(const float* S, const float* r, float* L, float* x, int m,
                                   int bw, int B, int refine, int hb, int depth, int rows,
                                   int smem, void* stream) {
  if (B == 0) return 0;
  if (!plan_ok(kFactorSolve, m, bw, hb, depth, rows, smem, refine)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BAND_DISPATCH(bw, (depth == 0 ? launch_blocks(factor_solve_kernel<BW, 0>, B, hb, 2 * kMaxHomes,
                                                smem, s, S, r, L, x, m, B, rows, refine, hb)
                                : launch_blocks(factor_solve_kernel<BW, kRingDepth>, B, hb, hb,
                                                smem, s, S, r, L, x, m, B, rows, refine, hb)));
}
