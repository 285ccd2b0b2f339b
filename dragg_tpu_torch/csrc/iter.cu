// One check window of the ReLU-QP solver, fused into one kernel launch,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of dragg_tpu/ops/pallas_iter.py:
//   fused_window ← _fused_window_t (:180; pallas_call at :226) / _iter_kernel
//
// For each home independently, k times (D = Dinv, Â the Ruiz-scaled dense
// equality matrix (m, n), S⁻¹ the home's selected rho-bank inverse (m, m)):
//
//   rhs = σx − q̂ + w∘(ρz − y)
//   t   = Â(D∘rhs) − b̂              (Âv)
//   ν   = S⁻¹t                      (S⁻¹t)
//   x̃   = D∘(rhs − Âᵀν)             (Âᵀν)
//   x  ← αx̃ + (1−α)x
//   zc  = αw∘x̃ + (1−α)z
//   z  ← clip(zc + y/ρ, l, u)
//   y  += ρ(zc − z)
//
// then Âx and Âᵀν once more and the four residual maxima (r_prim, r_dual,
// p_sc, d_sc) of ops/reluqp.py's check.  Only (x, z, ν, y) and the four
// (B,) scalars are written.  Same function as the plain PyTorch version
// (ops/iter_kernels.fused_window_plain, a port of reference_window); the
// dot products are fused multiply-adds summed in another order, so the two
// agree to float32 rounding of the sums, not bit for bit.  ν is state the
// window returns, so ÂᵀS⁻¹ is never folded into one operator.
//
// What bounds it.  Per window a home reads Â and S⁻¹ once (4(mn + m²)
// bytes) and does k(4mn + 2m²) + 4mn float32 operations: at the main
// path's four buckets (H = 24, k = 25) 0.174 ms by bytes and 0.163 ms by
// operations in all, on an H100.  Reading Â from shared memory twice per
// iteration moves 21.1 GB through shared memory per set of four bucket
// windows, ≈ 0.7 ms at ~30 TB/s (128 B/clk/SM, 132 SMs, 1.755 GHz): the
// floor of any design that keeps Â in shared memory.  Only S⁻¹ has to go
// through shared memory (3.35 GB, ≈ 0.11 ms) when each thread holds its
// share of Â in registers.
//
// The design.  A block of T threads (W = T/32 warps) per home, or a
// cluster of CL blocks per home where the home's operators exceed one
// block's 227 KB.  Slab ownership, one layout for all three products:
// warp w of cluster rank q owns the R rows q·W·R + w·R + [0, R) of Â and
// S⁻¹; lane l owns the columns j ≡ l (mod 32).
//   Âv:   each lane keeps R row partials (R independent FMA chains over
//         its C columns), and the warp reduces the R sums together by a
//         transpose-reduce over shuffles (R − 1 + 5 − log2 R shuffles for
//         R a power of two, not 5R), so shuffle latency is paid per slab.
//   S⁻¹t: the same on the warp's R rows of S⁻¹ (from shared memory); the
//         row totals ν of the slab stay with the warp that needs them.
//   Âᵀν:  each lane sums its slab's rows for its C columns (C independent
//         chains of R FMAs) into a (W, 32C) buffer of column partials;
//         after a barrier, thread j sums the W partials (of every rank of
//         the cluster, in rank order, through distributed shared memory).
// No thread runs an m-long dependent chain.  The slab of Â a lane reads
// for Âv is exactly the one it reads for Âᵀν: where that tile fits
// (R·C = 35 floats at m = 52, 70 at m = 77, the H = 24 buckets) it is held
// in registers for the whole window and Â never enters shared memory:
// four 256-thread homes per SM at m = 52 (32 warps), two at m = 77 (16
// warps; a 512-thread, 35-float tile giving 32 warps measured slower on
// the H100, PERF.md).  Elsewhere Â is read from shared memory, its rows
// zero-padded to 32C columns.  Three barriers per iteration (v ready; t
// ready; column partials ready), cluster-wide where CL > 1, where t's and
// the partials' slabs are read from the other ranks' shared memory.  The
// instantiation's C, CS and W·R may exceed the home's: padded columns are
// zero, rows beyond m are skipped, so one instantiation serves a range of
// shapes.
//
// Which instantiation runs is a host-side plan (ops/iter_kernels
// .window_plan: threads, rows per warp, column groups, cluster size,
// register tile, blocks per SM, dynamic shared memory bytes); the entry
// point validates the plan against WINDOW_KERNELS and refuses any other.
//
// Why not tensor cores: each product is a per-home matvec with one
// right-hand side and homes share no matrix.  wgmma's narrowest tile is
// N = 8, so 7/8 of its work would be padding, 77 rows pad to 128, and
// float32 accuracy needs 3xTF32: ≈ 495/8/3 × 77/128 ≈ 12 TFLOP/s at best,
// against 67 TFLOP/s of float32 FMA on the CUDA cores; TF32 alone would
// not meet the window's float64 accuracy check.
//
// Layout: batch first, as the solver holds the arrays — Â (B, m, n),
// S⁻¹ (B, m, m), vectors (B, n) or (B, m), ρ (B,), all float32 and
// contiguous; grid = B·CL.  A home's result depends only on its inputs:
// no atomics, no sum across homes, so any slice of homes reproduces the
// full batch bit for bit.
//
// Arithmetic: the contractions are __fmaf_rn (honoured under the build's
// -fmad=false); the elementwise work is explicitly rounded intrinsics, as
// the plain version rounds it; max is NaN-propagating, as torch.amax.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

// The instantiations, in the order ops/iter_kernels.KERNELS lists them:
// (threads, rows per warp R, column groups C of Â, column groups CS of S⁻¹,
//  cluster size, Â in registers, blocks per SM).
#define WINDOW_KERNELS(X)          \
  X(256, 4, 2, 1, 1, 1, 4)         \
  X(256, 7, 4, 2, 1, 1, 4)         \
  X(256, 7, 5, 2, 1, 1, 4)         \
  X(256, 10, 7, 3, 1, 1, 2)        \
  X(512, 7, 10, 4, 1, 0, 1)        \
  X(256, 10, 14, 5, 2, 0, 1)

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB: a block's dynamic shared memory on sm_90
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int log2c(int v) { return v <= 1 ? 0 : 1 + log2c(v / 2); }
__host__ __device__ constexpr int pow2c(int v) { return v <= 1 ? 1 : 2 * pow2c((v + 1) / 2); }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// NaN-propagating max / min (jnp.maximum, torch.maximum).
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float absmax(float acc, float v) { return maxp(acc, fabsf(v)); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = maxp(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Transpose-reduce: N per-lane values (N a power of two) summed over the
// warp.  Each step halves the values a lane holds, trading the half it
// gives up with the lane O apart; when one is left, a butterfly finishes
// the sum.  Lane l ends with the total of value l >> (5 − log2 N).
template <int N, int O>
__device__ __forceinline__ void fold(float* v, int lane) {
  if constexpr (N > 1) {
    constexpr int h = N / 2;
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = add(keep, __shfl_xor_sync(kFull, send, O));
    }
    fold<h, O / 2>(v, lane);
  } else if constexpr (O > 0) {
    v[0] = add(v[0], __shfl_xor_sync(kFull, v[0], O));
    fold<1, O / 2>(v, lane);
  }
}

struct WindowArgs {
  const float *A, *Sinv, *Dinv, *w, *qs, *bs, *ls, *us, *rho;
  const float *x0, *z0, *nu0, *y0, *eeq, *ebox, *cd, *pd;
  float *xo, *zo, *nuo, *yo, *rp, *rd, *ps, *ds;
  int m, n, k;
  float sigma, alpha, beta;
};

template <int T, int R, int C, int CS, int CL, bool REGS, int MINB>
__global__ void __launch_bounds__(T, MINB) fused_window_kernel(const WindowArgs a) {
  constexpr int W = T / 32, WR = W * R, RP = pow2c(R), SHIFT = 5 - log2c(RP);
  constexpr int NPC = 32 * C, MP = 32 * CS;
  extern __shared__ float smem[];
  const int m = a.m, n = a.n, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int rank = 0;
  if constexpr (CL > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const long b = blockIdx.x / CL;
  const int rb = rank * WR;                        // first row of this block's slab
  const int mb = max(0, min(WR, m - rb));          // rows of this block
  const int rw = rb + warp * R;                    // first row of this warp
  const int rv = max(0, min(R, m - rw));           // rows of this warp
  const int rows_alloc = min(WR, m);               // the largest slab (rank 0)
  // The lane that writes row r of the warp's slab after a fold.
  const int my_row = lane >> SHIFT;
  const bool writer = (lane & ((1 << SHIFT) - 1)) == 0 && my_row < rv;

  float* S_s = smem;                                         // (mb, m)
  float* A_s = S_s + rows_alloc * m;                         // (mb, NPC) unless REGS
  float* P_s = A_s + (REGS ? 0 : rows_alloc * NPC);          // (W, NPC) Âᵀν partials
  float* x_s = P_s + W * NPC;                                // n-vectors, zero-padded
  float* z_s = x_s + NPC;
  float* y_s = z_s + NPC;
  float* dinv_s = y_s + NPC;
  float* w_s = dinv_s + NPC;
  float* qs_s = w_s + NPC;
  float* ls_s = qs_s + NPC;
  float* us_s = ls_s + NPC;
  float* rhs_s = us_s + NPC;
  float* v_s = rhs_s + NPC;                                  // D∘rhs
  float* t_s = v_s + NPC;                                    // (MP) t, later Âx; own rows
  float* bs_s = t_s + MP;                                    // (m)
  float* nu_s = bs_s + m;                                    // (m) own rows
  float* red = nu_s + m;                                     // (5, W) + 5

  // --- Stage the home's operators and vectors once.
  const float* Ab = a.A + b * m * n;
  const float* Sb = a.Sinv + b * m * m + static_cast<long>(rb) * m;
  for (int e = tid; e < mb * m; e += T) S_s[e] = Sb[e];
  if constexpr (!REGS) {  // rows zero-padded to 32C columns
    for (int i = warp; i < mb; i += W) {
      for (int j = lane; j < NPC; j += 32) {
        A_s[i * NPC + j] = j < n ? Ab[static_cast<long>(rb + i) * n + j] : 0.0f;
      }
    }
  }
  float tile[REGS ? R : 1][REGS ? C : 1];
  if constexpr (REGS) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = lane + 32 * c;
        tile[r][c] = (r < rv && j < n) ? Ab[static_cast<long>(rw + r) * n + j] : 0.0f;
      }
    }
  }
  const long vn = b * n, vm = b * m;
  for (int j = tid; j < NPC; j += T) {
    const bool in = j < n;
    x_s[j] = in ? a.x0[vn + j] : 0.0f;
    z_s[j] = in ? a.z0[vn + j] : 0.0f;
    y_s[j] = in ? a.y0[vn + j] : 0.0f;
    dinv_s[j] = in ? a.Dinv[vn + j] : 0.0f;
    w_s[j] = in ? a.w[vn + j] : 0.0f;
    qs_s[j] = in ? a.qs[vn + j] : 0.0f;
    ls_s[j] = in ? a.ls[vn + j] : 0.0f;
    us_s[j] = in ? a.us[vn + j] : 0.0f;
    v_s[j] = 0.0f;
  }
  for (int i = tid; i < MP; i += T) t_s[i] = 0.0f;
  for (int i = tid; i < m; i += T) {
    bs_s[i] = a.bs[vm + i];
    nu_s[i] = a.nu0[vm + i];
  }
  const float r = a.rho[b];

  // t and the column partials of every rank of the cluster (rank order).
  const float* t_q[CL];
  const float* P_q[CL];
#pragma unroll
  for (int q = 0; q < CL; ++q) {
    if constexpr (CL > 1) {
      t_q[q] = q == rank ? t_s : cg::this_cluster().map_shared_rank(t_s, q);
      P_q[q] = q == rank ? P_s : cg::this_cluster().map_shared_rank(P_s, q);
    } else {
      t_q[q] = t_s;
      P_q[q] = P_s;
    }
  }
  auto sync_all = [] {
    if constexpr (CL > 1) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  };

  // Â[row, j] of this warp's slab: row r, column group c (zero outside).
  auto a_at = [&](int rr, int c) -> float {
    if constexpr (REGS) {
      return tile[REGS ? rr : 0][REGS ? c : 0];
    } else {
      return A_s[(warp * R + rr) * NPC + lane + 32 * c];
    }
  };
  // Σ_j Â[row, j] vec[j] over this warp's rows; lane l returns row l >> SHIFT.
  auto a_rows = [&](const float* vec) -> float {
    float acc[RP];
#pragma unroll
    for (int rr = 0; rr < RP; ++rr) acc[rr] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float vj = vec[lane + 32 * c];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        if (REGS || rr < rv) acc[rr] = fma_(a_at(rr, c), vj, acc[rr]);
      }
    }
    fold<RP, 16>(acc, lane);
    return acc[0];
  };
  // Σ_j S⁻¹[row, j] t[j] over this warp's rows, t read from its owners.
  auto s_rows = [&]() -> float {
    float acc[RP];
#pragma unroll
    for (int rr = 0; rr < RP; ++rr) acc[rr] = 0.0f;
#pragma unroll
    for (int c = 0; c < CS; ++c) {
      const int j = lane + 32 * c;
      if (j < m) {
        const float* tp = t_q[0];
#pragma unroll
        for (int q = 1; q < CL; ++q) {
          if (j >= q * WR) tp = t_q[q];
        }
        const float tj = tp[j];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          if (rr < rv) acc[rr] = fma_(S_s[(warp * R + rr) * m + j], tj, acc[rr]);
        }
      }
    }
    fold<RP, 16>(acc, lane);
    return acc[0];
  };
  // Column partials Σ_{rows of the slab} Â[row, j] ν[row] into P_s[warp].
  auto a_cols = [&]() {
    float nv[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) nv[rr] = rr < rv ? nu_s[rw + rr] : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float p = 0.0f;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        if (REGS || rr < rv) p = fma_(a_at(rr, c), nv[rr], p);
      }
      P_s[warp * NPC + lane + 32 * c] = p;
    }
  };
  // (Âᵀν)[j]: the W partials of every rank, in rank order, into four
  // running sums (partial i into sum i mod 4) added pairwise at the end.
  auto col_total = [&](int j) -> float {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < CL; ++q) {
#pragma unroll
      for (int ww = 0; ww < W; ++ww) s[ww % 4] = add(s[ww % 4], P_q[q][ww * NPC + j]);
    }
    return add(add(s[0], s[1]), add(s[2], s[3]));
  };

  for (int j = tid; j < n; j += T) {
    // rhs = (σx − q̂) + w(ρz − y)
    const float rhs = add(sub(mul(a.sigma, x_s[j]), qs_s[j]),
                          mul(w_s[j], sub(mul(r, z_s[j]), y_s[j])));
    rhs_s[j] = rhs;
    v_s[j] = mul(dinv_s[j], rhs);
  }
  __syncthreads();

  for (int it = 0; it < a.k; ++it) {
    const float tr = a_rows(v_s);                    // t = Â(D∘rhs) − b̂
    if (writer) t_s[rw + my_row] = sub(tr, bs_s[rw + my_row]);
    sync_all();
    const float nr = s_rows();                       // ν = S⁻¹t
    if (writer) nu_s[rw + my_row] = nr;
    __syncwarp();
    a_cols();                                        // Âᵀν, by slab
    sync_all();
    const bool more = it + 1 < a.k;
    for (int j = tid; j < n; j += T) {
      const float rhs = rhs_s[j];
      const float xt = mul(dinv_s[j], sub(rhs, col_total(j)));
      const float zt = mul(w_s[j], xt);
      const float z = z_s[j], y = y_s[j];
      const float x = add(mul(a.alpha, xt), mul(a.beta, x_s[j]));
      const float zc = add(mul(a.alpha, zt), mul(a.beta, z));
      const float zn = minp(maxp(add(zc, dvd(y, r)), ls_s[j]), us_s[j]);
      const float yn = add(y, mul(r, sub(zc, zn)));
      x_s[j] = x;
      z_s[j] = zn;
      y_s[j] = yn;
      if (more) {
        const float rhs2 = add(sub(mul(a.sigma, x), qs_s[j]), mul(w_s[j], sub(mul(r, zn), yn)));
        rhs_s[j] = rhs2;
        v_s[j] = mul(dinv_s[j], rhs2);
      }
    }
    __syncthreads();
  }

  // --- Residual maxima (ops/reluqp.py residuals), f32.
  const float ax = a_rows(x_s);                      // Âx, own rows
  if (writer) t_s[rw + my_row] = ax;
  sync_all();  // no rank still reads this block's partials of the last iteration
  a_cols();
  sync_all();
  float a_peq = 0.0f, a_pbox = 0.0f, a_dual = 0.0f, a_psc = 0.0f, a_dsc = 0.0f;
  for (int i = rb + tid; i < rb + mb; i += T) {
    const float e = a.eeq[vm + i], axi = t_s[i];
    a_peq = absmax(a_peq, dvd(sub(axi, bs_s[i]), e));
    a_psc = absmax(absmax(a_psc, dvd(axi, e)), dvd(bs_s[i], e));
    a.nuo[vm + i] = nu_s[i];
  }
  if (rank == 0) {
    for (int j = tid; j < n; j += T) {
      const float eb = a.ebox[vn + j], c = a.cd[vn + j];
      const float x = x_s[j], z = z_s[j], y = y_s[j], atnu = col_total(j);
      const float wx = mul(w_s[j], x), wy = mul(w_s[j], y);
      a_pbox = absmax(a_pbox, dvd(sub(wx, z), eb));
      // dual = (p_diag x + q̂ + Âᵀν + w y) / (c d)
      a_dual = absmax(a_dual, dvd(add(add(add(mul(a.pd[vn + j], x), qs_s[j]), atnu), wy), c));
      a_psc = absmax(absmax(a_psc, dvd(wx, eb)), dvd(z, eb));
      a_dsc = absmax(absmax(absmax(a_dsc, dvd(atnu, c)), dvd(wy, c)), dvd(qs_s[j], c));
      a.xo[vn + j] = x;
      a.zo[vn + j] = z;
      a.yo[vn + j] = y;
    }
  }
  a_peq = warp_max(a_peq);
  a_pbox = warp_max(a_pbox);
  a_dual = warp_max(a_dual);
  a_psc = warp_max(a_psc);
  a_dsc = warp_max(a_dsc);
  if (lane == 0) {
    red[0 * W + warp] = a_peq;
    red[1 * W + warp] = a_pbox;
    red[2 * W + warp] = a_dual;
    red[3 * W + warp] = a_psc;
    red[4 * W + warp] = a_dsc;
  }
  __syncthreads();
  float* fin = red + 5 * W;  // this block's five maxima
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      float q = red[c * W];
      for (int i = 1; i < W; ++i) q = maxp(q, red[c * W + i]);
      fin[c] = q;
    }
  }
  if constexpr (CL > 1) cg::this_cluster().sync();
  if (rank == 0 && tid == 0) {
    float q[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) q[c] = fin[c];
#pragma unroll
    for (int p = 1; p < CL; ++p) {
      const float* f = cg::this_cluster().map_shared_rank(fin, p);
#pragma unroll
      for (int c = 0; c < 5; ++c) q[c] = maxp(q[c], f[c]);
    }
    a.rp[b] = maxp(q[0], q[1]);
    a.rd[b] = q[2];
    a.ps[b] = q[3];
    a.ds[b] = q[4];
  }
  // A block's shared memory must outlive the other ranks' reads of it.
  if constexpr (CL > 1) cg::this_cluster().sync();
}

// Dynamic shared memory of one block (ops/iter_kernels.window_smem).
long smem_bytes(int T, int R, int C, int CS, bool regs, int m, int n) {
  const long W = T / 32, rows = std::min<long>(W * R, m), npc = 32L * C;
  return 4 * (rows * m + (regs ? 0 : rows * npc) + W * npc + 10 * npc + 32L * CS + 2L * m +
              5 * W + 5);
}

template <int T, int R, int C, int CS, int CL, bool REGS, int MINB>
int launch_window(const WindowArgs& a, int B, int smem, cudaStream_t stream) {
  const int m = a.m, n = a.n;
  const bool covers = m >= 1 && n >= 1 && a.k >= 0 && (T / 32) * R * CL >= m &&
                      32 * C >= n && 32 * CS >= m;
  if (!covers || smem != smem_bytes(T, R, C, CS, REGS, m, n) || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = fused_window_kernel<T, R, C, CS, CL, REGS, MINB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * CL);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One window over B homes with the plan (threads, rows, cols, scols,
// cluster, regs, blocks_per_sm, smem) of ops/iter_kernels.window_plan;
// returns a CUDA error code, cudaErrorInvalidValue for a plan that is not
// one of WINDOW_KERNELS or does not cover (m, n).
int fused_window(const float* A, const float* Sinv, const float* Dinv, const float* w,
                 const float* qs, const float* bs, const float* ls, const float* us,
                 const float* rho, const float* x, const float* z, const float* nu,
                 const float* y, const float* eeq, const float* ebox, const float* cd,
                 const float* pd, float* xo, float* zo, float* nuo, float* yo, float* rp,
                 float* rd, float* ps, float* ds, int B, int m, int n, int k,
                 double sigma, double alpha, int threads, int rows, int cols, int scols,
                 int cluster, int regs, int blocks_per_sm, int smem, cudaStream_t stream) {
  // 1 − α is formed in double and rounded once, as Python forms it.
  const WindowArgs a{A,  Sinv, Dinv, w,  qs, bs, ls, us, rho, x,  z,  nu, y,
                     eeq, ebox, cd,  pd, xo, zo, nuo, yo, rp, rd, ps, ds, m,  n,
                     k,  static_cast<float>(sigma), static_cast<float>(alpha),
                     static_cast<float>(1.0 - alpha)};
#define DRAGG_WINDOW_CASE(T_, R_, C_, CS_, CL_, REGS_, MINB_)                           \
  if (threads == T_ && rows == R_ && cols == C_ && scols == CS_ && cluster == CL_ &&   \
      regs == REGS_ && blocks_per_sm == MINB_) {                                        \
    return launch_window<T_, R_, C_, CS_, CL_, REGS_ != 0, MINB_>(a, B, smem, stream); \
  }
  WINDOW_KERNELS(DRAGG_WINDOW_CASE)
#undef DRAGG_WINDOW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
