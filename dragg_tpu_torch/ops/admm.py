"""Batched OSQP-style ADMM for the per-home MPC QPs (counterpart of
``dragg_tpu/ops/admm.py``; ``hems.solver = "admm"``), plus the pieces the
interior point and ReLU-QP share with it: the solution record, the cached
Schur triple lists, the padded gather and the Ruiz equilibration.

OSQP (Stellato et al. 2020) with equality elimination: only the box block
goes through the ADMM splitting, and ``A_eq x = b_eq`` holds inside every
x-update through the Schur complement ``S = Â D⁻¹ Âᵀ`` (m × m, SPD) of the
KKT system, D = diag(P̂ + σ + ρŵ²).  The sparse matvecs are gathers over the
padded pattern (``ops/qp.SparsePattern``); S is formed from the triple
lists at a (re)factorization and solved every iteration by one of two
backends (:func:`resolve_backend`):

* ``"dense_inv"``: the explicit inverse S⁻¹ (B, m, m), from the band
  Cholesky and one banded forward solve against I
  (``banded.banded_explicit_inverse``), applied as one batched matvec
  (``precision.mxu_einsum``, optionally a bf16 ``Sinv``) with ``refine``
  refinement passes against the exact S;
* ``"band"``: no (B, m, m) array at all; the band Cholesky factor and the
  refined band solve run as the CUDA kernels of ``ops/band_kernels.py``
  (``band_kernel = "auto"``/``"pallas"``, the factor carried transposed,
  (m, bw+1, B)) or as their plain versions (``"xla"``, (B, m, bw+1), the
  JAX package's scan layout).

Per-home Ruiz and cost scaling, adaptive rho every ``rho_update_every``
check windows (refactoring only when some home's rho changed), the OSQP
§3.4 primal-infeasibility certificate, the stagnation exit (``patience``),
optional Anderson acceleration on (z, y) once a window, and a final polish
(refine 2) onto the equality manifold.

PyTorch runs eagerly: the JAX package's ``lax.while_loop`` is a Python loop
over check windows of ``check_every`` iterations with one host read a
window, which decides both the exit and whether the rho update asks for a
refactorization.  ``refresh`` is a Python bool.  On the card the dense
inverse's window, ~30 small launches an iteration, is captured once a
solve as a CUDA graph and replayed (:class:`_WindowGraph`); the band
backend's windows launch one by one, so that each band kernel's launch is
counted.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from dragg_tpu_torch.ops import band_kernels
from dragg_tpu_torch.ops import banded as bd
from dragg_tpu_torch.ops.dual import has_tangent, primal
from dragg_tpu_torch.ops.precision import f32_guard, mxu_einsum, validate_precision
from dragg_tpu_torch.ops.qp import (
    SparsePattern,
    _build_pattern,
    build_schur_structure,
    schur_contrib,
    schur_index,
    scatter_schur,
)

RHO_MIN, RHO_MAX = 1e-6, 1e6

# "auto" goes banded when a bucket's dense Sinv would exceed this.
BAND_AUTO_BYTES = 1 << 30

# The profiler range around a factorization (read by profile_step), and
# the factorizations since the last reset, by cause: a fresh solve or
# refresh, or an in-loop rho change.
FACTOR_RANGE = "admm_factor"
FACTORIZATIONS = {"refresh": 0, "rho": 0}


def reset_factorizations() -> None:
    for k in FACTORIZATIONS:
        FACTORIZATIONS[k] = 0


# Replay the dense inverse's check windows as CUDA graphs on the card
# (False: launch them one by one, the reference the graphs are held to).
CUDA_GRAPHS = True


class _WindowGraph:
    """A check window of ``k`` iterations of ``step(F, rho, state)``
    captured as one CUDA graph over static copies of the state, the factor
    and rho: :meth:`run` copies a state in, replays the window and returns
    copies of its result; :meth:`set_factor` copies in a new factor and
    rho after a refactorization.  The same kernels as the window launched
    one by one, replayed with one launch."""

    def __init__(self, step, k: int, state, F, rho_b):
        dev = state[0].device
        self.st = [t.clone() for t in state]
        self.F = [t.clone() for t in F]
        self.rho = rho_b.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self._iterate(step, k)  # warm-up: library handles on this stream
            # thread_local: the aggregator's pipeline thread may use the
            # card meanwhile, on its own stream.
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = self._iterate(step, k)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)

    def _iterate(self, step, k: int):
        st = tuple(self.st)
        for _ in range(k):
            st = step(tuple(self.F), self.rho, st)
        return st

    def set_factor(self, F, rho_b) -> None:
        for a, b in zip(self.F, F):
            a.copy_(b)
        self.rho.copy_(rho_b)

    def run(self, state):
        for a, b in zip(self.st, state):
            a.copy_(b)
        self.graph.replay()
        return tuple(o.clone() for o in self.out)


@lru_cache(maxsize=32)
def _schur_structure_for(pat: SparsePattern):
    """Schur triple lists for a pattern, or None when the triple count
    says dense S formation is cheaper (checked from the column counts
    before building anything)."""
    col_counts = np.bincount(np.asarray(pat.cols), minlength=pat.n)
    if int(np.sum(col_counts.astype(np.int64) ** 2)) > pat.m * pat.n:
        return None
    ss = build_schur_structure(pat)
    if ss.n_s * ss.P > pat.m * pat.n:
        return None
    return ss


class FactorCarry(NamedTuple):
    """Cross-timestep solver cache: the Ruiz/cost scalings and the Schur
    factor, carried across the steps of a chunk so consecutive steps
    (whose matrices differ only in the water-mix band) skip the
    equilibration and the refactorization; the refinement in the solve
    absorbs the stale factor's drift, and a ``refresh`` rebuilds both."""

    d: torch.Tensor      # (B, n) column scaling
    e_eq: torch.Tensor   # (B, m) equality-row scaling
    e_box: torch.Tensor  # (B, n) box-row scaling
    c: torch.Tensor      # (B, 1) cost scaling
    Sinv: torch.Tensor   # dense_inv: the explicit inverse (B, m, m); band:
                         # the band Cholesky factor, (m, bw+1, B) under the
                         # kernels, (B, m, bw+1) under "xla"


def resolve_backend(solve_backend: str, B: int, m: int, has_plan: bool,
                    elem_bytes: int = 4, n_shards: int = 1) -> str:
    """The in-loop solve backend: ``"band"`` and ``"dense_inv"`` as given
    (band needs a banded Schur pattern); ``"auto"`` goes banded only when
    the dense Sinv of one shard would exceed :data:`BAND_AUTO_BYTES`."""
    if solve_backend == "band":
        if not has_plan:
            raise ValueError("solve_backend='band' needs a banded Schur pattern")
        return "band"
    if solve_backend == "dense_inv":
        return "dense_inv"
    if solve_backend != "auto":
        raise ValueError(f"unknown solve_backend {solve_backend!r}")
    if has_plan and elem_bytes * B * m * m > BAND_AUTO_BYTES * max(1, n_shards):
        return "band"
    return "dense_inv"


class ADMMSolution(NamedTuple):
    x: torch.Tensor        # (B, n) primal solution (unscaled, box-projected)
    y_eq: torch.Tensor     # (B, m_eq) duals on equality rows (unscaled)
    y_box: torch.Tensor    # (B, n) duals on box rows (unscaled)
    r_prim: torch.Tensor   # (B,) inf-norm primal residual (unscaled)
    r_dual: torch.Tensor   # (B,) inf-norm dual residual (unscaled, cost-descaled)
    solved: torch.Tensor   # (B,) bool
    infeasible: torch.Tensor  # (B,) bool
    iters: int             # iterations executed
    rho: torch.Tensor      # (B,) final per-home rho (ones for the interior point)
    conv_iters: torch.Tensor | None = None  # (B,) int32 live iterations per home
    diverged: torch.Tensor | None = None    # (B,) bool certified divergence
    bank_fallback: torch.Tensor | None = None  # (B,) bool: the ReLU-QP home needed
                                               # the exact-refactorization tail


def _pad_gather(vals: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(B, nnz) values → padded (B, *src.shape) with -1 slots zeroed."""
    out = vals[:, src.clamp(min=0)]
    return torch.where(src[None] >= 0, out, torch.zeros((), dtype=vals.dtype,
                                                        device=vals.device))


def ruiz_equilibrate_sparse(pat: SparsePattern, vals, q, iters: int = 10):
    """Modified Ruiz equilibration of the stacked constraint matrix
    [A_eq; I] plus cost normalization, on the sparse values.

    Returns (d, e_eq, e_box, c): per-home column scaling d (n,), row
    scalings for the equality and box blocks, and the cost scaling (B, 1).
    Degenerate (all-zero) rows keep their scaling."""
    B, dev, dtype = vals.shape[0], vals.device, vals.dtype
    rows = torch.as_tensor(pat.rows, device=dev)
    cols = torch.as_tensor(pat.cols, device=dev)
    row_src = torch.as_tensor(pat.row_src, device=dev)
    col_src = torch.as_tensor(pat.col_src, device=dev)
    d = torch.ones((B, pat.n), dtype=dtype, device=dev)
    e_eq = torch.ones((B, pat.m), dtype=dtype, device=dev)
    e_box = torch.ones((B, pat.n), dtype=dtype, device=dev)

    def scaled_abs(d, e_eq):
        return torch.abs(e_eq[:, rows] * vals * d[:, cols])

    def rescale(e, r):
        return torch.where(r > 1e-8, e / torch.sqrt(torch.clamp(r, min=1e-8)), e)

    for _ in range(iters):
        r_eq = torch.amax(_pad_gather(scaled_abs(d, e_eq), row_src), dim=2)
        r_box = torch.abs(e_box * d)
        e_eq = rescale(e_eq, r_eq)
        e_box = rescale(e_box, r_box)
        c_eq = torch.amax(_pad_gather(scaled_abs(d, e_eq), col_src), dim=2)
        cn = torch.maximum(c_eq, torch.abs(e_box * d))
        d = rescale(d, cn)
    qn = torch.amax(torch.abs(d * q), dim=1, keepdim=True)
    c = 1.0 / torch.clamp(qn, min=1e-8)
    return d, e_eq, e_box, c


def _band_ops(plan, device, band_kernel: str):
    """(scatter, chol, refined solve) of the band backend: the CUDA
    kernels' wrappers in the transposed layout (``band_kernels``, the
    split pair), or under ``"xla"`` the plain band operations in the
    (B, m, bw+1) layout.  ``solve(Lb, Sb, rp, refine)`` takes and returns
    (B, m) in permuted row order."""
    bw = plan.bw
    if band_kernel == "xla":
        return (lambda c: bd.band_scatter(plan, c),
                lambda Sb: bd.banded_cholesky(Sb, bw),
                lambda Lb, Sb, rp, refine: bd.refined_banded_solve(Lb, Sb, rp, bw, refine))
    scatter_fn, chol_fn, solve_fn, _, _ = band_kernels.make_band_ops(
        plan, device, kernel=band_kernel)
    return scatter_fn, chol_fn, solve_fn


def _dense_cholesky_inverse(S: torch.Tensor) -> torch.Tensor:
    """S⁻¹ = L⁻ᵀL⁻¹ by a batched dense Cholesky (the path of patterns with
    no band plan); a home whose S is not positive definite gets NaNs, as
    ``jnp.linalg.cholesky`` gives."""
    B, m, _ = S.shape
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where((info != 0)[:, None, None], float("nan"), L)
    eye = torch.eye(m, dtype=S.dtype, device=S.device).expand(B, m, m)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return mxu_einsum("bkm,bkn->bmn", Linv, Linv)


def _admm_impl(
    pat: SparsePattern,      # static sparsity
    vals: torch.Tensor,      # (B, nnz) A_eq values
    b_eq: torch.Tensor,      # (B, m_eq)
    l_box: torch.Tensor,     # (B, n)
    u_box: torch.Tensor,     # (B, n)
    q: torch.Tensor,         # (B, n)
    *,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-4,
    reg: float = 1e-3,       # proximal quadratic regularization
    iters: int = 1000,
    check_every: int = 25,
    ruiz_iters: int = 10,
    adaptive_rho: bool = True,
    rho_update_every: int = 4,  # rho updates are considered every Nth check
                                # window (each change pays a refactorization)
    patience: int = 4,       # stagnation exit in check windows; 0 disables
    matvec_dtype: str = "f32",  # "bf16": store the dense Sinv in bfloat16
    precision: str = "f32",  # dense_inv apply policy (ops/precision.py); the
                             # residuals, refinement and factor stay f32, and
                             # the band backend ignores it
    refine: int = 1,         # refinement passes per in-loop solve
    banded_factor: bool = True,  # factor S by RCM + band Cholesky; patterns
                                 # with no band plan factor densely
    solve_backend: str = "auto",  # "dense_inv" | "band" | "auto"
    band_kernel: str = "xla",  # band backend: "auto"/"pallas" the CUDA
                               # kernels, "xla" their plain versions
    anderson: int = 0,       # Anderson-acceleration history depth (0 = off)
    x0: torch.Tensor | None = None,
    y_box0: torch.Tensor | None = None,
    rho0: torch.Tensor | None = None,
    carry_in: FactorCarry | None = None,
    refresh: bool = True,    # with carry_in: recompute scalings + factor
) -> tuple[ADMMSolution, FactorCarry]:
    """Solve B problems  min ½ x'(reg I)x + q'x  s.t. A_eq x = b_eq,
    l ≤ x ≤ u  simultaneously.  Warm-startable in unscaled units (x0,
    y_box0, rho0); with ``carry_in`` the scalings and the Schur factor are
    reused unless ``refresh``."""
    B = vals.shape[0]
    m_eq, n = pat.m, pat.n
    dtype, dev = vals.dtype, vals.device
    validate_precision(precision)
    if band_kernel not in ("auto", "pallas", "xla"):
        raise ValueError(f"admm: band kernel {band_kernel!r} not in auto|pallas|xla")
    store_dtype = torch.bfloat16 if matvec_dtype == "bf16" else dtype

    idx_t = lambda a: torch.as_tensor(a, dtype=torch.long, device=dev)  # noqa: E731
    rows, cols = idx_t(pat.rows), idx_t(pat.cols)
    row_cols, row_src = idx_t(pat.row_cols), idx_t(pat.row_src)
    col_rows, col_src = idx_t(pat.col_rows), idx_t(pat.col_src)
    schur = _schur_structure_for(pat)
    schur_ix = schur_index(schur, dev) if schur is not None else None
    fresh = carry_in is None or bool(refresh)

    if fresh:
        d, e_eq, e_box, c = ruiz_equilibrate_sparse(pat, vals, q, iters=ruiz_iters)
    else:
        d, e_eq, e_box, c = carry_in.d, carry_in.e_eq, carry_in.e_box, carry_in.c
    vals_s = e_eq[:, rows] * vals * d[:, cols]     # scaled A values (B, nnz)
    vp_r = _pad_gather(vals_s, row_src)            # (B, m, K) row-padded
    vp_c = _pad_gather(vals_s, col_src)            # (B, n, Kc) col-padded
    vp_c_raw = _pad_gather(vals, col_src)          # unscaled, certificates
    w = e_box * d                                  # diagonal of the scaled box block
    qs = c * d * q
    bs = e_eq * b_eq
    ls = e_box * l_box
    us = e_box * u_box
    p_diag = c * d * d * reg                       # scaled P diagonal

    def mv(x):
        """Â x via row gathers (B, n) → (B, m)."""
        return torch.sum(vp_r * x[:, row_cols], dim=2)

    def mvt(y):
        """Âᵀ y via column gathers (B, m) → (B, n)."""
        return torch.sum(vp_c * y[:, col_rows], dim=2)

    def mvt_raw(y):
        """A_eqᵀ y with the unscaled values (infeasibility certificate)."""
        return torch.sum(vp_c_raw * y[:, col_rows], dim=2)

    def diag_inv(rho_b):
        """D⁻¹ for the current rho."""
        return 1.0 / (p_diag + sigma + rho_b[:, None] * w * w)

    def form_S(Dinv):
        """S = Â D⁻¹ Âᵀ from the triple lists, or (dense patterns) by the
        einsum of the dense Â."""
        if schur is not None:
            return scatter_schur(schur, m_eq, schur_contrib(schur_ix, vals_s, Dinv))
        A_dense = vals_s.new_zeros((B, m_eq * n)).index_add_(
            1, rows * n + cols, vals_s).reshape(B, m_eq, n)
        return mxu_einsum("bmn,bkn->bmk", A_dense * Dinv[:, None, :], A_dense)

    band_plan = bd.plan_for(schur, m_eq) if (banded_factor and schur is not None) else None
    backend = resolve_backend(solve_backend, B, m_eq, band_plan is not None,
                              elem_bytes=2 if matvec_dtype == "bf16" else 4)
    if backend == "band":
        perm_ix, invp_ix = idx_t(band_plan.perm), idx_t(band_plan.inv)
        scatter_fn, chol_fn, band_solve_fn = _band_ops(band_plan, dev, band_kernel)

    def factor(rho_b, cause: str = "refresh"):
        """(Dinv, factor, S) for the current problem at ``rho_b``: the
        band backend keeps the band S and its Cholesky factor; dense_inv
        the dense S (for refinement) and the explicit inverse."""
        FACTORIZATIONS[cause] += 1
        with torch.profiler.record_function(FACTOR_RANGE):
            Dinv = diag_inv(rho_b)
            if backend == "band":
                Sb = scatter_fn(schur_contrib(schur_ix, vals_s, Dinv))
                return Dinv, chol_fn(Sb), Sb
            if band_plan is not None:
                # One contrib feeds both the dense S and the banded inverse.
                contrib = schur_contrib(schur_ix, vals_s, Dinv)
                S = scatter_schur(schur, m_eq, contrib)
                Sinv = bd.banded_explicit_inverse(band_plan, contrib)
            else:
                S = form_S(Dinv)
                Sinv = _dense_cholesky_inverse(S)
            return Dinv, Sinv.to(store_dtype), S

    def stale_factor(rho_b):
        """The carried factor as a preconditioner: Dinv and S exact for the
        current problem, the factor stale; refinement corrects it."""
        Dinv = diag_inv(rho_b)
        if backend == "band":
            return Dinv, carry_in.Sinv, scatter_fn(schur_contrib(schur_ix, vals_s, Dinv))
        return Dinv, carry_in.Sinv, form_S(Dinv)

    def s_solve(F, r, refine: int = 1):
        """S⁻¹ r with ``refine`` refinement passes."""
        if backend == "band":
            _, Lb, Sb = F
            return band_solve_fn(Lb, Sb, r[:, perm_ix], refine)[:, invp_ix]
        _, Sinv, S = F
        # The per-iteration matvec runs at the hot-loop policy; the
        # refinement residual against the exact S stays float32.
        pinv = lambda rr: mxu_einsum(  # noqa: E731
            "bmn,bn->bm", Sinv, rr.to(Sinv.dtype), precision=precision, out_dtype=dtype)
        v = pinv(r)
        for _ in range(refine):
            v = v + pinv(r - mxu_einsum("bmn,bn->bm", S, v))
        return v

    def kkt_solve(F, rhs):
        """x = D⁻¹(rhs − Âᵀν), ν = S⁻¹(Â D⁻¹ rhs − b̂): the equalities hold
        to solve accuracy at every iterate."""
        Dinv = F[0]
        nu = s_solve(F, mv(Dinv * rhs) - bs, refine=refine)
        return Dinv * (rhs - mvt(nu)), nu

    rho_b = (torch.full((B,), rho, dtype=dtype, device=dev) if rho0 is None
             else rho0.to(dtype))
    x = torch.zeros((B, n), dtype=dtype, device=dev) if x0 is None else x0.to(dtype) / d
    nu = torch.zeros((B, m_eq), dtype=dtype, device=dev)
    y_box = (torch.zeros((B, n), dtype=dtype, device=dev) if y_box0 is None
             else c * y_box0.to(dtype) / e_box)
    z_box = torch.minimum(torch.maximum(w * x, ls), us)

    def residuals(x, z_box, nu, y_box):
        """Unscaled residuals and the relative scalings (OSQP §3.4, §5.1),
        always float32 and on primal values."""
        x, z_box, nu, y_box = map(primal, (x, z_box, nu, y_box))
        x = f32_guard(x, "admm residual iterate x")
        y_box = f32_guard(y_box, "admm residual dual y_box")
        Ax = mv(x)
        wx = w * x
        r_prim = torch.maximum(torch.amax(torch.abs((Ax - bs) / e_eq), dim=1),
                               torch.amax(torch.abs((wx - z_box) / e_box), dim=1))
        Aty = mvt(nu)
        cd = c * d
        r_dual = torch.amax(torch.abs((p_diag * x + qs + Aty + w * y_box) / cd), dim=1)
        amax = lambda a: torch.amax(torch.abs(a), dim=1)  # noqa: E731
        p_sc = torch.maximum(torch.maximum(amax(Ax / e_eq), amax(bs / e_eq)),
                             torch.maximum(amax(wx / e_box), amax(z_box / e_box)))
        d_sc = torch.maximum(amax(Aty / cd),
                             torch.maximum(amax(w * y_box / cd), amax(qs / cd)))
        ok = ((r_prim <= eps_abs + eps_rel * p_sc)
              & (r_dual <= eps_abs + eps_rel * d_sc))
        return r_prim, r_dual, p_sc, d_sc, ok

    def one_iter(F, rho_b, state):
        x, z_box, nu, y_box = state
        rho_c = rho_b[:, None]
        rhs = sigma * x - qs + w * (rho_c * z_box - y_box)
        x_t, nu_t = kkt_solve(F, rhs)
        x_new = alpha * x_t + (1.0 - alpha) * x
        z_relaxed = alpha * (w * x_t) + (1.0 - alpha) * z_box
        z_box_new = torch.minimum(torch.maximum(z_relaxed + y_box / rho_c, ls), us)
        y_box_new = y_box + rho_c * (z_relaxed - z_box_new)
        return x_new, z_box_new, nu_t, y_box_new

    def primal_infeasible(dnu, dy_box):
        """OSQP §3.4 certificate on the window's dual-change direction."""
        dnu_u = e_eq * primal(dnu) / c
        dy_box_u = e_box * primal(dy_box) / c
        At_dy = mvt_raw(dnu_u) + dy_box_u
        norm_dy = torch.maximum(torch.amax(torch.abs(dnu_u), dim=1),
                                torch.amax(torch.abs(dy_box_u), dim=1))
        eps_inf = 1e-4 * torch.clamp(norm_dy, min=1e-12)
        cond1 = torch.amax(torch.abs(At_dy), dim=1) <= eps_inf
        dy_pos = torch.clamp(dy_box_u, min=0.0)
        dy_neg = torch.clamp(dy_box_u, max=0.0)
        # An infinite bound against a nonzero direction makes the support
        # value infinite and blocks the certificate.
        sup = (torch.sum(b_eq * dnu_u, dim=1)
               + torch.sum(torch.where(dy_pos > 0, u_box * dy_pos, 0.0), dim=1)
               + torch.sum(torch.where(dy_neg < 0, l_box * dy_neg, 0.0), dim=1))
        return cond1 & (sup <= -eps_inf) & (norm_dy > 1e-10)

    # --- Anderson acceleration (type II, once per check window on (z, y)),
    # with a per-home safeguard that reverts to the plain iterate and
    # clears the home's history when an accelerated window regresses.
    K_aa = int(anderson)
    eye_k = torch.eye(K_aa, dtype=dtype, device=dev)

    def aa_init():
        return dict(
            hist_s=torch.zeros((K_aa, B, 2 * n), dtype=dtype, device=dev),  # window entries
            hist_t=torch.zeros((K_aa, B, 2 * n), dtype=dtype, device=dev),  # their images
            cnt=torch.zeros((B,), dtype=torch.int32, device=dev),  # valid history
            prev_r=torch.full((B,), float("inf"), dtype=dtype, device=dev),
            applied=torch.zeros((B,), dtype=torch.bool, device=dev),  # jumped last window
            s_plain=torch.zeros((B, 2 * n), dtype=dtype, device=dev),  # plain fallback
        )

    def aa_step(aa, widx: int, s_entry, s_plain, r_tot, done, rho_changed):
        """One AA update at a window boundary: (aa', s_next); ``s_next``
        seeds the next window."""
        revert = aa["applied"] & (r_tot > 2.0 * aa["prev_r"]) & ~done
        base = torch.where(revert[:, None], aa["s_plain"], s_plain)
        cnt = torch.where(revert | rho_changed, 0, aa["cnt"])
        slot = widx % K_aa
        # The stored pair is always the true map application.
        hist_s, hist_t = aa["hist_s"].clone(), aa["hist_t"].clone()
        hist_s[slot] = s_entry
        hist_t[slot] = s_plain
        cnt = torch.clamp(cnt + 1, max=K_aa)
        ages = torch.remainder(widx - torch.arange(K_aa, device=dev), K_aa)   # (K,)
        valid = ages[None, :] < cnt[:, None]                                  # (B, K)
        G = (hist_s - hist_t).permute(1, 0, 2) * valid[..., None]            # (B, K, D)
        M = mxu_einsum("bkd,bjd->bkj", G, G)
        gnorm = torch.clamp(torch.einsum("bkk->b", M), min=1e-12)
        M = M + (1e-8 * gnorm)[:, None, None] * eye_k
        inv = ~valid
        M = torch.where(inv[:, :, None] | inv[:, None, :], eye_k[None], M)
        o = valid.to(dtype)                                                   # (B, K)
        kkt = torch.cat([torch.cat([M, o[:, :, None]], dim=2),
                         torch.cat([o[:, None, :], M.new_zeros((B, 1, 1))], dim=2)],
                        dim=1)                                                # (B, K+1, K+1)
        rhs = M.new_zeros((B, K_aa + 1, 1))
        rhs[:, -1] = 1.0
        # solve_ex: a singular system (no valid slot) gives non-finite
        # weights, as jnp.linalg.solve does, instead of raising.
        gamma = torch.linalg.solve_ex(kkt, rhs)[0][:, :K_aa, 0] * o
        s_acc = torch.einsum("bk,kbd->bd", gamma, hist_t)
        use = (cnt >= 2) & ~done & ~revert & torch.all(torch.isfinite(s_acc), dim=1)
        s_next = torch.where(use[:, None], s_acc, base)
        # ``applied`` marks every synthetic jump (extrapolations and
        # reverts): the next window's certificate and revert skip it.
        return dict(hist_s=hist_s, hist_t=hist_t, cnt=cnt, prev_r=r_tot,
                    applied=use | revert, s_plain=base), s_next

    F = factor(rho_b) if fresh else stale_factor(rho_b)
    state = (x, z_box, nu, y_box)
    it = 0
    pinf = torch.zeros((B,), dtype=torch.bool, device=dev)
    best_done = torch.tensor(-1, device=dev)
    best_r = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    last_improve = torch.tensor(0, device=dev)
    conv_it = torch.full((B,), -1, dtype=torch.int32, device=dev)
    aa = aa_init() if K_aa > 0 else None
    graph = None
    if (CUDA_GRAPHS and dev.type == "cuda" and backend == "dense_inv" and iters > 0
            and not has_tangent(vals, b_eq, l_box, u_box, q, x0, rho0)):
        graph = _WindowGraph(one_iter, check_every, state, F, rho_b)
    keep = iters > 0
    while keep:
        nu_prev, y_box_prev = state[2], state[3]
        if K_aa > 0:
            aa_entry = torch.cat([state[1], state[3]], dim=1)
            applied_entry = aa["applied"]
        if graph is not None:
            state = graph.run(state)
        else:
            for _ in range(check_every):
                state = one_iter(F, rho_b, state)
        x, z_box, nu, y_box = state
        r_prim, r_dual, p_sc, d_sc, ok = residuals(x, z_box, nu, y_box)
        new_pinf = primal_infeasible(nu - nu_prev, y_box - y_box_prev)
        if K_aa > 0:
            # A window seeded by a jump has a synthetic dual direction.
            new_pinf = new_pinf & ~applied_entry
        pinf = pinf | new_pinf
        done = ok | pinf
        it += check_every
        conv_it = torch.where((conv_it < 0) & done, it, conv_it)
        # Progress: another home finished, or an unfinished home's residual
        # still descends.
        n_done = torch.sum(done)
        r_tot = r_prim + r_dual
        descending = (r_tot < 0.99 * best_r) & ~done
        improved = (n_done > best_done) | torch.any(descending)
        best_done = torch.maximum(best_done, n_done)
        best_r = torch.minimum(best_r, r_tot)
        last_improve = torch.where(improved, it, last_improve)
        rho_changed = torch.zeros((B,), dtype=torch.bool, device=dev)
        rho_next = rho_b
        if adaptive_rho and (it // check_every) % max(1, rho_update_every) == 0:
            ratio = torch.sqrt((r_prim / torch.clamp(p_sc, min=1e-10))
                               / torch.clamp(r_dual / torch.clamp(d_sc, min=1e-10),
                                             min=1e-10))
            rho_new = torch.clamp(rho_b * ratio, RHO_MIN, RHO_MAX)
            update = (ratio > 5.0) | (ratio < 0.2)
            rho_next = torch.where(update & ~done, rho_new, rho_b)
            rho_changed = rho_next != rho_b
        # The window's one host read: the exit and the refactorization.
        all_done, last, refactor = torch.stack(
            [torch.all(done).long(), last_improve, torch.any(rho_changed).long()]).tolist()
        if refactor:
            F = factor(rho_next, "rho")
            if graph is not None:
                graph.set_factor(F, rho_next)
        rho_b = rho_next
        if K_aa > 0:
            s_plain = torch.cat([z_box, y_box], dim=1)
            aa, s_next = aa_step(aa, it // check_every - 1, aa_entry, s_plain,
                                 r_tot, done, rho_changed)
            state = (x, s_next[:, :n], nu, s_next[:, n:])
        keep = it < iters and not all_done
        if patience > 0:
            keep = keep and it - last < patience * check_every

    x, z_box, nu, y_box = state
    r_prim, r_dual, _, _, ok = residuals(x, z_box, nu, y_box)

    # Final polish: the D-weighted projection onto the equality manifold,
    # two refinement passes (the second squares a stale factor's drift).
    x = x - F[0] * mvt(s_solve(F, mv(x) - bs, refine=2))

    # Unscale and box-project.
    x_out = torch.minimum(torch.maximum(d * x, l_box), u_box)
    sol = ADMMSolution(
        x=x_out, y_eq=e_eq * nu / c, y_box=e_box * y_box / c,
        r_prim=r_prim, r_dual=r_dual, solved=ok & ~pinf, infeasible=pinf,
        iters=it, rho=rho_b,
        conv_iters=torch.where(conv_it < 0, it, conv_it).to(torch.int32),
        diverged=pinf,
    )
    return sol, FactorCarry(d=d, e_eq=e_eq, e_box=e_box, c=c, Sinv=F[1])


def admm_solve_qp(pat, vals, b_eq, l_box, u_box, q, **kwargs) -> ADMMSolution:
    """One-shot solve (scalings and factor built in the call).  See
    :func:`_admm_impl` for parameters."""
    return _admm_impl(pat, vals, b_eq, l_box, u_box, q, **kwargs)[0]


def admm_solve_qp_cached(pat, vals, b_eq, l_box, u_box, q, carry_in, refresh,
                         **kwargs) -> tuple[ADMMSolution, FactorCarry]:
    """MPC-mode solve with the cross-timestep factor cache: reuses
    ``carry_in``'s scalings and factor unless ``refresh``.  Returns the
    solution and the carry for the next step."""
    return _admm_impl(pat, vals, b_eq, l_box, u_box, q, carry_in=carry_in,
                      refresh=bool(refresh), **kwargs)


def init_factor_carry(B: int, pat: SparsePattern, device=None, dtype=torch.float32,
                      matvec_dtype: str = "f32", solve_backend: str = "auto",
                      banded_factor: bool = True, band_kernel: str = "xla") -> FactorCarry:
    """Zero-filled carry for a chunk's first step (which must refresh): in
    band mode ``Sinv`` holds the band Cholesky factor, (m, bw+1, B) under
    the kernels and (B, m, bw+1) under ``"xla"``."""
    plan = bd.plan_for(_schur_structure_for(pat), pat.m) if banded_factor else None
    backend = resolve_backend(solve_backend, B, pat.m, plan is not None,
                              elem_bytes=2 if matvec_dtype == "bf16" else 4)
    if backend == "band" and band_kernel != "xla":
        shape, sinv_dtype = (pat.m, plan.bw + 1, B), dtype
    elif backend == "band":
        shape, sinv_dtype = (B, pat.m, plan.bw + 1), dtype
    else:
        shape = (B, pat.m, pat.m)
        sinv_dtype = torch.bfloat16 if matvec_dtype == "bf16" else dtype
    ones = lambda *s: torch.ones(s, dtype=dtype, device=device)  # noqa: E731
    return FactorCarry(d=ones(B, pat.n), e_eq=ones(B, pat.m), e_box=ones(B, pat.n),
                       c=ones(B, 1),
                       Sinv=torch.zeros(shape, dtype=sinv_dtype, device=device))


@lru_cache(maxsize=32)
def dense_pattern(m: int, n: int) -> SparsePattern:
    """A fully dense SparsePattern (generic LPs and tests; the MPC path
    uses the banded pattern of ``build_qp_static``)."""
    return _build_pattern(np.repeat(np.arange(m), n), np.tile(np.arange(n), m), m, n)


def admm_solve(A_eq, b_eq, l_box, u_box, q, **kwargs) -> ADMMSolution:
    """Dense-matrix API over :func:`admm_solve_qp` with a dense pattern.
    The proximal term defaults to 1e-8 here: a generic LP should not
    inherit the MPC-tuned 1e-3."""
    kwargs.setdefault("reg", 1e-8)
    B, m_eq, n = A_eq.shape
    return admm_solve_qp(dense_pattern(m_eq, n), A_eq.reshape(B, m_eq * n),
                         b_eq, l_box, u_box, q, **kwargs)
