"""ReLU-QP-style pre-factorized dense-matmul ADMM for the per-home MPC QPs
(counterpart of ``dragg_tpu/ops/reluqp.py``; ``hems.solver = "reluqp"``).

An OSQP-style ADMM whose KKT system is factorized once per (bucket, rho)
into an explicit dense inverse, so every iteration of the inner loop is a
fixed sequence of batched dense matrix-vector products plus an
elementwise clamp.  Rho adaptation is an index switch into a small
geometric bank of pre-inverted Schur operators S(ρ) = Â D(ρ)⁻¹ Âᵀ, never
a new factorization.

One iteration (σ, α as in OSQP; D = diag(P̂ + σ + ρŵ²)):

    rhs = σ x − q̂ + ŵ∘(ρ z − y)                     elementwise
    ν   = S(ρ)⁻¹ (Â (D⁻¹ rhs) − b̂)                  2 dense matvecs
    x⁺  = D⁻¹ (rhs − Âᵀ ν)                          1 dense matvec
    z⁺  = clip(α ŵ x⁺ + (1−α) z + y/ρ, l̂, û)        the "ReLU" clamp
    y⁺  = y + ρ (α ŵ x⁺ + (1−α) z − z⁺)             elementwise

Iterations run in check windows of ``check_every``.  Under
``iter_kernel = "pallas"`` a window and its residual maxima are one launch
of the CUDA kernel of ``ops/iter_kernels.py`` (its plain version on the
CPU); under ``"lax"`` they are that kernel's plain version, a chain of
batched einsums at the hot-loop ``precision``.  The
fallback tail's window and the final polish are einsums under both, as in
the JAX package.

The bank lives in :class:`ReLUQPCarry` across MPC timesteps, refreshed on
the engine's ``admm_refactor_every`` cadence.  Homes still unconverged
when the banked loop exits get one exact refactorization at their current
rho and a bounded tail of iterations, reported per home in
``ADMMSolution.bank_fallback``.

PyTorch runs eagerly: the while-loop over windows is a Python loop that
reads ``all_done`` and the patience counter once per window (one host
sync per window); ``refresh`` is a Python bool.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dragg_tpu_torch.ops import iter_kernels
from dragg_tpu_torch.ops.dual import primal
from dragg_tpu_torch.ops.admm import (
    ADMMSolution,
    _pad_gather,
    _schur_structure_for,
    ruiz_equilibrate_sparse,
)
from dragg_tpu_torch.ops.precision import mxu_einsum, validate_precision
from dragg_tpu_torch.ops.qp import SparsePattern, form_schur_sparse, schur_index


# The profiler range around a rho-bank build (read by profile_step).
BANK_BUILD_RANGE = "reluqp_bank_build"


class ReLUQPCarry(NamedTuple):
    """Cross-timestep cache: the Ruiz/cost scalings plus the full
    pre-inverted rho bank (bank axis 1, homes first)."""

    d: torch.Tensor          # (B, n) column scaling
    e_eq: torch.Tensor       # (B, m) equality-row scaling
    e_box: torch.Tensor      # (B, n) box-row scaling
    c: torch.Tensor          # (B, 1) cost scaling
    Sinv_bank: torch.Tensor  # (B, R, m, m) pre-inverted Schur operators


def bank_rhos(rho0: float, rho_factor: float, bank: int) -> np.ndarray:
    """The geometric rho schedule centred on ``rho0``: entry r is
    ``rho0 * rho_factor**(r - bank//2)``."""
    return float(rho0) * float(rho_factor) ** (
        np.arange(int(bank), dtype=np.float64) - int(bank) // 2)


def bank_array(rho0: float, rho_factor: float, bank: int,
               dtype=torch.float32) -> torch.Tensor:
    """The bank's rhos as the solver uses them: the schedule of
    :func:`bank_rhos` computed in ``dtype`` arithmetic on the CPU, as the
    JAX package's solver computes it (the float64 schedule rounded once
    can differ from it by an ulp)."""
    r = torch.arange(int(bank), dtype=dtype) - int(bank) // 2
    return torch.tensor(rho0, dtype=dtype) * torch.tensor(rho_factor, dtype=dtype) ** r


def iteration_flops(m: int, n: int) -> float:
    """Dense-matmul FLOPs of one iteration for one home: Â(D⁻¹rhs) 2mn,
    S⁻¹t 2m², Âᵀν 2mn."""
    return 4.0 * m * n + 2.0 * m * m


def bank_factor_flops(m: int, bank: int) -> float:
    """Dense FLOPs of (re)building the bank for one home: per entry one
    Cholesky (m³/3), one triangular solve of m right-hand sides (m³) and
    the Gram product L⁻ᵀL⁻¹ (m³)."""
    return float(bank) * (1.0 / 3.0 + 1.0 + 1.0) * float(m) ** 3


def equilibrated_spd_inverse(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Condition-checked explicit inverse of a batch of (already
    equilibrated) SPD matrices: S = LLᵀ, S⁻¹ = L⁻ᵀL⁻¹.  Homes whose
    factorization fails are retried once with a relative Tikhonov bump
    ``1e-6·max|S|`` on the diagonal.  Returns ``(Sinv, ok)``; homes that
    fail even the bumped factorization get the identity and ``ok`` false.

    ``cholesky_ex`` returns a partial, finite factor and a nonzero
    ``info`` for a matrix that is not positive definite (JAX returns
    NaNs), so a home is ok only when ``info`` is 0 AND its inverse is
    finite."""
    B, m, _ = S.shape
    eye = torch.eye(m, dtype=S.dtype, device=S.device)

    def try_inv(Sx):
        L, info = torch.linalg.cholesky_ex(Sx)
        Linv = torch.linalg.solve_triangular(L, eye.expand(B, m, m), upper=False)
        Sinv = mxu_einsum("bkm,bkn->bmn", Linv, Linv)
        ok = (info == 0) & torch.all(torch.isfinite(Sinv).reshape(B, -1), dim=1)
        return Sinv, ok

    Sinv, ok = try_inv(S)
    bump = 1e-6 * torch.amax(torch.abs(S).reshape(B, -1), dim=1)
    S2 = torch.where(ok[:, None, None], S,
                     S + torch.clamp(bump, min=1e-12)[:, None, None] * eye)
    Sinv2, ok2 = try_inv(S2)
    out = torch.where(ok[:, None, None], Sinv,
                      torch.where(ok2[:, None, None], Sinv2, eye[None]))
    return out, ok | ok2


def init_reluqp_carry(B: int, pat: SparsePattern, bank: int, device=None,
                      dtype=torch.float32) -> ReLUQPCarry:
    """Zero-filled carry for t=0 (the first step must refresh)."""
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)  # noqa: E731
    return ReLUQPCarry(
        d=ones(B, pat.n), e_eq=ones(B, pat.m), e_box=ones(B, pat.n), c=ones(B, 1),
        Sinv_bank=torch.zeros((B, bank, pat.m, pat.m), dtype=dtype, device=device),
    )


def _reluqp_impl(
    pat: SparsePattern,
    vals: torch.Tensor,      # (B, nnz) A_eq values
    b_eq: torch.Tensor,      # (B, m)
    l_box: torch.Tensor,     # (B, n)
    u_box: torch.Tensor,     # (B, n)
    q: torch.Tensor,         # (B, n)
    *,
    rho0: float = 0.1,
    rho_factor: float = 6.0,
    bank: int = 5,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-4,
    reg: float = 1e-3,
    iters: int = 2000,
    check_every: int = 25,
    ruiz_iters: int = 10,
    patience: int = 4,
    tail_iters: int = 300,   # fallback exact-refactorization tail budget
    precision: str = "f32",  # hot-loop matmul policy (ops/precision.py);
                             # the residual path is always f32
    iter_kernel: str = "lax",  # "pallas": each check window is one launch
                               # of ops/iter_kernels.fused_window (f32 only)
    x0: torch.Tensor | None = None,
    y_box0: torch.Tensor | None = None,
    rho_warm: torch.Tensor | None = None,  # (B,) unscaled rho hint, snapped
                                           # to the nearest bank entry
    carry_in: ReLUQPCarry | None = None,
    refresh: bool = True,    # with carry_in: recompute scalings + bank
) -> tuple[ADMMSolution, ReLUQPCarry]:
    """Solve B problems  min ½ x'(reg I)x + q'x  s.t. A_eq x = b_eq,
    l ≤ x ≤ u  with the pre-factorized dense iteration (module
    docstring).  Warm-startable in unscaled units."""
    B = vals.shape[0]
    m_eq, n = pat.m, pat.n
    dtype, dev = vals.dtype, vals.device
    R = int(bank)
    validate_precision(precision)
    if iter_kernel not in ("lax", "pallas"):
        raise ValueError(f"iter_kernel must be lax|pallas, got {iter_kernel!r}")
    if iter_kernel == "pallas" and precision != "f32":
        # The fused window is f32 end to end (its residual reduction runs
        # in the kernel); a bf16x3 hot loop composes with the lax path only.
        raise ValueError("iter_kernel='pallas' requires precision='f32'")

    idx_t = lambda a: torch.as_tensor(a, dtype=torch.long, device=dev)  # noqa: E731
    rows, cols = idx_t(pat.rows), idx_t(pat.cols)
    col_rows, col_src = idx_t(pat.col_rows), idx_t(pat.col_src)
    schur = _schur_structure_for(pat)
    schur_ix = schur_index(schur, dev) if schur is not None else None
    fresh = carry_in is None or bool(refresh)

    if fresh:
        d, e_eq, e_box, c = ruiz_equilibrate_sparse(pat, vals, q, iters=ruiz_iters)
    else:
        d, e_eq, e_box, c = carry_in.d, carry_in.e_eq, carry_in.e_box, carry_in.c
    vals_s = e_eq[:, rows] * vals * d[:, cols]
    vp_c_raw = _pad_gather(vals, col_src)          # unscaled, certificates
    w = e_box * d
    qs = c * d * q
    bs = e_eq * b_eq
    ls = e_box * l_box
    us = e_box * u_box
    p_diag = c * d * d * reg
    cd = c * d

    # The dense scaled Â, materialized per call (only the bank persists).
    A_dense = vals_s.new_zeros((B, m_eq * n)).index_add_(
        1, rows * n + cols, vals_s).reshape(B, m_eq, n)

    def mv(x):
        return mxu_einsum("bmn,bn->bm", A_dense, x)

    def mvt(y):
        return mxu_einsum("bmn,bm->bn", A_dense, y)

    def mvt_raw(y):
        """A_eqᵀ y with the unscaled values (infeasibility certificate)."""
        return torch.sum(vp_c_raw * y[:, col_rows], dim=2)

    bank_arr = bank_array(rho0, rho_factor, R, dtype).to(dev)

    def diag_inv(rho_b):
        return 1.0 / (p_diag + sigma + rho_b[:, None] * w * w)

    def form_S(Dinv):
        """Exact S = Â D⁻¹ Âᵀ at the current values."""
        if schur is not None:
            return form_schur_sparse(schur, m_eq, vals_s, Dinv, schur_ix)
        return mxu_einsum("bmn,bkn->bmk", A_dense * Dinv[:, None, :], A_dense)

    def build_bank():
        """One equilibrated, condition-checked dense inverse per bank rho
        (a named range, so a profiler trace can attribute its time)."""
        with torch.profiler.record_function(BANK_BUILD_RANGE):
            return torch.stack([
                equilibrated_spd_inverse(form_S(diag_inv(bank_arr[r].expand(B))))[0]
                for r in range(R)], dim=1)  # (B, R, m, m)

    Sinv_bank = build_bank() if fresh else carry_in.Sinv_bank

    # Warm-start boundary (unscaled → scaled), and the bank index from the
    # rho hint: idx = round(log_factor(rho_warm / rho0)) + centre.
    x = torch.zeros((B, n), dtype=dtype, device=dev) if x0 is None else x0.to(dtype) / d
    y_box = (torch.zeros((B, n), dtype=dtype, device=dev) if y_box0 is None
             else c * y_box0.to(dtype) / e_box)
    nu = torch.zeros((B, m_eq), dtype=dtype, device=dev)
    z_box = torch.minimum(torch.maximum(w * x, ls), us)
    if rho_warm is None:
        idx = torch.full((B,), R // 2, dtype=torch.long, device=dev)
    else:
        lf = torch.log(torch.tensor(rho_factor, dtype=dtype, device=dev))
        off = torch.round(torch.log(torch.clamp(rho_warm.to(dtype), min=1e-12) / rho0) / lf)
        idx = torch.clamp(off.to(torch.long) + R // 2, 0, R - 1)
    home = torch.arange(B, device=dev)

    def select(idx):
        """(B, m, m) operator slab at each home's bank index: the whole
        rho adaptation is this gather."""
        return Sinv_bank[home, idx]

    def residuals(*state):
        # Control quantities: computed on primal values under forward-mode
        # AD (ops/dual.py), as every certificate below.
        res = iter_kernels.residual_maxima(
            *map(primal, (A_dense, w, qs, bs, e_eq, e_box, cd, p_diag)),
            tuple(map(primal, state)))
        return (*res, converged(*res))

    def converged(r_prim, r_dual, p_sc, d_sc):
        return ((r_prim <= eps_abs + eps_rel * p_sc)
                & (r_dual <= eps_abs + eps_rel * d_sc))

    def primal_infeasible(dnu, dy_box):
        """OSQP §3.4 certificate on the window's dual-change direction."""
        c_p = primal(c)
        dnu_u = e_eq * primal(dnu) / c_p
        dy_box_u = e_box * primal(dy_box) / c_p
        At_dy = mvt_raw(dnu_u) + dy_box_u
        norm_dy = torch.maximum(torch.amax(torch.abs(dnu_u), dim=1),
                                torch.amax(torch.abs(dy_box_u), dim=1))
        eps_inf = 1e-4 * torch.clamp(norm_dy, min=1e-12)
        cond1 = torch.amax(torch.abs(At_dy), dim=1) <= eps_inf
        dy_pos = torch.clamp(dy_box_u, min=0.0)
        dy_neg = torch.clamp(dy_box_u, max=0.0)
        sup = (torch.sum(b_eq * dnu_u, dim=1)
               + torch.sum(torch.where(dy_pos > 0, u_box * dy_pos, 0.0), dim=1)
               + torch.sum(torch.where(dy_neg < 0, l_box * dy_neg, 0.0), dim=1))
        return cond1 & (sup <= -eps_inf) & (norm_dy > 1e-10)

    def window(Sinv_sel, Dinv, rho_b, state, k):
        return iter_kernels.iterate(A_dense, Sinv_sel, Dinv, w, qs, bs, ls, us, rho_b,
                                    state, k=k, sigma=sigma, alpha=alpha,
                                    precision=precision)

    def window_resid(Sinv_sel, Dinv, rho_b, state, k):
        """One check window and its residuals: one kernel launch under
        ``iter_kernel = "pallas"``, the einsum chain under ``"lax"``."""
        args = (A_dense, Sinv_sel, Dinv, w, qs, bs, ls, us, rho_b, *state,
                e_eq, e_box, cd, p_diag)
        if iter_kernel == "pallas":
            st, res = iter_kernels.fused_window(*args, k=k, sigma=sigma, alpha=alpha)
        else:
            st, res = iter_kernels.fused_window_plain(*args, k=k, sigma=sigma, alpha=alpha,
                                                      precision=precision)
        return st, (*res, converged(*res))

    # --- The banked loop, one check window per pass.
    state = (x, z_box, nu, y_box)
    it = 0
    pinf = torch.zeros((B,), dtype=torch.bool, device=dev)
    best_done = torch.tensor(-1, device=dev)
    best_r = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    last_improve = torch.tensor(0, device=dev)
    conv_it = torch.full((B,), -1, dtype=torch.int32, device=dev)
    keep = iters > 0
    while keep:
        nu_prev, y_box_prev = state[2], state[3]
        rho_b = bank_arr[idx]
        state, res = window_resid(select(idx), diag_inv(rho_b), rho_b, state, check_every)
        r_prim, r_dual, p_sc, d_sc, ok = res
        pinf = pinf | primal_infeasible(state[2] - nu_prev, state[3] - y_box_prev)
        done = ok | pinf
        it += check_every
        conv_it = torch.where((conv_it < 0) & done, it, conv_it)
        n_done = torch.sum(done)
        r_tot = r_prim + r_dual
        descending = (r_tot < 0.99 * best_r) & ~done
        improved = (n_done > best_done) | torch.any(descending)
        best_done = torch.maximum(best_done, n_done)
        best_r = torch.minimum(best_r, r_tot)
        last_improve = torch.where(improved, it, last_improve)
        # Rho adaptation = bank-index arithmetic, every window.
        ratio = torch.sqrt((r_prim / torch.clamp(p_sc, min=1e-10))
                           / torch.clamp(r_dual / torch.clamp(d_sc, min=1e-10), min=1e-10))
        step = torch.where(ratio > 5.0, 1, torch.where(ratio < 0.2, -1, 0))
        idx = torch.clamp(idx + torch.where(done, 0, step), 0, R - 1)
        # The loop condition: one host read per window.
        all_done, last = torch.stack([torch.all(done).long(), last_improve]).tolist()
        keep = it < iters and not all_done
        if patience > 0:
            keep = keep and it - last < patience * check_every

    x, z_box, nu, y_box = state
    r_prim, r_dual, _, _, ok = residuals(x, z_box, nu, y_box)

    # --- Fallback exact-refactorization tail for the homes the banked loop
    # left neither converged nor certified.
    need_tail = ~(ok | pinf)
    fallback = torch.zeros((B,), dtype=torch.bool, device=dev)
    if tail_iters > 0 and bool(torch.any(need_tail)):
        rho_b = bank_arr[idx]
        Dinv = diag_inv(rho_b)
        Sinv_ex, _ = equilibrated_spd_inverse(form_S(Dinv))
        x2, z2, nu2, y2 = window(Sinv_ex, Dinv, rho_b, (x, z_box, nu, y_box), tail_iters)
        # Only the homes that needed the tail adopt its iterate.
        m1 = need_tail[:, None]
        x = torch.where(m1, x2, x)
        z_box = torch.where(m1, z2, z_box)
        nu = torch.where(m1, nu2, nu)
        y_box = torch.where(m1, y2, y_box)
        conv_it = torch.where(need_tail & (conv_it < 0), it + tail_iters, conv_it)
        it += tail_iters
        fallback = need_tail
        r_prim, r_dual, _, _, ok = residuals(x, z_box, nu, y_box)

    # Final polish: D-weighted projection onto the equality manifold with
    # refinement against the exact current S (absorbs the bank's staleness
    # between refreshes).  Pinned f32.
    rho_b = bank_arr[idx]
    Dinv = diag_inv(rho_b)
    S_ex = form_S(Dinv)
    Sinv_sel = select(idx)

    def s_solve(r):
        pinv = lambda rr: mxu_einsum("bmn,bn->bm", Sinv_sel, rr)  # noqa: E731
        v = pinv(r)
        for _ in range(2):
            v = v + pinv(r - mxu_einsum("bmn,bn->bm", S_ex, v))
        return v

    x = x - Dinv * mvt(s_solve(mv(x) - bs))

    x_out = torch.minimum(torch.maximum(d * x, l_box), u_box)
    sol = ADMMSolution(
        x=x_out, y_eq=e_eq * nu / c, y_box=e_box * y_box / c,
        r_prim=r_prim, r_dual=r_dual, solved=ok & ~pinf, infeasible=pinf,
        iters=it, rho=bank_arr[idx],
        conv_iters=torch.where(conv_it < 0, it, conv_it).to(torch.int32),
        diverged=pinf,
        bank_fallback=fallback,
    )
    return sol, ReLUQPCarry(d=d, e_eq=e_eq, e_box=e_box, c=c, Sinv_bank=Sinv_bank)


def reluqp_solve_qp(pat, vals, b_eq, l_box, u_box, q, **kwargs) -> ADMMSolution:
    """One-shot solve (scalings + bank built in the call).  See
    :func:`_reluqp_impl` for parameters."""
    return _reluqp_impl(pat, vals, b_eq, l_box, u_box, q, **kwargs)[0]


def reluqp_solve_qp_cached(pat, vals, b_eq, l_box, u_box, q, carry_in, refresh,
                           **kwargs) -> tuple[ADMMSolution, ReLUQPCarry]:
    """MPC-mode solve with the cross-timestep bank cache: reuses
    ``carry_in``'s scalings and bank unless ``refresh`` (the engine's
    ``admm_refactor_every`` cadence).  Returns the solution and the carry
    for the next step."""
    return _reluqp_impl(pat, vals, b_eq, l_box, u_box, q, carry_in=carry_in,
                        refresh=bool(refresh), **kwargs)
