"""Batched primal-dual interior-point solver for the per-home MPC QPs
(counterpart of ``dragg_tpu/ops/ipm.py``).

A Mehrotra predictor-corrector method for

    minimize    qᵀx + (reg/2)‖x‖²
    subject to  A x = b,   l ≤ x ≤ u        (bounds may be ±inf)

run in lockstep over the home batch.  The Newton step's reduced system is
``A Θ⁻¹ Aᵀ dy = r`` with ``Θ = reg + z_l/s_l + z_u/s_u``, factored as an
RCM-permuted band matrix each iteration: the factor and the predictor
solve (refine 0), then the corrector solve (refine 1), through the band
kernels of ``ops/band_kernels.py`` (their plain versions on the CPU).

Homes whose final unscaled residuals miss tolerance come back
``solved=False`` and the engine routes them to the fallback controller.

On a sharded engine the batch is one rank's block of homes.  The phase-1
loop's all-frozen exit is decided over every rank (``world``), as the
JAX package's loop outside ``shard_map`` is; the straggler tail is per
rank, as JAX's per-shard tail, and the reported iteration count adds the
ranks' longest tail.
"""

from __future__ import annotations

import math

import torch

from dragg_tpu_torch import device as _device  # noqa: F401  (pins TF32 off)
from dragg_tpu_torch import telemetry
from dragg_tpu_torch.ops import band_kernels
from dragg_tpu_torch.ops.admm import (
    ADMMSolution,
    _pad_gather,
    _schur_structure_for,
    ruiz_equilibrate_sparse,
)
from dragg_tpu_torch.ops.banded import plan_for
from dragg_tpu_torch.ops.qp import (
    SparsePattern,
    build_schur_structure,
    schur_contrib,
    schur_index,
)

_BIG = 1e20

def band_plan(pat: SparsePattern):
    """The RCM band plan of a pattern's Schur complement A Θ⁻¹ Aᵀ."""
    # The density heuristic can reject small bucketed patterns that are
    # still banded; the IPM needs the triple lists regardless.
    schur = _schur_structure_for(pat) or build_schur_structure(pat)
    plan = plan_for(schur, pat.m)
    if plan is None:
        raise ValueError("ipm_solve_qp needs a banded Schur pattern")
    return plan


def ipm_solve_qp(
    pat: SparsePattern,
    vals: torch.Tensor,      # (B, nnz) A values
    b_eq: torch.Tensor,      # (B, m)
    l_box: torch.Tensor,     # (B, n)
    u_box: torch.Tensor,     # (B, n)
    q: torch.Tensor,         # (B, n)
    *,
    reg: float = 1e-3,
    iters: int = 30,
    tail_frac: float = 0.0,
    tail_iters: int = 0,
    eps_abs: float = 2e-4,
    eps_rel: float = 2e-4,
    ruiz_iters: int = 10,
    fused: bool = False,
    band_kernel: str = "auto",
    x0: torch.Tensor | None = None,
    warm_mu: float = 1e-2,
    freeze_zmax: float = 300.0,
    world=None,
) -> ADMMSolution:
    """Solve the batch (all tensors float32 on one device); returns the
    ADMM-compatible solution record (y_box carries z_u − z_l).  ``fused``
    runs the factor and the predictor solve as one kernel launch;
    ``band_kernel = "xla"`` runs the band operations' plain versions
    instead of the kernels (``band_kernels.make_band_ops``).  ``world``
    (``parallel.World``, None for one rank) shares the loop's exit."""
    B = vals.shape[0]
    m, n = pat.m, pat.n
    dev = vals.device

    schur = _schur_structure_for(pat) or build_schur_structure(pat)
    plan = band_plan(pat)

    def idx(a):
        # A copy from the host's memory to the card waits for the card.
        telemetry.inc("ipm.host_syncs")
        return torch.as_tensor(a, dtype=torch.long, device=dev)

    rows, cols = idx(pat.rows), idx(pat.cols)

    # --- Fixed-variable elimination: a barrier method needs a strict
    # interior, and the seasonal gate pins boxes to [0, 0].  Substitute the
    # fixed variables into the equalities, free their bounds, and restore
    # the pinned values on exit.  An inverted box (u < l) is infeasible by
    # construction and forced unsolved, never treated as fixed.
    both_fin = torch.isfinite(l_box) & torch.isfinite(u_box)
    width = u_box - l_box
    fixed = both_fin & (width >= 0) & (width <= 1e-9 * (1.0 + torch.abs(l_box)))
    inverted = torch.any(both_fin & (width < 0), dim=1)
    zero = torch.zeros((), dtype=vals.dtype, device=dev)
    fixval = torch.where(fixed, l_box, zero)

    row_cols, row_src = idx(pat.row_cols), idx(pat.row_src)
    col_rows, col_src = idx(pat.col_rows), idx(pat.col_src)
    b_eq = b_eq - torch.sum(_pad_gather(vals, row_src) * fixval[:, row_cols], dim=2)
    vals = torch.where(fixed[:, cols], zero, vals)
    q = torch.where(fixed, zero, q)
    l_box = torch.where(fixed, -math.inf, l_box)
    u_box = torch.where(fixed, math.inf, u_box)

    # Ruiz + cost equilibration.
    d, e_eq, e_box, c = ruiz_equilibrate_sparse(pat, vals, q, iters=ruiz_iters)
    vals_s = e_eq[:, rows] * vals * d[:, cols]
    vp_r = _pad_gather(vals_s, row_src)
    vp_c = _pad_gather(vals_s, col_src)
    qs = c * d * q
    bs = e_eq * b_eq
    fin_l = torch.isfinite(l_box)
    fin_u = torch.isfinite(u_box)
    # Bounds in the scaled variable x̂ = x/d.
    ls = torch.where(fin_l, l_box / d, -_BIG)
    us = torch.where(fin_u, u_box / d, _BIG)
    reg_s = c * d * d * reg  # scaled proximal diagonal (per entry)

    if x0 is not None:
        # Warm start pushed a safe distance into the strict interior, with
        # μ-scaled duals; slacks floored where the clip bounds cross.
        xw = torch.where(fixed, zero, x0 / d)
        width = torch.where(fin_l & fin_u, us - ls, 2.0)
        margin = torch.clamp(0.01 * width, min=1e-3)
        lo = torch.where(fin_l, ls + margin, -_BIG)
        hi = torch.where(fin_u, us - margin, _BIG)
        x = torch.minimum(torch.maximum(xw, lo), hi)   # jnp.clip order
        s_l = torch.where(fin_l, torch.clamp(x - ls, min=1e-4), 1.0)
        s_u = torch.where(fin_u, torch.clamp(us - x, min=1e-4), 1.0)
        z_l = torch.where(fin_l, warm_mu / torch.clamp(s_l, min=1e-3), 0.0)
        z_u = torch.where(fin_u, warm_mu / torch.clamp(s_u, min=1e-3), 0.0)
    else:
        x = torch.where(fin_l & fin_u, 0.5 * (ls + us),
                        torch.where(fin_l, ls + 1.0,
                                    torch.where(fin_u, us - 1.0, zero)))
        s_l = torch.where(fin_l, torch.clamp(x - ls, min=1.0), 1.0)
        s_u = torch.where(fin_u, torch.clamp(us - x, min=1.0), 1.0)
        z_l = torch.where(fin_l, 1.0, zero)
        z_u = torch.where(fin_u, 1.0, zero)
    y = torch.zeros((B, m), dtype=vals.dtype, device=dev)
    n_act = torch.clamp(torch.sum(fin_l, dim=1) + torch.sum(fin_u, dim=1), min=1)

    shared = dict(row_cols=row_cols, col_rows=col_rows,
                  perm_ix=idx(plan.perm), invp_ix=idx(plan.inv),
                  schur=schur_index(schur, dev),
                  band_ops=band_kernels.make_band_ops(plan, dev, fused=fused,
                                                            kernel=band_kernel),
                  freeze_zmax=freeze_zmax)
    data = (vals_s, vp_r, vp_c, qs, bs, ls, us, reg_s, fin_l, fin_u, n_act, c * d)
    x, y, s_l, s_u, z_l, z_u, cit, i_done = _run_phases(
        B, iters, tail_frac, tail_iters, eps_abs, eps_rel, data,
        (x, y, s_l, s_u, z_l, z_u), shared, world)

    # --- Final residuals in UNSCALED units (ADMM-convention norms).
    mvx = torch.sum(vp_r * x[:, row_cols], dim=2)
    r_prim = torch.amax(torch.abs((mvx - bs) / e_eq), dim=1)
    box_viol = torch.maximum(torch.where(fin_l, ls - x, zero),
                             torch.where(fin_u, x - us, zero))
    r_prim = torch.maximum(r_prim, torch.amax(box_viol * torch.abs(d), dim=1))
    dual = (reg_s * x + qs + torch.sum(vp_c * y[:, col_rows], dim=2)
            - z_l + z_u) / (c * d)
    r_dual = torch.amax(torch.abs(dual), dim=1)
    gap = _mean_gap(s_l, s_u, z_l, z_u, fin_l, fin_u, n_act)
    gap_u = gap / torch.clamp(torch.abs(torch.sum(qs * x, dim=1)), min=1.0)
    ok = ((r_prim <= 10 * eps_abs) & (r_dual <= 10 * eps_abs)
          & (gap_u <= max(10 * eps_rel, 1e-6)) & ~inverted)
    # Certified divergence, mirroring the loop-internal freeze criterion.
    rp_scaled = torch.amax(torch.abs(bs - mvx), dim=1)
    diverged = ((rp_scaled > 100 * max(eps_abs, 1e-6))
                & (_zmax(z_l, z_u, fin_l, fin_u) > freeze_zmax))

    x_out = torch.minimum(torch.maximum(d * x, l_box), u_box)  # jnp.clip order
    x_out = torch.where(fixed, fixval, x_out)
    return ADMMSolution(
        x=x_out,
        y_eq=e_eq * y / c,
        y_box=(z_u - z_l) * e_box / c,
        r_prim=r_prim,
        r_dual=r_dual,
        solved=ok,
        infeasible=torch.zeros((B,), dtype=torch.bool, device=dev),
        iters=i_done,
        rho=torch.ones((B,), dtype=vals.dtype, device=dev),
        conv_iters=cit,
        diverged=diverged & ~ok,
    )


def _mean_gap(s_l, s_u, z_l, z_u, fin_l, fin_u, n_act):
    """Mean complementarity over the active bounds."""
    return (torch.sum(s_l * z_l * fin_l, dim=1)
            + torch.sum(s_u * z_u * fin_u, dim=1)) / n_act


def _zmax(z_l, z_u, fin_l, fin_u):
    return torch.maximum(torch.amax(z_l * fin_l, dim=1),
                         torch.amax(z_u * fin_u, dim=1))


def _max_step(v, dv, active):
    """Largest step in [0, 1] keeping ``v + a·dv`` ≥ 0 on the active bounds."""
    r = torch.where(active & (dv < 0), -v / torch.clamp(dv, max=-1e-20), _BIG)
    return torch.clamp(torch.amin(r, dim=1), max=1.0)


def _make_loop(data, shared, eps_abs, eps_rel):
    """(body, converged) closures over one per-home data tuple."""
    (vals_s, vp_r, vp_c, qs, bs, ls, us, reg_s, fin_l, fin_u, n_act, cd) = data
    row_cols, col_rows = shared["row_cols"], shared["col_rows"]
    perm_ix, invp_ix = shared["perm_ix"], shared["invp_ix"]
    scatter_fn, _chol, band_solve_fn, add_diag_fn, factor_solve_fn = shared["band_ops"]
    zero = torch.zeros((), dtype=vals_s.dtype, device=vals_s.device)

    def mv(x):
        return torch.sum(vp_r * x[:, row_cols], dim=2)

    def mvt(y):
        return torch.sum(vp_c * y[:, col_rows], dim=2)

    def solve_kkt(Lb, Sb, theta_inv, r1, r2, refine=1):
        """[Θ Âᵀ; Â 0][dx; dy] = [r1; r2]: dy from the band factor with
        ``refine`` refinement passes, dx by back-substitution."""
        rhs = mv(theta_inv * r1) - r2
        dy = band_solve_fn(Lb, Sb, rhs[:, perm_ix], refine)[:, invp_ix]
        dx = theta_inv * (r1 - mvt(dy))
        return dx, dy

    def factor_solve_kkt(Sb, theta_inv, r1, r2):
        """solve_kkt at refine 0 with the band factor computed in the same
        call; returns (Lb, dx, dy)."""
        rhs = mv(theta_inv * r1) - r2
        Lb, dy_p = factor_solve_fn(Sb, rhs[:, perm_ix], 0)
        dy = dy_p[:, invp_ix]
        dx = theta_inv * (r1 - mvt(dy))
        return Lb, dx, dy

    def residual_vecs(x, y, z_l, z_u):
        r_dual = -(reg_s * x + qs + mvt(y) - z_l + z_u)     # stationarity
        r_prim = bs - mv(x)                                 # equality
        return r_dual, r_prim

    def converged_from(r_dual, r_prim, x, s_l, s_u, z_l, z_u):
        """Freeze verdict (converged, or certified-diverged: rp stalled far
        above tolerance while the box duals explode — the primal-infeasible
        signature) plus a residual score ranking stragglers."""
        rp = torch.amax(torch.abs(r_prim), dim=1)
        rd = torch.amax(torch.abs(r_dual) / cd, dim=1)
        gap = _mean_gap(s_l, s_u, z_l, z_u, fin_l, fin_u, n_act)
        gap_u = gap / torch.clamp(torch.abs(torch.sum(qs * x, dim=1)), min=1.0)
        ok = (rp <= eps_abs) & (rd <= 10 * eps_abs) & (gap_u <= max(eps_rel, 1e-7))
        diverged = ((rp > 100 * max(eps_abs, 1e-6))
                    & (_zmax(z_l, z_u, fin_l, fin_u) > shared["freeze_zmax"]))
        return ok | diverged, rp + rd + gap_u

    def converged(x, y, s_l, s_u, z_l, z_u):
        r_dual, r_prim = residual_vecs(x, y, z_l, z_u)
        return converged_from(r_dual, r_prim, x, s_l, s_u, z_l, z_u)

    def body(x, y, s_l, s_u, z_l, z_u, cit):
        """One Mehrotra iteration; frozen homes take zero-length steps.
        Returns the new iterate, the per-home live-iteration counts and
        the pre-step ``frozen`` verdict."""
        r_dual, r_prim = residual_vecs(x, y, z_l, z_u)
        frozen, _ = converged_from(r_dual, r_prim, x, s_l, s_u, z_l, z_u)
        theta = (reg_s + torch.where(fin_l, z_l / s_l, zero)
                 + torch.where(fin_u, z_u / s_u, zero))
        # f32 conditioning: cap the barrier diagonal and Tikhonov the Schur
        # diagonal; the refined corrector recovers the step's accuracy.
        theta = torch.minimum(torch.maximum(theta, reg_s), theta.new_tensor(1e6))
        # The scalar's copy to the card waits for the card: a host sync.
        telemetry.inc("ipm.host_syncs")
        theta = torch.where(frozen[:, None], 1.0, theta)  # benign factor input
        theta_inv = 1.0 / theta
        contrib = schur_contrib(shared["schur"], vals_s, theta_inv)
        Sb = add_diag_fn(scatter_fn(contrib), 1e-6)

        r_sl = torch.where(fin_l, x - ls - s_l, zero)
        r_su = torch.where(fin_u, us - x - s_u, zero)
        mu = _mean_gap(s_l, s_u, z_l, z_u, fin_l, fin_u, n_act)

        # --- Affine (predictor) direction: complementarity target 0; the
        # factor and this solve run unrefined (it only steers σ).
        rc_l = -s_l * z_l
        rc_u = -s_u * z_u
        r1 = (r_dual + torch.where(fin_l, (rc_l - z_l * r_sl) / s_l, zero)
              - torch.where(fin_u, (rc_u - z_u * r_su) / s_u, zero))
        Lb, dx_a, dy_a = factor_solve_kkt(Sb, theta_inv, r1, r_prim)
        ds_l_a = torch.where(fin_l, r_sl + dx_a, zero)
        ds_u_a = torch.where(fin_u, r_su - dx_a, zero)
        dz_l_a = torch.where(fin_l, (rc_l - z_l * ds_l_a) / s_l, zero)
        dz_u_a = torch.where(fin_u, (rc_u - z_u * ds_u_a) / s_u, zero)

        a_p = torch.minimum(_max_step(s_l, ds_l_a, fin_l), _max_step(s_u, ds_u_a, fin_u))
        a_d = torch.minimum(_max_step(z_l, dz_l_a, fin_l), _max_step(z_u, dz_u_a, fin_u))
        mu_aff = (
            torch.sum((s_l + a_p[:, None] * ds_l_a) * (z_l + a_d[:, None] * dz_l_a) * fin_l, dim=1)
            + torch.sum((s_u + a_p[:, None] * ds_u_a) * (z_u + a_d[:, None] * dz_u_a) * fin_u, dim=1)
        ) / n_act
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-12)) ** 3, 0.0, 1.0)

        # --- Corrector: target σμ − Mehrotra cross terms (refine 1).
        tgt = (sigma * mu)[:, None]
        rc_l = tgt - s_l * z_l - ds_l_a * dz_l_a
        rc_u = tgt - s_u * z_u - ds_u_a * dz_u_a
        r1 = (r_dual + torch.where(fin_l, (rc_l - z_l * r_sl) / s_l, zero)
              - torch.where(fin_u, (rc_u - z_u * r_su) / s_u, zero))
        dx, dy = solve_kkt(Lb, Sb, theta_inv, r1, r_prim)
        ds_l = torch.where(fin_l, r_sl + dx, zero)
        ds_u = torch.where(fin_u, r_su - dx, zero)
        dz_l = torch.where(fin_l, (rc_l - z_l * ds_l) / s_l, zero)
        dz_u = torch.where(fin_u, (rc_u - z_u * ds_u) / s_u, zero)

        eta = 0.99
        a_p = eta * torch.minimum(_max_step(s_l, ds_l, fin_l), _max_step(s_u, ds_u, fin_u))
        a_d = eta * torch.minimum(_max_step(z_l, dz_l, fin_l), _max_step(z_u, dz_u, fin_u))
        a_p = torch.where(frozen, zero, a_p)[:, None]
        a_d = torch.where(frozen, zero, a_d)[:, None]
        x_n = x + a_p * dx
        s_l_n = torch.where(fin_l, s_l + a_p * ds_l, s_l)
        s_u_n = torch.where(fin_u, s_u + a_p * ds_u, s_u)
        y_n = y + a_d * dy
        z_l_n = torch.where(fin_l, z_l + a_d * dz_l, z_l)
        z_u_n = torch.where(fin_u, z_u + a_d * dz_u, z_u)
        # Keep the iterates strictly interior in f32.
        s_l_n = torch.where(fin_l, torch.clamp(s_l_n, min=1e-10), 1.0)
        s_u_n = torch.where(fin_u, torch.clamp(s_u_n, min=1e-10), 1.0)
        z_l_n = torch.where(fin_l, torch.clamp(z_l_n, min=1e-12), zero)
        z_u_n = torch.where(fin_u, torch.clamp(z_u_n, min=1e-12), zero)
        # NaN guard: a home whose step blew up keeps its last finite iterate
        # (it fails the final residual check and falls back).
        fin_ok = (torch.all(torch.isfinite(x_n), dim=1)
                  & torch.all(torch.isfinite(y_n), dim=1)
                  & torch.all(torch.isfinite(z_l_n) & torch.isfinite(z_u_n), dim=1)
                  )[:, None]
        pick = lambda new, old: torch.where(fin_ok, new, old)  # noqa: E731
        return (pick(x_n, x), pick(y_n, y), pick(s_l_n, s_l), pick(s_u_n, s_u),
                pick(z_l_n, z_l), pick(z_u_n, z_u),
                cit + (~frozen).to(cit.dtype), frozen)

    return body, converged


def _while(body, limit, state, all_frozen, world=None):
    """``lax.while_loop`` over ``body`` while fewer than ``limit``
    iterations ran and not every home was frozen (pre-step) in the last
    one.  Checks ``frozen.all()`` on the host each iteration, so the count
    equals the JAX package's; with ``world``, every home of every rank
    (one small all-reduce an iteration)."""
    i = 0
    while i < limit and not all_frozen:
        *state, frozen = body(*state)
        all_frozen = bool(frozen.all())
        telemetry.inc("ipm.host_syncs")
        if world is not None:
            all_frozen = world.all(all_frozen)
        i += 1
    return state, i


def _run_phases(B, cap, tail_frac, tail_iters, eps_abs, eps_rel, data, carry0,
                shared, world=None):
    """Phase-1 full-batch Mehrotra loop, then optional tail compaction: the
    worst ``ceil(B·tail_frac)`` homes are gathered into a compact sub-batch
    that alone runs up to ``tail_iters`` more iterations.  Returns
    (x, y, s_l, s_u, z_l, z_u, conv_iters, iterations)."""
    body, _ = _make_loop(data, shared, eps_abs, eps_rel)
    do_tail = tail_frac > 0 and B >= 8 and cap > 10
    if do_tail:
        iters = min(cap, max(10, cap * 2 // 5))
        tail_iters = tail_iters or cap
    else:
        iters = cap
    cit = torch.zeros((B,), dtype=torch.int32, device=data[0].device)
    # Early exit once every home is frozen: frozen homes take zero-length
    # steps, so stopping there is output-identical to running the budget.
    with telemetry.span("ipm.phase1_s", event=False) as sp:
        (x, y, s_l, s_u, z_l, z_u, cit), i_done = _while(
            body, iters, (*carry0, cit), False, world)
        sp.set(iterations=i_done)

    if do_tail:
        with telemetry.span("ipm.tail_s", event=False) as sp:
            k = max(1, min(B - 1, math.ceil(B * float(tail_frac))))
            _, conv = _make_loop(data, shared, eps_abs, eps_rel)
            frozen, score = conv(x, y, s_l, s_u, z_l, z_u)
            # Frozen homes rank below any live straggler; non-finite scores
            # rank as the worst live straggler.
            score = torch.nan_to_num(score, nan=math.inf, posinf=math.inf)
            idx = torch.topk(torch.where(frozen, -1.0, score), k).indices
            body3, _ = _make_loop(tuple(a[idx] for a in data), shared, eps_abs,
                                  eps_rel)
            sub = tuple(a[idx] for a in (x, y, s_l, s_u, z_l, z_u, cit))
            all_frozen = bool(frozen.all())
            telemetry.inc("ipm.host_syncs")
            (x2, y2, s_l2, s_u2, z_l2, z_u2, cit2), i2 = _while(
                body3, tail_iters, sub, all_frozen)
            out = []
            for a, a2 in zip((x, y, s_l, s_u, z_l, z_u, cit),
                             (x2, y2, s_l2, s_u2, z_l2, z_u2, cit2)):
                a = a.clone()
                a[idx] = a2
                out.append(a)
            x, y, s_l, s_u, z_l, z_u, cit = out
            sp.set(iterations=i2)
        i_done += i2 if world is None else world.max(i2)
    return x, y, s_l, s_u, z_l, z_u, cit, i_done
