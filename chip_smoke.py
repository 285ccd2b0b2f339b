#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dragg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code on failure:

1. device: a CUDA card must be visible; prints its name and power limit;
2. build: compiles every kernel source in dragg_tpu_torch/csrc/ with nvcc
   (one nvcc per source, started together);
3. kernels: holds each band kernel against its plain PyTorch version on
   the card bit for bit (torch.equal) at every bucket shape of the main
   path (H = 24) and of a 48 h horizon, at the bucket's B, 10,000, a
   ragged 1,001 and 32 (one block of the largest plan), refine 0 and 1,
   the fused kernel equal to its plain version and to the split route;
   times kernel (``ms``: one call with the host's launch time, as every
   kernel of the line is timed; ``device_ms``: the device's time per
   call, launches queued back to back), plain version and the dense
   library yardstick (torch.linalg.cholesky_ex / torch.cholesky_solve)
   with CUDA events at the bucket's B, the fused kernel beside the split
   pair (factor, then solve at refine 0), and the kernels alone at 32
   homes (the measured chain floor); then the fused ReLU-QP window against
   its plain version at the bucket shapes and batch sizes, k = 25 and
   k = 1, and a slice of homes against the full batch bit for bit; at the
   main path's shapes, its error against a float64 evaluation at most
   twice the plain version's; times kernel (one call and device time) and
   plain version, which is also the iter_kernel = "lax" route (the
   batched-einsum chain) and the yardstick; then the same at the four
   bucket shapes of a 48 h horizon (B = bucket and 1,001), two of them on
   a 2-block cluster; then both at the six grid-block shapes (the buckets
   of a 10,000-home community under the stress_dr_outage pack at H = 24,
   whose grid events add the explicit p_grid block: bw 5 and 7, m 76 and
   101, the refined solve of (101, 7) on 16-home blocks, the window of
   m = 101 on its 512-thread shared-memory plan);
4. correctness on small inputs: interior-point and ReLU-QP objectives
   within 1 % of HiGHS on a 16-home, 24 h community QP; an 8-home engine
   run on the card against the same run on the CPU, for each solver;
5. main path, interior point: ``Aggregator(config, device="cuda").run()``
   on a 10,000-home mixed community (legacy bench mix), 24 h horizon, 24
   sim steps, through the split route (kernels 1 and 2), then again
   through the fused route (kernel 3), whose series must equal the split
   run's bit for bit;
6. main path, ReLU-QP: the same community and run with
   ``home.hems.solver = "reluqp"``, ``tpu.iter_kernel = "pallas"`` (the
   fused window kernel), ``tpu.precision = "f32"``;
7. kernel route against lax route on the card: a 1,000-home, 6-step
   ReLU-QP run both ways at a 4 h horizon, outputs equal under the
   flip-aware assertion set, and 3 steps at 24 h, its disagreement
   measured and held to noise bounds (route_check);
8. H = 48: a 1,000-home, 2-step ReLU-QP run through the fused window
   kernel (launch counts reset just before it), held against the lax
   route within route_check's H = 24 noise bounds;
9. resume and pipeline: the 10,000-home community in hourly chunks, the
   interior point over 2 steps with ``fleet.pipeline`` off, on, on
   stopped after 1 chunk and resumed (``simulation.resume``), on and off
   again, all bit-equal, then ReLU-QP through the fused window stopped after 1 of 2
   chunks and resumed, bit-equal to its uninterrupted run; seconds per
   step, ``phase_times``, checkpoint bytes and write seconds;
10. ``integer_repair = "resolve"``: for each solver an 8-home run on the
   card against the CPU, then 10,000 homes × 2 steps with solve rate,
   repair failures and launch counts (more a step than project mode's);
11. ``band_kernel = "xla"``: 1,000 homes × 2 IPM steps launch no band
   kernel and give the kernel route's bits;
12. the RL cases: the baseline over 36 hourly steps, then ``run_rl_agg``
   on the 10,000-home community, H = 24, the same 36 steps in daily
   chunks (24 and 12), the linear agent through the IPM's split route
   (solve rate ≥ 0.99 on day 1 and no more than 0.01 below the baseline's
   over the 36 steps, the reward price finite, within ±max_rp and not constant, the
   ridge refit running from step 34), the same run
   stopped after its first chunk and resumed bit for bit (results.json,
   the price, rl_data); the DDPG agent through the fused band route (its
   actor frozen to step 31, then moving); ReLU-QP through the fused window
   for 6 steps; one agent step's time and launches; 8 homes × 12 steps on
   the CPU against the card, step by step (the price and the agent within
   the CPU tests' tolerances, the community's series within phase 4's),
   and ``run_rl_simplified`` over 3 days on both, within the CPU tests'
   tolerances;
13. the fleet with scenarios: ``Aggregator(config, device="cuda").run()``
   on 4 communities × 2,500 homes (24 h weather offsets) under the
   stress_dr_outage pack (six home types, daily tariff shocks and DR
   calls, the day-2 outage), ``tpu.fix_tou_peak``, H = 24, 42 hourly
   steps in daily chunks (24 and 18) through the IPM's split route (no tail
   compaction, whose sub-batch depends on the batch): every band
   kernel of the route launched, on solved homes the DR cap and the
   islanding held within one duty count per appliance (+0.05 kW; the
   integer pin rounds the applied action), the solve rate per community
   and day; community 3 against its standalone run (community_base 3,
   through the fused band route, which the split route's kernels equal
   bit for bit; the same 42-step population, stopped after its first
   chunk) over that chunk, home by home before the home's first flip (a
   solved flag or applied duty counts that differ: float32 noise at the
   iteration cap or at a count's .5): the cost of homes without a
   battery and the temperatures within tests/test_fleet.py's bounds, the
   battery series and battery homes' cost within bounds set from
   ``python -m dragg_tpu_torch.fleet_witness`` (the same community at the
   fleet's batch sizes parts as far on the card), flags agreeing on ≥ 98
   % of home-steps and ≥ 85 % of home-steps before their home's first
   flip;
   the same fleet for 18 steps with ReLU-QP through the fused window,
   the same event checks; 12 homes (two of each type) × 2 communities
   with inline events, H = 6, 8 steps, the CPU against the card step by
   step, home-step by home-step where the home's bucket stopped below the
   iteration cap on both (at least 120 of 192): solved flags equal and
   the series within phase 4's 1e-2;
14. the fleet RL cases: ``run_rl_agg`` on 4 communities × 2,500 homes
   (legacy mix, no weather offset), H = 24: the shared linear agent
   through the IPM's split route for 30 hourly steps in daily chunks
   (solve rate ≥ 0.99 per community on day 1; each community's prices
   finite, within ±max_rp, not constant and apart from the others'; the
   shared ridge refit from step ⌊B/C⌋ + 1 = 9), the same run stopped
   after its first chunk (its fleet_rl.json holding the run's prices)
   and resumed bit for bit (results.json, the fleet_rl block, rl_data);
   the shared DDPG agent through the fused band route for 12 steps (its
   actor frozen until step ⌈B/C⌉ = 8, then moving); the per-community
   linear agents for 12 steps; ReLU-QP through the fused window for 6;
   ``rl.fleet.gradient = "mpc"``: the ValueError for ``band_kernel =
   "auto"`` and ``iter_kernel = "pallas"`` before any launch, then
   ReLU-QP on the lax route for 3 steps, score and mpc with
   ``mpc_weight`` 1e4 (drda finite and not all zero, θ_μ apart); the
   stress_dr_outage pack for 18 steps (event features non-zero every
   step, the DR cap held on solved homes); one fleet agent step's time and launches at C = 4 (shared
   linear, shared DDPG, per-community linear); 2 communities × 4 homes ×
   12 steps on the CPU against the card step by step (linear and DDPG:
   prices and agent within the CPU tests' tolerances, series within
   phase 4's); the simplified case with C = 8 over 3 days on both;
15. the run telemetry and the observatory, on by default in every run
   above: each main-path run's (phases 5 and 6) and the fleet's (phase
   13, its ev and heat_pump buckets among them) events.jsonl against its
   results.json (run.start and run.end, one chunk.done a chunk whose
   solve_rate and solver_iters are the Summary's, one solver.convergence
   a bucket whose histograms sum to the bucket's homes × steps, one
   solver.worst whose homes exist and whose largest r_prim is the
   chunk's r_prim_max, metrics.json with each bucket's conv-iters
   metric); the 8-home CPU-vs-card runs' (phase 4) solver.convergence
   records equal or their counts an adjacent bin apart; the kernel route
   against the lax route at H = 24 (phase 7, run through the aggregator,
   the kernel route with ``telemetry.forensics``): conv_iters counts an
   adjacent bin apart on at most 1 % of the home-steps, and a forensic
   dump a chunk naming solver.worst's homes with their state
   at the chunk's start; 10,000 homes × 4 hourly steps with the
   telemetry and the observatory on and off, IPM (split route) and
   ReLU-QP (the fused window): results.json bit-equal, every kernel
   launched as often, and one step of each under torch.profiler: the
   step's launches and device ms, the fold's (its launches are the
   difference a step), the fold alone timed with CUDA events;
   ``tpu.profile_dir`` on 1,000 homes × 2 hourly chunks (IPM): the
   second chunk's Chrome trace holds chol_kernel, refined_solve_kernel
   and the bus's span;
16. the ADMM (``home.hems.solver = "admm"``) and cyclic reduction: the
   refined band solve at refine 0, 1 and 2 (the ADMM's in-loop default,
   the IPM's, the ADMM's polish) bit-equal to its plain version at the
   four H = 24 bucket shapes and the six grid-block shapes, one call's
   ms and device ms at each refine; the ADMM within 1 % of HiGHS on the
   16-home, 24 h QP; 8 homes × 4 steps at H = 24 on the card against the
   CPU, each step from the CPU run's state, within the CPU tests'
   tolerances; the main path: ``Aggregator(config, device="cuda").run()``
   on the 10,000-home community, 24 steps, backend "auto" (the dense
   inverse at every bucket, no band or window kernel), solve rate ≥ 0.99,
   s a step, iterations, factorizations a step, one t = 0 step's launches
   under torch.profiler; ``admm_solve_backend = "band"``, 10,000 homes ×
   4 steps with the band kernels and with their plain versions on the
   card, the kernels launched and the runs bit-equal; 1,000 homes × 2
   steps of a bf16 Sinv (one refinement pass), the bf16x3 apply and
   Anderson depth 5 beside the float32 run, solve rates printed; ``band_kernel = "cr"`` on the interior point, 1,000
   homes × 4 steps against the split route within the CPU-vs-card
   tolerance;

then prints the phases line (each phase's seconds), the kernels JSON
line, the card line and, last, the result line.  Per-shape details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

N_HOMES = 10_000
BAND_SOURCE = "dragg_tpu_torch/csrc/band.cu"
REPLACES = {
    "banded_cholesky_t": "dragg_tpu/ops/pallas_band.py:346",
    "refined_banded_solve_t": "dragg_tpu/ops/pallas_band.py:446",
    "factor_refined_solve_t": "dragg_tpu/ops/pallas_band.py:514",
}
WINDOW = "fused_window"
WINDOW_SOURCE = "dragg_tpu_torch/csrc/iter.cu"
WINDOW_REPLACES = "dragg_tpu/ops/pallas_iter.py:180"
MAIN_HORIZON = 24
GRID = "grid24"   # kernel_phase's horizon tag of the grid-block shapes (H = 24)
# The fused window is held against its plain version at rtol 1e-3 / atol
# 1e-4 (dragg_tpu_torch/bench_window.check_window): the float32 sums run in
# another order (tests/test_pallas_iter.py holds the Pallas kernel so).
CHECK_EVERY = 25            # ReLU-QP's check window (ops/reluqp.py check_every)


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def community_config(n_homes: int, horizon: int, end: str, **tpu):
    # Imported here: main() first checks that the port is this checkout's.
    from dragg_tpu_torch.config import mixed_community_config

    return mixed_community_config(n_homes, horizon, end, **tpu)


# ------------------------------------------------------------ kernels
def dense_from_band(St):
    """(m, bw+1, B) lower band → dense symmetric (B, m, m)."""
    import torch

    m, bwp1, B = St.shape
    D = torch.zeros((B, m, m), device=St.device)
    i = torch.arange(m, device=St.device)
    for k in range(bwp1):
        rows = i[k:]
        D[:, rows, rows - k] = St[k:, k, :].T
        D[:, rows - k, rows] = St[k:, k, :].T
    return D


def exact(got, want, what: str) -> float:
    """Bit-for-bit equality of a kernel's result with its reference;
    returns the largest absolute difference (0.0)."""
    import torch

    err = (got - want).abs().max().item() if got.numel() else 0.0
    check(torch.equal(got, want), f"{what}: differs from its reference, max |difference| {err}")
    return err


def kernel_phase(shapes) -> dict:
    """Parity of every band kernel against its plain version, bit for bit,
    at every shape and batch size, timings at the bucket's B and at one
    block.  ``shapes`` is a list of (horizon, bucket, m, bw, B_bucket)."""
    import torch

    from dragg_tpu_torch.bench_band import band_bounds, band_fixture, chain_floor_cycles
    from dragg_tpu_torch.bench_window import cuda_ms
    from dragg_tpu_torch.ops import band_kernels as bk

    err = {k: 0.0 for k in REPLACES}
    per_shape, one_block = [], []
    hb = bk.BLOCK_HOMES
    for si, (h, bucket, m, bw, nb) in enumerate(shapes):
        for B in dict.fromkeys((nb, N_HOMES, 1001, hb)):
            what = f"H = {h} {bucket} (m={m}, bw={bw}) B={B}"
            St, r = band_fixture(m, bw, B, seed=100 * si + B % 97)
            L = bk.banded_cholesky_t(St, bw)
            Lp = bk.cholesky_t_plain(St, bw)
            torch.cuda.synchronize()
            err["banded_cholesky_t"] = max(err["banded_cholesky_t"],
                                           exact(L, Lp, f"banded_cholesky_t {what}"))
            for refine in (0, 1):
                x = bk.refined_banded_solve_t(L, St, r, bw, refine)
                xp = bk.refined_solve_t_plain(Lp, St, r, bw, refine)
                Lf, xf = bk.factor_refined_solve_t(St, r, bw, refine)
                torch.cuda.synchronize()
                err["refined_banded_solve_t"] = max(
                    err["refined_banded_solve_t"],
                    exact(x, xp, f"refined_banded_solve_t {what} refine={refine}"))
                # Its plain version, factor_solve_t_plain, is (Lp, xp).
                err["factor_refined_solve_t"] = max(
                    err["factor_refined_solve_t"],
                    exact(Lf, Lp, f"factor_refined_solve_t L {what} refine={refine}"),
                    exact(xf, xp, f"factor_refined_solve_t x {what} refine={refine}"),
                    exact(Lf, L, f"factor_refined_solve_t L, fused vs split, {what}"),
                    exact(xf, x, f"factor_refined_solve_t x, fused vs split, {what} "
                                 f"refine={refine}"))
            timed = {
                "banded_cholesky_t": lambda: bk.banded_cholesky_t(St, bw),
                "refined_banded_solve_t": lambda: bk.refined_banded_solve_t(L, St, r, bw, 1),
                "factor_refined_solve_t": lambda: bk.factor_refined_solve_t(St, r, bw, 0),
            }

            def split():
                # The split route's two launches for the fused kernel's (L, x).
                return bk.refined_banded_solve_t(bk.banded_cholesky_t(St, bw), St, r, bw, 0)

            if B == hb:
                # One wave of one or two blocks: the kernels' time is the
                # chain of one home's rows, the measured chain floor.
                row = dict(horizon=h, bucket=bucket, m=m, bw=bw, B=B, kernels={
                    name: dict(ms=cuda_ms(fn, 20), device_ms=cuda_ms(fn, 20, queued=True))
                    for name, fn in timed.items()},
                    split_device_ms=cuda_ms(split, 20, queued=True),
                    chain_floor_cycles={
                        "banded_cholesky_t": chain_floor_cycles("cholesky", bw),
                        "refined_banded_solve_t": chain_floor_cycles("solve", bw),
                        "factor_refined_solve_t": chain_floor_cycles("factor_solve", bw, 0)})
                one_block.append(row)
                log(f"kernels at one block, {what}: " + json.dumps(row["kernels"]))
            if B != nb:
                continue
            # Timings at the main path's shape: the IPM's calls are the
            # factor, the corrector solve (refine 1) and, fused, the
            # factor + predictor solve (refine 0).
            D = dense_from_band(St)
            Ld, _ = torch.linalg.cholesky_ex(D)
            rd = r.T.contiguous()[..., None]
            lib_chol = cuda_ms(lambda: torch.linalg.cholesky_ex(D), 10)
            lib_solve = cuda_ms(lambda: torch.cholesky_solve(rd, Ld), 10)
            plain = {
                "banded_cholesky_t": (lambda: bk.cholesky_t_plain(St, bw), lib_chol),
                "refined_banded_solve_t": (lambda: bk.refined_solve_t_plain(L, St, r, bw, 1),
                                           lib_solve),
                "factor_refined_solve_t": (lambda: bk.factor_solve_t_plain(St, r, bw, 0),
                                           lib_chol + lib_solve),
            }
            row = dict(horizon=h, bucket=bucket, m=m, bw=bw, B=B,
                       plans={k: bk.band_plan(m, bw, k, B, bk._sms(St.device))._asdict()
                              for k in bk.KERNEL_NAMES},
                       kernels={})
            for name, kern in timed.items():
                plain_fn, lib = plain[name]
                bound_ms, bound_by = band_bounds(m, bw, B)[name]
                row["kernels"][name] = dict(
                    ms=cuda_ms(kern, 20), device_ms=cuda_ms(kern, 20, queued=True),
                    plain_ms=cuda_ms(plain_fn, 3), bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=lib)
            row["kernels"]["factor_refined_solve_t"].update(
                split_ms=cuda_ms(split, 20), split_device_ms=cuda_ms(split, 20, queued=True))
            del D, Ld
            per_shape.append(row)
            log(f"kernels at {what}: " + json.dumps(row["kernels"]))
    return {"max_abs_err": err, "per_shape": per_shape, "one_block": one_block}


def window_phase(shapes, sizes=(N_HOMES, 1001)) -> dict:
    """The fused window against its plain version at every shape and at
    its bucket's B and each of ``sizes``, k = 25 and k = 1, a slice of
    homes against the full batch bit for bit; at the bucket's B, its error
    against a float64 evaluation at most twice the plain version's, and
    timings.  ``shapes`` is a list of (bucket, m, n, B_bucket)."""
    from dragg_tpu_torch.bench_window import (KW, check_window, cuda_ms, window_bounds,
                                              window_fixture)
    from dragg_tpu_torch.ops import iter_kernels as ik

    def kernel(args, k):
        return ik.fused_window(*args, k=k, **KW)

    err, per_shape = 0.0, []
    for si, (bucket, m, n, nb) in enumerate(shapes):
        plan = ik.window_plan(m, n)
        for B in dict.fromkeys((nb, *sizes)):
            args = window_fixture(m, n, B, seed=1000 + 100 * si + B % 97)
            for k in (CHECK_EVERY, 1):
                err = max(err, check_window(kernel, args, k, f"{bucket} (m={m}, n={n}) B={B}"))
            if B != nb:
                continue
            # Accuracy against a float64 evaluation of the same window (mean
            # relative error of the state, worst of x, z, nu, y): the kernel
            # must be about as accurate as its plain version.
            a64 = [a.double() for a in args]
            ref = ik.iterate(*a64[:9], tuple(a64[9:13]), k=CHECK_EVERY, **KW)
            del a64
            rel = {}
            for name, fn in (("kernel", ik.fused_window), ("plain", ik.fused_window_plain)):
                st = fn(*args, k=CHECK_EVERY, **KW)[0]
                rel[name] = max(((a.double() - r).abs().mean() / r.abs().mean()).item()
                                for a, r in zip(st, ref))
            del ref
            check(rel["kernel"] <= 2 * rel["plain"],
                  f"fused_window {bucket} (m={m}, n={n}): error against float64 "
                  f"{rel['kernel']:.3g}, the plain version's {rel['plain']:.3g}")
            t_b, t_o = window_bounds(m, n, B, CHECK_EVERY)
            plain_ms = cuda_ms(lambda: ik.fused_window_plain(*args, k=CHECK_EVERY, **KW), 3)
            def window():
                return ik.fused_window(*args, k=CHECK_EVERY, **KW)

            row = dict(bucket=bucket, m=m, n=n, B=B, k=CHECK_EVERY, plan=plan._asdict(),
                       ms=cuda_ms(window, 20), device_ms=cuda_ms(window, 20, queued=True),
                       # No single PyTorch call computes this window: the
                       # yardstick is the port's iter_kernel = "lax" route,
                       # which is the plain version.
                       plain_ms=plain_ms, library_ms=plain_ms,
                       bound_bytes_ms=1e3 * t_b, bound_ops_ms=1e3 * t_o,
                       f64_rel_err_kernel=rel["kernel"], f64_rel_err_plain=rel["plain"])
            per_shape.append(row)
            log(f"fused window at {bucket}: " + json.dumps(row))
            del args
    return {"max_abs_err": err, "per_shape": per_shape}


# ------------------------------------------------ small-input checks
def highs_check(solver: str) -> None:
    """Solutions on the card within 1 % of HiGHS, home by home, on the
    t = 0 QP of a 16-home mixed community at a 24 h horizon: the interior
    point, ReLU-QP through the fused window kernel (tests/test_reluqp.py
    _parity_check), or the ADMM on its dense inverse."""
    import numpy as np
    import torch
    from scipy.optimize import linprog

    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.ops.admm import admm_solve_qp
    from dragg_tpu_torch.ops.ipm import ipm_solve_qp
    from dragg_tpu_torch.ops.reluqp import reluqp_solve_qp

    with tempfile.TemporaryDirectory() as d:
        agg = Aggregator(community_config(16, 24, "2015-01-01 01", bucketed="false"),
                         outputs_dir=d, device="cuda")
        agg.get_homes()
        agg._build_engine()
    eng = agg.engine
    ctx = eng._buckets[0]
    qp, _ = eng._prepare(ctx, eng.init_state(), 0,
                         torch.zeros(eng.params.horizon, device="cuda"))
    qp_args = (ctx.static.pattern, qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q)
    if solver == "ipm":
        sol = ipm_solve_qp(*qp_args, iters=eng.params.ipm_iters, eps_abs=2e-4,
                           eps_rel=2e-4)
    elif solver == "admm":
        # The dense-inverse backend ("auto" at 16 homes), the engine's
        # iteration cap.
        sol = admm_solve_qp(*qp_args, iters=1500, eps_abs=1e-4, eps_rel=1e-4)
    else:
        sol = reluqp_solve_qp(*qp_args, iters=3000, eps_abs=1e-4, eps_rel=1e-4,
                              iter_kernel="pallas")
    pat = ctx.static.pattern
    vals, beq, lo, hi, q, x = (np.asarray(a.cpu(), np.float64) for a in
                               (qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q, sol.x))
    solved = sol.solved.cpu().numpy()
    n_checked = 0
    for i in range(vals.shape[0]):
        A = np.zeros((pat.m, pat.n))
        np.add.at(A, (np.asarray(pat.rows), np.asarray(pat.cols)), vals[i])
        bnds = [(a if np.isfinite(a) else None, b if np.isfinite(b) else None)
                for a, b in zip(lo[i], hi[i])]
        ref = linprog(q[i], A_eq=A, b_eq=beq[i], bounds=bnds, method="highs")
        if not ref.success:
            check(not solved[i], f"{solver} home {i}: HiGHS infeasible but solved")
            continue
        check(bool(solved[i]), f"{solver} home {i}: unsolved where HiGHS solves")
        gap = (q[i] @ x[i] - ref.fun) / max(abs(ref.fun), 1e-3)
        check(abs(gap) < 0.01, f"{solver} home {i}: objective gap {gap:.4%} vs HiGHS")
        n_checked += 1
    check(n_checked >= 8, f"{solver}: only {n_checked} homes comparable with HiGHS")
    log(f"HiGHS check ({solver}): {n_checked}/{vals.shape[0]} homes within 1 %")


def cpu_vs_cuda_check(**tpu) -> dict:
    """An 8-home, 4 h-horizon, 6-step bucketed engine run on the card
    against the same run on the CPU (plain band versions); ``tpu``
    overrides ``[tpu]`` keys.  Returns the two runs' observatory records
    compared (``convergence_match``)."""
    import numpy as np

    from dragg_tpu_torch.aggregator import Aggregator

    res, conv = {}, {}
    for dev in ("cpu", "cuda"):
        with tempfile.TemporaryDirectory() as d:
            agg = Aggregator(community_config(8, 4, "2015-01-01 06", bucketed="true", **tpu),
                             outputs_dir=d, device=dev)
            agg.run()
            with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
                res[dev] = json.load(f)
            conv[dev] = [r for r in events_of(agg.run_dir) if r["event"] == "solver.convergence"]
    worst = 0.0
    for name, series in res["cpu"].items():
        if name == "Summary":
            continue
        check(series["correct_solve"] == res["cuda"][name]["correct_solve"],
              f"{name}: solved flags differ between CPU and CUDA")
        for key, v in series.items():
            if isinstance(v, list):
                worst = max(worst, float(np.max(np.abs(
                    np.asarray(v) - np.asarray(res["cuda"][name][key])))))
    check(worst < ENGINE_CPU_CUDA_ATOL, f"CPU vs CUDA engine series differ by {worst} ({tpu})")
    log(f"CPU vs CUDA engine check {tpu}: max |difference| {worst:.3g}")
    return convergence_match(conv["cpu"], conv["cuda"], "CPU vs CUDA (8 homes)")


def engine_chunk(n_homes: int, horizon: int, steps: int, device: str,
                 solver: str = "reluqp", **tpu) -> tuple:
    """(StepOutputs as numpy, duty steps s) of a ``run_chunk`` from t = 0
    over ``steps`` steps of the mixed community (ReLU-QP by default)."""
    import numpy as np

    from dragg_tpu_torch.aggregator import Aggregator

    cfg = community_config(n_homes, horizon, "2015-01-02 00", **tpu)
    cfg["home"]["hems"]["solver"] = solver
    with tempfile.TemporaryDirectory() as d:
        agg = Aggregator(cfg, outputs_dir=d, device=device)
        agg.get_homes()
        agg._build_engine()
    eng = agg.engine
    _, out = eng.run_chunk(eng.init_state(), 0,
                           np.zeros((steps, eng.params.horizon), np.float32))
    return {f: getattr(out, f).cpu().numpy() for f in out._fields}, eng.params.s


def flip_aware_match(ref: dict, cmp: dict, s: float) -> None:
    """tests/test_reluqp.py's flip-aware assertion set (:333-403): solved
    flags equal; applied duty counts differ by at most one count, on at
    most 2 % of home-steps, and match on at least 95 %; aggregates within
    rtol 1e-2 / atol 5e-3; non-flip home-steps' cost within rtol 1e-2 /
    atol 2e-3, temperatures within 1e-2, battery series within 5e-3; flip
    home-steps within one count's worth."""
    import numpy as np

    def close(a, b, what, rtol=0.0, atol=0.0):
        check(bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b))),
              f"{what}: max |difference| {float(np.max(np.abs(a - b), initial=0.0)):.3g}")

    check(np.array_equal(cmp["correct_solve"], ref["correct_solve"]), "solved flags differ")
    flip = np.zeros(ref["cost"].shape, bool)
    exact = total = 0
    for key in ("hvac_cool_on", "hvac_heat_on", "wh_heat_on"):
        dc = np.abs(cmp[key] * s - ref[key] * s)
        where = [(int(k), int(i), float(ref[key][k, i] * s), float(cmp[key][k, i] * s),
                  float(ref["correct_solve"][k, i])) for k, i in np.argwhere(dc > 1 + 1e-3)]
        check(not where, f"{key}: a duty differs by more than one count at (step, home, "
                         f"counts, counts, solved) {where[:8]}")
        flip |= dc > 1e-3
        exact += int(np.sum(dc < 1e-3))
        total += dc.size
    check(exact / total >= 0.95, f"only {exact}/{total} actions match")
    check(flip.mean() <= 0.02, f"{int(flip.sum())} flip home-steps (> 2 %)")
    close(cmp["agg_cost"], ref["agg_cost"], "agg_cost", 1e-2, 5e-3)
    close(cmp["agg_load"], ref["agg_load"], "agg_load", 1e-2, 5e-3)
    nf = ~flip
    close(cmp["cost"][nf], ref["cost"][nf], "cost", 1e-2, 2e-3)
    for key, atol in (("temp_in", 1e-2), ("temp_wh", 1e-2), ("e_batt", 5e-3),
                      ("p_batt_ch", 5e-3), ("p_batt_disch", 5e-3)):
        close(cmp[key][nf], ref[key][nf], key, atol=atol)
    if flip.any():
        close(cmp["cost"][flip], ref["cost"][flip], "flip cost", atol=0.5)
        close(cmp["temp_in"][flip], ref["temp_in"][flip], "flip temp_in", atol=1.0)
        close(cmp["temp_wh"][flip], ref["temp_wh"][flip], "flip temp_wh", atol=1.0)


def reluqp_cpu_vs_cuda_check(**tpu) -> None:
    """An 8-home, 4 h-horizon, 12-step ReLU-QP engine run on the card (the
    fused window kernel) against the same run on the CPU (its plain
    version), crossing the bank refresh at t = 8; ``tpu`` overrides
    ``[tpu]`` keys."""
    cpu, s = engine_chunk(8, 4, 12, "cpu", bucketed="true", iter_kernel="pallas", **tpu)
    cuda, _ = engine_chunk(8, 4, 12, "cuda", bucketed="true", iter_kernel="pallas", **tpu)
    flip_aware_match(cpu, cuda, s)
    log(f"CPU vs CUDA ReLU-QP engine check {tpu}: flip-aware match, max |temp_in| "
        f"difference {float(abs(cpu['temp_in'] - cuda['temp_in']).max()):.3g}")


# ------------------------------------------------------- main path
def reset_launches() -> None:
    from dragg_tpu_torch.ops import band_kernels as bk
    from dragg_tpu_torch.ops import iter_kernels as ik

    bk.reset_launches()
    ik.reset_launches()


def launch_counts() -> dict:
    from dragg_tpu_torch.ops import band_kernels as bk
    from dragg_tpu_torch.ops import iter_kernels as ik

    return {**bk.LAUNCHES, **ik.LAUNCHES}


def drive(outputs_dir: str, solver: str = "ipm", **tpu):
    """One Aggregator run of the 10,000-home community (24 steps) through
    the public entry point, with every launch count reset just before it;
    returns (aggregator, results, launch counts, seconds)."""
    from dragg_tpu_torch.aggregator import Aggregator

    cfg = community_config(N_HOMES, 24, "2015-01-02 00", bucketed="auto", **tpu)
    cfg["home"]["hems"]["solver"] = solver
    agg = Aggregator(cfg, outputs_dir=outputs_dir, device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    agg.run()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
        results = json.load(f)
    return agg, results, launches, seconds


def check_results(res: dict, steps: int = 24) -> tuple[dict, list]:
    """Every home's series in results.json has the reference's length over
    ``steps`` steps and is finite; returns (Summary, per-home solved
    series)."""
    import numpy as np

    summary = res.pop("Summary")
    check(len(res) == N_HOMES, f"results.json holds {len(res)} homes")
    solved = []
    for name, series in res.items():
        for key, v in series.items():
            if isinstance(v, list):
                a = np.asarray(v, dtype=np.float64)
                want = steps + (key in ("temp_in_opt", "temp_wh_opt", "e_batt_opt"))
                check(a.shape == (want,) and np.all(np.isfinite(a)),
                      f"{name}.{key}: shape {a.shape} or non-finite values")
        solved.append(series["correct_solve"])
    return summary, solved


def main_path(outputs_dir: str) -> dict:
    import numpy as np

    agg, res, launches, seconds = drive(os.path.join(outputs_dir, "split"), band_fused=False)
    summary, solved = check_results(dict(res))
    check(launches["banded_cholesky_t"] > 0 and launches["refined_banded_solve_t"] > 0,
          f"main path did not launch the split-route kernels: {launches}")
    check(launches["factor_refined_solve_t"] == 0 and launches[WINDOW] == 0,
          f"split route launched other kernels: {launches}")
    iters = summary["solver_iterations"]
    phase = summary["phase_times"]
    stats = dict(
        homes=N_HOMES, steps=24, buckets=agg.engine.bucket_info(),
        solve_rate=float(np.mean(solved)), mean_ipm_iterations=float(np.mean(iters)),
        # One daily chunk: the engine steps' wall time over the 24 steps;
        # run_s adds home synthesis, the engine build and results.json.
        s_per_step=(phase["device_chunks"] + phase["collect"]) / 24,
        first_chunk_s_per_step=phase["device_chunks"] / 24,
        run_s=seconds, launches_split=launches,
    )
    log("main path (split): " + json.dumps(stats))
    stats["stream"] = stream_checks(agg, res, 24, "main path (split)")

    # The fused route: the same run, series equal to the split run's.
    agg2, res2, launches2, seconds2 = drive(os.path.join(outputs_dir, "fused"), band_fused=True)
    stream2 = stream_checks(agg2, res2, 24, "main path (fused)")
    phase2 = res2.pop("Summary")["phase_times"]
    check(launches2["factor_refined_solve_t"] > 0 and launches2["banded_cholesky_t"] == 0,
          f"fused route launches: {launches2}")
    for name, series in res2.items():
        for key, v in series.items():
            if isinstance(v, list):
                check(v == res[name][key], f"fused route differs from split at {name}.{key}")
    stats.update(launches_fused=launches2, run_s_fused=seconds2,
                 s_per_step_fused=(phase2["device_chunks"] + phase2["collect"]) / 24,
                 stream_fused=stream2)
    log(f"main path (fused): launches {launches2}, series equal to the split run's")
    return stats


def reluqp_main_path(outputs_dir: str) -> dict:
    """The 10,000-home, 24-step run with ReLU-QP through the fused window
    kernel (the rho bank rebuilt at t = 0, 8 and 16)."""
    import numpy as np

    agg, res, launches, seconds = drive(os.path.join(outputs_dir, "reluqp"), "reluqp",
                                        iter_kernel="pallas", precision="f32")
    stream = stream_checks(agg, res, 24, "main path (ReLU-QP)")
    summary, solved = check_results(res)
    check(agg.engine.iter_kernel == "pallas", f"iter_kernel {agg.engine.iter_kernel}")
    check(launches[WINDOW] > 0, f"ReLU-QP main path did not launch {WINDOW}: {launches}")
    check(all(v == 0 for k, v in launches.items() if k != WINDOW),
          f"ReLU-QP main path launched band kernels: {launches}")
    phase = summary["phase_times"]
    stats = dict(
        homes=N_HOMES, steps=24, solver="reluqp", iter_kernel="pallas",
        solve_rate=float(np.mean(solved)),
        mean_iterations=float(np.mean(summary["solver_iterations"])),
        iterations_per_step=summary["solver_iterations"],
        bank_fallback_count=agg.bank_fallback_total,
        s_per_step=(phase["device_chunks"] + phase["collect"]) / 24,
        run_s=seconds, launches=launches, stream=stream,
    )
    log("main path (ReLU-QP): " + json.dumps(stats))
    return stats


ROUTE_STEPS_H24 = 3


def route_check() -> dict:
    """The kernel route against the lax route on the card, 1,000 homes of
    the mixed community each way, 6 steps at H = 4 and ROUTE_STEPS_H24 at
    H = 24.  At a 4 h horizon (the horizon
    of tests/test_reluqp.py's fixture) the homes converge well inside the
    iteration cap, and the two routes must match under the flip-aware
    assertion set.  At the main path's 24 h a few homes stop at the cap on
    the tolerance, and whichever float32 summation order runs moves some
    across it (the lax route on the card and on the CPU disagree as much),
    so there the disagreement is measured and held to loose bounds: solved
    flags equal on ≥ 99 % of home-steps, duty counts within 2, aggregate
    cost within 2 %."""
    lax, s = engine_chunk(1000, 4, 6, "cuda", bucketed="auto", iter_kernel="lax")
    kern, _ = engine_chunk(1000, 4, 6, "cuda", bucketed="auto", iter_kernel="pallas")
    flip_aware_match(lax, kern, s)
    h4 = dict(solve_rate=float(kern["correct_solve"].mean()),
              iterations_kernel=kern["admm_iters"].tolist(),
              iterations_lax=lax["admm_iters"].tolist())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        # Through the aggregator (one chunk, the same steps as run_chunk's),
        # so the kernel route's run also writes its forensic dump.
        kern, s, kagg = aggregator_chunk(os.path.join(d, "kern"), 1000, 24, ROUTE_STEPS_H24,
                                         telemetry={"forensics": True}, bucketed="auto",
                                         iter_kernel="pallas")
        t1 = time.perf_counter()
        lax, _, lagg = aggregator_chunk(os.path.join(d, "lax"), 1000, 24, ROUTE_STEPS_H24,
                                        bucketed="auto", iter_kernel="lax")
        t2 = time.perf_counter()
        telemetry_legs = dict(forensics=forensics_checks(kagg, "route check (kernel route)"),
                              conv_iters=route_iters_noise(kagg, lagg))
    stats = dict(homes=1000, steps=6, steps_h24=ROUTE_STEPS_H24, horizon_4h_match=h4, horizon=24,
                 kernel_route_s=t1 - t0, lax_route_s=t2 - t1,
                 solve_rate_kernel=float(kern["correct_solve"].mean()),
                 solve_rate_lax=float(lax["correct_solve"].mean()),
                 iterations_kernel=kern["admm_iters"].tolist(),
                 iterations_lax=lax["admm_iters"].tolist(), **route_noise(kern, lax, s))
    log("kernel route vs lax route: flip-aware match at H = 4; " + json.dumps(stats))
    stats["telemetry"] = telemetry_legs
    check(within_noise(stats), f"kernel and lax routes disagree beyond the noise bounds: "
                               f"{stats}")
    return stats


def route_noise(kern: dict, lax: dict, s: float) -> dict:
    """How far two ReLU-QP runs of the same homes disagree: the share of
    home-steps whose solved flag differs, the largest duty-count
    difference and the largest relative aggregate-cost difference."""
    import numpy as np

    return dict(
        solved_flag_disagreement=float(np.mean(kern["correct_solve"] != lax["correct_solve"])),
        max_duty_count_difference=max(float(np.max(np.abs(kern[k] - lax[k]) * s))
                                      for k in ("hvac_cool_on", "hvac_heat_on", "wh_heat_on")),
        max_agg_cost_rel_difference=float(np.max(np.abs(kern["agg_cost"] - lax["agg_cost"])
                                                 / np.abs(lax["agg_cost"]))))


def within_noise(d: dict) -> bool:
    """route_check's bounds at H = 24: solved flags equal on ≥ 99 % of
    home-steps, duty counts within 2, aggregate cost within 2 %."""
    return (d["solved_flag_disagreement"] <= 0.01 and d["max_duty_count_difference"] <= 2 + 1e-3
            and d["max_agg_cost_rel_difference"] <= 0.02)


def h48_route_check() -> dict:
    """A 1,000-home × 2-step ReLU-QP run at a 48 h horizon through the
    fused window kernel (the two largest buckets on a 2-block cluster),
    its launch counts reset just before it and read just after, held
    against the same run through the lax route within route_check's
    H = 24 noise bounds."""
    import numpy as np

    reset_launches()
    t0 = time.perf_counter()
    kern, s = engine_chunk(1000, 48, 2, "cuda", bucketed="auto", iter_kernel="pallas")
    t1 = time.perf_counter()
    launches = launch_counts()
    lax, _ = engine_chunk(1000, 48, 2, "cuda", bucketed="auto", iter_kernel="lax")
    t2 = time.perf_counter()
    check(launches[WINDOW] > 0, f"the H = 48 ReLU-QP run did not launch {WINDOW}: {launches}")
    for key in ("agg_cost", "agg_load", "cost", "temp_in", "temp_wh", "e_batt"):
        check(bool(np.all(np.isfinite(kern[key]))), f"H = 48: non-finite {key}")
    stats = dict(homes=1000, steps=2, horizon=48, launches=launches,
                 kernel_route_s=t1 - t0, lax_route_s=t2 - t1,
                 solve_rate_kernel=float(kern["correct_solve"].mean()),
                 solve_rate_lax=float(lax["correct_solve"].mean()),
                 iterations_kernel=kern["admm_iters"].tolist(),
                 iterations_lax=lax["admm_iters"].tolist(), **route_noise(kern, lax, s))
    log("H = 48 kernel route vs lax route: " + json.dumps(stats))
    check(within_noise(stats), f"H = 48: kernel and lax routes disagree beyond the noise "
                               f"bounds: {stats}")
    return stats


# ------------------------------------------- resume, pipeline, resolve
RESUME_STEPS = 2          # hourly chunks of the IPM resume and pipeline runs
RESUME_STEPS_RELUQP = 2
RESOLVE_STEPS = 2


def hourly_drive(outputs_dir: str, steps: int, solver: str = "ipm", stop=None,
                 resume: bool = False, pipeline: bool = True, telemetry=None,
                 n_homes: int = N_HOMES, interval: str = "hourly", **tpu) -> dict:
    """One Aggregator run of the 10,000-home community in hourly chunks
    (a checkpoint after every step), with every launch count reset just
    before it; ``stop`` stops it after that many chunks, ``resume``
    restores the latest checkpoint; ``telemetry`` overrides ``[telemetry]``
    keys; ``interval = "daily"`` runs the steps as one chunk.  Returns the
    aggregator, results.json, the launch counts, the checkpoint writes'
    seconds and, when stopped, the bytes of the checkpoint left behind."""
    from dragg_tpu_torch.aggregator import Aggregator

    cfg = community_config(n_homes, 24, f"2015-01-01 {steps:02d}", bucketed="auto", **tpu)
    cfg["home"]["hems"]["solver"] = solver
    cfg["simulation"].update(checkpoint_interval=interval, resume=resume)
    cfg["fleet"]["pipeline"] = pipeline
    cfg["telemetry"].update(telemetry or {})
    agg = Aggregator(cfg, outputs_dir=outputs_dir, device="cuda")
    agg.stop_after_chunks = stop
    writes = []
    save = agg.save_checkpoint

    def timed_save(state):
        t0 = time.perf_counter()
        save(state)
        writes.append(time.perf_counter() - t0)

    agg.save_checkpoint = timed_save
    reset_launches()
    t0 = time.perf_counter()
    agg.run()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
        results = json.load(f)
    ckpt = agg._latest_checkpoint_dir()
    ckpt_bytes = ({name: os.path.getsize(os.path.join(ckpt, name)) for name in os.listdir(ckpt)}
                  if ckpt else None)
    return dict(agg=agg, results=results, launches=launches, run_s=run_s,
                checkpoint_write_s=writes, checkpoint_bytes=ckpt_bytes,
                phase_times=results["Summary"]["phase_times"],
                # Summary.solve_time: the baseline loop and the last
                # results.json, cumulative across a resume.
                s_per_step=results["Summary"]["solve_time"] / steps)


def same_results(got: dict, want: dict, what: str) -> None:
    """Every per-home series and the aggregates (the reward price among
    them) of two results.json bit for bit (JSON keeps float64 exactly)."""
    check(list(got) == list(want), f"{what}: different homes")
    for name, series in want.items():
        if name == "Summary":
            for key in ("p_grid_aggregate", "p_grid_setpoint", "solver_iterations", "RP"):
                check(got[name][key] == series[key], f"{what}: Summary.{key} differs")
            continue
        for key, v in series.items():
            if isinstance(v, list):
                check(got[name][key] == v, f"{what}: {name}.{key} differs")


def resume_pipeline_phase(outputs_dir: str) -> dict:
    """The interior point on the split route, 10,000 homes, H = 24, hourly
    chunks over RESUME_STEPS steps, three ways: the pipeline off, on, and
    on stopped after half the chunks and resumed; then ReLU-QP through the
    fused window stopped and resumed over RESUME_STEPS_RELUQP steps against
    its uninterrupted run.  All bit-equal."""
    half = RESUME_STEPS // 2
    off = hourly_drive(os.path.join(outputs_dir, "off"), RESUME_STEPS, pipeline=False)
    on = hourly_drive(os.path.join(outputs_dir, "on"), RESUME_STEPS)
    part = hourly_drive(os.path.join(outputs_dir, "res"), RESUME_STEPS, stop=half)
    check(part["agg"].timestep == half and part["checkpoint_bytes"],
          f"the stopped run left no checkpoint at t = {half}")
    res = hourly_drive(os.path.join(outputs_dir, "res"), RESUME_STEPS, resume=True)
    check(res["agg"].resumed_from is not None, "the resumed run did not resume")
    for run, what in ((off, "pipeline off"), (on, "pipeline on"), (res, "resumed")):
        check(run["launches"]["banded_cholesky_t"] > 0
              and run["launches"]["refined_banded_solve_t"] > 0,
              f"{what}: the split-route band kernels were not launched: {run['launches']}")
    # The A/B's second pair, in the other order (off, on, on, off).
    on2 = hourly_drive(os.path.join(outputs_dir, "on2"), RESUME_STEPS)
    off2 = hourly_drive(os.path.join(outputs_dir, "off2"), RESUME_STEPS, pipeline=False)
    same_results(on["results"], off["results"], "pipeline on vs off")
    same_results(res["results"], off["results"], "stopped and resumed vs uninterrupted")
    same_results(on2["results"], off2["results"], "pipeline on vs off (second pair)")
    ipm = {what: {k: run[k] for k in ("run_s", "s_per_step", "phase_times", "launches",
                                       "checkpoint_write_s", "checkpoint_bytes")}
           for what, run in (("pipeline_off", off), ("pipeline_on", on),
                             ("stopped", part), ("resumed", res),
                             ("pipeline_on_2", on2), ("pipeline_off_2", off2))}
    log("resume and pipeline (IPM, hourly, 10,000 homes): bit-equal; " + json.dumps(ipm))

    steps = RESUME_STEPS_RELUQP
    kw = dict(solver="reluqp", iter_kernel="pallas", precision="f32")
    full = hourly_drive(os.path.join(outputs_dir, "rq"), steps, **kw)
    part = hourly_drive(os.path.join(outputs_dir, "rq-res"), steps, stop=steps // 2, **kw)
    res = hourly_drive(os.path.join(outputs_dir, "rq-res"), steps, resume=True, **kw)
    check(res["agg"].resumed_from is not None, "the resumed ReLU-QP run did not resume")
    for run in (full, part, res):
        check(run["launches"][WINDOW] > 0, f"ReLU-QP resume: {WINDOW} not launched")
    same_results(res["results"], full["results"], "ReLU-QP stopped and resumed")
    rq = {what: {k: run[k] for k in ("run_s", "s_per_step", "phase_times", "launches",
                                      "checkpoint_write_s", "checkpoint_bytes")}
          for what, run in (("uninterrupted", full), ("stopped", part), ("resumed", res))}
    log("resume (ReLU-QP, hourly, 10,000 homes): bit-equal; " + json.dumps(rq))
    return {"ipm": ipm, "reluqp": rq}


def stepwise_cpu_vs_cuda(n_homes: int, horizon: int, steps: int, solver: str,
                         **tpu) -> tuple:
    """(CPU outputs, card outputs, duty steps s) of ``steps`` one-step
    chunks of the mixed community, both devices starting every step from
    the CPU run's state."""
    cfg = community_config(n_homes, horizon, "2015-01-02 00", **tpu)
    cfg["home"]["hems"]["solver"] = solver
    return stepwise_engines(cfg, steps)


def stepwise_engines(cfg: dict, steps: int, per_bucket: bool = False) -> tuple:
    """``stepwise_cpu_vs_cuda`` for any config (a fleet's too);
    ``per_bucket`` gives ``admm_iters`` per home, its bucket's count
    (``bucket_iterations``)."""
    import numpy as np

    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.checkpoint import tree_map

    engines = {}
    for dev in ("cpu", "cuda"):
        with tempfile.TemporaryDirectory() as d:
            agg = Aggregator(json.loads(json.dumps(cfg)), outputs_dir=d, device=dev)
            agg.get_homes()
            agg._build_engine()
        engines[dev] = agg.engine
        if per_bucket:
            bucket_iterations(agg.engine)
    rp = np.zeros((1, engines["cpu"].params.horizon), np.float32)
    state = engines["cpu"].init_state()
    outs = {"cpu": [], "cuda": []}
    for t in range(steps):
        nxt, out = engines["cpu"].run_chunk(state, t, rp)
        card = engines["cuda"].device
        _, out_c = engines["cuda"].run_chunk(tree_map(lambda a: a.to(card), state), t, rp)
        for dev, o in (("cpu", out), ("cuda", out_c)):
            outs[dev].append({f: getattr(o, f).cpu().numpy() for f in o._fields})
        state = nxt
    stack = lambda rows: {f: np.concatenate([r[f] for r in rows]) for f in rows[0]}  # noqa: E731
    return stack(outs["cpu"]), stack(outs["cuda"]), engines["cpu"].params.s


def bucket_iterations(engine) -> None:
    """Make ``engine``'s merged ``admm_iters`` per home: the iteration
    count of each home's bucket (the engine merges it as the largest
    over buckets)."""
    import torch

    merge = engine._merge_outputs

    def merged(outs):
        return merge(outs)._replace(admm_iters=torch.cat(
            [o.admm_iters.expand(o.correct_solve.shape) for o in outs]))

    engine._merge_outputs = merged


def resolve_phase(outputs_dir: str) -> dict:
    """``integer_repair = "resolve"``: for each solver, an 8-home run on the
    card against the same run on the CPU; then 10,000 homes ×
    RESOLVE_STEPS steps of the engine under "project" and under "resolve"
    (one population, two engines), with seconds per step, solve rate,
    repair failures and launch counts, which must be more a step under
    "resolve" (its second solve runs the same kernels again)."""
    import numpy as np
    import torch

    from dragg_tpu_torch.aggregator import Aggregator

    cpu_vs_cuda_check(integer_repair="resolve")
    # ReLU-QP step by step from the CPU run's state: an unsolved home whose
    # replayed plan puts its indoor temperature on its comfort bound flips
    # the fallback's bound check on float32 noise (the CPU and the card
    # differ by ~1e-6 degC after a few steps; heat jumps from the replayed
    # count to the cap), and a chunk run carries the flip on.
    cpu, cuda, s = stepwise_cpu_vs_cuda(8, 4, 12, solver="reluqp", bucketed="true",
                                        iter_kernel="pallas", integer_repair="resolve")
    flip_aware_match(cpu, cuda, s)
    log("CPU vs CUDA ReLU-QP engine check, integer_repair = resolve, step by step: "
        f"flip-aware match, max |temp_in| difference "
        f"{float(abs(cpu['temp_in'] - cuda['temp_in']).max()):.3g}")
    out = {}
    for solver, tpu, kernels in (
            ("ipm", {}, ("banded_cholesky_t", "refined_banded_solve_t")),
            ("reluqp", {"iter_kernel": "pallas", "precision": "f32"}, (WINDOW,))):
        cfg = community_config(N_HOMES, 24, "2015-01-02 00", bucketed="auto", **tpu)
        cfg["home"]["hems"]["solver"] = solver
        agg = Aggregator(cfg, outputs_dir=os.path.join(outputs_dir, f"resolve-{solver}"),
                         device="cuda")
        agg.get_homes()
        modes = {}
        for mode in ("project", "resolve"):
            agg.config["tpu"]["integer_repair"] = mode
            agg._build_engine()
            eng = agg.engine
            reset_launches()
            t0 = time.perf_counter()
            _, outs = eng.run_chunk(eng.init_state(), 0,
                                    np.zeros((RESOLVE_STEPS, eng.params.horizon), np.float32))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = launch_counts()
            res = {f: getattr(outs, f).cpu().numpy() for f in outs._fields}
            for k in ("agg_load", "agg_cost", "temp_in", "temp_wh", "p_grid"):
                check(bool(np.all(np.isfinite(res[k]))), f"{mode} ({solver}): non-finite {k}")
            modes[mode] = dict(
                s_per_step=seconds / RESOLVE_STEPS,
                solve_rate=float(res["correct_solve"].mean()),
                solve_rate_per_step=res["correct_solve"].mean(axis=1).tolist(),
                repair_failed_per_step=res["repair_failed"].tolist(),
                iterations_per_step=res["admm_iters"].tolist(),
                launches=launches,
                launches_per_step={k: launches[k] / RESOLVE_STEPS for k in kernels})
        p, r = modes["project"]["launches_per_step"], modes["resolve"]["launches_per_step"]
        for k in kernels:
            check(r[k] > p[k], f"resolve ({solver}): {k} launched {r[k]} a step, no more "
                               f"than project mode's {p[k]}")
        out[solver] = dict(homes=N_HOMES, steps=RESOLVE_STEPS, **modes,
                           launch_ratio={k: r[k] / p[k] for k in kernels})
        log(f"resolve vs project ({solver}, 10,000 homes): " + json.dumps(out[solver]))
    return out


def xla_route_check() -> dict:
    """``tpu.band_kernel = "xla"`` runs the plain band versions on the card:
    1,000 homes × 2 IPM steps launch no band kernel and give the same bits
    as the kernel route (the kernels are bit-equal to their plain
    versions on the card)."""
    import numpy as np

    reset_launches()
    plain, _ = engine_chunk(1000, 24, 2, "cuda", solver="ipm", bucketed="auto",
                            band_kernel="xla")
    launches = launch_counts()
    check(all(v == 0 for v in launches.values()),
          f'band_kernel = "xla" launched kernels: {launches}')
    reset_launches()
    kern, _ = engine_chunk(1000, 24, 2, "cuda", solver="ipm", bucketed="auto")
    check(launch_counts()["banded_cholesky_t"] > 0, "the kernel route launched no factor")
    for k, v in kern.items():
        check(np.array_equal(plain[k], v), f'band_kernel = "xla" differs from the kernels at {k}')
    log('band_kernel = "xla": no kernel launched, outputs equal to the kernel route')
    return {"launches": launches}


# ------------------------------------------------------------- RL cases
RL_STEPS = 36          # a daily chunk and 12 steps, past the ridge refit's first step (34)
RL_RELUQP_STEPS = 6
RL_CHECK_STEPS = 12    # CPU against the card: 8 homes, 4 h horizon
RL_SIMPLIFIED_END = "2015-01-04 00"  # a 3-day window
MAX_RP = 0.02          # agg.rl.max_rp (the default)
# The CPU tests' tolerances for the port against the JAX package
# (tests/test_torch_rl_runner.py): the reward price 1e-6, the simplified
# Summary 1e-5 and the agent's series 1e-4 of their largest magnitude.
# The community's series are held, the CPU against the card, to
# cpu_vs_cuda_check's 1e-2: the interior point on the two devices
# (float32 square roots rounded differently on the CPU) stops at
# different points of its 2e-4 tolerance, ~1e-3 apart at a step.
RL_RP_ATOL, RL_SIMPLIFIED_REL, RL_AGENT_REL = 1e-6, 1e-5, 1e-4
ENGINE_CPU_CUDA_ATOL = 1e-2


def rl_config(n_homes: int, horizon: int, steps: int, agent: str = "linear",
              solver: str = "ipm", bucketed: str = "auto", case: str = "rl_agg",
              **tpu) -> dict:
    """The mixed community running only ``case`` (``run_rl_agg``, or the
    baseline), ``steps`` hourly steps from 2015-01-01 00."""
    from datetime import datetime, timedelta

    end = (datetime(2015, 1, 1) + timedelta(hours=steps)).strftime("%Y-%m-%d %H")
    cfg = community_config(n_homes, horizon, end, bucketed=bucketed, **tpu)
    cfg["home"]["hems"]["solver"] = solver
    cfg["simulation"].update(run_rbo_mpc=case == "baseline", run_rl_agg=case == "rl_agg")
    cfg["rl"]["parameters"]["agent"] = agent
    return cfg


def rl_drive(outputs_dir: str, steps: int = RL_STEPS, agent: str = "linear",
             solver: str = "ipm", stop=None, resume: bool = False, case: str = "rl_agg",
             **tpu) -> dict:
    """One ``run_rl_agg`` (or, ``case="baseline"``, the baseline) of the
    10,000-home community in daily chunks through the public entry point,
    every launch count reset just before it and read just after; ``stop``
    stops it after that many chunks, ``resume`` restores the latest
    checkpoint."""
    from dragg_tpu_torch.aggregator import Aggregator

    cfg = rl_config(N_HOMES, MAIN_HORIZON, steps, agent, solver, case=case, **tpu)
    cfg["simulation"]["resume"] = resume
    agg = Aggregator(cfg, outputs_dir=outputs_dir, device="cuda")
    agg.stop_after_chunks = stop
    reset_launches()
    t0 = time.perf_counter()
    agg.run()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    case_dir = os.path.join(agg.run_dir, case)
    with open(os.path.join(case_dir, "results.json")) as f:
        results = json.load(f)
    rl_data = None
    if os.path.exists(os.path.join(case_dir, "utility_agent-results.json")):
        with open(os.path.join(case_dir, "utility_agent-results.json")) as f:
            rl_data = json.load(f)
    return dict(agg=agg, results=results, launches=launches, run_s=run_s, rl_data=rl_data)


def rl_checks(run: dict, steps: int, what: str, priced: bool = True) -> dict:
    """Every home's series complete and finite; for a ``priced`` (RL) run
    the reward price finite, within ±max_rp and not constant (the agent
    acted).  Returns the run's figures."""
    import numpy as np

    summary, solved = check_results(dict(run["results"]), steps)
    rp = np.asarray(summary["RP"])
    check(rp.shape == (steps,) and bool(np.all(np.isfinite(rp))), f"{what}: RP not finite")
    check(bool(np.all(np.abs(rp) <= MAX_RP + 1e-9)), f"{what}: RP beyond ±{MAX_RP}: {rp}")
    check(not priced or len(np.unique(rp)) > 1, f"{what}: RP constant, the agent did not act")
    phase = summary["phase_times"]
    solved = np.asarray(solved)
    return dict(homes=N_HOMES, steps=steps, solve_rate=float(np.mean(solved)),
                solve_rate_day_1=float(np.mean(solved[:, :24])),
                solve_rate_per_step=np.mean(solved, axis=0).tolist(),
                rp_min=float(rp.min()), rp_max=float(rp.max()),
                rp_distinct=int(len(np.unique(rp))),
                s_per_step=(phase["device_chunks"] + phase["collect"]) / steps,
                run_s=run["run_s"], launches=run["launches"],
                launches_per_step={k: v / steps for k, v in run["launches"].items()},
                mean_iterations=float(np.mean(summary["solver_iterations"])))


def agent_step_figures(agent: str) -> dict:
    """One agent step on the card alone (the 10,000-home run's
    hyperparameters, 40 steps in so every update is live): milliseconds a
    step over 20 steps between CUDA events, and kernel launches a step
    from torch.profiler's count of the host's launch calls over 4 steps."""
    import torch

    from dragg_tpu_torch.rl.agent import UtilityAgent
    from dragg_tpu_torch.rl.core import RLObservation

    ag = UtilityAgent(rl_config(N_HOMES, MAIN_HORIZON, RL_STEPS, agent), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)

    def obs(k):
        v = 0.1 * torch.randn(5, device="cuda", generator=g)
        return RLObservation(v[0], v[1], torch.full((), (k % 24) / 24, device="cuda"),
                             0.02 * v[3], -v[4] * v[4])

    carry = ag.carry
    for k in range(40):
        carry, _ = ag.scan_step(carry, obs(k))
    observations = [obs(k) for k in range(40, 60)]
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for o in observations:
        carry, _ = ag.scan_step(carry, o)
    end.record()
    torch.cuda.synchronize()
    out = dict(agent=agent, ms_per_step=start.elapsed_time(end) / len(observations))
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for o in observations[:4]:
                carry, _ = ag.scan_step(carry, o)
            torch.cuda.synchronize()
        calls = {e.key: e.count for e in prof.key_averages() if "LaunchKernel" in e.key}
        out["launches_per_step"] = sum(calls.values()) / 4
        out["launch_calls"] = calls
    except Exception as e:  # the launch count is a figure, not a check
        out["launches_per_step"] = f"not measured ({type(e).__name__}: {e})"
    log(f"agent step on the card ({agent}): " + json.dumps(out))
    return out


def rl_stepwise_cpu_vs_cuda(agent: str) -> dict:
    """8 homes, 4 h horizon, RL_CHECK_STEPS one-step chunks of run_rl_agg's
    step (observe, agent step, price, community, tracker), the CPU and the
    card each starting every step from the CPU run's carry (community,
    agent, environment): the price and the agent within the CPU tests'
    tolerances, the community's series within cpu_vs_cuda_check's."""
    import numpy as np

    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.checkpoint import host_snapshot, tree_map
    from dragg_tpu_torch.engine import OBS_FIELDS
    from dragg_tpu_torch.rl.agent import UtilityAgent
    from dragg_tpu_torch.rl.env import init_env_carry
    from dragg_tpu_torch.rl.runner import _rl_settings, run_chunk

    cfg = rl_config(8, 4, RL_CHECK_STEPS, agent, bucketed="true")
    side = {}
    for dev in ("cpu", "cuda"):
        with tempfile.TemporaryDirectory() as d:
            agg = Aggregator(cfg, outputs_dir=d, device=dev)
            agg.get_homes()
            agg._build_engine()
        side[dev] = (agg.engine, UtilityAgent(cfg, device=dev))
    settings, norm = _rl_settings(cfg), agg._max_possible_load()
    carry = (side["cpu"][0].init_state(), side["cpu"][1].carry,
             init_env_carry(8, settings["prev_n"], norm, "cpu"))
    worst = {"rp": 0.0, "agent": 0.0, "series": {}}
    for t in range(RL_CHECK_STEPS):
        nxt, got = run_chunk(*side["cpu"], settings, norm, carry, t, 1)
        _, got_c = run_chunk(*side["cuda"], settings, norm,
                             tree_map(lambda a: a.to("cuda"), carry), t, 1)
        (outs, recs, rp, _), (outs_c, recs_c, rp_c, _) = host_snapshot(got), host_snapshot(got_c)
        check(np.array_equal(outs.correct_solve, outs_c.correct_solve),
              f"RL CPU vs card ({agent}) t={t}: solved flags differ")
        for f in outs._fields:
            # The observatory's per-bucket leaves: phase 15 holds them.
            if np.asarray(getattr(outs, f)).dtype.kind == "f" and f not in OBS_FIELDS:
                worst["series"][f] = max(worst["series"].get(f, 0.0), float(np.max(np.abs(
                    getattr(outs, f) - getattr(outs_c, f)), initial=0.0)))
        worst["rp"] = max(worst["rp"], float(np.max(np.abs(rp - rp_c))))
        for a, b in zip(recs, recs_c):
            worst["agent"] = max(worst["agent"], float(
                np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)))
        carry = nxt
    check(max(worst["series"].values()) <= ENGINE_CPU_CUDA_ATOL and worst["rp"] <= RL_RP_ATOL
          and worst["agent"] <= RL_AGENT_REL,
          f"RL CPU vs card ({agent}): differences {worst} beyond the tolerances")
    log(f"RL CPU vs card, step by step ({agent}, 8 homes, H = 4): " + json.dumps(worst))
    return worst


def rl_simplified_check() -> dict:
    """``run_rl_simplified`` over a 3-day window (72 steps, 10,000 homes'
    normalizer), the card against the CPU: the Summary's series and the
    agent's within the CPU tests' tolerances."""
    import numpy as np

    from dragg_tpu_torch.aggregator import Aggregator

    out, seconds = {}, {}
    for dev in ("cpu", "cuda"):
        cfg = community_config(N_HOMES, MAIN_HORIZON, RL_SIMPLIFIED_END)
        cfg["simulation"].update(run_rbo_mpc=False, run_rl_simplified=True)
        with tempfile.TemporaryDirectory() as d:
            agg = Aggregator(cfg, outputs_dir=d, device=dev)
            t0 = time.perf_counter()
            agg.run()
            seconds[dev] = time.perf_counter() - t0
            case = os.path.join(agg.run_dir, "simplified")
            with open(os.path.join(case, "results.json")) as f:
                res = json.load(f)
            with open(os.path.join(case, "utility_agent-results.json")) as f:
                out[dev] = (res, json.load(f))
    (res, data), (res_c, data_c) = out["cpu"], out["cuda"]
    check(list(res_c) == ["Summary"], f"simplified results.json holds {list(res_c)}")
    worst = {}
    for key, tol, a, b in (
            *((k, RL_SIMPLIFIED_REL, res["Summary"][k], res_c["Summary"][k])
              for k in ("p_grid_aggregate", "RP", "p_grid_setpoint", "agg_cost")),
            *((k, RL_AGENT_REL, data[k], data_c[k]) for k in data if k != "parameters")):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        check(a.shape == b.shape and a.shape[0] == 72, f"simplified {key}: shape {b.shape}")
        worst[key] = float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30))
        check(worst[key] <= tol, f"simplified, card vs CPU: {key} differs by {worst[key]:.3g}")
    stats = dict(steps=72, rel_differences=worst, run_s_cpu=seconds["cpu"],
                 run_s_cuda=seconds["cuda"])
    log("RL simplified, card vs CPU: " + json.dumps(stats))
    return stats


def rl_phase(outputs_dir: str, baseline: dict) -> dict:
    """The RL aggregator on the card: the 10,000-home community, H = 24,
    RL_STEPS hourly steps in daily chunks, first the baseline, then through the
    IPM's split route with the linear agent (the ridge refit from step 34 on), the same run stopped
    after its first chunk and resumed, bit-equal; the DDPG agent through
    the fused band route (its actor frozen until step 32); ReLU-QP through
    the fused window for 6 steps; one agent step's time and launches; 8
    homes step by step on the CPU against the card; the simplified case
    on both.  ``baseline`` is the baseline main path's figures."""
    import numpy as np

    # The baseline over the same steps: day 2 (2015-01-02) holds homes
    # that no controller keeps in their comfort band, so the MPC's quality
    # is held at 0.99 on day 1 and, over both days, against the baseline's.
    base = rl_checks(rl_drive(os.path.join(outputs_dir, "rl-base"), case="baseline"),
                     RL_STEPS, f"baseline ({RL_STEPS} steps)", priced=False)
    log(f"baseline (10,000 homes, {RL_STEPS} steps): " + json.dumps(base))
    main = rl_drive(os.path.join(outputs_dir, "rl"))
    lin = rl_checks(main, RL_STEPS, "rl_agg (linear)")
    check(lin["solve_rate_day_1"] >= 0.99,
          f"rl_agg (linear): day-1 solve rate {lin['solve_rate_day_1']}")
    check(lin["solve_rate"] >= base["solve_rate"] - 0.01,
          f"rl_agg (linear): solve rate {lin['solve_rate']} below the baseline's "
          f"{base['solve_rate']} over the same steps")
    ln = main["launches"]
    check(ln["banded_cholesky_t"] > 0 and ln["refined_banded_solve_t"] > 0
          and ln["factor_refined_solve_t"] == 0 and ln[WINDOW] == 0,
          f"rl_agg (linear) did not run the split route's kernels alone: {ln}")
    # Column i of θ_q recorded at step k is column (k + 1) mod 2; the
    # ridge refit first fires at step 33 (post-increment t - 1 > 32).
    tq = np.asarray(main["rl_data"]["theta_q"])
    check(np.array_equal(tq[31], tq[1]) and np.array_equal(tq[32], tq[0]),
          "rl_agg (linear): θ_q moved before the ridge refit's first step")
    last = RL_STEPS - 1  # odd, as step 31
    change = [float(np.max(np.abs(tq[last] - tq[31]))),
              float(np.max(np.abs(tq[last - 1] - tq[32])))]
    check(min(change) > 0, f"rl_agg (linear): the ridge refit did not run ({change})")
    lin.update(theta_q_change_after_step_34=change,
               baseline_launches_per_step=base["launches_per_step"],
               baseline_main_path_launches_per_step={
                   k: baseline["launches_split"][k] / 24
                   for k in ("banded_cholesky_t", "refined_banded_solve_t")})
    log(f"rl_agg (linear, 10,000 homes, {RL_STEPS} steps): " + json.dumps(lin))

    part = rl_drive(os.path.join(outputs_dir, "rl-res"), stop=1)
    check(part["agg"].timestep == 24 and part["agg"]._latest_checkpoint_dir() is not None,
          "rl_agg stopped after one chunk left no checkpoint")
    res = rl_drive(os.path.join(outputs_dir, "rl-res"), resume=True)
    check(res["agg"].resumed_from is not None, "rl_agg did not resume")
    same_results(res["results"], main["results"], "rl_agg stopped and resumed")
    check(res["rl_data"] == main["rl_data"], "rl_agg resumed: rl_data differs")
    resume = {what: dict(run_s=run["run_s"], launches=run["launches"])
              for what, run in (("stopped", part), ("resumed", res))}
    log("rl_agg stopped after chunk 1 and resumed: bit-equal; " + json.dumps(resume))

    dd = rl_drive(os.path.join(outputs_dir, "rl-ddpg"), agent="ddpg", band_fused=True)
    ddpg = rl_checks(dd, RL_STEPS, "rl_agg (DDPG)")
    check(ddpg["solve_rate_day_1"] >= 0.99 and ddpg["solve_rate"] >= base["solve_rate"] - 0.01,
          f"rl_agg (DDPG): solve rate {ddpg['solve_rate']}, day 1 {ddpg['solve_rate_day_1']}")
    ln = dd["launches"]
    check(ln["factor_refined_solve_t"] > 0 and ln["banded_cholesky_t"] == 0,
          f"rl_agg (DDPG) did not run the fused route: {ln}")
    norms = dd["rl_data"]["theta_mu"]  # the actor's parameter norm, step by step
    check(len(set(norms[:32])) == 1 and norms[last] != norms[31],
          f"rl_agg (DDPG): the actor's norm {norms[30:34]} … {norms[last]} (frozen to step "
          f"31, then moving)")
    ddpg["actor_norm_change_after_step_32"] = abs(norms[last] - norms[31])
    log(f"rl_agg (DDPG, fused band route, 10,000 homes, {RL_STEPS} steps): "
        + json.dumps(ddpg))

    rq = rl_drive(os.path.join(outputs_dir, "rl-reluqp"), RL_RELUQP_STEPS, solver="reluqp",
                  iter_kernel="pallas", precision="f32")
    reluqp = rl_checks(rq, RL_RELUQP_STEPS, "rl_agg (ReLU-QP)")
    ln = rq["launches"]
    check(ln[WINDOW] > 0 and all(v == 0 for k, v in ln.items() if k != WINDOW),
          f"rl_agg (ReLU-QP) did not run the fused window alone: {ln}")
    log("rl_agg (ReLU-QP, fused window, 10,000 homes, 6 steps): " + json.dumps(reluqp))

    agent_steps = {a: agent_step_figures(a) for a in ("linear", "ddpg")}
    for stats, a in ((lin, "linear"), (ddpg, "ddpg")):
        stats["agent_step_share"] = agent_steps[a]["ms_per_step"] / 1e3 / stats["s_per_step"]
    stepwise = {a: rl_stepwise_cpu_vs_cuda(a) for a in ("linear", "ddpg")}
    return dict(baseline=base, linear=lin, resume=resume, ddpg=ddpg, reluqp=reluqp,
                agent_step=agent_steps,
                cpu_vs_cuda=stepwise, simplified=rl_simplified_check())

# ------------------------------------------------- fleet with scenarios
FLEET_C = 4              # communities of N_HOMES // FLEET_C homes
FLEET_STEPS = 42         # a daily chunk and 18 steps: both DR calls and the day-2 outage
FLEET_RELUQP_STEPS = 18  # the first DR call (15-17)
FLEET_CPU_STEPS = 8
FLEET_CPU_MIN_COMPARED = 120   # of its 192 home-steps (152 below the cap on the CPU)
PACK = "stress_dr_outage"
# The pack's events in sim hours (data/packs/stress_dr_outage.toml): a DR
# call at 15-17 daily with a 2 kW cap, the outage at 34-35.
DR_STEPS, OUTAGE_STEPS, DR_CAP_KW = (15, 16, 17, 39, 40, 41), (34, 35), 2.0
# tests/test_torch_scenario_runs.py's bound on solved homes: the cap (0
# for the outage) plus one duty count per appliance (the integer pin
# rounds the applied action) plus 0.05 kW.
EVENT_ATOL = 0.05
COMMUNITY_MATCH_MIN_AGREE = 0.98
COMMUNITY_MATCH_MIN_COMPARED = 0.85
BATTERY_ATOL = 0.5         # kWh and kW: 2.5 × the witness's 0.203 (PERF.md)
STORAGE_COST_ATOL = 0.4    # $: 2.6 × its 0.155
# (rtol, atol) per series of community_match: tests/test_fleet.py's for
# the cost of homes without storage and the temperatures; the battery
# series and the cost of battery and EV homes from the batch witness.
COMMUNITY_TOLS = {"cost": (1e-2, 2e-3), "temp_in": (0.0, 1e-3), "temp_wh": (0.0, 1e-3),
                  "cost (storage homes)": (0.0, STORAGE_COST_ATOL),
                  "e_batt": (0.0, BATTERY_ATOL), "p_batt_ch": (0.0, BATTERY_ATOL),
                  "p_batt_disch": (0.0, BATTERY_ATOL)}


def scenario_config(homes_per_community: int, horizon: int, steps: int,
                    communities: int = 1, **tpu) -> dict:
    """The mixed community under the stress_dr_outage pack (its mix
    replaces the legacy one), ``tpu.fix_tou_peak``, 24 h weather offsets
    between communities, ``steps`` hourly steps from 2015-01-01 00."""
    from dragg_tpu_torch.config import pack_fleet_config

    return pack_fleet_config(homes_per_community, horizon, steps, communities, PACK, **tpu)


def fleet_drive(outputs_dir: str, steps: int, solver: str = "ipm", communities: int = FLEET_C,
                base: int = 0, stop=None, **tpu) -> dict:
    """One Aggregator run of the fleet (or, ``communities=1``, community
    ``base`` of it alone) through the public entry point, every launch
    count reset just before it and read just after; ``stop`` stops it
    after that many daily chunks (the homes' water draws are drawn for the
    whole run, so a shorter run would be another population)."""
    from dragg_tpu_torch.aggregator import Aggregator

    cfg = scenario_config(N_HOMES // FLEET_C, MAIN_HORIZON, steps, communities, **tpu)
    cfg["home"]["hems"]["solver"] = solver
    cfg["fleet"]["community_base"] = base
    agg = Aggregator(cfg, outputs_dir=outputs_dir, device="cuda")
    agg.stop_after_chunks = stop
    reset_launches()
    t0 = time.perf_counter()
    agg.run()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
        results = json.load(f)
    return dict(agg=agg, results=results, launches=launches, run_s=run_s)


def series_matrix(run: dict, key: str, steps: int):
    """(steps, homes) of one per-home series of results.json, in all_homes
    order; the state series drop their leading initial value."""
    import numpy as np

    res = run["results"]
    lead = key in ("temp_in_opt", "temp_wh_opt", "e_batt_opt")
    return np.array([res[h["name"]][key][lead:lead + steps] for h in run["agg"].all_homes],
                    dtype=np.float64).T


def event_checks(run: dict, steps: int, what: str) -> dict:
    """Every home's series finite and complete; on solved homes the DR cap
    and the islanding held (DR_STEPS, OUTAGE_STEPS within ``steps``);
    the solve rate per community and day."""
    import numpy as np

    agg = run["agg"]
    summary, _ = check_results(dict(run["results"]), steps)
    s = float(agg.config["home"]["hems"]["sub_subhourly_steps"])
    slack = max((float(h["hvac"]["p_c"]) + float(h["hvac"]["p_h"]) + float(h["wh"]["p"])) / s
                for h in agg.all_homes)
    pg = series_matrix(run, "p_grid_opt", steps)
    ok = series_matrix(run, "correct_solve", steps) > 0
    dr = [k for k in DR_STEPS if k < steps]
    out = [k for k in OUTAGE_STEPS if k < steps]
    check(bool(ok[dr].any()), f"{what}: no home solved in a DR step")
    worst_dr = float(np.max(pg[dr][ok[dr]]))
    check(worst_dr <= DR_CAP_KW + slack + EVENT_ATOL,
          f"{what}: a solved home drew {worst_dr} kW in a DR step (cap {DR_CAP_KW}, "
          f"one count per appliance {slack})")
    worst_out = float(np.max(np.abs(pg[out][ok[out]]), initial=0.0)) if out else None
    if out:
        check(worst_out <= slack + EVENT_ATOL,
              f"{what}: a solved home drew {worst_out} kW in the outage")
    B = len(agg.all_homes) // agg.n_communities
    rate = {f"c{c}": [float(ok[d * 24:(d + 1) * 24, c * B:(c + 1) * B].mean())
                      for d in range(-(-steps // 24))] for c in range(agg.n_communities)}
    phase = summary["phase_times"]
    return dict(homes=len(agg.all_homes), communities=agg.n_communities, steps=steps,
                buckets=[[b["name"], b["n_real"], b["m_eq"], b["n_var"], b["band_bw"]]
                         for b in agg.engine.bucket_info()],
                solve_rate=float(ok.mean()), solve_rate_per_community_day=rate,
                solve_rate_dr_steps=float(ok[dr].mean()),
                solve_rate_outage_steps=float(ok[out].mean()) if out else None,
                max_p_grid_dr_solved=worst_dr, max_abs_p_grid_outage_solved=worst_out,
                duty_count_slack_kw=slack,
                s_per_step=(phase["device_chunks"] + phase["collect"]) / steps,
                run_s=run["run_s"], launches=run["launches"],
                launches_per_step={k: v / steps for k, v in run["launches"].items()},
                iterations_per_step=summary["solver_iterations"],
                mean_iterations=float(np.mean(summary["solver_iterations"])))


def results_series(results: dict, names: list, steps: int) -> dict:
    """``fleet_witness.compare_homes``'s (steps, homes) series of the homes
    ``names`` from results.json (a home without a battery: zeros)."""
    import numpy as np

    keys = dict(correct_solve="correct_solve", hvac_cool_on="hvac_cool_on_opt",
                hvac_heat_on="hvac_heat_on_opt", wh_heat_on="wh_heat_on_opt", cost="cost_opt",
                temp_in="temp_in_opt", temp_wh="temp_wh_opt", e_batt="e_batt_opt",
                p_batt_ch="p_batt_ch", p_batt_disch="p_batt_disch")
    lead = ("temp_in", "temp_wh", "e_batt")  # their leading initial value
    return {k: np.array([results[n][src][int(k in lead):int(k in lead) + steps]
                         if src in results[n] else np.zeros(steps) for n in names],
                        dtype=np.float64).T
            for k, src in keys.items()}


def community_match(fleet: dict, solo: dict, community: int, steps: int) -> dict:
    """Community ``community`` of the fleet run against its standalone run
    over the first ``steps`` steps, home by home (the homes are
    independent), with ``fleet_witness.compare_homes``: each home on its
    steps before its first flip (a solved flag that differs, or applied
    duty counts more than ``fleet_witness.FLIP_COUNTS`` apart), held to
    COMMUNITY_TOLS.  The cost of a home without a battery or an EV and the
    temperatures are held to tests/test_fleet.py's bounds for those
    series; the cost of a home with a battery or an EV and the battery
    series to bounds set from ``python -m dragg_tpu_torch.fleet_witness``
    on the card (PERF.md, Findings).  The two runs differ at all only
    because a float32 sum over a row of odd length takes another order at
    another alignment of the row there (the pv_battery, battery_only and
    ev buckets; ``replica_check`` holds the rest bit for bit), and the
    near-degenerate battery and EV coordinates carry that noise on.
    Flags agree on at least COMMUNITY_MATCH_MIN_AGREE of the home-steps,
    and at least COMMUNITY_MATCH_MIN_COMPARED of them come before their
    home's first flip."""
    import numpy as np

    from dragg_tpu_torch.fleet_witness import compare_homes

    names = [h["name"] for h in solo["agg"].all_homes]
    fres, sres = fleet["results"], solo["results"]
    check(all(n.startswith(f"c{community}-") for n in names) and all(n in fres for n in names),
          f"community {community}'s homes are not the fleet's")
    s = float(solo["agg"].config["home"]["hems"]["sub_subhourly_steps"])
    battery = np.array(["battery" in h["type"] for h in solo["agg"].all_homes])
    storage = battery | np.array([h["type"] == "ev" for h in solo["agg"].all_homes])
    stats = compare_homes(results_series(sres, names, steps), results_series(fres, names, steps),
                          s, battery, storage, COMMUNITY_TOLS)
    stats = dict(community=community, **stats)
    log(f"community {community} vs standalone: " + json.dumps(stats))
    check(not stats["violations"], f"community {community} vs standalone: {stats['violations']}")
    check(stats["solved_flag_agreement"] >= COMMUNITY_MATCH_MIN_AGREE
          and stats["compared_share"] >= COMMUNITY_MATCH_MIN_COMPARED,
          f"community {community} vs standalone: {stats}")
    return stats


def replica_check(fleet: dict, solo: dict, community: int, steps: int) -> dict:
    """Community ``community`` at the fleet's batch sizes: FLEET_C copies
    of its run alone in one engine (``fleet_witness.replica_engine``, the
    rows of copy c where the fleet has community c), one chunk of
    ``steps`` steps.  Copies 0 and 2, whose rows sit where the run alone
    has them modulo 4 (every bucket's batch is even), equal the run alone
    bit for bit, and copy ``community`` equals the fleet's community bit
    for bit: the fleet's wiring adds nothing to a home's solve, and what
    parts the fleet's community from its run alone is where its rows lie
    (a float32 sum over a row of odd length takes another order at
    another alignment on the card; ``python -m
    dragg_tpu_torch.fleet_witness``)."""
    import numpy as np

    from dragg_tpu_torch.fleet_witness import BATTERY_SERIES, engine_series, replica_engine

    names = [h["name"] for h in solo["agg"].all_homes]
    battery = np.array(["battery" in h["type"] for h in solo["agg"].all_homes])
    B = len(names)
    rep, seconds = engine_series(replica_engine(solo["agg"], FLEET_C), steps)
    copy = lambda c: {k: v[:, c * B:(c + 1) * B] for k, v in rep.items()}  # noqa: E731

    def differing(a: dict, b: dict) -> list:
        return [k for k in a if not np.array_equal(
            a[k][:, battery] if k in BATTERY_SERIES else a[k],
            b[k][:, battery] if k in BATTERY_SERIES else b[k])]

    alone = results_series(solo["results"], names, steps)
    in_fleet = results_series(fleet["results"], names, steps)
    bad = {f"copy {c} vs alone": differing(alone, copy(c)) for c in (0, 2)}
    bad[f"copy {community} vs the fleet's community {community}"] = differing(
        in_fleet, copy(community))
    stats = dict(homes=B * FLEET_C, steps=steps, run_s=seconds, series_differing=bad)
    log("community 3 at the fleet's batch sizes: " + json.dumps(stats))
    check(not any(bad.values()), f"the replica's copies are not bit-equal: {bad}")
    return stats


def fleet_cpu_vs_cuda() -> dict:
    """12 homes (two of each of the six types) × 2 communities, 24 h
    weather offsets, a tariff shock, a DR call (4 kW) and an outage in
    the first 8 hours, H = 6, 8 one-step chunks, the CPU and the card each
    from the CPU run's state, compared home-step by home-step: where the
    home's bucket stopped below the iteration cap on both devices (at
    least FLEET_CPU_MIN_COMPARED of the 192 home-steps; 152 on the CPU),
    solved flags equal and every series within phase 4's 1e-2; flags
    equal on ≥ 95 % of all home-steps."""
    import numpy as np

    from dragg_tpu_torch.config import default_config
    from dragg_tpu_torch.engine import OBS_FIELDS

    cfg = default_config()
    cfg["community"].update(total_number_homes=12, homes_pv=2, homes_battery=2,
                            homes_pv_battery=2, homes_ev=2, homes_heat_pump=2)
    cfg["simulation"].update(start_datetime="2015-01-01 00", end_datetime="2015-01-02 00")
    cfg["home"]["hems"]["prediction_horizon"] = 6
    cfg["fleet"].update(communities=2, weather_offset_hours=24)
    cfg["tpu"].update(fix_tou_peak=True, bucketed="true")
    cfg["scenarios"]["events"] = [
        dict(kind="tariff_shock", start_hour=1, duration_hours=3, price_delta=0.1),
        dict(kind="dr", start_hour=2, duration_hours=3, p_cap_kw=4.0, comfort_relax_degc=1.5),
        dict(kind="outage", start_hour=5, duration_hours=2, comfort_relax_degc=2.0)]
    cpu, cuda, _ = stepwise_engines(cfg, FLEET_CPU_STEPS, per_bucket=True)
    cap = 16 + 6 // 2  # engine_params' ipm_iters at H = 6
    agree = cpu["correct_solve"] == cuda["correct_solve"]
    below = (cpu["admm_iters"] < cap) & (cuda["admm_iters"] < cap)
    compared = int(below.sum())
    check(compared >= FLEET_CPU_MIN_COMPARED,
          f"fleet CPU vs card: {compared} home-steps below the cap")
    check(bool(agree[below].all()), "fleet CPU vs card: solved flags differ below the cap")
    check(float(agree.mean()) >= 0.95, f"fleet CPU vs card: flags agree on {agree.mean():.3f}")
    # Per-home series only: the observatory's leaves are per bucket (phase
    # 15 holds them, CPU against the card).
    worst = {f: float(np.max(np.abs(cpu[f][below] - cuda[f][below]), initial=0.0))
             for f in cpu if cpu[f].dtype.kind == "f" and cpu[f].ndim == 2
             and f not in OBS_FIELDS}
    check(max(worst.values()) <= ENGINE_CPU_CUDA_ATOL,
          f"fleet CPU vs card: series differ by {worst}")
    stats = dict(homes=24, steps=FLEET_CPU_STEPS, home_steps=int(below.size),
                 home_steps_compared=compared,
                 solved_flag_agreement=float(agree.mean()), max_abs_differences=worst)
    log("fleet CPU vs card, step by step: " + json.dumps(stats))
    return stats


def fleet_phase(outputs_dir: str) -> dict:
    """Phase 13: the fleet with scenarios (see the module docstring)."""
    # The interior point's tail compaction picks the worst quarter of a
    # bucket's batch, which depends on the batch's composition: the fleet
    # and the community alone run without it (as tests/test_fleet.py
    # does), so each home's iterates depend on its own QP alone.
    ipm_run = fleet_drive(os.path.join(outputs_dir, "fleet"), FLEET_STEPS, ipm_tail_frac=0.0)
    ipm = event_checks(ipm_run, FLEET_STEPS, "fleet (IPM)")
    ln = ipm_run["launches"]
    check(ln["banded_cholesky_t"] > 0 and ln["refined_banded_solve_t"] > 0
          and ln["factor_refined_solve_t"] == 0 and ln[WINDOW] == 0,
          f"fleet (IPM) did not run the split route's kernels alone: {ln}")
    check(ipm_run["agg"].engine.n_communities == FLEET_C
          and ipm_run["agg"].engine.events is not None, "fleet (IPM): not a fleet with events")
    log(f"fleet (IPM, 4 × 2,500 homes, {FLEET_STEPS} steps): " + json.dumps(ipm))
    solo = fleet_drive(os.path.join(outputs_dir, "fleet-c3"), FLEET_STEPS, communities=1,
                       base=FLEET_C - 1, stop=1, band_fused=True, ipm_tail_frac=0.0)
    ln = solo["launches"]
    check(ln["factor_refined_solve_t"] > 0 and ln["banded_cholesky_t"] == 0,
          f"community {FLEET_C - 1} alone did not run the fused route: {ln}")
    match = community_match(ipm_run, solo, FLEET_C - 1, MAIN_HORIZON)
    match.update(launches=ln, run_s=solo["run_s"],
                 replica=replica_check(ipm_run, solo, FLEET_C - 1, MAIN_HORIZON))
    rq_run = fleet_drive(os.path.join(outputs_dir, "fleet-reluqp"), FLEET_RELUQP_STEPS,
                         solver="reluqp", iter_kernel="pallas", precision="f32")
    reluqp = event_checks(rq_run, FLEET_RELUQP_STEPS, "fleet (ReLU-QP)")
    ln = rq_run["launches"]
    check(ln[WINDOW] > 0 and all(v == 0 for k, v in ln.items() if k != WINDOW),
          f"fleet (ReLU-QP) did not run the fused window alone: {ln}")
    log(f"fleet (ReLU-QP, fused window, {FLEET_RELUQP_STEPS} steps): " + json.dumps(reluqp))
    streams = {"ipm": stream_checks(ipm_run["agg"], ipm_run["results"], FLEET_STEPS,
                                    "fleet (IPM)"),
               "reluqp": stream_checks(rq_run["agg"], rq_run["results"], FLEET_RELUQP_STEPS,
                                       "fleet (ReLU-QP)")}
    return dict(ipm=ipm, community_3=match, reluqp=reluqp, cpu_vs_cuda=fleet_cpu_vs_cuda(),
                streams=streams)


# ------------------------------------------------------------- fleet RL
FRL_STEPS = 30           # daily chunks of 24 and 6: past the refit (step 9), a resume
FRL_SHORT_STEPS = 12     # DDPG, per-community: past the shared learner's gate
FRL_RELUQP_STEPS = 6
# θ_μ first moves at step 2, with step 1's drda: its update at step t
# reads the basis of step t - 1's observation, and at step 0 the forecast
# error is zero here (3 kW a home, the initial guess, is half of this
# mix's max possible load), so that basis is zero.
FRL_MPC_STEPS = 3
# The mpc leg's rl.fleet.mpc_weight (default 0.25): with 2,500 homes a
# community, drda = -2·err·dagg/norm² is ~1e-7 to 2e-5 (norm, the
# community's max possible load, is ~1.5e4 kW), so at the default weight
# the term moves θ_μ by a few float32 ulps (PERF.md, section 6).
FRL_MPC_WEIGHT = 1e4
FRL_EVENT_STEPS = 18     # the pack's first DR call (15-17) and tariff shock (17-19)
FRL_CPU_STEPS = 12       # CPU against the card: 2 communities × 4 homes, H = 4
FRL_SIMPLIFIED_C = 8


def fleet_rl_config(steps: int, agent: str = "linear", solver: str = "ipm",
                    policy: str = "shared", gradient: str = "score", pack: bool = False,
                    homes: int = N_HOMES // FLEET_C, communities: int = FLEET_C,
                    horizon: int = MAIN_HORIZON, mpc_weight: float = 0.25, **tpu) -> dict:
    """``communities`` communities of ``homes`` homes running only
    ``run_rl_agg`` for ``steps`` hourly steps from 2015-01-01 00, no
    weather offset (day 1 is 2015-01-01 for every community): the legacy
    mix, or the stress_dr_outage pack (``pack``)."""
    if pack:
        cfg = scenario_config(homes, horizon, steps, communities, **tpu)
    else:
        cfg = rl_config(homes, horizon, steps, agent, **tpu)
    cfg["fleet"].update(communities=communities, weather_offset_hours=0)
    cfg["home"]["hems"]["solver"] = solver
    cfg["simulation"].update(run_rbo_mpc=False, run_rl_agg=True)
    cfg["rl"]["parameters"]["agent"] = agent
    cfg["rl"]["fleet"].update(policy=policy, gradient=gradient, mpc_weight=mpc_weight)
    return cfg


def fleet_rl_drive(outputs_dir: str, steps: int, stop=None, resume: bool = False,
                   **kw) -> dict:
    """One fleet ``run_rl_agg`` through the public entry point, every
    launch count reset just before it and read just after."""
    from dragg_tpu_torch.aggregator import Aggregator

    cfg = fleet_rl_config(steps, **kw)
    cfg["simulation"]["resume"] = resume
    agg = Aggregator(cfg, outputs_dir=outputs_dir, device="cuda")
    agg.stop_after_chunks = stop
    reset_launches()
    t0 = time.perf_counter()
    agg.run()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    case_dir = os.path.join(agg.run_dir, "rl_agg")
    with open(os.path.join(case_dir, "results.json")) as f:
        results = json.load(f)
    rl_data = None
    if os.path.exists(os.path.join(case_dir, "utility_agent-results.json")):
        with open(os.path.join(case_dir, "utility_agent-results.json")) as f:
            rl_data = json.load(f)
    return dict(agg=agg, results=results, launches=launches, run_s=run_s, rl_data=rl_data)


def fleet_rl_checks(run: dict, steps: int, what: str, acted: bool = True) -> dict:
    """Every home's series complete and finite; each community's reward
    prices finite and within ±max_rp, and for a run long enough to show
    the agent act (``acted``) not constant and apart from the other
    communities' (the exploration noise often clips the price at ±max_rp,
    so two steps may not differ).  Returns the run's figures, the solve
    rate per community and day among them."""
    import numpy as np

    agg = run["agg"]
    summary, solved = check_results(dict(run["results"]), steps)
    rp = np.asarray(summary["fleet_rl"]["RP_by_community"])
    check(rp.shape == (FLEET_C, steps) and bool(np.all(np.isfinite(rp))),
          f"{what}: RP_by_community {rp.shape} or not finite")
    check(bool(np.all(np.abs(rp) <= MAX_RP + 1e-9)), f"{what}: RP beyond ±{MAX_RP}")
    check(not acted or all(len(np.unique(r)) > 1 for r in rp),
          f"{what}: a community's RP is constant")
    check(not acted or all(not np.array_equal(rp[a], rp[b]) for a in range(FLEET_C)
                           for b in range(a)), f"{what}: two communities got the same prices")
    solved = np.asarray(solved)                       # (homes, steps), all_homes order
    B = len(agg.all_homes) // FLEET_C
    rate = {f"c{c}": [float(solved[c * B:(c + 1) * B, d * 24:(d + 1) * 24].mean())
                      for d in range(-(-steps // 24))] for c in range(FLEET_C)}
    phase = summary["phase_times"]
    return dict(communities=FLEET_C, homes=len(agg.all_homes), steps=steps,
                solve_rate=float(solved.mean()), solve_rate_per_community_day=rate,
                rp_min=float(rp.min()), rp_max=float(rp.max()),
                s_per_step=(phase["device_chunks"] + phase["collect"]) / steps,
                run_s=run["run_s"], launches=run["launches"],
                launches_per_step={k: v / steps for k, v in run["launches"].items()},
                mean_iterations=float(np.mean(summary["solver_iterations"])))


def fleet_agent_step_figures(policy: str, agent: str) -> dict:
    """One fleet agent step at C = 4 on the card alone (40 steps in, so
    every update is live): ms a step over 20 steps between CUDA events,
    launches a step from torch.profiler's count of the host's launch
    calls over 2 steps."""
    import torch

    from dragg_tpu_torch.rl.core import RLObservation
    from dragg_tpu_torch.rl.fleet import N_EVENT_FEATURES, FleetAgent, FleetObservation

    ag = FleetAgent(fleet_rl_config(FRL_STEPS, agent, policy=policy), FLEET_C, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)

    def obs(k):
        v = 0.1 * torch.randn(5, FLEET_C, device="cuda", generator=g)
        return FleetObservation(
            obs=RLObservation(v[0], v[1], torch.full((FLEET_C,), (k % 24) / 24, device="cuda"),
                              0.02 * v[3], -v[4] * v[4]),
            events=torch.rand(FLEET_C, N_EVENT_FEATURES, device="cuda", generator=g),
            drda=torch.zeros(FLEET_C, device="cuda"))

    carry = ag.carry
    for k in range(40):
        carry, _ = ag.scan_step(carry, obs(k))
    observations = [obs(k) for k in range(40, 60)]
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for o in observations:
        carry, _ = ag.scan_step(carry, o)
    end.record()
    torch.cuda.synchronize()
    out = dict(policy=policy, agent=agent, communities=FLEET_C,
               ms_per_step=start.elapsed_time(end) / len(observations))
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for o in observations[:2]:
                carry, _ = ag.scan_step(carry, o)
            torch.cuda.synchronize()
        calls = {e.key: e.count for e in prof.key_averages() if "LaunchKernel" in e.key}
        out["launches_per_step"] = sum(calls.values()) / 2
    except Exception as e:  # the launch count is a figure, not a check
        out["launches_per_step"] = f"not measured ({type(e).__name__}: {e})"
    log("fleet agent step on the card: " + json.dumps(out))
    return out


def fleet_rl_stepwise_cpu_vs_cuda(agent: str) -> dict:
    """2 communities × 4 homes (one PV, one battery, one PV + battery
    home each), H = 4, FRL_CPU_STEPS one-step chunks of the fleet step,
    the CPU and the card each from the CPU run's carry (community, agent,
    environment): prices and agent within the CPU tests' tolerances, the
    community's series within cpu_vs_cuda_check's, solved flags equal."""
    import numpy as np
    import torch

    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.checkpoint import host_snapshot, tree_map
    from dragg_tpu_torch.engine import OBS_FIELDS
    from dragg_tpu_torch.rl.env import init_fleet_env_carry
    from dragg_tpu_torch.rl.fleet import CommunityFold, FleetAgent, FleetEnvCarry, run_fleet_chunk
    from dragg_tpu_torch.rl.runner import _rl_settings

    cfg = fleet_rl_config(FRL_CPU_STEPS, agent, homes=4, communities=2, horizon=4,
                          bucketed="true")
    cfg["community"].update(homes_pv=1, homes_battery=1, homes_pv_battery=1)
    side = {}
    for dev in ("cpu", "cuda"):
        with tempfile.TemporaryDirectory() as d:
            agg = Aggregator(cfg, outputs_dir=d, device=dev)
            agg.get_homes()
            agg._build_engine()
        norms = agg._max_possible_load_per_community()
        side[dev] = (agg.engine, FleetAgent(cfg, 2, device=dev),
                     torch.as_tensor(norms, dtype=torch.float32, device=dev),
                     CommunityFold.of(agg.engine))
    settings = _rl_settings(cfg)
    carry = (side["cpu"][0].init_state(), side["cpu"][1].carry,
             FleetEnvCarry(init_fleet_env_carry(4, settings["prev_n"], norms, "cpu"),
                           torch.zeros(2)))
    worst = {"rp": 0.0, "agent": 0.0, "series": {}}
    for t in range(FRL_CPU_STEPS):
        eng, ag, nrm, fold = side["cpu"]
        nxt, got = run_fleet_chunk(eng, ag, settings, nrm, fold, carry, t, 1)
        eng, ag, nrm, fold = side["cuda"]
        _, got_c = run_fleet_chunk(eng, ag, settings, nrm, fold,
                                   tree_map(lambda a: a.to("cuda"), carry), t, 1)
        (outs, recs, rp, _), (outs_c, recs_c, rp_c, _) = host_snapshot(got), host_snapshot(got_c)
        check(np.array_equal(outs.correct_solve, outs_c.correct_solve),
              f"fleet RL CPU vs card ({agent}) t={t}: solved flags differ")
        for f in outs._fields:
            # The observatory's per-bucket leaves: phase 15 holds them.
            if np.asarray(getattr(outs, f)).dtype.kind == "f" and f not in OBS_FIELDS:
                worst["series"][f] = max(worst["series"].get(f, 0.0), float(np.max(np.abs(
                    getattr(outs, f) - getattr(outs_c, f)), initial=0.0)))
        worst["rp"] = max(worst["rp"], float(np.max(np.abs(rp - rp_c))))
        for a, b in zip(recs, recs_c):
            worst["agent"] = max(worst["agent"], float(
                np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)))
        carry = nxt
    check(max(worst["series"].values()) <= ENGINE_CPU_CUDA_ATOL and worst["rp"] <= RL_RP_ATOL
          and worst["agent"] <= RL_AGENT_REL,
          f"fleet RL CPU vs card ({agent}): differences {worst} beyond the tolerances")
    log(f"fleet RL CPU vs card, step by step ({agent}, 2 × 4 homes, H = 4): "
        + json.dumps(worst))
    return worst


def fleet_rl_simplified_check() -> dict:
    """The fleet's ``run_rl_simplified`` with C = 8 over a 3-day window,
    the card against the CPU: the Summary's series (fleet_rl included)
    and the agent's within the CPU tests' tolerances."""
    import numpy as np

    from dragg_tpu_torch.aggregator import Aggregator

    out = {}
    for dev in ("cpu", "cuda"):
        cfg = community_config(N_HOMES // FLEET_C, MAIN_HORIZON, RL_SIMPLIFIED_END)
        cfg["simulation"].update(run_rbo_mpc=False, run_rl_simplified=True)
        cfg["fleet"]["communities"] = FRL_SIMPLIFIED_C
        with tempfile.TemporaryDirectory() as d:
            agg = Aggregator(cfg, outputs_dir=d, device=dev)
            agg.run()
            case = os.path.join(agg.run_dir, "simplified")
            with open(os.path.join(case, "results.json")) as f:
                res = json.load(f)["Summary"]
            with open(os.path.join(case, "utility_agent-results.json")) as f:
                out[dev] = (res, json.load(f))
    (res, data), (res_c, data_c) = out["cpu"], out["cuda"]
    worst = {}
    for key, tol, a, b in (
            *((k, RL_SIMPLIFIED_REL, res[k], res_c[k])
              for k in ("p_grid_aggregate", "RP", "p_grid_setpoint", "agg_cost")),
            *((k, RL_SIMPLIFIED_REL, res["fleet_rl"][k], res_c["fleet_rl"][k])
              for k in ("RP_by_community", "setpoint_by_community")),
            *((k, RL_AGENT_REL, data[k], data_c[k]) for k in data if k != "parameters")):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        check(a.shape == b.shape, f"fleet simplified {key}: shape {b.shape}")
        worst[key] = float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30))
        check(worst[key] <= tol, f"fleet simplified, card vs CPU: {key} differs by "
              f"{worst[key]:.3g}")
    check(np.asarray(res_c["fleet_rl"]["RP_by_community"]).shape == (FRL_SIMPLIFIED_C, 72),
          "fleet simplified: not 8 communities × 72 steps")
    log("fleet RL simplified (C = 8, 72 steps), card vs CPU: " + json.dumps(worst))
    return dict(communities=FRL_SIMPLIFIED_C, steps=72, rel_differences=worst)


def mpc_route_errors() -> dict:
    """``rl.fleet.gradient = "mpc"`` on a kernel route raises at
    construction, before any launch: ``band_kernel = "auto"`` (the IPM on
    the card) and ``iter_kernel = "pallas"`` (ReLU-QP)."""
    from dragg_tpu_torch.aggregator import Aggregator

    out = {}
    reset_launches()
    for key, solver, tpu in (("tpu.band_kernel", "ipm", {}),
                             ("tpu.iter_kernel", "reluqp", {"iter_kernel": "pallas"})):
        cfg = fleet_rl_config(FRL_MPC_STEPS, solver=solver, gradient="mpc", **tpu)
        with tempfile.TemporaryDirectory() as d:
            try:
                Aggregator(cfg, outputs_dir=d, device="cuda").run()
                raised = None
            except ValueError as e:
                raised = str(e)
        check(raised is not None and "rl.fleet.gradient" in raised and key in raised,
              f"mpc on the {key} kernel route: {raised!r}")
        out[key] = raised
    check(all(v == 0 for v in launch_counts().values()),
          f"mpc route errors: kernels launched {launch_counts()}")
    log("mpc on kernel routes raises before any launch: " + json.dumps(out))
    return out


def fleet_rl_phase(outputs_dir: str, rl: dict) -> dict:
    """Phase 14: the fleet form of the RL cases (see the module
    docstring).  ``rl`` is phase 12's figures."""
    import numpy as np

    from dragg_tpu_torch.rl.fleet import FLEET_STATE_SCALARS, fleet_params_from_config

    out = {}
    t_phase = time.perf_counter()
    main = fleet_rl_drive(os.path.join(outputs_dir, "frl"), FRL_STEPS)
    lin = fleet_rl_checks(main, FRL_STEPS, "fleet rl_agg (linear)")
    day1 = [v[0] for v in lin["solve_rate_per_community_day"].values()]
    check(min(day1) >= 0.99, f"fleet rl_agg (linear): day-1 solve rates {day1}")
    ln = main["launches"]
    check(ln["banded_cholesky_t"] > 0 and ln["refined_banded_solve_t"] > 0
          and ln["factor_refined_solve_t"] == 0 and ln[WINDOW] == 0,
          f"fleet rl_agg (linear) did not run the split route's kernels alone: {ln}")
    # The shared learner refits once the replay holds more than
    # learner_batch transitions, C a step: from step ⌊B / C⌋ + 1.  The
    # recorded column alternates, so a column is compared two steps apart.
    lb = fleet_params_from_config(main["agg"].config, FLEET_C).learner_batch
    first = lb // FLEET_C + 1
    tq = np.asarray(main["rl_data"]["theta_q"])
    check(all(np.array_equal(tq[k], tq[k - 2]) for k in range(2, first)),
          "fleet rl_agg (linear): θ_q moved before the shared learner's first refit")
    check(all(not np.array_equal(tq[k], tq[k - 2]) for k in range(first, FRL_STEPS)),
          f"fleet rl_agg (linear): the ridge refit did not run from step {first}")
    lin.update(first_refit_step=first, phase12_s_per_step=rl["linear"]["s_per_step"])
    log(f"fleet rl_agg (shared linear, 4 × 2,500 homes, {FRL_STEPS} steps): " + json.dumps(lin))
    out["linear"] = lin

    part = fleet_rl_drive(os.path.join(outputs_dir, "frl-res"), FRL_STEPS, stop=1)
    ckpt = part["agg"]._latest_checkpoint_dir()
    check(part["agg"].timestep == 24 and ckpt is not None,
          "fleet rl_agg stopped after one chunk left no checkpoint")
    with open(os.path.join(ckpt, "fleet_rl.json")) as f:
        saved = np.asarray(json.load(f)["rps"])
    want_rp = np.asarray(main["results"]["Summary"]["fleet_rl"]["RP_by_community"]).T
    check(np.array_equal(saved[:24], want_rp[:24]),
          "fleet rl_agg stopped: fleet_rl.json's prices differ from the run's")
    res = fleet_rl_drive(os.path.join(outputs_dir, "frl-res"), FRL_STEPS, resume=True)
    check(res["agg"].resumed_from is not None, "fleet rl_agg did not resume")
    same_results(res["results"], main["results"], "fleet rl_agg stopped and resumed")
    check(res["results"]["Summary"]["fleet_rl"] == main["results"]["Summary"]["fleet_rl"],
          "fleet rl_agg resumed: the fleet_rl block differs")
    check(res["rl_data"] == main["rl_data"], "fleet rl_agg resumed: rl_data differs")
    out["resume"] = {what: dict(run_s=run["run_s"], launches=run["launches"])
                     for what, run in (("stopped", part), ("resumed", res))}
    log("fleet rl_agg stopped after chunk 1 and resumed: bit-equal; " + json.dumps(out["resume"]))

    dd = fleet_rl_drive(os.path.join(outputs_dir, "frl-ddpg"), FRL_SHORT_STEPS, agent="ddpg",
                        band_fused=True)
    ddpg = fleet_rl_checks(dd, FRL_SHORT_STEPS, "fleet rl_agg (DDPG)")
    ln = dd["launches"]
    check(ln["factor_refined_solve_t"] > 0 and ln["banded_cholesky_t"] == 0,
          f"fleet rl_agg (DDPG) did not run the fused route: {ln}")
    # Frozen while the replay holds fewer than learner_batch transitions,
    # then the actor moves (policy_delay 2: at even steps).
    gate = -(-lb // FLEET_C)
    norms = [r[0] for r in dd["rl_data"]["theta_mu"]]
    check(len(set(norms[:gate])) == 1 and norms[gate] != norms[gate - 1],
          f"fleet rl_agg (DDPG): actor norms {norms} (frozen to step {gate - 1}, then moving)")
    ddpg["actor_first_moves_at_step"] = gate
    log(f"fleet rl_agg (shared DDPG, fused band route, {FRL_SHORT_STEPS} steps): "
        + json.dumps(ddpg))
    out["ddpg"] = ddpg

    pc = fleet_rl_drive(os.path.join(outputs_dir, "frl-pc"), FRL_SHORT_STEPS,
                        policy="per_community")
    per = fleet_rl_checks(pc, FRL_SHORT_STEPS, "fleet rl_agg (per-community linear)")
    theta = pc["agg"].agent.carry.theta_mu.cpu().numpy()
    check(theta.shape[0] == FLEET_C and len({r.tobytes() for r in theta}) == FLEET_C,
          "fleet rl_agg (per-community): the communities' policies are not apart")
    log(f"fleet rl_agg (per-community linear, {FRL_SHORT_STEPS} steps): " + json.dumps(per))
    out["per_community"] = per

    rq = fleet_rl_drive(os.path.join(outputs_dir, "frl-reluqp"), FRL_RELUQP_STEPS,
                        solver="reluqp", iter_kernel="pallas", precision="f32")
    reluqp = fleet_rl_checks(rq, FRL_RELUQP_STEPS, "fleet rl_agg (ReLU-QP)")
    ln = rq["launches"]
    check(ln[WINDOW] > 0 and all(v == 0 for k, v in ln.items() if k != WINDOW),
          f"fleet rl_agg (ReLU-QP) did not run the fused window alone: {ln}")
    log(f"fleet rl_agg (ReLU-QP, fused window, {FRL_RELUQP_STEPS} steps): " + json.dumps(reluqp))
    out["reluqp"] = reluqp

    out["mpc_route_errors"] = mpc_route_errors()
    mpc = {}
    for grad in ("score", "mpc"):
        run = fleet_rl_drive(os.path.join(outputs_dir, f"frl-{grad}"), FRL_MPC_STEPS,
                             solver="reluqp", iter_kernel="lax", gradient=grad,
                             mpc_weight=FRL_MPC_WEIGHT)
        mpc[grad] = fleet_rl_checks(run, FRL_MPC_STEPS, f"fleet rl_agg (ReLU-QP lax, {grad})",
                                    acted=False)
        check(all(v == 0 for v in run["launches"].values()),
              f"fleet rl_agg ({grad}, lax route) launched a kernel: {run['launches']}")
        mpc[grad]["theta_mu"] = run["agg"].agent.carry.theta_mu.cpu().numpy()
        mpc[grad]["drda"] = run["agg"].fleet_env.drda.cpu().numpy()
    drda = mpc["mpc"]["drda"]
    check(bool(np.all(np.isfinite(drda))) and bool(np.any(drda != 0)),
          f"fleet rl_agg (mpc): drda {drda}")
    check(bool(np.all(mpc["score"]["drda"] == 0)), "fleet rl_agg (score): drda not zero")
    moved = float(np.max(np.abs(mpc["mpc"]["theta_mu"] - mpc["score"]["theta_mu"])))
    check(moved > 0, "fleet rl_agg (mpc): θ_μ equals the score gradient's")
    for grad in mpc:
        mpc[grad]["theta_mu"] = mpc[grad]["theta_mu"].tolist()
        mpc[grad]["drda"] = mpc[grad]["drda"].tolist()
    mpc["theta_mu_max_abs_difference"] = moved
    log("fleet rl_agg, mpc against score gradient (ReLU-QP lax route): "
        + json.dumps({"drda": mpc["mpc"]["drda"], "theta_mu_difference": moved,
                      "s_per_step": {g: mpc[g]["s_per_step"] for g in ("score", "mpc")}}))
    out["mpc"] = mpc

    ev_run = fleet_rl_drive(os.path.join(outputs_dir, "frl-pack"), FRL_EVENT_STEPS, pack=True)
    events = event_checks(ev_run, FRL_EVENT_STEPS, "fleet rl_agg under the pack")
    carry = ev_run["agg"].agent.carry
    feats = carry.mem_s[:(FRL_EVENT_STEPS - 1) * FLEET_C, 4:FLEET_STATE_SCALARS].cpu().numpy()
    check(bool(np.all(np.any(feats != 0, axis=1))),
          "fleet rl_agg under the pack: a step's event features are all zero")
    events.update(event_feature_max=feats.max(axis=0).tolist(),
                  event_feature_min=feats.min(axis=0).tolist())
    log(f"fleet rl_agg under the pack ({FRL_EVENT_STEPS} steps): " + json.dumps(events))
    out["events"] = events

    out["agent_step"] = [fleet_agent_step_figures(p, a) for p, a in
                         (("shared", "linear"), ("shared", "ddpg"),
                          ("per_community", "linear"))]
    out["cpu_vs_cuda"] = {a: fleet_rl_stepwise_cpu_vs_cuda(a) for a in ("linear", "ddpg")}
    out["simplified"] = fleet_rl_simplified_check()
    out["launches"] = {
        "banded_cholesky_t": main["launches"]["banded_cholesky_t"],
        "refined_banded_solve_t": main["launches"]["refined_banded_solve_t"],
        "factor_refined_solve_t": dd["launches"]["factor_refined_solve_t"],
        WINDOW: rq["launches"][WINDOW]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"fleet RL: {lin['s_per_step']:.4f} s a step (phase 12, one community: "
        f"{rl['linear']['s_per_step']:.4f}); launches {json.dumps(out['launches'])}; "
        f"phase {out['phase_s']:.1f} s")
    return out


# ----------------------------------------------- telemetry (phase 15)
AB_STEPS = 4              # hourly steps of each leg of the per_home A/B, one chunk
PROFILE_HOMES = 1000      # the tpu.profile_dir leg: 1,000 homes × 2 hourly chunks
FOLD = "observatory.fold"  # the profiler range put around the fold to time it


def events_of(run_dir: str) -> list[dict]:
    """A run's events.jsonl."""
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def stream_checks(agg, results: dict, steps: int, what: str) -> dict:
    """A finished run's telemetry against its results.json: run.start first
    and run.end last; metrics.json written; one chunk.done a chunk, each
    with one solver.convergence a bucket (its ``n_homes`` the bucket's,
    both histograms summing to the bucket's homes × steps) and one
    solver.worst, whose homes exist and whose largest r_prim is the
    chunk's r_prim_max; chunk.done's solve_rate and solver_iters the
    Summary's over the chunk (to their rounding).  Returns the run's
    per-bucket histograms summed over its chunks."""
    import numpy as np

    recs = events_of(agg.run_dir)
    check(os.path.exists(os.path.join(agg.run_dir, "metrics.json")), f"{what}: no metrics.json")
    names = [r["event"] for r in recs]
    check(names[0] == "run.start" and names[-1] == "run.end" and recs[-1]["completed"],
          f"{what}: the stream does not open with run.start and close with run.end")
    done = [r for r in recs if r["event"] == "chunk.done"]
    check([r["t0"] for r in done] == list(range(0, steps, agg.checkpoint_interval)),
          f"{what}: chunk.done at {[r['t0'] for r in done]}")
    binfo = agg.engine.bucket_info()
    solved = np.array([v["correct_solve"] for k, v in results.items() if k != "Summary"])
    iters = np.asarray(results["Summary"]["solver_iterations"], dtype=np.float64)
    totals = {b["name"]: {"rprim_hist": np.zeros(18, int), "iters_hist": np.zeros(17, int),
                          "diverged": 0} for b in binfo}
    for r in done:
        t0, t1 = r["t0"], r["t1"]
        conv = [c for c in recs if c["event"] == "solver.convergence" and c["t0"] == t0]
        check([c["bucket"] for c in conv] == [b["name"] for b in binfo],
              f"{what}: chunk {t0}: solver.convergence for {[c['bucket'] for c in conv]}")
        for c, b in zip(conv, binfo):
            check(c["n_homes"] == b["n_real"]
                  and sum(c["rprim_hist"]) == sum(c["iters_hist"]) == b["n_real"] * (t1 - t0),
                  f"{what}: chunk {t0}, bucket {b['name']}: histograms {c}")
            tot = totals[b["name"]]
            tot["rprim_hist"] += np.asarray(c["rprim_hist"])
            tot["iters_hist"] += np.asarray(c["iters_hist"])
            tot["diverged"] += c["diverged"]
        check(abs(r["solve_rate"] - float(solved[:, t0:t1].mean())) <= 5e-5 + 1e-9,
              f"{what}: chunk {t0}: solve_rate {r['solve_rate']} against the Summary's "
              f"{float(solved[:, t0:t1].mean())}")
        check(abs(r["solver_iters"] - float(iters[t0:t1].mean())) <= 0.05 + 1e-9,
              f"{what}: chunk {t0}: solver_iters {r['solver_iters']}")
        worst = [w for w in recs if w["event"] == "solver.worst" and w["t0"] == t0]
        check(len(worst) == 1 and worst[0]["homes"], f"{what}: chunk {t0}: solver.worst {worst}")
        homes = worst[0]["homes"]
        check(all(0 <= h["home"] < len(agg.all_homes) for h in homes),
              f"{what}: chunk {t0}: solver.worst names homes {[h['home'] for h in homes]}")
        check(max(h["r_prim"] for h in homes) == r["r_prim_max"],
              f"{what}: chunk {t0}: worst r_prim {max(h['r_prim'] for h in homes)} against "
              f"r_prim_max {r['r_prim_max']}")
    with open(os.path.join(agg.run_dir, "metrics.json")) as f:
        hists = set(json.load(f)["histograms"])
    want = {f"solver.conv_iters_{b['name']}" for b in binfo}
    check(want <= hists, f"{what}: metrics.json lacks {want - hists}")
    return dict(events=len(recs), chunks=len(done),
                buckets={k: {"rprim_hist": v["rprim_hist"].tolist(),
                             "iters_hist": v["iters_hist"].tolist(),
                             "diverged": int(v["diverged"])} for k, v in totals.items()})


def adjacent_moves(a, b) -> int | None:
    """The counts that differ between two histograms of equal total when
    each of them moved to an adjacent bin, else None (the net flow across
    each bin boundary leaves no bin with more counts going out than it
    holds); tests/test_torch_observatory.py holds the same helper."""
    import numpy as np

    flow = np.cumsum(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    if flow[-1] != 0:
        return None
    for i in range(len(flow)):
        out = max(flow[i], 0.0) + (max(-flow[i - 1], 0.0) if i else 0.0)
        if out > a[i]:
            return None
    return int(np.abs(flow).sum())


def convergence_match(ref: list, cmp: list, what: str) -> dict:
    """Two runs' solver.convergence records: the same buckets and chunks,
    the same homes and divergence counts, each histogram equal or its
    counts moved to adjacent bins only; returns how many moved."""
    check([(r["t0"], r["bucket"], r["n_homes"]) for r in ref]
          == [(r["t0"], r["bucket"], r["n_homes"]) for r in cmp],
          f"{what}: the solver.convergence records cover other chunks or buckets")
    moved = {"rprim_hist": 0, "iters_hist": 0}
    for a, b in zip(ref, cmp):
        check(a["diverged"] == b["diverged"],
              f"{what}: diverged {a['diverged']} vs {b['diverged']}")
        for key in moved:
            m = adjacent_moves(a[key], b[key])
            check(m is not None, f"{what}: {a['bucket']} t0 {a['t0']}: {key} {a[key]} vs {b[key]}")
            moved[key] += m
    equal = sum(all(a[k] == b[k] for k in ("rprim_hist", "iters_hist", "diverged"))
                for a, b in zip(ref, cmp))
    out = dict(records=len(ref), equal=equal, moved_rprim=moved["rprim_hist"],
               moved_iters=moved["iters_hist"],
               observations=sum(sum(r["rprim_hist"]) for r in ref))
    log(f"{what}: solver.convergence " + json.dumps(out))
    return out


def aggregator_chunk(outputs_dir: str, n_homes: int, horizon: int, steps: int,
                     solver: str = "reluqp", telemetry=None, **tpu) -> tuple:
    """``engine_chunk`` through ``Aggregator.run()``: one chunk of ``steps``
    steps from t = 0 (the same run_chunk), with the chunk's StepOutputs
    caught as the aggregator collects them.  Returns (outputs as numpy,
    duty steps s, the aggregator)."""
    from dragg_tpu_torch.aggregator import Aggregator

    cfg = community_config(n_homes, horizon, f"2015-01-01 {steps:02d}", **tpu)
    cfg["home"]["hems"]["solver"] = solver
    cfg["telemetry"].update(telemetry or {})
    agg = Aggregator(cfg, outputs_dir=outputs_dir, device="cuda")
    caught = []
    collect = agg._collect_chunk

    def catch(outs, *a, **kw):
        caught.append({f: getattr(outs, f) for f in outs._fields})
        collect(outs, *a, **kw)

    agg._collect_chunk = catch
    agg.run()
    check(len(caught) == 1, f"{len(caught)} chunks collected")
    return caught[0], agg.engine.params.s, agg


def forensics_checks(agg, what: str) -> dict:
    """``telemetry.forensics``: one forensics/chunk_t<t0>.json a chunk,
    naming the chunk's solver.worst homes (each home's name and config
    those of all_homes) with a finite state at the chunk's start."""
    import math

    fdir = os.path.join(agg.run_dir, "forensics")
    files = sorted(os.listdir(fdir)) if os.path.isdir(fdir) else []
    worst = [r for r in events_of(agg.run_dir) if r["event"] == "solver.worst"]
    check(files == [f"chunk_t{w['t0']:08d}.json" for w in worst],
          f"{what}: forensics {files} for chunks {[w['t0'] for w in worst]}")
    for name, w in zip(files, worst):
        with open(os.path.join(fdir, name)) as f:
            dump = json.load(f)
        check([h["home"] for h in dump["homes"]] == [h["home"] for h in w["homes"]],
              f"{what}: {name} names other homes than solver.worst")
        for h in dump["homes"]:
            home = agg.all_homes[h["home"]]
            st = h["state_at_chunk_start"]
            check(h["name"] == home["name"] and h["config"] == home and st is not None
                  and set(st) == {"temp_in", "temp_wh", "e_batt", "counter"}
                  and all(math.isfinite(v) for v in st.values()),
                  f"{what}: {name}: home {h['home']}: {h['name']}, state {st}")
    return dict(files=files, homes=[len(w["homes"]) for w in worst],
                first=dump["homes"][0] if files else None)


def route_iters_noise(kagg, lagg) -> dict:
    """The kernel route's conv_iters histograms against the lax route's
    over the same run (route_check, H = 24), held as route_check holds the
    solved flags: every count moved to an adjacent bin only (a home that
    stops a check window earlier or later) and on at most 1 % of the
    home-steps.  Returns the counts that moved and each bucket's mean
    iterations both ways (a home can stop a window apart inside one bin)."""
    k = [r for r in events_of(kagg.run_dir) if r["event"] == "solver.convergence"]
    lx = [r for r in events_of(lagg.run_dir) if r["event"] == "solver.convergence"]
    out = convergence_match(lx, k, "kernel route vs lax route (conv_iters)")
    check(out["moved_iters"] <= 0.01 * out["observations"],
          f"kernel vs lax route: {out['moved_iters']} of {out['observations']} conv_iters "
          f"counts moved")
    out["mean_iters"] = {a["bucket"]: [a["mean_iters"], b["mean_iters"]] for a, b in zip(lx, k)}
    return out


def step_profile(engine) -> dict:
    """One engine step (t = 0, zero prices, after a warm-up step) under
    ``torch.profiler`` with the observatory fold wrapped in a FOLD range:
    the step's kernel launches and device ms, the fold's; then the fold
    alone at the same inputs (its four buckets' calls) launched back to
    back 20 times between CUDA events: its wall time a step, which the
    host's launches set."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from dragg_tpu_torch import engine as em

    fold = em.per_home_obs
    calls = []

    def traced(*a, **kw):
        calls.append((a, kw))
        with record_function(FOLD):
            return fold(*a, **kw)

    state = engine.init_state()
    rps = np.zeros((1, engine.params.horizon), np.float32)
    em.per_home_obs = traced
    try:
        engine.run_chunk(state, 0, rps)
        torch.cuda.synchronize()
        calls.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.run_chunk(state, 0, rps)
            torch.cuda.synchronize()
    finally:
        em.per_home_obs = fold
    events = list(prof.events())

    def kernels(e) -> list:
        return list(e.kernels) + [k for c in e.cpu_children for k in kernels(c)]

    step_kernels = [k for e in events for k in e.kernels]
    fold_kernels = [k for e in events if e.name == FOLD for k in kernels(e)]
    out = dict(step_launches=len(step_kernels),
               step_device_ms=sum(k.duration for k in step_kernels) / 1e3,
               fold_launches=len(fold_kernels),
               fold_device_ms=sum(k.duration for k in fold_kernels) / 1e3,
               fold_calls=len(calls))
    if calls:
        for a, kw in calls:
            fold(*a, **kw)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(20):
            for a, kw in calls:
                fold(*a, **kw)
        e1.record()
        torch.cuda.synchronize()
        out["fold_wall_ms_cuda_events"] = e0.elapsed_time(e1) / 20
    return out


def telemetry_ab(outputs_dir: str, solver: str, **tpu) -> dict:
    """10,000 homes × AB_STEPS hourly steps (one chunk) with the telemetry
    and the observatory on (the defaults) and off: results.json bit-equal, every
    kernel launched as often, the stream of the run with it on checked,
    none written with it off; then one step of each engine profiled, so
    that the launches a step on against off are the fold's own."""
    on = hourly_drive(os.path.join(outputs_dir, f"ab-{solver}-on"), AB_STEPS, solver=solver,
                      interval="daily", **tpu)
    off = hourly_drive(os.path.join(outputs_dir, f"ab-{solver}-off"), AB_STEPS, solver=solver,
                       telemetry={"enabled": False, "per_home": False}, interval="daily",
                       **tpu)
    same_results(on["results"], off["results"], f"{solver}: telemetry on vs off")
    check(on["launches"] == off["launches"],
          f"{solver}: kernel launches with telemetry on {on['launches']}, off {off['launches']}")
    check(not os.path.exists(os.path.join(off["agg"].run_dir, "events.jsonl")),
          f"{solver}: telemetry off wrote a stream")
    stream = stream_checks(on["agg"], on["results"], AB_STEPS, f"A/B {solver} (on)")
    prof_on, prof_off = step_profile(on["agg"].engine), step_profile(off["agg"].engine)
    check(prof_on["fold_calls"] == len(on["agg"].engine.bucket_info())
          and prof_off["fold_calls"] == 0 and prof_off["fold_launches"] == 0,
          f"{solver}: fold calls on {prof_on['fold_calls']}, off {prof_off['fold_calls']}")
    check(prof_on["fold_launches"] > 0 and prof_on["step_device_ms"] > 0,
          f"{solver}: the profiler saw no device work: {prof_on}")
    out = dict(launches=on["launches"], s_per_step_on=on["s_per_step"],
               s_per_step_off=off["s_per_step"], profile_on=prof_on, profile_off=prof_off,
               step_launches_difference=prof_on["step_launches"] - prof_off["step_launches"],
               stream=stream)
    log(f"telemetry A/B ({solver}, 10,000 homes, {AB_STEPS} steps): results bit-equal; "
        + json.dumps({k: v for k, v in out.items() if k != "stream"}))
    return out


def profile_leg(outputs_dir: str) -> dict:
    """``tpu.profile_dir``: 1,000 homes × 2 hourly chunks (IPM, split
    route); the second chunk's Chrome trace holds chol_kernel,
    refined_solve_kernel and the bus's span, which the stream records."""
    trace_dir = os.path.join(outputs_dir, "trace")
    run = hourly_drive(os.path.join(outputs_dir, "profiled"), 2, n_homes=PROFILE_HOMES,
                       profile_dir=trace_dir)
    files = os.listdir(trace_dir)
    check(files == ["chunk_t00000001.pt.trace.json"], f"profile_dir holds {files}")
    path = os.path.join(trace_dir, files[0])
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in trace if e.get("cat") == "kernel"]
    found = {k: sum(k in n for n in kernels) for k in ("chol_kernel", "refined_solve_kernel")}
    spans = [e for e in trace if e.get("name") == "engine.chunk_device_s"]
    check(all(found.values()) and spans, f"the chunk trace: kernels {found}, spans {len(spans)}")
    recs = [r for r in events_of(run["agg"].run_dir) if r["event"] == "span"]
    check([r["name"] for r in recs] == ["engine.chunk_device_s"], f"span events {recs}")
    out = dict(bytes=os.path.getsize(path), events=len(trace), kernels=len(kernels),
               band_kernels=found, launches=run["launches"], span_s=recs[0]["s"])
    log("profile_dir (1,000 homes, 2 hourly chunks): " + json.dumps(out))
    return out


def telemetry_phase(outputs_dir: str, stats: dict, rstats: dict, fleet: dict, routes: dict,
                    cpu_conv: dict) -> dict:
    """Phase 15: the run telemetry and the observatory (see the module
    docstring); the earlier phases' streams were checked as they ran."""
    out = dict(main_path={"split": stats["stream"], "fused": stats["stream_fused"],
                          "reluqp": rstats["stream"]},
               fleet=fleet["streams"], forensics=routes["telemetry"]["forensics"],
               route_conv_iters=routes["telemetry"]["conv_iters"], cpu_vs_cuda=cpu_conv)
    for run in fleet["streams"].values():
        check({"ev", "heat_pump"} <= set(run["buckets"]),
              f"the fleet's stream lacks the ev or heat_pump bucket: {list(run['buckets'])}")
    out["ab_ipm"] = telemetry_ab(outputs_dir, "ipm", band_fused=False)
    out["ab_reluqp"] = telemetry_ab(outputs_dir, "reluqp", iter_kernel="pallas", precision="f32")
    out["profile"] = profile_leg(outputs_dir)
    out["launches"] = {"banded_cholesky_t": out["ab_ipm"]["launches"]["banded_cholesky_t"],
                       "refined_banded_solve_t":
                           out["ab_ipm"]["launches"]["refined_banded_solve_t"],
                       "factor_refined_solve_t":
                           out["ab_ipm"]["launches"]["factor_refined_solve_t"],
                       WINDOW: out["ab_reluqp"]["launches"][WINDOW]}
    return out


# ------------------------------------------------------------- the ADMM
ADMM_REFINES = (0, 1, 2)   # the ADMM's in-loop default, the IPM's, the polish's
ADMM_CPU_STEPS = 4         # 8 homes, H = 24, each step from the CPU run's state
ADMM_BAND_STEPS = 4
# The plain band versions launch ~18 small operations a band row (45.9-55.4
# s a 10,000-home step on an H100 80GB HBM3): they are held against the
# kernels over 2 steps at an iteration cap of 100 (4 check windows, the
# first rho update, the polish), both routes at that cap.
ADMM_BAND_PLAIN_STEPS, ADMM_BAND_PLAIN_ITERS = 2, 100
ADMM_VARIANT_HOMES, ADMM_VARIANT_STEPS = 1000, 2
CR_HOMES, CR_STEPS = 1000, 4
# The CPU tests' tolerances (tests/test_torch_engine_admm.py): a first-order
# iterate is pinned only to its 1e-4 + 1e-4·|row| stopping ball.
ADMM_SERIES_ATOL = 1e-3
ADMM_MIN_RATE = 0.99       # solve rate of the main path on 2015-01-01
PER_HOME = ("p_grid", "forecast_p_grid", "p_load", "temp_in", "temp_wh", "hvac_cool_on",
            "hvac_heat_on", "wh_heat_on", "cost", "p_pv", "u_pv_curt", "e_batt",
            "p_batt_ch", "p_batt_disch", "p_ev_ch", "e_ev")


def admm_refine_kernels(shapes) -> dict:
    """``refined_banded_solve_t`` at refine 0, 1 and 2 against its plain
    version bit for bit at each (bucket's) shape: the ADMM's band backend
    solves at ``admm_refine`` (0 by default) every iteration and at 2 in
    the polish, the interior point at 1.  One call's ms and device ms at
    each refine, the plan each runs."""
    import torch

    from dragg_tpu_torch.bench_band import band_fixture
    from dragg_tpu_torch.bench_window import cuda_ms
    from dragg_tpu_torch.ops import band_kernels as bk

    rows, err = [], 0.0
    for si, (h, bucket, m, bw, nb) in enumerate(shapes):
        St, r = band_fixture(m, bw, nb, seed=700 + si)
        L, Lp = bk.banded_cholesky_t(St, bw), bk.cholesky_t_plain(St, bw)
        torch.cuda.synchronize()
        exact(L, Lp, f"banded_cholesky_t H = {h} {bucket} (m={m}, bw={bw}) B={nb}")
        row = dict(horizon=h, bucket=bucket, m=m, bw=bw, B=nb, refine={})
        for refine in ADMM_REFINES:
            x = bk.refined_banded_solve_t(L, St, r, bw, refine)
            xp = bk.refined_solve_t_plain(Lp, St, r, bw, refine)
            torch.cuda.synchronize()
            err = max(err, exact(x, xp, f"refined_banded_solve_t H = {h} {bucket} (m={m}, "
                                        f"bw={bw}) B={nb} refine={refine}"))

            def fn(refine=refine):
                return bk.refined_banded_solve_t(L, St, r, bw, refine)

            row["refine"][refine] = dict(
                ms=cuda_ms(fn, 20), device_ms=cuda_ms(fn, 20, queued=True),
                plan=bk.band_plan(m, bw, "solve", nb, bk._sms(St.device), refine)._asdict())
        rows.append(row)
        log(f"refined solve at refine {ADMM_REFINES}, H = {h} {bucket} B={nb}: "
            + json.dumps({k: [v["ms"], v["device_ms"]] for k, v in row["refine"].items()}))
    sums = {refine: {k: sum(r["refine"][refine][k] for r in rows) for k in ("ms", "device_ms")}
            for refine in ADMM_REFINES}
    return {"max_abs_err": err, "per_shape": rows, "summed": sums}


def admm_cpu_vs_cuda() -> dict:
    """8 homes, H = 24, ADMM_CPU_STEPS one-step chunks (each refreshing the
    factor) on the card against the CPU, both from the CPU run's state
    every step: the CPU tests' tolerances (solved flags, cooling duty and
    water draws equal; the series within ADMM_SERIES_ATOL; the iteration
    counts whole check windows apart)."""
    import numpy as np

    cpu, cuda, _ = stepwise_cpu_vs_cuda(8, 24, ADMM_CPU_STEPS, "admm", bucketed="true")
    for key in ("correct_solve", "hvac_cool_on", "waterdraws"):
        check(np.array_equal(cpu[key], cuda[key]), f"ADMM CPU vs CUDA: {key} differs")
    check(bool(np.all((cpu["admm_iters"] - cuda["admm_iters"]) % CHECK_EVERY == 0)),
          f"ADMM CPU vs CUDA iterations {cpu['admm_iters']} / {cuda['admm_iters']}")
    worst = {k: float(np.max(np.abs(cpu[k].astype(np.float64) - cuda[k]))) for k in PER_HOME}
    check(max(worst.values()) <= ADMM_SERIES_ATOL, f"ADMM CPU vs CUDA series: {worst}")
    out = dict(worst=worst, iters_cpu=cpu["admm_iters"].tolist(),
               iters_cuda=cuda["admm_iters"].tolist(),
               solve_rate=float(cpu["correct_solve"].mean()))
    log("ADMM CPU vs CUDA (8 homes, H = 24): " + json.dumps(out))
    return out


def admm_main_path(outputs_dir: str) -> dict:
    """The 10,000-home, 24-step main path with ``solver = "admm"``,
    backend "auto" (the dense inverse at every bucket), telemetry on:
    solve rate, seconds and launches a step, iterations, factorizations a
    step; no band or window kernel launched."""
    import numpy as np

    from dragg_tpu_torch.ops import admm

    admm.reset_factorizations()
    agg, res, launches, seconds = drive(os.path.join(outputs_dir, "admm"), "admm")
    factors = dict(admm.FACTORIZATIONS)
    stream = stream_checks(agg, res, 24, "main path (ADMM)")
    summary, solved = check_results(res)
    backends = agg.engine.solve_backends
    check(backends == ["dense_inv"] * len(backends), f"ADMM backends {backends}")
    check(all(v == 0 for v in launches.values()),
          f"the ADMM's dense-inverse path launched kernels: {launches}")
    rate = float(np.mean(solved))
    check(rate >= ADMM_MIN_RATE, f"ADMM main path solve rate {rate} < {ADMM_MIN_RATE}")
    phase = summary["phase_times"]
    prof = step_profile(agg.engine)
    stats = dict(
        homes=N_HOMES, steps=24, solver="admm", backends=backends, solve_rate=rate,
        mean_iterations=float(np.mean(summary["solver_iterations"])),
        iterations_per_step=summary["solver_iterations"],
        s_per_step=(phase["device_chunks"] + phase["collect"]) / 24,
        run_s=seconds, launches=launches,
        factorizations=factors, factorizations_per_step=sum(factors.values()) / 24,
        # One t = 0 step (a refresh, cold start) under torch.profiler.
        step_profile_t0=prof, stream=stream,
    )
    log("main path (ADMM): " + json.dumps({k: v for k, v in stats.items() if k != "stream"}))
    return stats


def admm_engine_run(n_homes: int, steps: int, **tpu) -> tuple:
    """(outputs as numpy, seconds a step, launch counts, factorizations) of
    a ``run_chunk`` of ``steps`` steps from t = 0 of the mixed community
    under the ADMM, H = 24, on the card."""
    import torch

    from dragg_tpu_torch.ops import admm

    import numpy as np

    from dragg_tpu_torch.aggregator import Aggregator

    cfg = community_config(n_homes, 24, "2015-01-02 00", bucketed="auto", **tpu)
    cfg["home"]["hems"]["solver"] = "admm"
    with tempfile.TemporaryDirectory() as d:
        agg = Aggregator(cfg, outputs_dir=d, device="cuda")
        agg.get_homes()
        agg._build_engine()
    eng = agg.engine
    rps = np.zeros((steps, eng.params.horizon), np.float32)
    reset_launches()
    admm.reset_factorizations()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = eng.run_chunk(eng.init_state(), 0, rps)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / steps
    return ({f: getattr(out, f).cpu().numpy() for f in out._fields}, sec, launch_counts(),
            dict(admm.FACTORIZATIONS), eng)


def admm_band_leg() -> dict:
    """``admm_solve_backend = "band"``: 10,000 homes × ADMM_BAND_STEPS with
    the band kernels (``band_kernel = "auto"``): the kernels launched (the
    factor at every refactorization, the solve every iteration and in the
    polish); then the kernels and their plain versions (``"xla"``) on the
    card, ADMM_BAND_PLAIN_STEPS at ADMM_BAND_PLAIN_ITERS iterations,
    bit-equal (a refresh, a stale-factor step, a rho update)."""
    import numpy as np

    kern, sec_k, launches_k, fac_k, eng = admm_engine_run(
        N_HOMES, ADMM_BAND_STEPS, admm_solve_backend="band")
    check(eng.solve_backends == ["band"] * len(eng.solve_backends)
          and eng.admm_band_kernel == "auto", f"band leg: {eng.solve_backends}")
    check(launches_k["banded_cholesky_t"] > 0 and launches_k["refined_banded_solve_t"] > 0,
          f"the ADMM band backend launched {launches_k}")
    check(launches_k["factor_refined_solve_t"] == 0 and launches_k[WINDOW] == 0,
          f"the ADMM band backend launched other kernels: {launches_k}")
    capped = dict(admm_solve_backend="band", admm_iters=ADMM_BAND_PLAIN_ITERS)
    kern_c, _, launches_c, _, _ = admm_engine_run(N_HOMES, ADMM_BAND_PLAIN_STEPS, **capped)
    check(launches_c["banded_cholesky_t"] > 0, f"the capped kernel run launched {launches_c}")
    plain, sec_p, launches_p, fac_p, _ = admm_engine_run(
        N_HOMES, ADMM_BAND_PLAIN_STEPS, band_kernel="xla", **capped)
    check(all(v == 0 for v in launches_p.values()), f'"xla" launched kernels: {launches_p}')
    n = ADMM_BAND_PLAIN_STEPS
    diff = [k for k in kern_c if not np.array_equal(kern_c[k], plain[k],
                                                    equal_nan=kern_c[k].dtype.kind == "f")]
    check(not diff, f"ADMM band backend: the kernels differ from their plain versions at {diff}")
    out = dict(steps=ADMM_BAND_STEPS, plain_steps=n, plain_iters=ADMM_BAND_PLAIN_ITERS,
               launches=launches_k, launches_capped=launches_c, s_per_step=sec_k,
               s_per_step_plain=sec_p, factorizations=fac_k, factorizations_plain=fac_p,
               solve_rate=float(kern["correct_solve"].mean()),
               iterations_per_step=kern["admm_iters"].tolist(), bit_equal=True)
    log("ADMM band backend: " + json.dumps(out))
    return out


def admm_variants() -> dict:
    """1,000 homes × ADMM_VARIANT_STEPS: the float32 run, the same with
    its windows launched one by one instead of replayed as CUDA graphs
    (within the CPU tests' tolerances; whether bit-equal is printed), and
    each opt-in variant: a bf16 Sinv (with one refinement
    pass: at the default 0 neither package's ADMM solves a home of the
    16-home, 24 h QP on the CPU), the bf16x3 apply, Anderson depth 5;
    solve rate, iterations, seconds a step printed, every series finite."""
    import numpy as np

    from dragg_tpu_torch.ops import admm

    base, sec, _, _, _ = admm_engine_run(ADMM_VARIANT_HOMES, ADMM_VARIANT_STEPS)
    out = {"f32": dict(solve_rate=float(base["correct_solve"].mean()), s_per_step=sec,
                       iterations=base["admm_iters"].tolist())}
    # The dense inverse's windows replayed as CUDA graphs against the same
    # windows launched one by one: the same kernels (expected bit-equal;
    # held to the CPU tests' tolerances, the flags equal).
    admm.CUDA_GRAPHS = False
    try:
        eager, sec, _, _, _ = admm_engine_run(ADMM_VARIANT_HOMES, ADMM_VARIANT_STEPS)
    finally:
        admm.CUDA_GRAPHS = True
    check(np.array_equal(base["correct_solve"], eager["correct_solve"]),
          "ADMM: solved flags differ between the CUDA-graph and the eager windows")
    worst = max(float(np.max(np.abs(base[k].astype(np.float64) - eager[k])))
                for k in PER_HOME)
    check(worst <= ADMM_SERIES_ATOL, f"ADMM: graph against eager windows: {worst}")
    out["f32_eager"] = dict(s_per_step=sec, worst=worst, bit_equal=all(
        np.array_equal(base[k], eager[k], equal_nan=base[k].dtype.kind == "f") for k in base))
    for name, tpu in (("bf16_sinv_refine1", dict(admm_matvec_dtype="bf16", admm_refine=1)),
                      ("bf16x3", dict(precision="bf16x3")),
                      ("anderson5", dict(admm_anderson=5))):
        got, sec, _, _, _ = admm_engine_run(ADMM_VARIANT_HOMES, ADMM_VARIANT_STEPS, **tpu)
        check(all(np.all(np.isfinite(got[k])) for k in PER_HOME), f"ADMM {name}: non-finite")
        out[name] = dict(solve_rate=float(got["correct_solve"].mean()), s_per_step=sec,
                         iterations=got["admm_iters"].tolist())
    log("ADMM variants: " + json.dumps(out))
    return out


def cr_check() -> dict:
    """``band_kernel = "cr"`` on the interior point, CR_HOMES × CR_STEPS on
    the card, each step from the split route's state, against the split
    route (the band kernels): solved flags equal; the series within the
    IPM's CPU-vs-card ENGINE_CPU_CUDA_ATOL, but for two degenerate faces
    that another elimination order moves the interior point along
    (measured on an H100 80GB HBM3): the PV curtailment, compared only
    where the home generates (``p_pv`` > 0: at night any curtailment is
    optimal; 0.194 apart there with p_pv equal), and the battery's
    schedule with the grid power it moves, held to BATTERY_ATOL (0.0106
    kWh apart); seconds a step of each."""
    import numpy as np
    import torch

    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.checkpoint import tree_map

    engines = {}
    for kern in ("cr", "auto"):
        with tempfile.TemporaryDirectory() as d:
            agg = Aggregator(community_config(CR_HOMES, 24, "2015-01-02 00", bucketed="auto",
                                              band_kernel=kern), outputs_dir=d, device="cuda")
            agg.get_homes()
            agg._build_engine()
        engines[kern] = agg.engine
    rp = np.zeros((1, 24), np.float32)
    state = engines["auto"].init_state()
    worst, secs = {}, {"cr": 0.0, "auto": 0.0}
    reset_launches()
    for t in range(CR_STEPS):
        outs = {}
        for kern in ("cr", "auto"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nxt, o = engines[kern].run_chunk(tree_map(lambda a: a.clone(), state), t, rp)
            torch.cuda.synchronize()
            secs[kern] += (time.perf_counter() - t0) / CR_STEPS
            outs[kern] = {f: getattr(o, f).cpu().numpy() for f in o._fields}
            if kern == "auto":
                state = nxt
        check(np.array_equal(outs["cr"]["correct_solve"], outs["auto"]["correct_solve"]),
              f"cr: solved flags differ from the split route at t = {t}")
        lit = (outs["cr"]["p_pv"] > 0) | (outs["auto"]["p_pv"] > 0)
        for k in PER_HOME + ("u_pv_curt_lit",):
            a, b = (outs[r][k.removesuffix("_lit")].astype(np.float64) for r in ("cr", "auto"))
            d = np.abs(a - b)[lit] if k.endswith("_lit") else np.abs(a - b)
            worst[k] = max(worst.get(k, 0.0), float(np.max(d, initial=0.0)))
    battery = ("e_batt", "p_batt_ch", "p_batt_disch", "p_grid", "forecast_p_grid")
    check(all(worst[k] <= (BATTERY_ATOL if k in battery else ENGINE_CPU_CUDA_ATOL)
              for k in worst if k != "u_pv_curt"), f"cr against the split route: {worst}")
    out = dict(homes=CR_HOMES, steps=CR_STEPS, s_per_step_cr=secs["cr"],
               s_per_step_split=secs["auto"], worst=worst, launches=launch_counts())
    log("cr: " + json.dumps(out))
    return out


def admm_phase(outputs_dir: str, shapes, grid_shapes) -> dict:
    """Phase 16: the ADMM (dense inverse and band backend) and cyclic
    reduction (module docstring)."""
    out = dict(refine_kernels=admm_refine_kernels(shapes),
               refine_kernels_grid=admm_refine_kernels(grid_shapes))
    highs_check("admm")
    out["cpu_vs_cuda"] = admm_cpu_vs_cuda()
    out["main_path"] = admm_main_path(outputs_dir)
    out["band"] = admm_band_leg()
    out["variants"] = admm_variants()
    out["cr"] = cr_check()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device visible")
    try:
        from dragg_tpu_torch.ops import band_kernels as bk
    except ImportError as e:
        return fail(f"the dragg_tpu_torch package is not importable here ({e})")
    # The run checks this checkout's port and kernel sources, never an
    # installed copy found elsewhere on the path.
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.abspath(bk.__file__).startswith(os.path.join(here, "dragg_tpu_torch", "")):
        return fail(f"dragg_tpu_torch comes from {bk.__file__}, not from {here}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "", f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({card}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    from dragg_tpu_torch.ops.cuda_lib import build_library

    # Seconds of each phase, for the next slice's budget (the phases line).
    phases = {}

    def timed(phase: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phases[phase] = round(phases.get(phase, 0.0) + time.perf_counter() - t0, 1)
        return out

    t_start = time.perf_counter()
    timed("2_build", build_library)
    log(f"build: {phases['2_build']:.1f} s")

    from dragg_tpu_torch.aggregator import Aggregator

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        buckets = {}
        for h in (MAIN_HORIZON, 48):
            agg = Aggregator(community_config(N_HOMES, h, "2015-01-01 01", bucketed="auto"),
                             outputs_dir=d, device="cuda")
            agg.get_homes()
            agg._build_engine()
            buckets[h] = agg.engine.bucket_info()
            del agg
        # The grid-block shapes: 10,000 homes under the pack, H = 24.
        agg = Aggregator(scenario_config(N_HOMES, MAIN_HORIZON, 1), outputs_dir=d, device="cuda")
        agg.get_homes()
        agg._build_engine()
        grid = agg.engine.bucket_info()
        check(agg.engine.events is not None and len(grid) == 6,
              f"the grid-block community: {len(grid)} buckets, events {agg.engine.events}")
        del agg
        shapes = [(h, b["name"], b["m_eq"], b["band_bw"], b["n_real"])
                  for h, bs in buckets.items() for b in bs]
        log(f"bucket band shapes (horizon, name, m, bw, B): {shapes}")
        grid_shapes = [(GRID, b["name"], b["m_eq"], b["band_bw"], b["n_real"]) for b in grid]
        log(f"grid-block band shapes: {grid_shapes}")
        phases["3_kernels"] = round(time.perf_counter() - t0, 1)  # the bucket shapes
        kern = timed("3_kernels", kernel_phase, shapes)
        win = timed("3_kernels", window_phase, [(b["name"], b["m_eq"], b["n_var"], b["n_real"])
                                                for b in buckets[MAIN_HORIZON]])
        # H = 48: every bucket runs, the two largest on a 2-block cluster.
        win48 = timed("3_kernels", window_phase,
                      [(b["name"], b["m_eq"], b["n_var"], b["n_real"]) for b in buckets[48]],
                      sizes=(1001,))
        kern_grid = timed("3_kernels", kernel_phase, grid_shapes)
        win_grid = timed("3_kernels", window_phase,
                         [(b["name"], b["m_eq"], b["n_var"], b["n_real"]) for b in grid],
                         sizes=(1001,))
        timed("4_small_inputs", highs_check, "ipm")
        timed("4_small_inputs", highs_check, "reluqp")
        cpu_conv = timed("4_small_inputs", cpu_vs_cuda_check)
        timed("4_small_inputs", reluqp_cpu_vs_cuda_check)
        stats = timed("5_main_path_ipm", main_path, d)
        rstats = timed("6_main_path_reluqp", reluqp_main_path, d)
        routes = timed("7_route_check", route_check)
        routes48 = timed("8_h48", h48_route_check)
        resume = timed("9_resume_pipeline", resume_pipeline_phase, d)
        resolve = timed("10_resolve", resolve_phase, d)
        xla = timed("11_band_kernel_xla", xla_route_check)
        rl = timed("12_rl", rl_phase, d, stats)
        fleet = timed("13_fleet", fleet_phase, d)
        fleet_rl = timed("14_fleet_rl", fleet_rl_phase, d, rl)
        tel = timed("15_telemetry", telemetry_phase, d, stats, rstats, fleet, routes, cpu_conv)
        admm = timed("16_admm", admm_phase, d, [r for r in shapes if r[0] == MAIN_HORIZON],
                     grid_shapes)

    launches = {"banded_cholesky_t": stats["launches_split"]["banded_cholesky_t"],
                "refined_banded_solve_t": stats["launches_split"]["refined_banded_solve_t"],
                "factor_refined_solve_t": stats["launches_fused"]["factor_refined_solve_t"]}
    # run_rl_agg: the band kernels from the linear agent's split-route run,
    # the fused kernel from the DDPG run's fused route, the window from
    # the ReLU-QP run.
    launches_rl = {"banded_cholesky_t": rl["linear"]["launches"]["banded_cholesky_t"],
                   "refined_banded_solve_t": rl["linear"]["launches"]["refined_banded_solve_t"],
                   "factor_refined_solve_t": rl["ddpg"]["launches"]["factor_refined_solve_t"],
                   WINDOW: rl["reluqp"]["launches"][WINDOW]}
    # Phase 13: the band kernels from the fleet's split-route run, the fused
    # kernel from community 3's run alone, the window from the ReLU-QP run.
    launches_fleet = {"banded_cholesky_t": fleet["ipm"]["launches"]["banded_cholesky_t"],
                      "refined_banded_solve_t":
                          fleet["ipm"]["launches"]["refined_banded_solve_t"],
                      "factor_refined_solve_t":
                          fleet["community_3"]["launches"]["factor_refined_solve_t"],
                      WINDOW: fleet["reluqp"]["launches"][WINDOW]}

    def grid_block(rows, name=None):
        """One call at each grid-block bucket's shape, summed."""
        pick = (lambda r: r["kernels"][name]) if name else (lambda r: r)
        out = {k: sum(pick(r)[k] for r in rows)
               for k in ("ms", "device_ms", "plain_ms", "library_ms")}
        if name:
            out.update(bound_ms=sum(pick(r)["bound_ms"] for r in rows),
                       bound_by=pick(rows[0])["bound_by"],
                       shapes=[[r["bucket"], r["m"], r["bw"], r["B"]] for r in rows])
        else:
            t_b = sum(r["bound_bytes_ms"] for r in rows)
            t_o = sum(r["bound_ops_ms"] for r in rows)
            out.update(bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations",
                       shapes=[[r["bucket"], r["m"], r["n"], r["B"]] for r in rows],
                       plans=[r["plan"] for r in rows])
        return out

    grid_rows = [r for r in kern_grid["per_shape"] if r["horizon"] == GRID]
    entries = []
    main_rows = [r for r in kern["per_shape"] if r["horizon"] == MAIN_HORIZON]
    floor_rows = [r for r in kern["one_block"] if r["horizon"] == MAIN_HORIZON]
    for name in REPLACES:
        rows = [r["kernels"][name] for r in main_rows]
        entries.append(dict(
            name=name, route="cuda", source=BAND_SOURCE, replaces=REPLACES[name],
            launches=launches[name], max_abs_err=kern["max_abs_err"][name],
            # One call at every bucket's main-path shape, summed: ms with
            # the host's launch time, as the window's and every earlier
            # table's; device_ms the device's time per call (launches
            # queued back to back).
            ms=sum(r["ms"] for r in rows), device_ms=sum(r["device_ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by=rows[0]["bound_by"],
            library_ms=sum(r["library_ms"] for r in rows),
            **({"split_ms": sum(r["split_ms"] for r in rows),
                "split_device_ms": sum(r["split_device_ms"] for r in rows)}
               if name == "factor_refined_solve_t" else {}),
            # The same kernels over 32 homes at each distinct shape.
            one_block_device_ms={f"m={r['m']},bw={r['bw']},B={r['B']}":
                                 r["kernels"][name]["device_ms"] for r in floor_rows},
            shapes=[[r["bucket"], r["m"], r["bw"], r["B"]] for r in main_rows],
            # integer_repair = "resolve", 10,000 homes × RESOLVE_STEPS steps
            # (the fused kernel does not run on the default split route).
            launches_resolve=resolve["ipm"]["resolve"]["launches"][name],
            launches_rl=launches_rl[name],
            launches_fleet=launches_fleet[name],
            launches_fleet_rl=fleet_rl["launches"][name],
            # Phase 15's A/B legs with the telemetry on (IPM, split route).
            launches_telemetry=tel["launches"][name],
            # Phase 16: the ADMM's band backend, 10,000 homes × ADMM_BAND_STEPS.
            launches_admm_band=admm["band"]["launches"][name],
            **({"refine_ms": {str(k): v["ms"] for k, v in
                              admm["refine_kernels"]["summed"].items()},
                "refine_device_ms": {str(k): v["device_ms"] for k, v in
                                     admm["refine_kernels"]["summed"].items()},
                "refine_max_abs_err": max(admm["refine_kernels"]["max_abs_err"],
                                          admm["refine_kernels_grid"]["max_abs_err"])}
               if name == "refined_banded_solve_t" else {}),
            grid_block=dict(grid_block(grid_rows, name),
                            max_abs_err=kern_grid["max_abs_err"][name]),
        ))
    rows = win["per_shape"]
    t_bytes = sum(r["bound_bytes_ms"] for r in rows)
    t_ops = sum(r["bound_ops_ms"] for r in rows)
    entries.append(dict(
        name=WINDOW, route="cuda", source=WINDOW_SOURCE, replaces=WINDOW_REPLACES,
        launches=rstats["launches"][WINDOW], max_abs_err=win["max_abs_err"],
        # One k = 25 window at every bucket's main-path shape, summed.
        ms=sum(r["ms"] for r in rows), device_ms=sum(r["device_ms"] for r in rows),
        plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=sum(r["library_ms"] for r in rows),
        library="the port's iter_kernel='lax' route, the plain version (a batched "
                "einsum chain): no single PyTorch call computes the window",
        launches_resolve=resolve["reluqp"]["resolve"]["launches"][WINDOW],
        launches_rl=launches_rl[WINDOW],
        shapes=[[r["bucket"], r["m"], r["n"], r["B"]] for r in rows],
        launches_fleet=launches_fleet[WINDOW],
        launches_fleet_rl=fleet_rl["launches"][WINDOW],
        launches_telemetry=tel["launches"][WINDOW],
        launches_admm_band=admm["band"]["launches"][WINDOW],
        grid_block=dict(grid_block(win_grid["per_shape"]), max_abs_err=win_grid["max_abs_err"]),
    ))
    phases["whole_script"] = round(time.perf_counter() - t_start, 1)
    log(f"whole script: {phases['whole_script']:.1f} s")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kern, "window": win, "window_h48": win48,
                   "main_path": stats, "main_path_reluqp": rstats, "routes": routes,
                   "routes_h48": routes48, "resume_pipeline": resume, "resolve": resolve,
                   "band_kernel_xla": xla, "rl": rl, "kernels_grid": kern_grid,
                   "window_grid": win_grid, "fleet": fleet, "fleet_rl": fleet_rl,
                   "telemetry": tel, "admm": admm, "phases": phases}, f, indent=1)
    print(json.dumps({"phases": phases}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except AssertionError as e:
        sys.exit(fail(str(e)))
