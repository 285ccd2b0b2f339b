#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dragg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code on failure:

1. device: a CUDA card must be visible; prints its name and power limit;
2. build, as the image builds: the kernel-build ``RUN`` line of
   dragg_tpu_torch/deploy/Dockerfile (``CUDA_VISIBLE_DEVICES= python -m
   dragg_tpu_torch.kernel_cache``) in a subprocess that sees no card,
   into a fresh ``$DRAGG_COMPILE_CACHE_DIR`` outside the repo that the
   script then keeps for every later phase and child: every kernel
   source in dragg_tpu_torch/csrc/ compiled with nvcc (one nvcc per
   unit, started together: band.cu in five units, iter.cu) and the
   native host library with g++ beside them, both in that directory,
   no card visible and torch not imported;
   beside phase 3's bucket-shape discovery (engines built, no kernel
   launched);
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
9. resume and pipeline: a 2,500-home community in hourly chunks, the
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
   on a 1,000-home community of the mix, H = 24, the same 36 steps in daily
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
   the same fleet at 4 × 500 homes for 18 steps with ReLU-QP through the
   fused window, the same event checks; 12 homes (two of each type) × 2 communities
   with inline events, H = 6, 8 steps, the CPU against the card step by
   step, home-step by home-step where the home's bucket stopped below the
   iteration cap on both (at least 120 of 192): solved flags equal and
   the series within phase 4's 1e-2;
14. the fleet RL cases, in a Python process of their own beside phase 13
   (both host-bound, one core each): ``run_rl_agg`` on 4 communities × 500 homes
   (legacy mix, no weather offset), H = 24: the shared linear agent
   through the IPM's split route for 26 hourly steps in daily chunks
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
   at the chunk's start; 2,500 homes × 2 hourly steps with the
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
   on the 10,000-home community, 4 steps, backend "auto" (the dense
   inverse at every bucket, no band or window kernel), solve rate ≥ 0.99,
   s a step, iterations, factorizations a step, one t = 0 step's launches
   under torch.profiler; ``admm_solve_backend = "band"``, 2,500 homes ×
   2 steps with the band kernels and with their plain versions on the
   card, the kernels launched and the runs bit-equal; 1,000 homes × 1
   step of a bf16 Sinv (one refinement pass), the bf16x3 apply and
   Anderson depth 5 beside the float32 run, solve rates printed; ``band_kernel = "cr"`` on the interior point, 1,000
   homes × 4 steps against the split route within the CPU-vs-card
   tolerance;
17. the CLI readers: ``python -m dragg_tpu_torch sweep --horizons 2,4,8
   --no-figures`` through ``__main__.main`` on the 2,500-home community
   of the mix, 6 hourly steps from 2015-01-01 00 (the card's machine has
   no matplotlib): each horizon's results.json on disk, its solve rate at
   least SWEEP_MIN_SOLVE_RATE, its band kernels launched (counted per
   horizon around each ``Aggregator.run``); the band kernels bit-equal to
   their plain versions at every bucket shape of the three horizons and
   timed there; Reformat on the sweep's tree discovers exactly the three
   runs, ``daily_stats`` and ``stats_table`` run; the dashboard served
   from a thread on an ephemeral port answers ``/``, ``/live`` and
   ``/metrics.json`` with 200, the index naming the three runs;
18. supervised runs (``run --supervised`` through the CLI in a subprocess
   whose parent must not import torch; the children are subprocesses with
   deadlines): the subprocess CUDA probe says the card is alive; a healthy
   run of 2,500 homes × 4 hourly chunks (``--platform auto``) finishes on
   "cuda" in one attempt, with its child's band kernel launches, its
   results.json bit-equal to an in-process ``Aggregator(config,
   device="cuda").run()``; a card lost at the third chunk
   (``probe_live,sigkill@sim_chunk:3:once``, 16 homes × 4 hourly chunks,
   H = 4) is CHILD_CRASH, resumes on the CPU from timestep 1 (the
   pipeline has checkpointed chunk 1, not chunk 2), is recorded as one
   cuda→cpu transition, completes, clears its checkpoint, and holds
   phase 4's checks against a card run (flags equal, series within
   1e-2); under ``probe_down:5`` ``--platform cuda`` does not complete
   and runs no CPU attempt;
19. sharding over torch.distributed (``dragg_tpu_torch.parallel``), the
   2,500-home community of the mix, H = 24, hourly chunks: (a) a world
   of one through ``python -m dragg_tpu_torch run --device cuda`` (the
   CLI's ``main`` in-process) with ``$DRAGG_DISTRIBUTED=1`` and the three
   ``$DRAGG_*`` variables, 4 steps through the IPM's split route: its
   results.json bit-equal to an unsharded run's, the same band launches,
   its checkpoints the shard file ``state.proc00000-of-00001.npz``; then
   two ranks of one gloo group sharing the card (``cuda:0`` each), two
   processes of ``RANK_PROGRAM`` with a timeout, which run every job below
   in turn: (b) the same 4 steps, rank 0 alone writing results.json,
   within 1e-2 of leg a, solve rate ≥ 0.99, both ranks reporting the
   same iterations and running the same phase-1 iterations (each rank's
   own count, before any reduction), each rank's band kernels bit-equal
   to their plain versions at its block shapes (B = 500 and 125), its launches and s
   a step; (c) 2,500 homes × 2 chunks stopped after 1 and resumed,
   bit-equal to the uninterrupted two-rank run, each rank's directory
   holding its own shard file alone and rank 1 no progress.json; (d)
   1,000 homes × 2 steps of ReLU-QP (``iter_kernel = "pallas"``,
   resolved to ``"lax"``) and of the ADMM, both ranks reading the same
   check windows (each rank's own count) and stopping at the same
   windows with the same factorizations;

20. serving (``python -m dragg_tpu_torch serve --platform cuda --port 0``
   in subprocesses whose parents must not import torch, driven over
   HTTP): the main daemon serves the 10,000-home community of the mix (H =
   24, hourly, IPM on the split band route) and a ``serve.patterns`` lane
   of 4 fleet slots × 2,500 homes; (a) both workers warm on the card, the
   warm-up's three stages reported and the kernel library a ``hit`` (phase
   2 built it); (b) 24 requests at t = 0 and 1 over two reward prices (some
   with state overrides) and 16 on the fleet lane over four prices in one
   batch, each answer equal to the port's ``EngineRunner`` run in this
   process on the card on the same lane configs and groups, and each
   served batch's band launches (from the worker's beats) equal to that
   run's; (c) a fleet group solved alone at the next slot within 1e-2,
   its verdicts equal (bit-equality reported); (d) a ``steps = 4`` request
   streams 4 chunk lines and a terminal record; (e) the default lane's
   first worker SIGKILLed at its first batch (``sigkill@serve_batch:1:once``)
   is CHILD_CRASH, relaunched on the card (a ``hit``), its batch answered
   once, ``loadgen.journal_anomalies`` empty; (f) 8 homes: the card lost
   at the first batch with the probe held down moves serving to the CPU
   (``--device cpu``), the transition journaled, every answer carrying
   it, within 1e-2 of the card's with equal verdicts; (g) 8 homes: a
   daemon SIGTERMed with a batch hung in its worker exits 1, and one
   restarted on the same serve directory replays the two unfinished
   requests (equal to the card's direct run) and answers duplicates from
   the journal; prints each worker's warm-up, per-lane latency, each
   batch's seconds and groups, and the band launches a served step;
21. the shard coordinator (``python -m dragg_tpu_torch.shard --platform
   cuda``, leg d ``auto``, in subprocesses whose parents must not import
   torch; the workers
   are ``python -m dragg_tpu_torch.shard.worker --device cuda|cpu``) on
   phase 13's fleet shape without the pack: 4 communities × 2,500 homes of
   the legacy mix, H = 24, hourly, 4 steps in chunks of 2, the IPM on the
   split band route: (a) first and alone on the card, one coordinator at
   a time, so that its workers' ready and device seconds are the layer's
   own: one worker, its merged per-community series
   (agg_load, agg_cost, solved) bit-equal to ``Aggregator(config,
   device="cuda").run()``'s results.json folded the same way; two workers
   within 1e-2 of it with equal solved counts (bit-equality reported), solve
   rate ≥ 0.99, every worker on the card with ``chol_kernel`` and
   ``refined_solve_kernel`` launches (its beats' counts); (b) a worker
   SIGKILLed at its second chunk (``sigkill@shard_chunk:2:once``): one
   CHILD_CRASH, one relaunch on the card, every chunk acked, the merged
   series bit-equal to (a)'s two-worker run; (c) ``shard.transport =
   "tcp"``: bit-equal to it, every chunk acked once; all at once with
   b and c, after a, on threads, with the in-process reference of (a)
   (their seconds are contended), (d) 8 homes a community under
   ``--platform auto``, one worker's first generation exiting at its
   build and the probe then finding the card gone
   (``exit@shard_build:1:once,probe_down``, ``degrade_after = 1``): that
   shard relaunched ``--device cpu``, the transition journaled with its
   kind, the other on the card, the merged series within 1e-2 of a run all
   on the card; (e) 100 homes a community stopped at t = 2 on 2 workers,
   ``python -m dragg_tpu_torch.reshard_checkpoint --workers 4`` (every
   community's rows read back bit-exact), resumed on 4 workers to 4 steps,
   within 1e-2 of an uninterrupted 2-worker run; (f) ``python -m
   dragg_tpu_torch doctor --compile-check --shard-check --telemetry``:
   exit 0, no FAIL, the parent torch-free, the backend "cuda",
   ``cuda_kernels`` ok for all four kernels, ``staged_compile``'s library
   a ``hit``; prints each worker's ready seconds, device seconds a chunk
   and launches, the merge lag of each chunk and the relaunch seconds;
22. the serving load and soak tools and the scale check, each ``python -m
   dragg_tpu_torch.<tool>`` in a subprocess whose parent asserts it has no
   torch, their workers and children on the card: (a) alone, the load
   ladder ``serve_load --homes 2500 --fleet-slots 4
   --horizon-hours 24 --rates 2,8,32 --duration-s 4`` (10,000 home slots
   a batch, the IPM on the split band route, the default 30 s p99 SLO and
   4 reward-price groups): ok, every level within the SLO, the journal
   without anomalies (``loadgen.journal_anomalies``), every answer from
   the card, the served batches' ``chol_kernel`` and
   ``refined_solve_kernel`` launches (the worker's beats) and no other
   kernel's; (b) the soak's ``child_crash`` and ``kill9`` scenarios
   (``serve_soak --scenario``, one soak each, at its default 32 homes, H
   = 4, 48 requests): every invariant of ``check_invariants``, a
   classified CHILD_CRASH that struck a batch in flight (a request
   answered on a retry), a replacement worker ready on the card, its
   library not a ``miss``; (c) ``validate_scale --homes 10000
   --horizon-hours 48 --steps 4 --chunk 4`` (the ADMM, the bench mix):
   ok (finite outputs, comfort bands within its 0.05 tolerance, its 0.97
   solve rate), from the card; b and c at once, started before phase 13
   and run beside it (contended), joined before a;
   prints each level's p50 / p99 and phase split, the saturation rate,
   the warm-up, the band launches a served batch, the soak's recovery
   seconds, and the scale check's seconds a step, home-steps a second,
   each bucket's ADMM backend and the card's peak memory; the tools'
   ``tpu.compile_cache_dir`` (under their ``--root``) holds links to
   phase 2's libraries, so their workers load them;
23. the bench harness and the last tools, each ``python -m
   dragg_tpu_torch[.<tool>]`` in a subprocess (the harness's parent and
   ``bench_rl_fleet``'s never import torch): (a) ``python -m
   dragg_tpu_torch bench --platform cuda --homes 10000 --solver ipm
   --steps 8 --chunks 2``: exactly one line, exit 0, from the card
   (``platform`` "cuda", no ``fallback`` or ``error``, ``device_kind`` the
   card's name), solve rate ≥ 0.99, the phase timers (assemble, solve,
   merge_collect and the four buckets' solves), ``mfu_basis``
   "gpu_spec:h100_sxm" on an H100 SXM, 0 < ``hbm_util`` ≤ 1.05, the timed
   chunks' ``kernel_launches`` the split band route's kernels alone; (b)
   ``bench.run_measured`` in this process at 2,500 homes with the launch
   counts reset (``chol_kernel`` and ``refined_solve_kernel`` launched, no
   other), then, at the main path's 10,000 homes, ``Engine.phase_fns``
   composed (prepare, solve with a refresh, finish) bit-equal to
   ``engine.step`` on the card from a state one step in, and the two
   orders timed against each other (``step`` bucket by bucket, the
   composition phase by phase over the buckets: seconds a step and peak
   device memory, alternated); (c) ``bench --shards 2 --homes 1000
   --communities 2 --platform cuda --steps 2 --chunks 2``: one line, both
   workers on the card, no restart; (d) ``fallback_forensics`` at its
   default (10,000 homes × 24 steps, day 1): failed home-steps found
   (11 in PR 17's runs) and each classified infeasible or under-converged
   by HiGHS, every sampled solved home feasible; (e) ``soak --device cuda`` at its own
   size (rl_agg, DDPG, the IPM at H = 12, 128 homes, 3 days stopped after
   day 1 and resumed): every assertion; (f) ``trace_view
   --assert-complete`` over phase 20's main daemon and phase 21's TCP leg
   (both run with ``telemetry.trace`` on for this): every trace one rooted
   tree without orphans; c, d and e at once, started before phase 13 and
   run beside it (contended), joined first;
24. deploy: ``dragg_tpu_torch/deploy/batch.sh`` run as sbatch would run
   it, under a stand-in ``srun`` written onto ``PATH`` (one task:
   ``SLURM_JOB_ID``, ``SLURM_STEP_NODELIST`` this host's name,
   ``SLURM_NTASKS=1``, ``SLURM_PROCID=0``, ``SLURM_LOCALID=0``; the
   machine has no SLURM) and a stand-in ``nvcc`` that records each call
   and runs the toolkit's: ``python -m dragg_tpu_torch run`` on the
   10,000-home community of the mix, H = 24, 4 hourly steps, the IPM on
   the split band route, started beside phase 13: it finds its rank
   through SLURM's variables (``[run] slurm: rank 0 of 1, local id 0``,
   the coordinator this host on the job id's port), loads phase 2's
   library (``run.end``'s ``kernel_library`` a ``hit``, nvcc started for
   ``--version`` alone), launches ``chol_kernel`` and
   ``refined_solve_kernel`` (``run.end``'s ``kernel_launches``) as often
   as the in-process run, and its results.json is bit-equal to an
   in-process ``Aggregator(config, device="cuda").run()`` of the same
   config; prints the seconds from the launch to the first chunk's start
   and a step;

then prints the phases line (each phase's seconds), the kernels JSON
line, the card line and, last, the result line.  Per-shape details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import atexit
import datetime
import json
import os
import shutil
import signal
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


def end_after(steps: int) -> str:
    """The end datetime of a run of ``steps`` hourly steps from 2015-01-01 00."""
    end = datetime.datetime(2015, 1, 1) + datetime.timedelta(hours=steps)
    return end.strftime("%Y-%m-%d %H")


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


def drive(outputs_dir: str, solver: str = "ipm", steps: int = 24, **tpu):
    """One Aggregator run of the 10,000-home community (``steps`` hourly
    steps in one chunk) through the public entry point, with every launch
    count reset just before it; returns (aggregator, results, launch
    counts, seconds)."""
    from dragg_tpu_torch.aggregator import Aggregator

    cfg = community_config(N_HOMES, 24, end_after(steps), bucketed="auto", **tpu)
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


def check_results(res: dict, steps: int = 24, homes: int = N_HOMES) -> tuple[dict, list]:
    """Every one of the ``homes`` homes' series in results.json has the
    reference's length over ``steps`` steps and is finite; returns
    (Summary, per-home solved series)."""
    import numpy as np

    summary = res.pop("Summary")
    check(len(res) == homes, f"results.json holds {len(res)} homes, not {homes}")
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
# The resume and pipeline runs' community: 2,500 homes of the mix (10,000
# until PR 12, cut to buy back the script's time: a 10,000-home run's host
# work, results.json rewritten at every chunk boundary, outweighs its two
# steps).
RESUME_HOMES = 2_500
RESUME_STEPS_RELUQP = 2
RESOLVE_STEPS = 2


def hourly_drive(outputs_dir: str, steps: int, solver: str = "ipm", stop=None,
                 resume: bool = False, pipeline: bool = True, telemetry=None,
                 n_homes: int = N_HOMES, interval: str = "hourly", **tpu) -> dict:
    """One Aggregator run of an ``n_homes``-home community in hourly chunks
    (a checkpoint after every step), with every launch count reset just
    before it; ``stop`` stops it after that many chunks, ``resume``
    restores the latest checkpoint; ``telemetry`` overrides ``[telemetry]``
    keys; ``interval = "daily"`` runs the steps as one chunk.  Returns the
    aggregator, results.json, the launch counts, the checkpoint writes'
    seconds and, when stopped, the bytes of the checkpoint left behind."""
    from dragg_tpu_torch.aggregator import Aggregator

    cfg = community_config(n_homes, 24, end_after(steps), bucketed="auto", **tpu)
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
    """The interior point on the split route, RESUME_HOMES homes, H = 24, hourly
    chunks over RESUME_STEPS steps, three ways: the pipeline off, on, and
    on stopped after half the chunks and resumed; then ReLU-QP through the
    fused window stopped and resumed over RESUME_STEPS_RELUQP steps against
    its uninterrupted run.  All bit-equal."""
    half = RESUME_STEPS // 2
    off = hourly_drive(os.path.join(outputs_dir, "off"), RESUME_STEPS, pipeline=False,
                       n_homes=RESUME_HOMES)
    on = hourly_drive(os.path.join(outputs_dir, "on"), RESUME_STEPS, n_homes=RESUME_HOMES)
    part = hourly_drive(os.path.join(outputs_dir, "res"), RESUME_STEPS, stop=half,
                        n_homes=RESUME_HOMES)
    check(part["agg"].timestep == half and part["checkpoint_bytes"],
          f"the stopped run left no checkpoint at t = {half}")
    res = hourly_drive(os.path.join(outputs_dir, "res"), RESUME_STEPS, resume=True,
                       n_homes=RESUME_HOMES)
    check(res["agg"].resumed_from is not None, "the resumed run did not resume")
    for run, what in ((off, "pipeline off"), (on, "pipeline on"), (res, "resumed")):
        check(run["launches"]["banded_cholesky_t"] > 0
              and run["launches"]["refined_banded_solve_t"] > 0,
              f"{what}: the split-route band kernels were not launched: {run['launches']}")
    # The A/B's second pair, in the other order (off, on, on, off).
    on2 = hourly_drive(os.path.join(outputs_dir, "on2"), RESUME_STEPS, n_homes=RESUME_HOMES)
    off2 = hourly_drive(os.path.join(outputs_dir, "off2"), RESUME_STEPS, pipeline=False,
                        n_homes=RESUME_HOMES)
    same_results(on["results"], off["results"], "pipeline on vs off")
    same_results(res["results"], off["results"], "stopped and resumed vs uninterrupted")
    same_results(on2["results"], off2["results"], "pipeline on vs off (second pair)")
    ipm = {what: {k: run[k] for k in ("run_s", "s_per_step", "phase_times", "launches",
                                       "checkpoint_write_s", "checkpoint_bytes")}
           for what, run in (("pipeline_off", off), ("pipeline_on", on),
                             ("stopped", part), ("resumed", res),
                             ("pipeline_on_2", on2), ("pipeline_off_2", off2))}
    log(f"resume and pipeline (IPM, hourly, {RESUME_HOMES:,} homes): bit-equal; "
        + json.dumps(ipm))

    steps = RESUME_STEPS_RELUQP
    kw = dict(solver="reluqp", n_homes=RESUME_HOMES, iter_kernel="pallas", precision="f32")
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
    log(f"resume (ReLU-QP, hourly, {RESUME_HOMES:,} homes): bit-equal; " + json.dumps(rq))
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
# The RL runs' community: 1,000 homes of the mix (10,000 until PR 12, cut
# to buy back the script's time; the agent, its gates and the checks do
# not depend on the community's size).
RL_HOMES = 1_000
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
    RL_HOMES-home community in daily chunks through the public entry point,
    every launch count reset just before it and read just after; ``stop``
    stops it after that many chunks, ``resume`` restores the latest
    checkpoint."""
    from dragg_tpu_torch.aggregator import Aggregator

    cfg = rl_config(RL_HOMES, MAIN_HORIZON, steps, agent, solver, case=case, **tpu)
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

    summary, solved = check_results(dict(run["results"]), steps, RL_HOMES)
    rp = np.asarray(summary["RP"])
    check(rp.shape == (steps,) and bool(np.all(np.isfinite(rp))), f"{what}: RP not finite")
    check(bool(np.all(np.abs(rp) <= MAX_RP + 1e-9)), f"{what}: RP beyond ±{MAX_RP}: {rp}")
    check(not priced or len(np.unique(rp)) > 1, f"{what}: RP constant, the agent did not act")
    phase = summary["phase_times"]
    solved = np.asarray(solved)
    return dict(homes=RL_HOMES, steps=steps, solve_rate=float(np.mean(solved)),
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
    """The RL aggregator on the card: the RL_HOMES-home community, H = 24,
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
    log(f"baseline ({RL_HOMES:,} homes, {RL_STEPS} steps): " + json.dumps(base))
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
    log(f"rl_agg (linear, {RL_HOMES:,} homes, {RL_STEPS} steps): " + json.dumps(lin))

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
    log(f"rl_agg (DDPG, fused band route, {RL_HOMES:,} homes, {RL_STEPS} steps): "
        + json.dumps(ddpg))

    rq = rl_drive(os.path.join(outputs_dir, "rl-reluqp"), RL_RELUQP_STEPS, solver="reluqp",
                  iter_kernel="pallas", precision="f32")
    reluqp = rl_checks(rq, RL_RELUQP_STEPS, "rl_agg (ReLU-QP)")
    ln = rq["launches"]
    check(ln[WINDOW] > 0 and all(v == 0 for k, v in ln.items() if k != WINDOW),
          f"rl_agg (ReLU-QP) did not run the fused window alone: {ln}")
    log(f"rl_agg (ReLU-QP, fused window, {RL_HOMES:,} homes, {RL_RELUQP_STEPS} steps): "
        + json.dumps(reluqp))

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
# The ReLU-QP fleet's communities: 500 homes each (2,500 until PR 12, cut
# to buy back the script's time; its checks are per home).  The IPM
# fleet keeps 2,500 a community: the bounds of its community-3 match come
# from the witness at those batch sizes.
FLEET_RELUQP_HOMES = 500
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
                base: int = 0, stop=None, homes: int = N_HOMES // FLEET_C, **tpu) -> dict:
    """One Aggregator run of the fleet (or, ``communities=1``, community
    ``base`` of it alone) through the public entry point, every launch
    count reset just before it and read just after; ``stop`` stops it
    after that many daily chunks (the homes' water draws are drawn for the
    whole run, so a shorter run would be another population); ``homes``
    a community."""
    from dragg_tpu_torch.aggregator import Aggregator

    cfg = scenario_config(homes, MAIN_HORIZON, steps, communities, **tpu)
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
    return dict(agg=agg, results=results, launches=launches, run_s=run_s,
                homes=communities * homes)


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
    summary, _ = check_results(dict(run["results"]), steps, run["homes"])
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
                         solver="reluqp", homes=FLEET_RELUQP_HOMES, iter_kernel="pallas",
                         precision="f32")
    reluqp = event_checks(rq_run, FLEET_RELUQP_STEPS, "fleet (ReLU-QP)")
    ln = rq_run["launches"]
    check(ln[WINDOW] > 0 and all(v == 0 for k, v in ln.items() if k != WINDOW),
          f"fleet (ReLU-QP) did not run the fused window alone: {ln}")
    log(f"fleet (ReLU-QP, fused window, 4 × {FLEET_RELUQP_HOMES} homes, "
        f"{FLEET_RELUQP_STEPS} steps): " + json.dumps(reluqp))
    streams = {"ipm": stream_checks(ipm_run["agg"], ipm_run["results"], FLEET_STEPS,
                                    "fleet (IPM)"),
               "reluqp": stream_checks(rq_run["agg"], rq_run["results"], FLEET_RELUQP_STEPS,
                                       "fleet (ReLU-QP)")}
    return dict(ipm=ipm, community_3=match, reluqp=reluqp, cpu_vs_cuda=fleet_cpu_vs_cuda(),
                streams=streams)


# ------------------------------------------------------------- fleet RL
FRL_STEPS = 26           # daily chunks of 24 and 2: past the refit (step 9), a resume (30
                         # until PR 16, cut to buy back the script's time)
FRL_SHORT_STEPS = 12     # DDPG, per-community: past the shared learner's gate
FRL_RELUQP_STEPS = 6
# θ_μ first moves at step 2, with step 1's drda: its update at step t
# reads the basis of step t - 1's observation, and at step 0 the forecast
# error is zero here (3 kW a home, the initial guess, is half of this
# mix's max possible load), so that basis is zero.
FRL_MPC_STEPS = 3
# The mpc leg's rl.fleet.mpc_weight (default 0.25): with 2,500 homes a
# community, drda = -2·err·dagg/norm² is ~1e-7 to 2e-5 (norm, the
# community's max possible load, is ~1.5e4 kW; err and dagg grow with the
# homes as norm does, so drda shrinks as 1/homes), so at the default
# weight the term moves θ_μ by a few float32 ulps (PERF.md, section 6).
FRL_MPC_WEIGHT = 1e4
FRL_EVENT_STEPS = 18     # the pack's first DR call (15-17) and tariff shock (17-19)
FRL_CPU_STEPS = 12       # CPU against the card: 2 communities × 4 homes, H = 4
FRL_SIMPLIFIED_C = 8
# The fleet RL runs' communities: 500 homes each (2,500 until PR 12, cut to
# buy back the script's time; the shared learner's gates depend on C and
# the learner batch, not on the homes).
FRL_HOMES = 500


def fleet_rl_config(steps: int, agent: str = "linear", solver: str = "ipm",
                    policy: str = "shared", gradient: str = "score", pack: bool = False,
                    homes: int = FRL_HOMES, communities: int = FLEET_C,
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
    homes = kw.get("homes", FRL_HOMES) * kw.get("communities", FLEET_C)
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
    return dict(agg=agg, results=results, launches=launches, run_s=run_s, rl_data=rl_data,
                homes=homes)


def fleet_rl_checks(run: dict, steps: int, what: str, acted: bool = True) -> dict:
    """Every home's series complete and finite; each community's reward
    prices finite and within ±max_rp, and for a run long enough to show
    the agent act (``acted``) not constant and apart from the other
    communities' (the exploration noise often clips the price at ±max_rp,
    so two steps may not differ).  Returns the run's figures, the solve
    rate per community and day among them."""
    import numpy as np

    agg = run["agg"]
    summary, solved = check_results(dict(run["results"]), steps, run["homes"])
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
    log(f"fleet rl_agg (shared linear, 4 × {FRL_HOMES} homes, {FRL_STEPS} steps): "
        + json.dumps(lin))
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
AB_STEPS = 2              # hourly steps of each leg of the per_home A/B, one chunk (4
                          # until PR 16, cut to buy back the script's time)
# The A/B's community: 2,500 homes of the mix (10,000 until PR 12, cut to
# buy back the script's time).
AB_HOMES = 2_500
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

    cfg = community_config(n_homes, horizon, end_after(steps), **tpu)
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
    """AB_HOMES homes × AB_STEPS hourly steps (one chunk) with the telemetry
    and the observatory on (the defaults) and off: results.json bit-equal, every
    kernel launched as often, the stream of the run with it on checked,
    none written with it off; then one step of each engine profiled, so
    that the launches a step on against off are the fold's own."""
    on = hourly_drive(os.path.join(outputs_dir, f"ab-{solver}-on"), AB_STEPS, solver=solver,
                      interval="daily", n_homes=AB_HOMES, **tpu)
    off = hourly_drive(os.path.join(outputs_dir, f"ab-{solver}-off"), AB_STEPS, solver=solver,
                       telemetry={"enabled": False, "per_home": False}, interval="daily",
                       n_homes=AB_HOMES, **tpu)
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
    log(f"telemetry A/B ({solver}, {AB_HOMES:,} homes, {AB_STEPS} steps): results bit-equal; "
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
ADMM_BAND_STEPS = 2        # a refresh and a step on its factor (4 until PR 12)
# The plain band versions launch ~18 small operations a band row (45.9-55.4
# s a 10,000-home step on an H100 80GB HBM3): they are held against the
# kernels over 2 steps at an iteration cap of 100 (4 check windows, the
# first rho update, the polish), both routes at that cap.
ADMM_BAND_PLAIN_STEPS, ADMM_BAND_PLAIN_ITERS = 2, 100
# The band leg's community: 2,500 homes (10,000 before a cut for the
# script's time: its plain run took 24 s there; its checks are per home).
ADMM_BAND_HOMES = 2_500
ADMM_VARIANT_HOMES, ADMM_VARIANT_STEPS = 1000, 1   # 2 steps until PR 12
CR_HOMES, CR_STEPS = 1000, 4
# The CPU tests' tolerances (tests/test_torch_engine_admm.py): a first-order
# iterate is pinned only to its 1e-4 + 1e-4·|row| stopping ball.
ADMM_SERIES_ATOL = 1e-3
ADMM_MIN_RATE = 0.99       # solve rate of the main path on 2015-01-01
# The ADMM main path's steps: 4 (24 until PR 12, cut to buy back the
# script's time: 1.716 s a step there, PR 11).
ADMM_MAIN_STEPS = 4
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
    """The 10,000-home main path (ADMM_MAIN_STEPS steps) with ``solver = "admm"``,
    backend "auto" (the dense inverse at every bucket), telemetry on:
    solve rate, seconds and launches a step, iterations, factorizations a
    step; no band or window kernel launched."""
    import numpy as np

    from dragg_tpu_torch.ops import admm

    admm.reset_factorizations()
    steps = ADMM_MAIN_STEPS
    agg, res, launches, seconds = drive(os.path.join(outputs_dir, "admm"), "admm", steps)
    factors = dict(admm.FACTORIZATIONS)
    stream = stream_checks(agg, res, steps, "main path (ADMM)")
    summary, solved = check_results(res, steps)
    backends = agg.engine.solve_backends
    check(backends == ["dense_inv"] * len(backends), f"ADMM backends {backends}")
    check(all(v == 0 for v in launches.values()),
          f"the ADMM's dense-inverse path launched kernels: {launches}")
    rate = float(np.mean(solved))
    check(rate >= ADMM_MIN_RATE, f"ADMM main path solve rate {rate} < {ADMM_MIN_RATE}")
    phase = summary["phase_times"]
    prof = step_profile(agg.engine)
    stats = dict(
        homes=N_HOMES, steps=steps, solver="admm", backends=backends, solve_rate=rate,
        mean_iterations=float(np.mean(summary["solver_iterations"])),
        iterations_per_step=summary["solver_iterations"],
        s_per_step=(phase["device_chunks"] + phase["collect"]) / steps,
        run_s=seconds, launches=launches,
        factorizations=factors, factorizations_per_step=sum(factors.values()) / steps,
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
    """``admm_solve_backend = "band"``: ADMM_BAND_HOMES × ADMM_BAND_STEPS with
    the band kernels (``band_kernel = "auto"``): the kernels launched (the
    factor at every refactorization, the solve every iteration and in the
    polish); then the kernels and their plain versions (``"xla"``) on the
    card, ADMM_BAND_PLAIN_STEPS at ADMM_BAND_PLAIN_ITERS iterations,
    bit-equal (a refresh, a stale-factor step, a rho update)."""
    import numpy as np

    kern, sec_k, launches_k, fac_k, eng = admm_engine_run(
        ADMM_BAND_HOMES, ADMM_BAND_STEPS, admm_solve_backend="band")
    check(eng.solve_backends == ["band"] * len(eng.solve_backends)
          and eng.admm_band_kernel == "auto", f"band leg: {eng.solve_backends}")
    check(launches_k["banded_cholesky_t"] > 0 and launches_k["refined_banded_solve_t"] > 0,
          f"the ADMM band backend launched {launches_k}")
    check(launches_k["factor_refined_solve_t"] == 0 and launches_k[WINDOW] == 0,
          f"the ADMM band backend launched other kernels: {launches_k}")
    capped = dict(admm_solve_backend="band", admm_iters=ADMM_BAND_PLAIN_ITERS)
    kern_c, _, launches_c, _, _ = admm_engine_run(ADMM_BAND_HOMES, ADMM_BAND_PLAIN_STEPS,
                                                  **capped)
    check(launches_c["banded_cholesky_t"] > 0, f"the capped kernel run launched {launches_c}")
    plain, sec_p, launches_p, fac_p, _ = admm_engine_run(
        ADMM_BAND_HOMES, ADMM_BAND_PLAIN_STEPS, band_kernel="xla", **capped)
    check(all(v == 0 for v in launches_p.values()), f'"xla" launched kernels: {launches_p}')
    n = ADMM_BAND_PLAIN_STEPS
    diff = [k for k in kern_c if not np.array_equal(kern_c[k], plain[k],
                                                    equal_nan=kern_c[k].dtype.kind == "f")]
    check(not diff, f"ADMM band backend: the kernels differ from their plain versions at {diff}")
    out = dict(homes=ADMM_BAND_HOMES, steps=ADMM_BAND_STEPS, plain_steps=n,
               plain_iters=ADMM_BAND_PLAIN_ITERS, launches=launches_k,
               launches_capped=launches_c, s_per_step=sec_k,
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


# ------------------------------------------------ the readers (phase 17)
SWEEP_HORIZONS = (2, 4, 8)
SWEEP_STEPS = 6
# The sweep's community: 2,500 homes (10,000 before a cut for the script's
# time; its checks are per run and per bucket shape).
SWEEP_HOMES = 2_500
# The solve rate each horizon's run must reach: the bar that the same
# config at 400 homes meets on the CPU (python -m dragg_tpu_torch sweep
# --device cpu): 0.98125, 0.99292 and 1.0 at H = 2, 4 and 8.  A 2 h
# horizon cannot keep every water heater in its band in the morning
# (steps 3-5 solve 0.945-0.985 there), so the bar is below 0.99.
SWEEP_MIN_SOLVE_RATE = 0.97


def toml_text(cfg: dict) -> str:
    """``cfg`` as a TOML file (tables of scalars and lists, lists of inline
    tables), for the CLI's ``--config``."""
    def value(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            return json.dumps(v)
        if isinstance(v, (int, float)):
            return repr(v)
        if isinstance(v, dict):  # an inline table (serve.patterns' entries)
            return "{" + ", ".join(f"{k} = {value(x)}" for k, x in v.items()) + "}"
        return "[" + ", ".join(value(x) for x in v) + "]"

    lines = []

    def table(d: dict, name: str) -> None:
        if name:
            lines.append(f"[{name}]")
        lines.extend(f"{k} = {value(v)}" for k, v in d.items() if not isinstance(v, dict))
        for k, v in d.items():
            if isinstance(v, dict):
                table(v, f"{name}.{k}" if name else k)

    table(cfg, "")
    return "\n".join(lines) + "\n"


def write_config(path: str, cfg: dict) -> str:
    import tomllib

    text = toml_text(cfg)
    check(tomllib.loads(text) == cfg, f"{path}: the TOML does not read back as the config")
    with open(path, "w") as f:
        f.write(text)
    return path


def http_get(port: int, path: str) -> tuple[int, bytes]:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
        return r.status, r.read()


def readers_phase(outputs_dir: str) -> dict:
    """Phase 17: the CLI readers on the card (module docstring): the
    horizon sweep through ``__main__.main``, its runs and their band
    kernel launches (read around each ``Aggregator.run`` the sweep makes),
    the band kernels bit-equal at the sweep's bucket shapes, Reformat's
    discovery and statistics, and the dashboard over HTTP."""
    import contextlib
    import io
    import re
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np

    from dragg_tpu_torch import __main__ as cli
    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.dashboard import Dashboard, make_handler
    from dragg_tpu_torch.reformat import Reformat, daily_stats, stats_table

    cfg = community_config(SWEEP_HOMES, SWEEP_HORIZONS[0], end_after(SWEEP_STEPS),
                           bucketed="auto")
    path = write_config(os.path.join(outputs_dir, "sweep.toml"), cfg)
    out = os.path.join(outputs_dir, "sweep")
    runs = []
    run = Aggregator.run

    def observed(agg):
        before = launch_counts()
        t0 = time.perf_counter()
        run(agg)
        runs.append(dict(horizon=agg.config["home"]["hems"]["prediction_horizon"],
                         run_s=time.perf_counter() - t0, run_dir=agg.run_dir,
                         buckets=agg.engine.bucket_info(),
                         launches={k: v - before[k] for k, v in launch_counts().items()}))

    printed = io.StringIO()
    Aggregator.run = observed
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            rc = cli.main(["sweep", "--horizons", ",".join(map(str, SWEEP_HORIZONS)),
                           "--config", path, "--outputs-dir", out, "--no-figures"])
    finally:
        Aggregator.run = run
    sweep_s = time.perf_counter() - t0
    launches = launch_counts()
    table = printed.getvalue()
    log("sweep:\n" + table)
    rows = [line.split() for line in table.splitlines() if re.match(r"\s+\d+\s", line)]
    check(rc == 0 and [int(r[0]) for r in rows] == list(SWEEP_HORIZONS)
          and all(r[3] == "baseline" for r in rows), f"sweep printed {table!r} (rc {rc})")
    check([r["horizon"] for r in runs] == list(SWEEP_HORIZONS), f"sweep ran {runs}")
    check(launches == {k: sum(r["launches"][k] for r in runs) for k in launches},
          f"sweep launches {launches} against its runs' {[r['launches'] for r in runs]}")
    for r in runs:
        res_path = os.path.join(r["run_dir"], "baseline", "results.json")
        check(os.path.exists(res_path), f"H = {r['horizon']}: no {res_path}")
        with open(res_path) as f:
            res = json.load(f)
        summary, solved = check_results(res, SWEEP_STEPS, SWEEP_HOMES)
        ln = r["launches"]
        check(ln["banded_cholesky_t"] > 0 and ln["refined_banded_solve_t"] > 0
              and ln["factor_refined_solve_t"] == 0 and ln[WINDOW] == 0,
              f"sweep H = {r['horizon']} did not run the split route's kernels alone: {ln}")
        r.update(solve_rate=float(np.mean(solved)), p_max_kw=summary["p_max_aggregate"],
                 mean_ipm_iterations=float(np.mean(summary["solver_iterations"])),
                 s_per_step=(summary["phase_times"]["device_chunks"]
                             + summary["phase_times"]["collect"]) / SWEEP_STEPS,
                 results=res_path)
        check(r["solve_rate"] >= SWEEP_MIN_SOLVE_RATE,
              f"sweep H = {r['horizon']}: solve rate {r['solve_rate']} < {SWEEP_MIN_SOLVE_RATE}")
    log("sweep runs: " + json.dumps([{k: v for k, v in r.items() if k not in ("buckets",)}
                                     for r in runs]))
    # The band kernels at the sweep's bucket shapes, bit for bit.
    shapes = [(r["horizon"], b["name"], b["m_eq"], b["band_bw"], b["n_real"])
              for r in runs for b in r["buckets"]]
    log(f"sweep band shapes (horizon, name, m, bw, B): {shapes}")
    kern = kernel_phase(shapes)

    # Reformat on the sweep's tree, as run_sweep does: exactly the three runs.
    ref = Reformat(config=cfg, outputs_dir=out)
    ref.mpc_params["mpc_prediction_horizons"] = set(SWEEP_HORIZONS)
    ref.mpc_folders = ref.set_mpc_folders()
    ref.files = ref.set_files()
    found = sorted(os.path.abspath(f["results"]) for f in ref.files)
    check(found == sorted(os.path.abspath(r["results"]) for r in runs),
          f"Reformat found {found}")
    stats = []
    for f in ref.files:
        summary = ref._load(f["results"])["Summary"]
        loads = summary["p_grid_aggregate"]
        # Six hourly steps: no whole day (the figures' statistics are
        # empty), so the steps are also read as one "day".
        check(daily_stats(loads, 24 * f["parent"]["agg_dt"]) == {}, "daily_stats of 6 steps")
        stats.append((f"H = {summary['horizon']}, {f['name']}", daily_stats(loads, SWEEP_STEPS)))
    text = stats_table(stats)
    check(all(f"H = {h}, " in text for h in SWEEP_HORIZONS)
          and text.count("\n") == 3 + len(stats), f"stats_table:\n{text}")
    log("Reformat on the sweep's tree:\n" + text)

    # The dashboard as `python -m dragg_tpu_torch dashboard --outputs-dir`
    # serves it (no config: the glob over the tree), from a thread.
    dash = Dashboard(outputs_dir=out)
    check(sorted(os.path.abspath(f["results"]) for f in dash.ref.files) == found,
          f"the dashboard found {[f['results'] for f in dash.ref.files]}")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(dash))
    server = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.1},
                              daemon=True)
    server.start()
    pages = {}
    try:
        for route in ("/", "/live", "/metrics.json"):
            t1 = time.perf_counter()
            status, body = http_get(httpd.server_address[1], route)
            pages[route] = dict(status=status, bytes=len(body), s=time.perf_counter() - t1)
            check(status == 200, f"dashboard {route}: HTTP {status}")
            if route == "/":
                index = body.decode()
                check(all(f["results"] in index for f in dash.ref.files),
                      "the dashboard's index does not name the three runs")
            elif route == "/live":
                check(body.decode().count('<li><a href="/live?run=') == len(runs),
                      "the dashboard's /live does not list the three streams")
            else:
                snap = json.loads(body)
                check(snap["final"] and snap["run_dir"] in [r["run_dir"] for r in runs],
                      f"/metrics.json: {str(snap)[:300]}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    log("dashboard: " + json.dumps(pages))
    return dict(homes=SWEEP_HOMES, steps=SWEEP_STEPS, sweep_s=sweep_s, launches=launches,
                runs=[{k: v for k, v in r.items() if k != "buckets"} for r in runs],
                shapes=shapes, kernels=kern, stats_table=text, dashboard=pages)


# ------------------------------------------- supervised runs (phase 18)
SUPERVISED_STEPS = 4       # hourly chunks
SUPERVISED_HOMES = 2_500   # the healthy run's (10,000 before a cut for time)
LOSS_HOMES = 16
# The parent: the CLI in a fresh interpreter, which then says whether it
# imported torch.
SUPERVISED_WRAPPER = ("import json, sys\n"
                      "from dragg_tpu_torch.__main__ import main\n"
                      "rc = main(sys.argv[1:])\n"
                      "print(json.dumps({'rc': rc, 'parent_torch': 'torch' in sys.modules}))\n")


def supervised_cli(outputs_dir: str, cfg: dict, spec: str, platform: str) -> dict:
    """``python -m dragg_tpu_torch run --supervised`` on ``cfg`` in a
    subprocess with ``$DRAGG_FAULT_INJECT`` = ``spec``: its provenance line,
    the wrapper's line and its seconds."""
    os.makedirs(outputs_dir, exist_ok=True)
    path = write_config(os.path.join(outputs_dir, "config.toml"), cfg)
    env = dict(os.environ, DRAGG_FAULT_INJECT=spec, DRAGG_FAULT_STATE=outputs_dir)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", SUPERVISED_WRAPPER, "run", "--supervised", "--platform", platform,
         "--config", path, "--outputs-dir", os.path.join(outputs_dir, "out"),
         "--deadline", "600"],
        capture_output=True, text=True, timeout=900, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(len(lines) >= 2, f"run --supervised ({spec!r}) printed {proc.stdout!r}; "
                           f"stderr {proc.stderr[-3000:]}")
    prov, tail = json.loads(lines[-2]), json.loads(lines[-1])
    check(tail["parent_torch"] is False, f"the supervising parent imported torch ({spec!r})")
    check(proc.returncode == 0 and tail["rc"] == (0 if prov["completed"] else 1),
          f"run --supervised: exit {proc.returncode}, rc {tail['rc']}, provenance {prov}")
    return dict(prov=prov, seconds=seconds, outputs=os.path.join(outputs_dir, "out"))


def card_run(outputs_dir: str, cfg: dict) -> dict:
    """results.json of an in-process ``Aggregator(cfg, device="cuda").run()``
    and the run's launches."""
    from dragg_tpu_torch.aggregator import Aggregator

    agg = Aggregator(cfg, outputs_dir=outputs_dir, device="cuda")
    reset_launches()
    agg.run()
    launches = launch_counts()
    with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
        return dict(results=json.load(f), launches=launches, run_dir=agg.run_dir)


def supervised_phase(outputs_dir: str, card: str) -> dict:
    """Phase 18: supervised runs (module docstring)."""
    import numpy as np

    from dragg_tpu_torch.resilience.liveness import check_liveness
    from dragg_tpu_torch.resilience.runner import latest_checkpoint_timestep, run_dir_for

    out = {}
    report = check_liveness(120.0)
    check(report.alive and report.backend == "cuda" and card.split(",")[0] in report.detail,
          f"the CUDA probe: {report}")
    out["probe"] = report._asdict()
    log("probe: " + json.dumps(out["probe"]))

    # A healthy run: one attempt on the card, the results a card run's.
    cfg = community_config(SUPERVISED_HOMES, MAIN_HORIZON, end_after(SUPERVISED_STEPS),
                           bucketed="auto")
    cfg["simulation"]["checkpoint_interval"] = "hourly"
    run = supervised_cli(os.path.join(outputs_dir, "sup-healthy"), cfg, "", "auto")
    prov = run["prov"]
    check(prov["completed"] and prov["final_platform"] == "cuda"
          and [(a["platform"], a["ok"]) for a in prov["attempts"]] == [("cuda", True)]
          and prov["platform_transitions"] == [], f"healthy supervised run: {prov}")
    child = prov["attempts"][0]["progress"]["launches"]
    check(child["banded_cholesky_t"] > 0 and child["refined_banded_solve_t"] > 0,
          f"the supervised child launched {child}")
    with open(os.path.join(run_dir_for(cfg, run["outputs"]), "baseline", "results.json")) as f:
        got = json.load(f)
    want = card_run(os.path.join(outputs_dir, "sup-ref"), cfg)
    same_results(got, want["results"], "supervised run vs in-process card run")
    check(child == want["launches"], f"the child's launches {child}, in-process "
                                     f"{want['launches']}")
    out["healthy"] = dict(homes=SUPERVISED_HOMES, steps=SUPERVISED_STEPS, seconds=run["seconds"],
                          attempts=prov["attempts"], launches=child,
                          bit_equal_to_in_process_run=True)
    log("supervised healthy run: " + json.dumps(out["healthy"]))

    # A card lost at the third chunk: the run resumes on the CPU.
    cfg = community_config(LOSS_HOMES, 4, end_after(SUPERVISED_STEPS), bucketed="true")
    cfg["simulation"]["checkpoint_interval"] = "hourly"
    run = supervised_cli(os.path.join(outputs_dir, "sup-loss"), cfg,
                         "probe_live,sigkill@sim_chunk:3:once", "auto")
    prov = run["prov"]
    check(prov["completed"] and prov["final_platform"] == "cpu"
          and [(a["platform"], a.get("failure"), a["rc"]) for a in prov["attempts"]]
          == [("cuda", "CHILD_CRASH", -9), ("cpu", None, 0)], f"device loss: {prov}")
    check(prov["platform_transitions"] == [{"from": "cuda", "to": "cpu",
                                            "resumed_from_timestep": 1,
                                            "failure": "CHILD_CRASH"}],
          f"device loss: transitions {prov['platform_transitions']}")
    run_dir = run_dir_for(cfg, run["outputs"])
    check(latest_checkpoint_timestep(run_dir) is None, "device loss: the checkpoint remains")
    with open(os.path.join(run_dir, "baseline", "results.json")) as f:
        got = json.load(f)
    want = card_run(os.path.join(outputs_dir, "sup-loss-ref"), cfg)["results"]
    check(list(got) == list(want), "device loss: the homes differ from the card run's")
    worst = 0.0
    for name, series in want.items():
        if name == "Summary":
            continue
        check(got[name]["correct_solve"] == series["correct_solve"],
              f"device loss: {name}'s solved flags differ from the card run's")
        for key, v in series.items():
            if isinstance(v, list):
                check(len(got[name][key]) == len(v), f"device loss: {name}.{key} length")
                worst = max(worst, float(np.max(np.abs(np.asarray(got[name][key])
                                                       - np.asarray(v)), initial=0.0)))
    check(worst <= ENGINE_CPU_CUDA_ATOL, f"device loss: series {worst} from the card run's")
    out["device_loss"] = dict(homes=LOSS_HOMES, steps=SUPERVISED_STEPS, seconds=run["seconds"],
                              attempts=prov["attempts"],
                              transitions=prov["platform_transitions"],
                              max_abs_difference_to_card_run=worst)
    log("supervised device loss: " + json.dumps(out["device_loss"]))

    # No card: --platform cuda does not complete on the CPU (the probe and
    # its one retry, a second apart, both down).
    cfg["resilience"].update(retries=1, backoff_s=1.0)
    run = supervised_cli(os.path.join(outputs_dir, "sup-down"), cfg, "probe_down:5", "cuda")
    prov = run["prov"]
    check(not prov["completed"] and "final_platform" not in prov
          and [a.get("skipped") for a in prov["attempts"]] == ["probe_down"],
          f"--platform cuda without a card: {prov}")
    out["no_device"] = dict(seconds=run["seconds"], attempts=prov["attempts"])
    log("supervised, no card, --platform cuda: " + json.dumps(out["no_device"]))
    return out


# --------------------------------------------------- sharding (phase 19)
SHARD_STEPS = 4            # hourly chunks of legs a and b
SHARDING_HOMES = 2_500     # legs a and b (10,000 before a cut for time)
SHARD_RESUME_HOMES = 2_500
SHARD_RESUME_STEPS = 2     # hourly chunks of leg c, stopped after 1
SHARD_SHORT_HOMES = 1_000
SHARD_SHORT_STEPS = 2      # leg d: ReLU-QP and the ADMM
SHARD_ATOL = 1e-2          # two ranks against one (tests/test_parallel.py:83-91)
SHARD_MIN_RATE = 0.99
SHARD_TIMEOUT_S = 600
# One rank of a two-rank run sharing the card: joins the group from the
# $DRAGG_* variables, then runs each job of a JSON list through
# Aggregator(...).run() on cuda:0 in its own outputs directory, recording
# its launches (counted from zero just before each run), seconds, solver
# iterations (the world's, reduced) and factorizations, its own check
# windows and IPM phase-1 iterations (this process's, before any
# reduction), resolved routes and files; after a job
# with "kernels", holds the band kernels against their plain versions at
# its block shapes (launches made after the run's count was read).  The
# World's collectives are timed (seconds inside them, the wait for the
# other rank included; the host pipeline's thread too) and counted.
RANK_PROGRAM = """
import json, os, sys, time
import torch
from dragg_tpu_torch import parallel
from dragg_tpu_torch.parallel.world import World
world = parallel.init_from_env()
waits = [0.0, 0]
def timed(fn):
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            waits[0] += time.perf_counter() - t0
            waits[1] += 1
    return wrapper
for name in ("all_reduce", "all_gather", "gather", "broadcast", "barrier"):
    setattr(World, name, timed(getattr(World, name)))
from dragg_tpu_torch.aggregator import Aggregator
from dragg_tpu_torch.bench_band import band_fixture
from dragg_tpu_torch import telemetry
from dragg_tpu_torch.ops import admm, band_kernels as bk, iter_kernels as ik
from dragg_tpu_torch.ops.ipm import band_plan
jobs, out_path = json.load(open(sys.argv[1])), sys.argv[2]
records = []
for job in jobs:
    out = os.path.join(job["outputs"], f"rank{world.rank}")
    agg = Aggregator(job["config"], outputs_dir=out, device="cuda:0")
    agg.stop_after_chunks = job.get("stop")
    bk.reset_launches(); ik.reset_launches(); admm.reset_factorizations()
    waits[:] = [0.0, 0]
    torch.cuda.synchronize(); t0 = time.perf_counter()
    with telemetry.recording() as recorded:
        agg.run()
    torch.cuda.synchronize(); seconds = time.perf_counter() - t0
    eng = agg.engine
    rec = dict(job=job["name"], rank=world.rank, size=world.size, device=str(agg.device),
               seconds=seconds, s_per_step=agg._phase_times["device_chunks"] / max(1, agg.timestep),
               launches={**bk.LAUNCHES, **ik.LAUNCHES}, factorizations=dict(admm.FACTORIZATIONS),
               check_windows=admm.CHECK_WINDOWS["windows"],
               phase1_iterations=sum(r["attrs"]["iterations"] for r in recorded.records
                                     if r["name"] == "ipm.phase1_s"),
               solver_iterations=agg._solve_iters, timestep=agg.timestep,
               resumed_from=agg.resumed_from, iter_kernel=eng.iter_kernel,
               engine=type(eng).__name__, n_homes=eng.n_homes, n_local=eng.n_local,
               run_dir=agg.run_dir, collective_s=waits[0], collectives=waits[1],
               files=sorted(f for _, _, fs in os.walk(out) for f in fs))
    if job.get("kernels"):
        shapes, ok = [], True
        for i, c in enumerate(eng._buckets):
            m, bw, B = c.lay.m_eq, band_plan(c.static.pattern).bw, c.n
            St, r = band_fixture(m, bw, B, seed=1000 * world.rank + i)
            L, Lp = bk.banded_cholesky_t(St, bw), bk.cholesky_t_plain(St, bw)
            ok &= torch.equal(L, Lp)
            for refine in (0, 1):
                ok &= torch.equal(bk.refined_banded_solve_t(L, St, r, bw, refine),
                                  bk.refined_solve_t_plain(Lp, St, r, bw, refine))
                Lf, xf = bk.factor_refined_solve_t(St, r, bw, refine)
                ok &= torch.equal(Lf, Lp) and torch.equal(
                    xf, bk.refined_solve_t_plain(Lp, St, r, bw, refine))
            shapes.append([c.name, m, bw, B])
        torch.cuda.synchronize()
        rec.update(kernel_shapes=shapes, kernels_bit_equal=bool(ok))
    records.append(rec)
    del agg, eng
    torch.cuda.empty_cache()
json.dump(records, open(out_path, "w"))
parallel.shutdown()
"""


def rank_pair(outputs_dir: str, jobs: list) -> list:
    """Two ranks of one gloo group on the one card (``cuda:0`` each), as
    two processes of :data:`RANK_PROGRAM`, each with a timeout: their
    records, one list a rank.  A rank that fails fails the phase."""
    import socket

    os.makedirs(outputs_dir, exist_ok=True)
    spec = os.path.join(outputs_dir, "jobs.json")
    with open(spec, "w") as f:
        json.dump(jobs, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for r in range(2):
        env = dict(os.environ, DRAGG_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   DRAGG_NUM_PROCESSES="2", DRAGG_PROCESS_ID=str(r),
                   PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_PROGRAM, spec, os.path.join(outputs_dir, f"rank{r}.json")],
            env=env, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=SHARD_TIMEOUT_S)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out) in enumerate(outs):
        check(rc == 0, f"sharded rank {r} exited {rc}:\n{out[-4000:]}")
    records = []
    for r in range(2):
        with open(os.path.join(outputs_dir, f"rank{r}.json")) as f:
            records.append({rec["job"]: rec for rec in json.load(f)})
    return records


def shard_cfg(n_homes: int, steps: int, solver: str = "ipm", **tpu) -> dict:
    cfg = community_config(n_homes, MAIN_HORIZON, end_after(steps), bucketed="auto", **tpu)
    cfg["home"]["hems"]["solver"] = solver
    cfg["simulation"]["checkpoint_interval"] = "hourly"
    return cfg


def sharding_phase(outputs_dir: str) -> dict:
    """Phase 19: sharding over torch.distributed (module docstring)."""
    import numpy as np

    from dragg_tpu_torch.__main__ import main as cli
    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.parallel import current_world

    out = {}
    cfg = shard_cfg(SHARDING_HOMES, SHARD_STEPS)

    # a. A world of one through the run entry, against an unsharded run.
    ref = card_run(os.path.join(outputs_dir, "shard-one-ref"), cfg)
    path = write_config(os.path.join(outputs_dir, "shard-one.toml"), cfg)
    seen = []
    clear = Aggregator.clear_checkpoint

    def recording_clear(self):
        # The files of the last checkpoint, before the finished run drops it.
        d = self._latest_checkpoint_dir()
        seen.extend(sorted(os.listdir(d)) if d else [])
        clear(self)

    env = {"DRAGG_DISTRIBUTED": "1", "DRAGG_NUM_PROCESSES": "1", "DRAGG_PROCESS_ID": "0"}
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        env["DRAGG_COORDINATOR_ADDRESS"] = f"127.0.0.1:{s.getsockname()[1]}"
    os.environ.update(env)
    Aggregator.clear_checkpoint = recording_clear
    reset_launches()
    t0 = time.perf_counter()
    try:
        rc = cli(["run", "--config", path, "--outputs-dir",
                  os.path.join(outputs_dir, "shard-one"), "--device", "cuda"])
    finally:
        Aggregator.clear_checkpoint = clear
        for k in env:
            os.environ.pop(k)
    one_s = time.perf_counter() - t0
    launches = launch_counts()
    check(rc == 0 and current_world().size == 1 and current_world().group is None,
          f"run entry, world of one: rc {rc}, world {current_world()}")
    with open(os.path.join(outputs_dir, "shard-one", os.path.relpath(
            ref["run_dir"], os.path.join(outputs_dir, "shard-one-ref")),
            "baseline", "results.json")) as f:
        one = json.load(f)
    same_results(one, ref["results"], "world of one vs unsharded run")
    check(launches == ref["launches"], f"world of one launched {launches}, unsharded "
                                       f"{ref['launches']}")
    check("state.proc00000-of-00001.npz" in seen and "state.npz" not in seen,
          f"world of one: its last checkpoint held {seen}")
    step_s = lambda res: res["Summary"]["phase_times"]["device_chunks"] / SHARD_STEPS  # noqa: E731
    out["world_of_one"] = dict(homes=SHARDING_HOMES, steps=SHARD_STEPS, seconds=one_s,
                               s_per_step=step_s(one),
                               unsharded_s_per_step=step_s(ref["results"]),
                               launches=launches, checkpoint_files=seen,
                               bit_equal_to_unsharded=True)
    log("sharding, world of one: " + json.dumps(out["world_of_one"]))

    # b-d. Two ranks sharing the card, one process pair for every job.
    resume_cfg = shard_cfg(SHARD_RESUME_HOMES, SHARD_RESUME_STEPS)
    jobs = [
        dict(name="b", config=cfg, outputs=os.path.join(outputs_dir, "shard-b"), kernels=True),
        dict(name="c_full", config=resume_cfg, outputs=os.path.join(outputs_dir, "shard-c-full")),
        dict(name="c_stop", config=resume_cfg, outputs=os.path.join(outputs_dir, "shard-c"),
             stop=1),
        dict(name="c_resume", config={**resume_cfg, "simulation": {
            **resume_cfg["simulation"], "resume": True}},
             outputs=os.path.join(outputs_dir, "shard-c")),
        dict(name="d_reluqp", config=shard_cfg(SHARD_SHORT_HOMES, SHARD_SHORT_STEPS, "reluqp",
                                               iter_kernel="pallas"),
             outputs=os.path.join(outputs_dir, "shard-d-reluqp")),
        dict(name="d_admm", config=shard_cfg(SHARD_SHORT_HOMES, SHARD_SHORT_STEPS, "admm"),
             outputs=os.path.join(outputs_dir, "shard-d-admm")),
    ]
    t0 = time.perf_counter()
    ranks = rank_pair(os.path.join(outputs_dir, "shard-ranks"), jobs)
    pair_s = time.perf_counter() - t0

    def results_of(rec) -> dict | None:
        p = os.path.join(rec["run_dir"], "baseline", "results.json")
        if not os.path.isfile(p):
            return None
        with open(p) as f:
            return json.load(f)

    b0, b1 = ranks[0]["b"], ranks[1]["b"]
    check(b0["engine"] == b1["engine"] == "ShardedEngine" and b0["device"] == "cuda:0"
          and b0["n_local"] == b1["n_local"] == SHARDING_HOMES // 2,
          f"two ranks: {[(r['engine'], r['device'], r['n_local']) for r in (b0, b1)]}")
    check(results_of(b1) is None, "rank 1 wrote results.json")
    two = results_of(b0)
    check(b0["solver_iterations"] == b1["solver_iterations"],
          f"ranks report other iterations: {b0['solver_iterations']}, {b1['solver_iterations']}")
    # Each rank's own count, before any reduction: the ranks ran the same
    # phase-1 iterations.
    check(b0["phase1_iterations"] == b1["phase1_iterations"] > 0,
          f"ranks ran other phase-1 iterations: {b0['phase1_iterations']}, "
          f"{b1['phase1_iterations']}")
    summary, solved = check_results(two, SHARD_STEPS, SHARDING_HOMES)
    check(summary["solver_iterations"] == b0["solver_iterations"], "Summary's iterations")
    worst = 0.0
    for name, series in ref["results"].items():
        if name == "Summary":
            continue
        for key, v in series.items():
            if isinstance(v, list):
                worst = max(worst, float(np.max(np.abs(np.asarray(two[name][key])
                                                       - np.asarray(v)), initial=0.0)))
    rate = float(np.mean(solved))
    check(worst <= SHARD_ATOL, f"two ranks: series {worst} from the world of one")
    check(rate >= SHARD_MIN_RATE, f"two ranks: solve rate {rate}")
    for rec in (b0, b1):
        ln = rec["launches"]
        check(ln["banded_cholesky_t"] > 0 and ln["refined_banded_solve_t"] > 0
              and ln["factor_refined_solve_t"] == 0 and ln[WINDOW] == 0,
              f"rank {rec['rank']} launched {ln}")
        check(rec["kernels_bit_equal"], f"rank {rec['rank']}: band kernels differ from "
                                        f"their plain versions at {rec['kernel_shapes']}")
    out["two_ranks"] = dict(
        homes=SHARDING_HOMES, steps=SHARD_STEPS, solve_rate=rate, max_abs_difference_to_one=worst,
        iterations=b0["solver_iterations"], pair_s=pair_s,
        ranks=[{k: rec[k] for k in ("rank", "launches", "s_per_step", "seconds", "n_local",
                                    "phase1_iterations",
                                    "collective_s", "collectives", "kernel_shapes",
                                    "kernels_bit_equal")} for rec in (b0, b1)])
    log("sharding, two ranks on one card: " + json.dumps(out["two_ranks"]))

    # c. Stopped after one chunk and resumed: bit-equal, each rank's own shard.
    full, resumed = results_of(ranks[0]["c_full"]), results_of(ranks[0]["c_resume"])
    same_results(resumed, full, "two ranks resumed vs uninterrupted")
    for r in range(2):
        stop, res = ranks[r]["c_stop"], ranks[r]["c_resume"]
        mine = f"state.proc{r:05d}-of-00002.npz"
        other = f"state.proc{1 - r:05d}-of-00002.npz"
        check(stop["timestep"] == 1 and mine in stop["files"] and other not in stop["files"],
              f"rank {r}'s checkpoint files: {stop['files']}")
        check(("progress.json" in stop["files"]) == (r == 0),
              f"rank {r}'s progress.json: {stop['files']}")
        check(res["resumed_from"] is not None and res["resumed_from"].endswith("ckpt_t00000001"),
              f"rank {r} resumed from {res['resumed_from']}")
    out["resume"] = dict(homes=SHARD_RESUME_HOMES, steps=SHARD_RESUME_STEPS, bit_equal=True,
                         files={r: ranks[r]["c_stop"]["files"] for r in range(2)})
    log("sharding, two-rank resume: " + json.dumps(out["resume"]))

    # d. ReLU-QP and the ADMM: the same stop windows and factorizations.
    short = {}
    for job in ("d_reluqp", "d_admm"):
        r0, r1 = ranks[0][job], ranks[1][job]
        check(r0["solver_iterations"] == r1["solver_iterations"],
              f"{job}: ranks stopped at other windows: {r0['solver_iterations']}, "
              f"{r1['solver_iterations']}")
        check(r0["factorizations"] == r1["factorizations"],
              f"{job}: factorizations {r0['factorizations']}, {r1['factorizations']}")
        # Each rank's own count of check windows read, before any reduction.
        check(r0["check_windows"] == r1["check_windows"] > 0,
              f"{job}: ranks read other check windows: {r0['check_windows']}, "
              f"{r1['check_windows']}")
        check(r0["launches"][WINDOW] == r1["launches"][WINDOW] == 0,
              f"{job}: the window kernel ran on two ranks: {r0['launches']}")
        res = results_of(r0)
        summary, solved = check_results(res, SHARD_SHORT_STEPS, SHARD_SHORT_HOMES)
        short[job] = dict(iter_kernel=r0["iter_kernel"], iterations=r0["solver_iterations"],
                          factorizations=r0["factorizations"],
                          check_windows=[r0["check_windows"], r1["check_windows"]],
                          solve_rate=float(np.mean(solved)),
                          s_per_step=[r0["s_per_step"], r1["s_per_step"]],
                          launches=[r0["launches"], r1["launches"]])
    check(short["d_reluqp"]["iter_kernel"] == "lax",
          f"iter_kernel 'pallas' resolved to {short['d_reluqp']['iter_kernel']} on two ranks")
    out["short"] = short
    log("sharding, ReLU-QP and ADMM on two ranks: " + json.dumps(short))
    out["launches_per_rank"] = [b0["launches"], b1["launches"]]
    return out


# ---------------------------------------------------- serving (phase 20)
SERVE_FLEET_HOMES = 2_500    # the fleet lane: 4 community slots of 2,500 homes
SERVE_FLEET_C = 4
SERVE_SMALL_HOMES = 8        # legs f and g
SERVE_RPS = (0.0, 0.05)      # leg b's reward prices on the default lane
SERVE_FLEET_RPS = (0.0, 0.02, 0.05, -0.01)   # one a fleet slot
SERVE_FLEET_GROUPS = (5, 5, 5, 1)            # requests a price: the 4th slot fills last
SERVE_STREAM_STEPS = 4
SERVE_TIMEOUT_S = 300        # any one wait of the phase
SERVE_FIELDS = ("p_grid", "temp_in", "temp_wh", "e_batt", "hvac_cool_on", "hvac_heat_on",
                "wh_heat_on", "cost", "correct_solve")


def serve_lane_config(n_homes: int, **serve) -> dict:
    """The served community (the legacy mix, H = 24, hourly) with the
    phase's daemon settings: ephemeral port, short ticks and backoff, and
    deadlines past any wait of the phase."""
    cfg = community_config(n_homes, MAIN_HORIZON, end_after(24))
    cfg["serve"].update(port=0, poll_s=0.02, backoff_s=0.2, request_retries=3,
                        request_deadline_s=float(SERVE_TIMEOUT_S),
                        batch_deadline_s=float(SERVE_TIMEOUT_S),
                        worker_stall_s=float(SERVE_TIMEOUT_S), **serve)
    return cfg


class ServeProc:
    """``python -m dragg_tpu_torch serve --platform cuda --port 0`` in a
    subprocess (the CLI's ``main`` in a fresh interpreter, which then says
    whether it imported torch), driven over HTTP; its journal, events and
    ready reports read from its serve directory."""

    def __init__(self, outputs_dir: str, name: str, cfg: dict, faults: str = "",
                 serve_dir: str | None = None):
        self.name = name
        self.dir = os.path.join(outputs_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.serve_dir = serve_dir or os.path.join(self.dir, "serve")
        self.config_path = write_config(os.path.join(self.dir, "config.toml"), cfg)
        env = dict(os.environ, DRAGG_FAULT_INJECT=faults, DRAGG_FAULT_STATE=self.dir)
        env.pop("DRAGG_TELEMETRY_DIR", None)
        self.err_path = os.path.join(self.dir, "daemon.err")
        self.base = None
        self.stopped = False
        self.started = time.perf_counter()
        with open(self.err_path, "wb") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", SUPERVISED_WRAPPER, "serve", "--platform", "cuda",
                 "--port", "0", "--serve-dir", self.serve_dir, "--config", self.config_path],
                stdout=subprocess.PIPE, stderr=err, text=True, env=env,
                cwd=os.path.dirname(os.path.abspath(__file__)), start_new_session=True)

    def tail(self) -> str:
        with open(self.err_path, errors="replace") as f:
            return f.read()[-3000:]

    def until(self, cond, what: str):
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        while True:
            got = cond()
            if got:
                return got
            check(self.proc.poll() is None, f"serve {self.name}: the daemon exited "
                                            f"{self.proc.returncode} waiting for {what}: "
                                            f"{self.tail()}")
            check(time.monotonic() < deadline, f"serve {self.name}: no {what} in "
                                               f"{SERVE_TIMEOUT_S} s: {self.tail()}")
            time.sleep(0.05)

    def url(self) -> str:
        def bound():
            with open(self.err_path, errors="replace") as f:
                for line in f:
                    if "serving on http://" in line:
                        self.base = line.split("serving on ")[1].split()[0]
            return self.base

        return self.base or self.until(bound, "HTTP surface")

    def call(self, method: str, path: str, body=None) -> tuple[int, dict]:
        from dragg_tpu_torch.serve.loadgen import http_call

        return http_call(method, self.url() + path, body, timeout=120)

    def post(self, reqs) -> None:
        code, body = self.call("POST", "/solve", reqs)
        check(code == 202, f"serve {self.name}: POST answered {code}: {body}")

    def wait(self, ids) -> dict:
        """Every id's terminal /result body; each must be done."""
        out = {}

        def answered():
            for rid in ids:
                if rid not in out:
                    _, body = self.call("GET", f"/result?id={rid}")
                    if body.get("status") in ("done", "failed"):
                        out[rid] = body
            return len(out) == len(ids)

        self.until(answered, f"answers to {len(ids)} requests")
        bad = {rid: b for rid, b in out.items() if b["status"] != "done"}
        check(not bad, f"serve {self.name}: requests failed: {bad}")
        return out

    def stop(self, drained: bool = True) -> float:
        """SIGTERM: the daemon drains and exits 0 (1: work left in the
        journal) without having imported torch; returns the seconds."""
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        out, _ = self.proc.communicate(timeout=SERVE_TIMEOUT_S)
        self.stopped = True
        lines = out.strip().splitlines()
        check(bool(lines), f"serve {self.name}: no exit line: {self.tail()}")
        tail = json.loads(lines[-1])
        check(tail == {"rc": 0 if drained else 1, "parent_torch": False},
              f"serve {self.name}: exit {tail} (drained {drained}): {self.tail()}")
        return time.perf_counter() - t0

    def kill(self) -> None:
        """The failure path: the daemon, its probes (its process group) and
        every worker it launched (each in a session of its own)."""
        if self.stopped:
            return
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except OSError:
            pass
        self.proc.wait()
        for e in self.events("serve.worker.launch"):
            try:
                os.killpg(e["pid"], signal.SIGKILL)
            except OSError:
                pass
        self.stopped = True

    def events(self, name: str | None = None) -> list[dict]:
        out = []
        try:
            with open(os.path.join(self.serve_dir, "events.jsonl")) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if name is None or rec.get("event") == name:
                        out.append(rec)
        except OSError:
            pass
        return out

    def journal(self) -> list[dict]:
        with open(os.path.join(self.serve_dir, "journal.jsonl")) as f:
            return [json.loads(line) for line in f if line.strip()]

    def ready_reports(self) -> list[dict]:
        import glob

        out = []
        for p in glob.glob(os.path.join(self.serve_dir, "spool", "w*", "ready-*.json")):
            with open(p) as f:
                out.append(json.load(f))
        return sorted(out, key=lambda r: (r["slot"], r["gen"]))


def served_batches(daemon: ServeProc, outcomes: dict) -> dict:
    """batch -> {t, steps, groups} as the daemon served it: each answered
    request (its accepted record, as the worker got it) in the group of
    its community slot."""
    accepted = {r["id"]: r["req"] for r in daemon.journal() if r["state"] == "accepted"}
    batches: dict = {}
    for rid, body in outcomes.items():
        resp, req = body["response"], accepted[rid]
        t, steps = int(req.get("t") or 0), int(req.get("steps") or 1)
        b = batches.setdefault(resp["batch"], {"t": t, "steps": steps, "groups": {}})
        check((b["t"], b["steps"]) == (t, steps), f"batch {resp['batch']} mixes timesteps")
        rp = float(req.get("rp") or 0.0)
        g = b["groups"].setdefault(resp["cslot"], {"cslot": resp["cslot"], "rp": rp,
                                                   "requests": []})
        check(g["rp"] == rp, f"batch {resp['batch']}: slot {resp['cslot']} mixes prices")
        g["requests"].append(req)
    return batches


def batch_launches(beats: list[dict]) -> dict:
    """batch -> the kernel launches its worker made serving it, from a
    serve directory's ``heartbeat.beat`` events: the worker's batch-done
    beat's counts less those of its previous beat (the ready beat follows
    the warm-up's first execution)."""
    last, out = {}, {}
    for e in beats:
        prog = e.get("progress") or {}
        if "launches" not in prog:
            continue
        if prog["stage"] == "serve:batch_done" and e["pid"] in last:
            out[prog["batch"]] = {k: v - last[e["pid"]][k] for k, v in prog["launches"].items()}
        last[e["pid"]] = prog["launches"]
    return out


def replay_in_process(runner, batches: dict, outcomes: dict, what: str) -> dict:
    """Solve every served batch's groups with the in-process runner on the
    card and hold each served answer equal to it; batch -> its launches
    here (counted from zero around the solve)."""
    launches = {}
    for seq, b in sorted(batches.items()):
        reset_launches()
        want = runner.solve(b["t"], list(b["groups"].values()), steps=b["steps"])
        launches[seq] = launch_counts()
        for rid, w in want.items():
            got = {k: v for k, v in outcomes[rid]["response"].items() if k in w}
            check(got == w, f"{what}: {rid} (batch {seq}) served {got}, in-process {w}")
    return launches


def latency(daemon: ServeProc, ids) -> dict:
    """p50 / p99 / max seconds from accept to answer (the daemon's
    serve.request and serve.done events)."""
    import numpy as np

    t_req = {e["id"]: e["mono"] for e in daemon.events("serve.request")}
    lat = [e["mono"] - t_req[e["id"]] for e in daemon.events("serve.done")
           if e["id"] in ids and e["id"] in t_req]
    check(len(lat) == len(ids), f"serve {daemon.name}: {len(lat)} latencies of {len(ids)}")
    return dict(n=len(lat), p50_s=float(np.percentile(lat, 50)),
                p99_s=float(np.percentile(lat, 99)), max_s=float(max(lat)))


def restart_leg(outputs_dir: str, cfg: dict, result: dict, daemons: list) -> None:
    """Leg g, on a thread: a daemon SIGTERMed with one batch hung in its
    worker (``hang@serve_batch:2:once``) and one request queued drains
    what it can and exits 1; a daemon restarted on the same serve
    directory replays both and answers duplicates from the journal."""
    try:
        g1 = ServeProc(outputs_dir, "serve-restart", cfg, faults="hang@serve_batch:2:once")
        daemons.append(g1)
        reqs = [{"id": f"g{t}", "t": t, "home": t + 1,
                 **({"state": {"temp_in": 19.0}} if t == 1 else {})} for t in range(3)]
        g1.post(reqs)
        first = g1.wait(["g0"])
        g1.until(lambda: g1.call("GET", "/healthz")[1].get("assigned") == 1, "the hung batch")
        result["drain_s"] = g1.stop(drained=False)
        g2 = ServeProc(outputs_dir, "serve-restart-2", cfg, serve_dir=g1.serve_dir)
        daemons.append(g2)
        got = g2.wait(["g1", "g2"])
        for rid, want in (("g0", first["g0"]), ("g1", got["g1"])):
            code, body = g2.call("POST", "/solve", {"id": rid})
            check(code == 200 and body == want, f"restart: duplicate {rid} answered {code} "
                                                f"{body}, not {want}")
        replays = g2.events("serve.replay")
        check([e["requeued"] for e in replays] == [2], f"restart: replays {replays}")
        result["stop_s"] = g2.stop()
        recs = g2.journal()
        for state in ("accepted", "done"):
            ids = sorted(r["id"] for r in recs if r["state"] == state)
            check(ids == ["g0", "g1", "g2"], f"restart: {state} records for {ids}")
        result.update(reqs=reqs, outcomes={**first, **got}, daemon=g2,
                      replayed=replays[0]["requeued"])
    except BaseException as e:  # re-raised on the main thread
        result["error"] = e


def serving_phase(outputs_dir: str) -> dict:
    """Phase 20: serving on the card (module docstring)."""
    import threading

    import numpy as np
    import torch

    from dragg_tpu_torch.config import load_config
    from dragg_tpu_torch.serve import patterns
    from dragg_tpu_torch.serve.daemon import serve_config
    from dragg_tpu_torch.serve.loadgen import journal_anomalies
    from dragg_tpu_torch.serve.worker import EngineRunner
    from dragg_tpu_torch.telemetry.compile_obs import STAGES

    t_phase = time.perf_counter()
    fleet_mix = community_config(SERVE_FLEET_HOMES, MAIN_HORIZON, end_after(24))["community"]
    fleet_spec = {"name": "fleet", "fleet_slots": SERVE_FLEET_C,
                  "homes": {"total": SERVE_FLEET_HOMES, "pv": fleet_mix["homes_pv"],
                            "battery": fleet_mix["homes_battery"],
                            "pv_battery": fleet_mix["homes_pv_battery"]}}
    # The fleet lane's 16 requests must land in one batch: the coalescing
    # window holds the first three slots' groups until the fourth fills.
    main_cfg = serve_lane_config(N_HOMES, batch_window_ms=2000.0, patterns=[fleet_spec])
    main_cfg["telemetry"]["trace"] = True   # phase 23's trace_view reads its tree
    small_cfg = serve_lane_config(SERVE_SMALL_HOMES, drain_s=0.5)
    out, daemons, g_result = {}, [], {}
    g_thread = None
    try:
        a = ServeProc(outputs_dir, "serve-main", main_cfg, faults="sigkill@serve_batch:1:once")
        f = ServeProc(outputs_dir, "serve-degrade", small_cfg,
                      faults="probe_live:1,probe_down:99,sigkill@serve_batch:1:once")
        daemons += [a, f]
        g_thread = threading.Thread(target=restart_leg,
                                    args=(outputs_dir, small_cfg, g_result, daemons))
        g_thread.start()
        f_reqs = [{"id": f"f{i}", "t": i % 2, "home": i,
                   **({"state": {"temp_in": 18.0 + i}} if i % 3 == 0 else {})}
                  for i in range(SERVE_SMALL_HOMES)]
        f.post(f_reqs)

        # The direct run: the port's EngineRunner in this process on the
        # card, on the lane configs as the daemons load them.
        def lane_runner(path: str, spec: dict):
            cfg = load_config(path)
            return EngineRunner(patterns.lane_config(
                cfg, patterns.normalize_spec(spec, serve_config(cfg))), "cuda")

        t0 = time.perf_counter()
        ref_default = lane_runner(a.config_path, {})
        ref_fleet = lane_runner(a.config_path, fleet_spec)
        ref_small = lane_runner(f.config_path, {})
        out["in_process_build_s"] = time.perf_counter() - t0
        check(ref_default.compile_report["cache"] == "hit", "the in-process runner built "
                                                            "the kernel library anew")

        # a. Both workers warm on the card from phase 2's library.
        a.until(lambda: sorted(a.call("GET", "/healthz")[1].get("workers_ready") or [])
                == [0, 1], "two warm workers")
        out["ready_s"] = time.perf_counter() - a.started
        for r in a.ready_reports():
            check(r["platform"] == "cuda" and tuple(r["compile"]["stages"]) == STAGES
                  and r["compile"]["cache"] == "hit",
                  f"worker w{r['slot']} gen {r['gen']}: {r}")
        check([(r["n_homes"], r["fleet_slots"]) for r in a.ready_reports()]
              == [(N_HOMES, 1), (SERVE_FLEET_HOMES, SERVE_FLEET_C)],
              f"lane geometry {a.ready_reports()}")

        # b, e. The default lane: 24 requests at t = 0 and 1 over two
        # prices; the first batch's worker is SIGKILLed before it solves.
        default_reqs = []
        for t in (0, 1):
            for rp in SERVE_RPS:
                for _ in range(6):
                    i = len(default_reqs)
                    req = {"id": f"d{i:02d}", "t": t, "home": (i * 1237 + 11) % N_HOMES,
                           "rp": rp}
                    if i % 4 == 0:
                        req["state"] = {"temp_in": 18.0 + i % 5}
                    elif i % 4 == 1:
                        req["state"] = {"temp_wh": 45.0, "e_batt": 1.0}
                    default_reqs.append(req)
        a.post(default_reqs)
        got = a.wait([r["id"] for r in default_reqs])
        check(max(b["response"]["retries"] for b in got.values()) >= 1,
              "no request was retried after the killed batch")
        # b. The fleet lane: 16 requests over four prices, one batch.
        fleet_reqs = []
        for rp, n in zip(SERVE_FLEET_RPS, SERVE_FLEET_GROUPS):
            for _ in range(n):
                j = len(fleet_reqs)
                req = {"id": f"c{j:02d}", "t": 0, "home": (j * 331 + 7) % SERVE_FLEET_HOMES,
                       "rp": rp, "pattern": "fleet"}
                if j % 3 == 0:
                    req["state"] = {"temp_in": 19.0 + j % 4}
                fleet_reqs.append(req)
        a.post(fleet_reqs)
        got_fleet = a.wait([r["id"] for r in fleet_reqs])
        check(len({b["response"]["batch"] for b in got_fleet.values()}) == 1
              and sorted({b["response"]["cslot"] for b in got_fleet.values()})
              == list(range(SERVE_FLEET_C)),
              f"the fleet lane's requests: {[b['response'] for b in got_fleet.values()]}")
        # d. Streaming: steps = 4, one chunk line a step, then the record.
        import urllib.request

        a.post({"id": "s0", "t": 2, "home": 4321 % N_HOMES, "steps": SERVE_STREAM_STEPS,
                "state": {"temp_in": 21.0}})
        t0 = time.perf_counter()
        with urllib.request.urlopen(a.url() + "/result?id=s0&stream=1",
                                    timeout=SERVE_TIMEOUT_S) as r:
            lines = [json.loads(ln) for ln in r.read().decode().splitlines()]
        stream_s = time.perf_counter() - t0
        chunks = [ln for ln in lines if ln.get("kind") == "chunk"]
        final = lines[-1]
        check([(c["step"], c["timestep"]) for c in chunks]
              == [(k, 2 + k) for k in range(SERVE_STREAM_STEPS)]
              and final.get("kind") == "result" and final.get("status") == "done"
              and final["response"]["steps"] == SERVE_STREAM_STEPS
              and all(final["response"][k] == chunks[-1][k] for k in SERVE_FIELDS),
              f"the stream: {lines}")
        got_stream = {"s0": {k: v for k, v in final.items() if k != "kind"}}

        # b. Every served answer equals the direct run of its batch, and
        # the worker launched what the direct run launched.
        default_out = {**got, **got_stream}
        default_batches = served_batches(a, default_out)
        here = replay_in_process(ref_default, default_batches, default_out, "default lane")
        here.update(replay_in_process(ref_fleet, served_batches(a, got_fleet), got_fleet,
                                      "fleet lane"))
        served = batch_launches(a.events("heartbeat.beat"))
        check(sorted(served) == sorted(here) and all(served[b] == here[b] for b in here),
              f"served batches' launches {served}, in-process {here}")
        for seq, ln in served.items():
            check(ln["banded_cholesky_t"] > 0 and ln["refined_banded_solve_t"] > 0,
                  f"batch {seq} launched {ln}")
        one_step = [here[b] for b, v in default_batches.items() if v["steps"] == 1]
        # c. Slot invariance: each fleet group alone at the next slot.
        slot_worst, slot_equal = 0.0, True
        for b in served_batches(a, got_fleet).values():
            for g in b["groups"].values():
                moved = ref_fleet.solve(b["t"], [dict(g, cslot=(g["cslot"] + 1) % SERVE_FLEET_C)])
                for rid, w in moved.items():
                    resp = got_fleet[rid]["response"]
                    check(resp["correct_solve"] == w["correct_solve"],
                          f"slot invariance: {rid}'s verdict moved with its slot")
                    diff = max(abs(resp[k] - w[k]) for k in SERVE_FIELDS)
                    slot_worst = max(slot_worst, diff)
                    slot_equal &= all(resp[k] == w[k] for k in SERVE_FIELDS)
        check(slot_worst <= ENGINE_CPU_CUDA_ATOL, f"slot invariance: {slot_worst}")

        # e. The killed worker: CHILD_CRASH, relaunched on the card from
        # the library (hit), its batch answered once, no journal anomaly.
        ids = [r["id"] for r in default_reqs + fleet_reqs] + ["s0"]
        failures = [(e["slot"], e["gen"], e["failure"]) for e in a.events("serve.worker.exit")]
        check(failures == [(0, 1, "CHILD_CRASH")], f"worker deaths {failures}")
        gens = [(r["slot"], r["gen"], r["platform"], r["compile"]["cache"])
                for r in a.ready_reports()]
        check((0, 2, "cuda", "hit") in gens, f"the relaunched worker: {gens}")
        check(journal_anomalies(os.path.join(a.serve_dir, "journal.jsonl"), ids) == [],
              "journal anomalies after the kill")
        done = sorted(r["id"] for r in a.journal() if r["state"] == "done")
        check(done == sorted(ids), "not every request answered exactly once")
        lat = {"default": latency(a, [r["id"] for r in default_reqs]),
               "default_unretried": latency(a, [rid for rid, b in got.items()
                                                if b["response"]["retries"] == 0]),
               "fleet": latency(a, [r["id"] for r in fleet_reqs])}
        elapsed = {}
        for e in a.events("serve.done"):
            elapsed.setdefault(e["batch"], e.get("elapsed_s"))
        batches = [dict(batch=e["batch"], lane=e["pattern"], groups=e["groups"], n=e["n"],
                        steps=e["steps"], elapsed_s=elapsed.get(e["batch"]),
                        launches=served.get(e["batch"]))
                   for e in a.events("serve.assign")]
        workers = [dict(slot=r["slot"], gen=r["gen"], platform=r["platform"],
                        warmup_s=r["warmup_s"], stages=r["compile"]["stages"],
                        cache=r["compile"]["cache"]) for r in a.ready_reports()]
        a.stop()
        totals = {k: sum(ln[k] for ln in served.values()) for k in next(iter(served.values()))}
        out["main"] = dict(
            homes=N_HOMES, fleet_lane=[SERVE_FLEET_C, SERVE_FLEET_HOMES],
            requests=len(ids), workers=workers, latency=lat, batches=batches,
            stream=dict(steps=SERVE_STREAM_STEPS, seconds=stream_s),
            launches_per_served_step=dict(
                banded_cholesky_t=sorted({ln["banded_cholesky_t"] for ln in one_step}),
                refined_banded_solve_t=sorted({ln["refined_banded_solve_t"]
                                               for ln in one_step})),
            served_equal_in_process=True, slot_invariance=dict(
                bit_equal=bool(slot_equal), max_abs_difference=slot_worst),
            kill=dict(failures=failures, generations=gens, anomalies=[]))
        out["launches"] = totals
        log("serving workers (warmup_s, stages): " + json.dumps(workers))
        log("serving latency per lane: " + json.dumps(lat))
        log("serving batches (elapsed_s, groups, launches): " + json.dumps(batches))
        log("serving: band launches a served step " +
            json.dumps(out["main"]["launches_per_served_step"]) + "; slot invariance "
            + json.dumps(out["main"]["slot_invariance"]))

        # f. Degradation: the card lost at the first batch with the probe
        # held down; the next generation runs on the CPU.
        f_ids = [r["id"] for r in f_reqs]
        got_f = f.wait(f_ids)
        prov = {"from": "cuda", "to": "cpu", "failure": "CHILD_CRASH"}
        for rid, body in got_f.items():
            check(body["response"]["platform"] == "cpu"
                  and body["response"].get("degraded") == prov,
                  f"degradation: {rid} answered {body['response']}")
        trans = [{k: r[k] for k in ("from", "to", "failure")} for r in f.journal()
                 if r["state"] == "transition"]
        check(trans == [prov], f"degradation: journaled transitions {trans}")
        check([(e["from_platform"], e["to_platform"]) for e in
               f.events("degrade.transition")] == [("cuda", "cpu")],
              "degradation: the degrade.transition event")
        launched = [(e["gen"], e["platform"]) for e in f.events("serve.worker.launch")]
        f_ready = [(r["gen"], r["platform"], r["compile"]["cache"]) for r in f.ready_reports()]
        check(launched == [(1, "cuda"), (2, "cpu")]
              and f_ready == [(1, "cuda", "hit"), (2, "cpu", "unknown")],
              f"degradation: launches {launched}, ready {f_ready}")
        worst = 0.0
        for b in served_batches(f, got_f).values():
            for rid, w in ref_small.solve(b["t"], list(b["groups"].values())).items():
                resp = got_f[rid]["response"]
                check(resp["correct_solve"] == w["correct_solve"],
                      f"degradation: {rid}'s verdict on the CPU differs from the card's")
                worst = max(worst, max(abs(resp[k] - w[k]) for k in SERVE_FIELDS))
        check(worst <= ENGINE_CPU_CUDA_ATOL,
              f"degradation: the CPU's answers {worst} from the card's")
        f.stop()
        out["degradation"] = dict(homes=SERVE_SMALL_HOMES, requests=len(f_ids),
                                  provenance=prov, workers=launched, ready=f_ready,
                                  max_abs_difference_to_card=worst)
        log("serving, degradation to the CPU: " + json.dumps(out["degradation"]))

        # g. The restart leg's thread; its answers equal the direct run.
        g_thread.join(timeout=3 * SERVE_TIMEOUT_S)
        check(not g_thread.is_alive(), "the restart leg did not finish")
        if "error" in g_result:
            raise g_result["error"]
        g_got = g_result["outcomes"]
        for req in g_result["reqs"]:
            want = ref_small.solve(req["t"], [{"cslot": 0, "rp": 0.0, "requests": [
                dict(req, rp=0.0)]}])[req["id"]]
            got_g = {k: v for k, v in g_got[req["id"]]["response"].items() if k in want}
            check(got_g == want, f"restart: {req['id']} served {got_g}, in-process {want}")
        out["restart"] = dict(homes=SERVE_SMALL_HOMES, replayed=g_result["replayed"],
                              drain_s=g_result["drain_s"], stop_s=g_result["stop_s"],
                              duplicates_answered_from_journal=["g0", "g1"])
        log("serving, restart: " + json.dumps(out["restart"]))
    finally:
        # Every daemon this phase started, and their workers: those of the
        # restart leg too, which may start one more until its thread ends.
        for d in list(daemons):
            d.kill()
        if g_thread is not None:
            g_thread.join(timeout=SERVE_TIMEOUT_S)
        for d in list(daemons):
            d.kill()
    del ref_default, ref_fleet, ref_small
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"serving phase: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------- shard coordinator
SHARD_C = 4                 # communities: phase 13's fleet shape, without the pack
SHARD_C_HOMES = 2_500       # homes a community (legs a-c)
SHARD_RUN_STEPS = 4         # hourly steps of every leg
SHARD_CHUNK = 2             # shard.chunk_steps
SHARD_DEGRADE_HOMES = 8     # leg d's communities
SHARD_RESHARD_HOMES = 100   # leg e's communities
SHARD_RUN_TIMEOUT_S = 600
SHARD_SERIES = {"p_grid_opt": "agg_load", "cost_opt": "agg_cost", "correct_solve": "solved"}
SHARD_MIN_RATE = 0.99
SHARD_CLI_WRAPPER = ("import json, sys\n"
                     "from dragg_tpu_torch.shard.__main__ import main\n"
                     "rc = main(sys.argv[1:])\n"
                     "print(json.dumps({'rc': rc, 'parent_torch': 'torch' in sys.modules}))\n")


def shard_fleet_config(homes: int, **shard) -> dict:
    """The legacy mix, ``SHARD_C`` communities of ``homes`` homes, H = 24,
    hourly, ``SHARD_RUN_STEPS`` steps from 2015-01-01 00, the IPM on the
    split band route; ``shard`` overrides ``[shard]`` keys."""
    cfg = community_config(homes, MAIN_HORIZON, end_after(SHARD_RUN_STEPS), bucketed="auto")
    cfg["fleet"]["communities"] = SHARD_C
    cfg["shard"].update(shard)
    return cfg


def traced(cfg: dict) -> dict:
    """``cfg`` with ``telemetry.trace`` on (phase 23's trace_view reads the
    run's tree)."""
    cfg["telemetry"]["trace"] = True
    return cfg


def shard_events(path: str, name: str | None = None) -> list[dict]:
    out = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if name is None or rec.get("event") == name:
                    out.append(rec)
    except OSError:
        pass
    return out


def shard_journal(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "shard_journal.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def shard_workers(run_dir: str) -> list[dict]:
    """Per shard and generation: its platform, ready seconds (process start
    to the ready file), device seconds per chunk (the chunk files it
    wrote), and its kernel launches (its last beat's counts, from its
    telemetry sub-stream, and that beat's timestep)."""
    import glob

    out = []
    for sdir in sorted(glob.glob(os.path.join(run_dir, "spool", "s*"))):
        k = int(os.path.basename(sdir)[1:])
        chunks = {}
        for p in glob.glob(os.path.join(sdir, "outbox", "chunk-*.json")):
            with open(p) as f:
                c = json.load(f)
            chunks.setdefault(c["gen"], []).append((c["seq"], c["device_s"], c["platform"]))
        beats = {}
        for e in shard_events(os.path.join(run_dir, f"shard{k}", "events.jsonl"),
                              "heartbeat.beat"):
            prog = e.get("progress") or {}
            if "launches" in prog:
                beats[e["pid"]] = (prog.get("timestep"), prog["launches"])
        pids = [e["pid"] for e in shard_events(os.path.join(run_dir, "events.jsonl"),
                                               "shard.launch") if e["shard"] == k]
        for p in sorted(glob.glob(os.path.join(sdir, "ready-*.json"))):
            with open(p) as f:
                r = json.load(f)
            gen = r["gen"]
            beat_t, launches = (beats.get(pids[gen - 1], (None, None)) if gen <= len(pids)
                                else (None, None))
            out.append(dict(shard=k, gen=gen, platform=r["platform"], ready_s=r["ready_s"],
                            t_resume=r["t_resume"],
                            device_s=[d for _, d, _ in sorted(chunks.get(gen, []))],
                            beat_t=beat_t, launches=launches))
    return out


def shard_cli(outputs_dir: str, name: str, cfg: dict, args: list, faults: str = "",
              run_dir: str | None = None, platform: str = "cuda") -> dict:
    """``python -m dragg_tpu_torch.shard --platform <platform>`` on ``cfg`` in a
    subprocess (its ``main`` under a wrapper that then says whether the
    parent imported torch) with ``$DRAGG_FAULT_INJECT`` = ``faults``, on
    ``run_dir`` (default: a new one): its merged result, run directory,
    seconds and workers.  It must exit 0; every worker it launched is
    killed when it does not return."""
    d = os.path.join(outputs_dir, name)
    os.makedirs(d, exist_ok=True)
    path = write_config(os.path.join(d, "config.toml"), cfg)
    run_dir = run_dir or os.path.join(d, "run")
    env = dict(os.environ, DRAGG_FAULT_INJECT=faults, DRAGG_FAULT_STATE=d)
    env.pop("DRAGG_TELEMETRY_DIR", None)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", SHARD_CLI_WRAPPER, "--config", path, "--run-dir", run_dir,
         "--steps", str(SHARD_RUN_STEPS), "--chunk", str(SHARD_CHUNK), "--platform",
         platform, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=here,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=SHARD_RUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            for e in shard_events(os.path.join(run_dir, "events.jsonl"), "shard.launch"):
                try:
                    os.killpg(e["pid"], signal.SIGKILL)
                except OSError:
                    pass
    seconds = time.perf_counter() - t0
    lines = out.strip().splitlines()
    check(proc.returncode == 0 and len(lines) >= 2
          and json.loads(lines[-1]) == {"rc": 0, "parent_torch": False},
          f"shard {name}: exit {proc.returncode}: {out[-1500:]}\n{err[-3000:]}")
    # Merge lag: a chunk file's write (its mtime) to the coordinator's
    # merge record; relaunch: a death's record to the next generation's
    # ready file (wall clocks of one host).
    events = shard_events(os.path.join(run_dir, "events.jsonl"))
    spool_dir = os.path.join(run_dir, "spool")
    lag = [e["t"] - os.stat(os.path.join(spool_dir, f"s{e['shard']}", "outbox",
                                         f"chunk-{e['seq']}.json")).st_mtime
           for e in events if e.get("event") == "shard.chunk"]
    relaunch = [os.stat(os.path.join(spool_dir, f"s{e['shard']}",
                                     f"ready-{e['gen'] + 1}.json")).st_mtime - e["t"]
                for e in events if e.get("event") == "shard.exit"]
    return dict(result=json.loads(lines[-2]), run_dir=run_dir, seconds=seconds,
                workers=shard_workers(run_dir), merge_lag_s=lag, relaunch_s=relaunch)


def series_diff(got: dict, want: dict) -> tuple[float, bool]:
    """(largest |difference|, bit-equal) of two merged series dicts."""
    import numpy as np

    check(sorted(got) == sorted(want), f"series names {sorted(got)} vs {sorted(want)}")
    worst = max(float(np.max(np.abs(np.asarray(got[k]) - np.asarray(want[k])))) for k in got)
    return worst, all(got[k] == want[k] for k in got)


def in_thread(fn, *args):
    """Start ``fn(*args)`` on a thread; the returned function joins it and
    returns its value or re-raises its exception on the caller's thread."""
    import threading

    box = {}

    def run():
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # re-raised by join
            box["error"] = e

    th = threading.Thread(target=run)
    th.start()

    def join():
        th.join(timeout=4 * SHARD_RUN_TIMEOUT_S)
        check(not th.is_alive(), f"{fn.__name__} did not finish")
        if "error" in box:
            raise box["error"]
        return box["value"]

    return join


def shard_degrade_leg(outputs_dir: str) -> dict:
    """Leg d: under ``--platform auto``, one shard's first generation exits at
    its build and the coordinator's probe then reports the card gone (the
    card itself stays up: the probe verdict is injected)."""
    cfg = shard_fleet_config(SHARD_DEGRADE_HOMES, degrade_after=1, restarts=3)
    t0 = time.perf_counter()
    card_join = in_thread(shard_cli, outputs_dir, "shard-d-card", cfg, ["--workers", "2"])
    deg = shard_cli(outputs_dir, "shard-d-degrade", cfg, ["--workers", "2"],
                    faults="exit@shard_build:1:once,probe_down", platform="auto")
    card = card_join()
    recs = shard_journal(deg["run_dir"])
    trans = [(r["shard"], r["from"], r["to"], r["failure"]) for r in recs
             if r["state"] == "transition"]
    check(len(trans) == 1 and trans[0][1:] == ("cuda", "cpu", "CHILD_CRASH"),
          f"degradation: transitions {trans}")
    k = trans[0][0]
    launches = [(r["shard"], r["gen"], r["platform"]) for r in recs if r["state"] == "launch"]
    check(sorted(launches) == sorted([(k, 1, "cuda"), (k, 2, "cpu"), (1 - k, 1, "cuda")]),
          f"degradation: launches {launches}")
    plat = {(w["shard"], w["gen"]): w["platform"] for w in deg["workers"]}
    check(plat == {(k, 2): "cpu", (1 - k, 1): "cuda"}, f"degradation: workers {plat}")
    worst, equal = series_diff(deg["result"]["series"], card["result"]["series"])
    check(worst <= ENGINE_CPU_CUDA_ATOL, f"degradation: {worst} from the card's run")
    out = dict(homes=SHARD_DEGRADE_HOMES, transitions=trans, launches=launches,
               max_abs_difference_to_card=worst, bit_equal_to_card=equal,
               solved_equal=deg["result"]["series"]["solved"]
               == card["result"]["series"]["solved"],
               relaunch_s=deg["relaunch_s"], workers=deg["workers"],
               seconds=time.perf_counter() - t0)
    log("shard, degradation: " + json.dumps(out))
    return out


def shard_reshard_leg(outputs_dir: str) -> dict:
    """Leg e: 2 workers stopped at t = 2, resharded to 4, resumed; beside
    an uninterrupted 2-worker run."""
    cfg = shard_fleet_config(SHARD_RESHARD_HOMES)
    t0 = time.perf_counter()
    whole_join = in_thread(shard_cli, outputs_dir, "shard-e-whole", cfg, ["--workers", "2"])
    part = shard_cli(outputs_dir, "shard-e-old", cfg,
                     ["--workers", "2", "--stop-t", str(SHARD_CHUNK)])
    check(part["result"]["stopped_early"] and part["result"]["steps"] == SHARD_CHUNK,
          f"reshard: the stopped run {part['result']['steps']}")
    new_dir = os.path.join(outputs_dir, "shard-e-new", "run")
    t1 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "dragg_tpu_torch.reshard_checkpoint",
                        "--run-dir", part["run_dir"], "--out-dir", new_dir, "--workers", "4"],
                       capture_output=True, text=True, timeout=SHARD_RUN_TIMEOUT_S,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    reshard_s = time.perf_counter() - t1
    check(p.returncode == 0, f"reshard: exit {p.returncode}: {p.stderr[-3000:]}")
    verdict = json.loads(p.stdout.strip().splitlines()[-1])
    check(verdict["ok"] and verdict["new_ranges"] == [[0, 1], [1, 2], [2, 3], [3, 4]]
          and all(verdict["validated_per_community"].values())
          and len(verdict["validated_per_community"]) == SHARD_C,
          f"reshard: {verdict}")
    resumed = shard_cli(outputs_dir, "shard-e-new", cfg, ["--workers", "4"], run_dir=new_dir)
    check(all(w["t_resume"] == SHARD_CHUNK for w in resumed["workers"]),
          f"reshard: resumed workers {resumed['workers']}")
    whole = whole_join()
    worst, equal = series_diff(resumed["result"]["series"], whole["result"]["series"])
    check(worst <= ENGINE_CPU_CUDA_ATOL, f"reshard: resumed {worst} from the whole run")
    out = dict(homes=SHARD_RESHARD_HOMES, verdicts=verdict["validated_per_community"],
               reshard_s=reshard_s, max_abs_difference_to_whole=worst,
               bit_equal_to_whole=equal, resumed_platforms=resumed["result"]["platforms"],
               workers=resumed["workers"], seconds=time.perf_counter() - t0)
    log("shard, reshard: " + json.dumps(out))
    return out


def shard_doctor_leg(outputs_dir: str) -> dict:
    """Leg f: the doctor, every self-test on, through the CLI."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", SUPERVISED_WRAPPER, "doctor",
                        "--compile-check", "--shard-check", "--telemetry",
                        "--outputs-dir", os.path.join(outputs_dir, "doctor")],
                       capture_output=True, text=True, timeout=SHARD_RUN_TIMEOUT_S,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = p.stdout.strip().splitlines()
    check(p.returncode == 0 and lines
          and json.loads(lines[-1]) == {"rc": 0, "parent_torch": False}
          and "[FAIL]" not in p.stdout,
          f"doctor: exit {p.returncode}: {p.stdout[-3000:]}\n{p.stderr[-2000:]}")
    rows = {}
    for ln in lines:
        if ln.startswith("  ") and "[" in ln:
            name, rest = ln.split(None, 1)
            detail = rest[rest.index("]") + 1:].strip()
            rows[name] = (rest[1:rest.index("]")].strip(), json.loads(detail) if detail else {})
    check(rows["backend"][1].get("backend") == "cuda", f"doctor: backend {rows['backend']}")
    kern = rows.get("cuda_kernels", ("missing", {}))
    check(kern[0] == "ok" and sorted(k for k, v in kern[1]["kernels"].items() if v)
          == sorted([*REPLACES, WINDOW]), f"doctor: cuda_kernels {kern}")
    check(rows["staged_compile"][1].get("cache") == "hit",
          f"doctor: staged_compile {rows['staged_compile']}")
    out = dict(rows={k: v[0] for k, v in rows.items()}, cuda_kernels=kern[1],
               staged=rows["staged_compile"][1], seconds=time.perf_counter() - t0)
    log("shard, doctor: " + json.dumps(out))
    return out


def shard_phase(outputs_dir: str) -> dict:
    """Phase 21: the shard coordinator on the card (module docstring)."""
    import numpy as np
    import torch

    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.shard.partition import fold_community_series

    t_phase = time.perf_counter()
    out = {}
    cfg = shard_fleet_config(SHARD_C_HOMES)
    # Leg a first, one coordinator at a time with nothing else on the card:
    # its workers' ready and device seconds are the layer's own.
    n1 = shard_cli(outputs_dir, "shard-a-n1", cfg, ["--workers", "1"])
    n2 = shard_cli(outputs_dir, "shard-a-n2", cfg, ["--workers", "2"])
    # Then every other leg at once: the coordinators of b-c in subprocesses
    # (their CLIs on threads), legs d-f on threads of their own, the
    # in-process reference here; the checks read them as they finish.
    legs = {name: in_thread(shard_cli, outputs_dir, name, c, ["--workers", "2"], faults)
            for name, c, faults in (
                ("shard-b-kill", cfg, "sigkill@shard_chunk:2:once"),
                ("shard-c-tcp", traced(shard_fleet_config(SHARD_C_HOMES, transport="tcp")),
                 ""))}
    light = {name: in_thread(fn, outputs_dir) for name, fn in (
        ("d_degrade", shard_degrade_leg), ("e_reshard", shard_reshard_leg),
        ("f_doctor", shard_doctor_leg))}
    try:
        # a. The in-process fleet, folded per community from results.json.
        t0 = time.perf_counter()
        agg = Aggregator(cfg, outputs_dir=os.path.join(outputs_dir, "shard-ref"),
                         device="cuda")
        agg.run()
        with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
            res = json.load(f)
        n = SHARD_C * SHARD_C_HOMES
        pairs = np.stack([np.arange(n) // SHARD_C_HOMES, np.arange(n)], axis=1)
        ref = {}
        for key, name in SHARD_SERIES.items():
            vals = np.array([res[h["name"]][key][:SHARD_RUN_STEPS] for h in agg.all_homes],
                            dtype=np.float64).T
            ref[name] = fold_community_series(vals, pairs, SHARD_C).tolist()
        del agg, res
        torch.cuda.empty_cache()
        out["in_process_s"] = time.perf_counter() - t0

        check(n1["result"]["series"] == ref,
              f"N = 1: merged series differ from the in-process fleet by "
              f"{series_diff(n1['result']['series'], ref)[0]}")
        worst, equal = series_diff(n2["result"]["series"], ref)
        check(worst <= ENGINE_CPU_CUDA_ATOL and n2["result"]["series"]["solved"] == ref["solved"],
              f"N = 2: {worst} from the in-process fleet, solved "
              f"{n2['result']['series']['solved']} vs {ref['solved']}")
        for run, what in ((n1, "N = 1"), (n2, "N = 2")):
            r = run["result"]
            check(r["ok"] and r["solve_rate"] >= SHARD_MIN_RATE and r["platforms"] == ["cuda"]
                  and r["restarts"] == {},
                  f"{what}: ok {r['ok']}, solve rate {r['solve_rate']}, platforms "
                  f"{r['platforms']}, restarts {r['restarts']}")
            for w in run["workers"]:
                ln = w["launches"] or {}
                check(w["platform"] == "cuda" and w["beat_t"] == SHARD_RUN_STEPS
                      and ln.get("banded_cholesky_t", 0) > 0
                      and ln.get("refined_banded_solve_t", 0) > 0,
                      f"{what}: worker {w}")
        out["a"] = dict(alone=True, homes=[SHARD_C, SHARD_C_HOMES], steps=SHARD_RUN_STEPS,
                        chunk=SHARD_CHUNK, n1_bit_equal=True,
                        n2_max_abs_difference=worst, n2_bit_equal=equal,
                        solve_rate=[n1["result"]["solve_rate"], n2["result"]["solve_rate"]],
                        seconds=[n1["seconds"], n2["seconds"]],
                        merge_lag_s=[n1["merge_lag_s"], n2["merge_lag_s"]],
                        workers={"n1": n1["workers"], "n2": n2["workers"]})
        log("shard, N = 1 and N = 2 (workers: ready_s, device_s a chunk, launches): "
            + json.dumps(out["a"]))

        # b. kill -9 at a shard's second chunk.
        kill = legs["shard-b-kill"]()
        recs = shard_journal(kill["run_dir"])
        relaunch = [(r["shard"], r["gen"], r["platform"]) for r in recs
                    if r["state"] == "launch" and r["gen"] > 1]
        exits = [(r["shard"], r["failure"]) for r in recs if r["state"] == "exit"]
        acked = {}
        for r in recs:
            if r["state"] == "chunk":
                acked.setdefault(r["shard"], set()).add(r["seq"])
        n_chunks = SHARD_RUN_STEPS // SHARD_CHUNK
        check(len(relaunch) == 1 and relaunch[0][1:] == (2, "cuda")
              and exits == [(relaunch[0][0], "CHILD_CRASH")]
              and sum(kill["result"]["restarts"].values()) == 1
              and acked == {0: set(range(n_chunks)), 1: set(range(n_chunks))},
              f"kill: relaunches {relaunch}, exits {exits}, acked {acked}")
        check(kill["result"]["series"] == n2["result"]["series"],
              f"kill: {series_diff(kill['result']['series'], n2['result']['series'])[0]} "
              f"from the uninterrupted N = 2 run")
        out["b_kill"] = dict(relaunch=relaunch, exits=exits, bit_equal=True,
                             seconds=kill["seconds"], relaunch_s=kill["relaunch_s"],
                             merge_lag_s=kill["merge_lag_s"], workers=kill["workers"])
        log("shard, kill -9: " + json.dumps(out["b_kill"]))

        # c. The TCP transport.
        tcp = legs["shard-c-tcp"]()
        acks = sorted((r["shard"], r["seq"]) for r in shard_journal(tcp["run_dir"])
                      if r["state"] == "chunk")
        check(tcp["result"]["series"] == n2["result"]["series"]
              and acks == [(k, s) for k in (0, 1) for s in range(n_chunks)],
              f"tcp: {series_diff(tcp['result']['series'], n2['result']['series'])[0]} from "
              f"N = 2, acks {acks}")
        out["c_tcp"] = dict(bit_equal=True, seconds=tcp["seconds"],
                            merge_lag_s=tcp["merge_lag_s"], workers=tcp["workers"])
        log("shard, tcp: " + json.dumps(out["c_tcp"]))
        out["launches"] = {k: [(w["launches"] or {}).get(k, 0) for w in n1["workers"]
                               + n2["workers"]] for k in (*REPLACES, WINDOW)}
    finally:
        # Every thread ends (and its error surfaces) before the phase does.
        done = {}
        for name, join in {**legs, **light}.items():
            try:
                value = join()
            except BaseException as e:
                done.setdefault("error", e)
            else:
                if name in light:
                    done[name] = value
    if "error" in done:
        raise done.pop("error")
    out.update(done)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"shard phase: {out['seconds']:.1f} s")
    return out


# ------------------------------------------- a phase in its own process
PHASE_PROGRAM = ("import json, sys\n"
                 "sys.path.insert(0, '.')\n"
                 "import chip_smoke\n"
                 "value = getattr(chip_smoke, sys.argv[1])(*json.loads(sys.argv[2]))\n"
                 "with open(sys.argv[3], 'w') as f:\n"
                 "    json.dump(value, f, default=str)\n")
PHASE_TIMEOUT_S = 1200


def phase_in_own_process(outputs_dir: str, name: str, *args):
    """Start ``<name>(outputs_dir, *args)`` of this script in a Python
    process of its own (JSON in, JSON out), beside whatever this process
    runs next.  Returns a function that waits for it, relays its log to
    this process's stdout and returns its value, or fails with its error;
    the process (its group) is killed when it does not end in time."""
    d = os.path.join(outputs_dir, f"own-{name}")
    os.makedirs(d, exist_ok=True)
    out_path, log_path, err_path = (os.path.join(d, n) for n in
                                    ("value.json", "stdout.txt", "stderr.txt"))
    with open(log_path, "wb") as out, open(err_path, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", PHASE_PROGRAM, name, json.dumps([outputs_dir, *args]),
             out_path], stdout=out, stderr=err,
            cwd=os.path.dirname(os.path.abspath(__file__)), start_new_session=True)

    def join():
        try:
            rc = proc.wait(timeout=PHASE_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        with open(log_path, errors="replace") as f:
            sys.stdout.write(f.read())
        sys.stdout.flush()
        with open(err_path, errors="replace") as f:
            err_text = f.read()
        failed = [ln for ln in err_text.splitlines() if ln.startswith("AssertionError")]
        check(rc == 0, f"{name} (its own process) exited {rc}: "
                       f"{failed[-1] if failed else err_text[-3000:]}")
        with open(out_path) as f:
            return json.load(f)

    return join


# ------------------------------------ serving tools and scale (phase 22)
# (a) the load ladder: 4 fleet slots × 2,500 homes (10,000 home slots a
# batch, phase 20's fleet lane), H = 24, the IPM on the split band route.
LOAD_ARGS = ["--homes", "2500", "--fleet-slots", "4", "--horizon-hours", "24",
             "--rates", "2,8,32", "--duration-s", "4"]
LOAD_LEVELS = 3
# (b) the soak's scenarios on real workers, at its default size (32 homes,
# H = 4, 48 requests), each in a soak of its own.
SOAK_SCENARIOS = ("child_crash", "kill9")
# (c) validate_scale at its own width: 10,000 homes, H = 48, the ADMM,
# the bench mix, one chunk of 4 steps.
SCALE_ARGS = ["--homes", "10000", "--horizon-hours", "48", "--steps", "4", "--chunk", "4"]
SCALE_BAND_TOL = 0.05         # validate_scale's band tolerance (no events)
SCALE_MIN_SOLVE_RATE = 0.97   # validate_scale's --min-solve-rate default
TOOL_TIMEOUT_S = 600


def tool_cli(outputs_dir: str, name: str, module: str, args: list) -> dict:
    """``python -m dragg_tpu_torch.<module> <args>`` (``python -m
    dragg_tpu_torch <args>`` for ``module`` "") in a subprocess; the serving
    tools' working directory is ``<outputs_dir>/<name>/run`` (their
    ``--root``).  Returns its exit code, last JSON line and count of JSON
    lines, stdout, stderr and seconds; on a timeout every
    process it launched (its group, its serve workers, its supervised
    child) is killed."""
    d = os.path.join(outputs_dir, name)
    os.makedirs(d, exist_ok=True)
    root = os.path.join(d, "run")
    if module in ("serve_load", "serve_soak"):
        args = [*args, "--root", root]
        # The tools put tpu.compile_cache_dir under their root, as the JAX
        # tools put their XLA cache: it holds phase 2's libraries, as a
        # deployment's shared directory would, so no worker compiles.
        lib_dir = os.path.join(root, "compile_cache")
        os.makedirs(lib_dir, exist_ok=True)
        cache_dir = os.environ["DRAGG_COMPILE_CACHE_DIR"]
        for so in os.listdir(cache_dir):
            if so.endswith(".so") and not os.path.exists(os.path.join(lib_dir, so)):
                os.symlink(os.path.join(cache_dir, so), os.path.join(lib_dir, so))
    env = dict(os.environ, DRAGG_FAULT_STATE=d)
    for var in ("DRAGG_FAULT_INJECT", "DRAGG_TELEMETRY_DIR"):
        env.pop(var, None)
    here = os.path.dirname(os.path.abspath(__file__))
    err_path = os.path.join(d, "stderr.txt")
    t0 = time.perf_counter()
    with open(err_path, "wb") as err:
        proc = subprocess.Popen([sys.executable, "-m",
                                 "dragg_tpu_torch" + (f".{module}" if module else ""), *args],
                                stdout=subprocess.PIPE, stderr=err, text=True, env=env,
                                cwd=here, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TOOL_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            import glob

            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            pids = [e["pid"] for p in glob.glob(os.path.join(root, "**", "events.jsonl"),
                                                recursive=True)
                    for e in shard_events(p, "serve.worker.launch")]
            with open(err_path, errors="replace") as f:
                pids += [int(line.split("pid=")[1].split()[0]) for line in f
                         if line.startswith("[supervise] >>>")]
            for pid in pids:
                try:
                    os.killpg(pid, signal.SIGKILL)
                except OSError:
                    pass
    seconds = time.perf_counter() - t0
    with open(err_path, errors="replace") as f:
        err_text = f.read()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(bool(lines), f"{name}: exit {proc.returncode}, no JSON line: {out[-1500:]}\n"
                       f"{err_text[-3000:]}")
    return dict(rc=proc.returncode, result=json.loads(lines[-1]), stderr=err_text,
                seconds=seconds, root=root, n_lines=len(lines), stdout=out)


def load_leg(outputs_dir: str) -> dict:
    """Leg a: ``python -m dragg_tpu_torch.serve_load`` on real workers on
    the card, alone: ok, every level within the SLO, the journal clean,
    every answer from the card, the served batches' band kernels launched
    (the workers' beats)."""
    from dragg_tpu_torch.serve.loadgen import journal_anomalies

    run = tool_cli(outputs_dir, "tools-load", "serve_load", LOAD_ARGS)
    r = run["result"]
    check(run["rc"] == 0 and r["ok"] and r["violations"] == [] and r["platform"] == "cuda"
          and r["serve"] == "pool-C4x1w" and len(r["levels"]) == LOAD_LEVELS
          and all(lv["slo_ok"] for lv in r["levels"]),
          f"serve_load: exit {run['rc']}: {json.dumps(r)[:3000]}\n{run['stderr'][-3000:]}")
    with open(os.path.join(run["root"], "journal.jsonl")) as f:
        journal = [json.loads(line) for line in f if line.strip()]
    ids = {rec["id"] for rec in journal if "id" in rec}
    anomalies = journal_anomalies(os.path.join(run["root"], "journal.jsonl"), ids)
    platforms = {rec["response"]["platform"] for rec in journal if rec["state"] == "done"}
    check(anomalies == [] and platforms == {"cuda"} and len(ids) == r["requests"],
          f"serve_load: journal anomalies {anomalies}, answers from {platforms}, "
          f"{len(ids)} ids of {r['requests']}")
    served = batch_launches(shard_events(os.path.join(run["root"], "events.jsonl"),
                                         "heartbeat.beat"))
    launches = {k: sum(b.get(k, 0) for b in served.values()) for k in (*REPLACES, WINDOW)}
    check(launches["banded_cholesky_t"] > 0 and launches["refined_banded_solve_t"] > 0
          and launches["factor_refined_solve_t"] == 0 and launches[WINDOW] == 0,
          f"serve_load: the served batches did not run the split route's kernels alone: "
          f"{launches} over {len(served)} batches")
    levels = [{k: lv[k] for k in ("rate_rps", "offered", "done", "achieved_rps", "p50_s",
                                  "p99_s", "max_s", "batches", "occupancy_mean",
                                  "coalesced_mean", "phases")} for lv in r["levels"]]
    out = dict(alone=True, args=LOAD_ARGS, seconds=run["seconds"],
               saturation_rps=r["metrics"]["saturation_rps"],
               warmup_s=r["metrics"]["warmup_s"], levels=levels, batches=len(served),
               launches=launches,
               launches_per_batch={k: v / max(1, len(served)) for k, v in launches.items()})
    log("serve_load ladder (4 × 2,500 homes, H = 24, p50 / p99 s a level): "
        + json.dumps(out))
    return out


def soak_leg(outputs_dir: str, scenario: str) -> dict:
    """One ``python -m dragg_tpu_torch.serve_soak --scenario <scenario>`` on
    real workers on the card: every invariant, a classified CHILD_CRASH
    that struck a batch in flight (a request answered on a retry), the
    replacement worker ready on the card, its library not a ``miss``."""
    run = tool_cli(outputs_dir, f"tools-soak-{scenario}", "serve_soak",
                   ["--scenario", scenario])
    r = run["result"]
    rep = r.get("scenarios", {}).get(scenario, {})
    check(run["rc"] == 0 and r["ok"] and r["violations"] == [] and not r["stub"],
          f"serve_soak {scenario}: exit {run['rc']}: {json.dumps(r)[:3000]}\n"
          f"{run['stderr'][-3000:]}")
    sdir = os.path.join(run["root"], scenario)
    ready = shard_events(os.path.join(sdir, "events.jsonl"), "serve.worker.ready")
    with open(os.path.join(sdir, "journal.jsonl")) as f:
        done = [json.loads(line)["response"] for line in f
                if line.strip() and json.loads(line)["state"] == "done"]
    check("CHILD_CRASH" in rep["events"]["failures"]
          and rep.get("restart_cache") not in (None, "miss")
          and any(e["gen"] > 1 and e["platform"] == "cuda" for e in ready)
          and max(d["retries"] or 0 for d in done) >= 1
          and {d["platform"] for d in done} == {"cuda"},
          f"serve_soak {scenario}: failures {rep['events']['failures']}, restart cache "
          f"{rep.get('restart_cache')}, ready {ready}, retries "
          f"{sorted({d['retries'] for d in done})}, platforms {({d['platform'] for d in done})}")
    out = dict(seconds=run["seconds"], elapsed_s=rep["elapsed_s"],
               cold_ready_s=rep.get("cold_ready_s"), recovery_s=rep.get("recovery_s"),
               restart_warmup_s=rep.get("restart_warmup_s"),
               restart_cache=rep.get("restart_cache"), sustained_rps=rep.get("sustained_rps"),
               failures=rep["events"]["failures"],
               retried=sum(1 for d in done if d["retries"]))
    log(f"serve_soak {scenario} (32 homes, H = 4, 48 requests): " + json.dumps(out))
    return out


def scale_leg(outputs_dir: str) -> dict:
    """Leg c: ``python -m dragg_tpu_torch.validate_scale`` at its own width
    on the card: ok (finite outputs, the band tolerance, the tool's solve
    rate), each bucket's ADMM backend and the card's peak memory."""
    run = tool_cli(outputs_dir, "tools-scale", "validate_scale", SCALE_ARGS)
    r = run["result"]
    check(run["rc"] == 0 and r["ok"] and r["platform"] == "cuda" and r["homes"] == 10_000
          and r["horizon_h"] == 48 and r["steps"] == 4
          and r["solve_rate"] >= SCALE_MIN_SOLVE_RATE
          and r["comfort_violation_max"] <= SCALE_BAND_TOL,
          f"validate_scale: exit {run['rc']}: {json.dumps(r)}\n{run['stderr'][-3000:]}")
    backends = peak = None
    for line in run["stderr"].splitlines():
        if line.startswith("[validate_scale] admm backends: "):
            backends = line.split(": ", 1)[1]
        elif line.startswith("[validate_scale] peak_rss_gb="):
            peak = float(line.split("peak_device_gb=")[1])
    check(backends is not None and peak is not None,
          f"validate_scale: no backend or peak-memory line: {run['stderr'][-3000:]}")
    out = dict(seconds=run["seconds"], s_per_step=1.0 / r["timesteps_per_s"],
               home_steps_per_s=r["home_steps_per_s"], total_s=r["total_s"],
               solve_rate=r["solve_rate"], comfort_violation_max=r["comfort_violation_max"],
               home_slots=r["home_slots"], bucket_patterns=r["bucket_patterns"],
               admm_backends=backends, peak_device_gb=peak, peak_rss_gb=r["peak_rss_gb"],
               device_kind=r["device_kind"])
    log("validate_scale (10,000 homes, H = 48, ADMM, 4 steps): " + json.dumps(out))
    return out


def serving_tools_background(outputs_dir: str) -> dict:
    """Phase 22's legs b and c, started on threads (their tools in
    subprocesses), at once: the two soak scenarios and the scale check.
    ``main`` starts them beside phase 13, whose host-bound runs hold one
    core of the eight; :func:`serving_tools_phase` joins them."""
    legs = {f"b_{s}": in_thread(soak_leg, outputs_dir, s) for s in SOAK_SCENARIOS}
    legs["c_scale"] = in_thread(scale_leg, outputs_dir)
    return legs


def serving_tools_phase(outputs_dir: str, legs: dict) -> dict:
    """Phase 22: the serving load and soak tools and the scale check on the
    card (module docstring).  ``legs`` are legs b and c, started by
    :func:`serving_tools_background`."""
    t_phase = time.perf_counter()
    out, errors = {}, []
    for name, join in legs.items():
        try:
            out[name] = join()
        except BaseException as e:
            errors.append(e)
    if errors:
        raise errors[0]
    # Leg a after b and c have ended, alone: its latencies are the serving
    # layer's own.
    out["a_load"] = load_leg(outputs_dir)
    out["launches"] = out["a_load"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"serving tools phase (leg a and the join of b-c): {out['seconds']:.1f} s")
    return out


# ----------------------------------- the bench harness and tools (phase 23)
# (a) the default bench's community, cut to 2 chunks of 8 steps.
BENCH_ARGS = ["bench", "--platform", "cuda", "--homes", "10000", "--solver", "ipm",
              "--steps", "8", "--chunks", "2"]
BENCH_PHASES = {"assemble", "solve", "merge_collect", "solve_pv_battery", "solve_pv_only",
                "solve_battery_only", "solve_base"}
BENCH_MIN_SOLVE_RATE = 0.99
BENCH_HBM_UTIL_MAX = 1.05   # the byte model is a floor estimate, not a count
# (b) run_measured in this process, and the phase composition.
BENCH_INPROC_HOMES = 2_500
# (c) the sharded bench: 2 workers, 2 communities of 1,000 homes.
BENCH_SHARD_ARGS = ["bench", "--shards", "2", "--homes", "1000", "--communities", "2",
                    "--platform", "cuda", "--steps", "2", "--chunks", "2"]
# (d) the forensics at its default: 10,000 homes × 24 steps (H = 24, the IPM).
FORENSICS_ARGS: list = []
# (f) the traced runs: phase 20's main daemon and phase 21's TCP leg.
TRACED_DIRS = (("serve-main", "serve"), ("shard-c-tcp", "run"))


def bench_cli_leg(outputs_dir: str, kind: str) -> dict:
    """Leg a: ``python -m dragg_tpu_torch bench --platform cuda`` at 10,000
    homes: one line, from the card, no fallback or error, the solve rate,
    every phase timer, the H100's basis and a byte share within the card's
    rate, the timed chunks through the split band route's kernels."""
    from dragg_tpu_torch.bench import GPU_BASIS, H100_SXM

    run = tool_cli(outputs_dir, "bench-a", "", BENCH_ARGS)
    r = run["result"]
    phases = r.get("phase_s_per_step") or {}
    launches = r.get("kernel_launches") or {}
    basis = GPU_BASIS if H100_SXM in kind.lower() else None
    check(run["rc"] == 0 and run["n_lines"] == 1 and r.get("platform") == "cuda"
          and "fallback" not in r and "error" not in r and r["device_kind"] == kind
          and r["solve_rate"] >= BENCH_MIN_SOLVE_RATE and BENCH_PHASES <= set(phases)
          and r["mfu_basis"] == basis and r["hbm_util"] is not None
          and 0 < r["hbm_util"] <= BENCH_HBM_UTIL_MAX,
          f"bench: exit {run['rc']}, {run['n_lines']} lines: {json.dumps(r)[:3000]}\n"
          f"{run['stderr'][-3000:]}")
    check(launches.get("banded_cholesky_t", 0) > 0 and launches.get("refined_banded_solve_t", 0) > 0
          and launches.get("factor_refined_solve_t") == 0 and launches.get(WINDOW) == 0,
          f"bench: the timed chunks did not run the split route's kernels alone: {launches}")
    out = dict(seconds=run["seconds"], line=r)
    log("bench (10,000 homes, H = 24, IPM, 2 × 8 steps): " + json.dumps(r))
    return out


def bench_inprocess_leg() -> dict:
    """Leg b: ``bench.run_measured`` in this process at 2,500 homes with the
    launch counts reset (it launches the split route's kernels), then, at
    10,000 homes, the phase functions composed against ``engine.step`` on
    the card bit for bit, from a state one step in, and the two orders'
    seconds a step and peak device memory (:func:`step_orders`)."""
    import numpy as np
    import torch

    from dragg_tpu_torch import bench

    args = bench.build_parser().parse_args(
        ["--_child", "--platform", "cuda", "--homes", str(BENCH_INPROC_HOMES),
         "--steps", "4", "--chunks", "1"])
    reset_launches()
    r = bench.run_measured(args)
    launches = launch_counts()
    check(r["platform"] == "cuda" and launches["banded_cholesky_t"] > 0
          and launches["refined_banded_solve_t"] > 0
          and launches["factor_refined_solve_t"] == 0 and launches[WINDOW] == 0
          and r["phase_s_per_step"] is not None,
          f"run_measured at {BENCH_INPROC_HOMES} homes: launches {launches}, "
          f"{json.dumps(r)[:2000]}")
    eng, _ = bench.build(N_HOMES, MAIN_HORIZON, 1000, solver="ipm", device="cuda")
    rp = np.zeros(MAIN_HORIZON, np.float32)
    state, _ = eng.step(eng.init_state(), 0, rp)
    prep, solve, fin = eng.phase_fns()
    qp, aux = prep(state, 1, rp)
    sol, _carry, warm, rf = solve(state, qp, eng.init_factor(), True)
    got_state, got = fin(state, 1, sol, aux, warm, rf)
    want_state, want = eng.step(state, 1, rp)
    differ = [f for f in want._fields if not torch.equal(getattr(got, f), getattr(want, f))]
    differ += [f"state.{f}" for g, w in zip(got_state, want_state) for f in w._fields
               if not torch.equal(getattr(g, f), getattr(w, f))]
    check(differ == [], f"phase_fns composed differ from engine.step on the card: {differ}")
    out = dict(launches=launches, value=r["value"], phases=r["phase_s_per_step"],
               composed_bit_equal=True, step_orders=step_orders(eng, state, rp))
    log(f"bench in process ({BENCH_INPROC_HOMES} homes; the composition at {N_HOMES}): "
        + json.dumps(out))
    return out


STEP_ORDER_STEPS = 2   # steps a run, t = 1 and 2 from the same state


def step_orders(eng, state, rp) -> dict:
    """``engine.step`` (prepare, solve, finish bucket by bucket) against
    the phase functions composed (each phase over every bucket, then the
    next), runs of ``STEP_ORDER_STEPS`` steps from ``state`` alternated
    step, composed, composed, step: each run's seconds a step (wall,
    synchronized) and peak device memory (allocated, from a reset)."""
    import torch

    prep, solve, fin = eng.phase_fns()

    def composed(st, t, rp):
        qp, aux = prep(st, t, rp)
        sol, _c, warm, rf = solve(st, qp, eng.init_factor(), True)
        return fin(st, t, sol, aux, warm, rf)

    runs = {"step": [], "composed": []}
    peaks = {"step": [], "composed": []}
    for name in ("step", "composed", "composed", "step"):
        fn = eng.step if name == "step" else composed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for t in range(1, 1 + STEP_ORDER_STEPS):
            fn(state, t, rp)
        torch.cuda.synchronize()
        runs[name].append((time.perf_counter() - t0) / STEP_ORDER_STEPS)
        peaks[name].append(torch.cuda.max_memory_allocated())
    return dict(homes=N_HOMES, steps=STEP_ORDER_STEPS, s_per_step=runs,
                peak_allocated_bytes=peaks)


def bench_shard_leg(outputs_dir: str) -> dict:
    """Leg c: ``bench --shards 2 --platform cuda``: one line, both workers
    on the card (``platform`` joins the set of the workers' platforms, as
    the JAX harness's does), no restart."""
    run = tool_cli(outputs_dir, "bench-c-shards", "", BENCH_SHARD_ARGS)
    r = run["result"]
    check(run["rc"] == 0 and run["n_lines"] == 1 and r["platform"] == "cuda"
          and r["shards"] == 2 and not any(r["restarts"].values()) and r["value"] > 0
          and r["solve_rate"] >= BENCH_MIN_SOLVE_RATE,
          f"bench --shards 2: exit {run['rc']}: {json.dumps(r)[:3000]}\n{run['stderr'][-3000:]}")
    log("bench --shards 2 (2 × 1,000 homes): " + json.dumps(r))
    return dict(seconds=run["seconds"], line=r)


def forensics_leg(outputs_dir: str) -> dict:
    """Leg d: ``fallback_forensics`` at its default (10,000 homes × 24
    steps) on the card: failed home-steps to classify, each one
    infeasible or under-converged under HiGHS, and HiGHS finds every
    sampled solved home feasible."""
    run = tool_cli(outputs_dir, "tools-forensics", "fallback_forensics", FORENSICS_ARGS)
    r = run["result"]
    check(run["rc"] == 0 and r["device"] == "cuda" and r["solved_but_highs_infeasible"] == 0
          and r["homes"] == N_HOMES and r["steps"] == MAIN_HORIZON
          and r["failed_home_steps"] > 0 and r["solved_cross_checked"] > 0
          and r["failed_home_steps"] == r["infeasible"] + r["under_converged"]
          and all(s["failed"] == s["infeasible"] + s["under_converged"] for s in r["per_step"]),
          f"fallback_forensics: exit {run['rc']}: {json.dumps(r)[:3000]}\n"
          f"{run['stderr'][-3000:]}")
    log("fallback_forensics (10,000 homes × 24 steps): " + json.dumps(r))
    return dict(seconds=run["seconds"], line=r)


def soak_tool_leg(outputs_dir: str) -> dict:
    """Leg e: ``python -m dragg_tpu_torch.soak --device cuda`` at its own
    size (128 homes, H = 12, DDPG, 3 days, stopped and resumed): every
    assertion, ``SOAK OK``."""
    d = os.path.join(outputs_dir, "tools-soak-rl")
    run = tool_cli(outputs_dir, "tools-soak-rl", "soak", [os.path.join(d, "out"),
                                                         "--device", "cuda"])
    r = run["result"]
    check(run["rc"] == 0 and run["stdout"].strip().endswith("SOAK OK") and r["device"] == "cuda"
          and r["steps"] == 72 and r["homes"] == 128,
          f"soak: exit {run['rc']}: {run['stdout'][-2000:]}\n{run['stderr'][-3000:]}")
    log("soak (rl_agg, DDPG, 128 homes, H = 12, 3 days): " + json.dumps(r))
    return dict(seconds=run["seconds"], line=r)


def trace_view_leg(outputs_dir: str) -> dict:
    """Leg f: ``trace_view --assert-complete`` over phase 20's main daemon
    and phase 21's TCP leg, both run with ``telemetry.trace`` on: every
    trace one rooted tree with no orphan span."""
    out = {}
    for name, sub in TRACED_DIRS:
        report_path = os.path.join(outputs_dir, name, "trace_report.json")
        proc = subprocess.run([sys.executable, "-m", "dragg_tpu_torch.trace_view",
                               os.path.join(outputs_dir, name, sub), "--assert-complete",
                               "--out", report_path],
                              capture_output=True, text=True, timeout=TOOL_TIMEOUT_S,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        check(proc.returncode == 0, f"trace_view {name}: exit {proc.returncode}: "
                                    f"{proc.stderr[-3000:]}\n{proc.stdout[-3000:]}")
        with open(report_path) as f:
            traces = json.load(f)["traces"]
        check(len(traces) > 0 and all(t["complete"] for t in traces.values()),
              f"trace_view {name}: {json.dumps(traces)[:3000]}")
        out[name] = dict(traces=len(traces), spans=sum(t["spans"] for t in traces.values()))
    log("trace_view --assert-complete: " + json.dumps(out))
    return out


def bench_tools_background(outputs_dir: str) -> dict:
    """Phase 23's legs c, d and e, started on threads (their tools in
    subprocesses) beside phase 13, joined by :func:`bench_tools_phase`."""
    return {"c_shards": in_thread(bench_shard_leg, outputs_dir),
            "d_forensics": in_thread(forensics_leg, outputs_dir),
            "e_soak": in_thread(soak_tool_leg, outputs_dir)}


def bench_tools_phase(outputs_dir: str, legs: dict, kind: str) -> dict:
    """Phase 23: the bench harness and the last tools on the card (module
    docstring).  ``legs`` are legs c, d and e, started by
    :func:`bench_tools_background` (c, d and e)."""
    t_phase = time.perf_counter()
    out, errors = {}, []
    for name, join in legs.items():
        try:
            out[name] = join()
        except BaseException as e:
            errors.append(e)
    if errors:
        raise errors[0]
    out["a_bench"] = bench_cli_leg(outputs_dir, kind)
    out["b_in_process"] = bench_inprocess_leg()
    out["f_trace_view"] = trace_view_leg(outputs_dir)
    out["launches"] = out["a_bench"]["line"]["kernel_launches"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"bench and tools phase (legs a, b, f and the join of c, d, e): "
        f"{out['seconds']:.1f} s")
    return out


# ------------------------ the image's build (phase 2) and deploy (phase 24)
DEPLOY_DIR = os.path.join("dragg_tpu_torch", "deploy")
DEPLOY_STEPS = 4          # phase 24: hourly steps of the 10,000-home run
DEPLOY_TIMEOUT_S = 600


def stand_in(bin_dir: str, name: str, body: str) -> None:
    """An executable ``bin_dir/name`` running the shell ``body``."""
    os.makedirs(bin_dir, exist_ok=True)
    path = os.path.join(bin_dir, name)
    with open(path, "w") as f:
        f.write("#!/bin/bash\n" + body)
    os.chmod(path, 0o755)


def image_build(cache_dir: str, bin_dir: str) -> dict:
    """Phase 2: the Dockerfile's kernel-build ``RUN`` line, as written there
    (``CUDA_VISIBLE_DEVICES=``, no card visible), in a subprocess with
    ``$DRAGG_COMPILE_CACHE_DIR`` the fresh ``cache_dir`` and ``python``
    this interpreter: its report, both libraries in ``cache_dir``, the
    kernel library compiled there, no card visible and torch not even
    imported."""
    with open(os.path.join(DEPLOY_DIR, "Dockerfile")) as f:
        runs = [ln.strip()[len("RUN "):] for ln in f
                if ln.startswith("RUN CUDA_VISIBLE_DEVICES= ")]
    check(len(runs) == 1, f"the Dockerfile's kernel-build RUN lines: {runs}")
    env = dict(os.environ, DRAGG_COMPILE_CACHE_DIR=cache_dir,
               PATH=bin_dir + os.pathsep + os.environ.get("PATH", ""))
    proc = subprocess.run(["bash", "-c", runs[0]], env=env, capture_output=True, text=True,
                          timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"the image's build ({runs[0]!r}): exit {proc.returncode}\n{proc.stderr[-4000:]}")
    rep = json.loads(lines[0])
    check(rep["directory"] == cache_dir and rep["built"] and rep["cuda_visible_devices"] == ""
          and not rep["torch_imported"]
          and os.path.dirname(rep["kernels"]) == cache_dir and os.path.isfile(rep["kernels"])
          and rep["host"] and os.path.dirname(rep["host"]) == cache_dir,
          f"the image's build: {rep}")
    return dict(rep, command=runs[0])


SRUN_STAND_IN = """# srun's stand-in: one task of one step on this host (no SLURM here).
export SLURM_JOB_ID={job} SLURM_STEP_NODELIST={host} SLURM_NTASKS=1 SLURM_PROCID=0 SLURM_LOCALID=0
exec "$@"
"""
NVCC_STAND_IN = """# Records every call, then runs the toolkit's nvcc.
echo "$*" >> {log}
exec {nvcc} "$@"
"""


def deploy_run(outputs_dir: str, bin_dir: str) -> dict:
    """Phase 24's run: ``dragg_tpu_torch/deploy/batch.sh`` under a stand-in
    ``srun`` (one task; ``$SLURM_STEP_NODELIST`` this host's name, the
    coordinator port derived from the job id) and a stand-in ``nvcc``
    that records its calls, on the 10,000-home community of the mix, H =
    24, DEPLOY_STEPS hourly steps.  Started beside phase 13; returns what
    :func:`deploy_phase` checks."""
    import socket

    from dragg_tpu_torch.ops import cuda_lib
    from dragg_tpu_torch.parallel import world

    d = os.path.join(outputs_dir, "deploy")
    run_bin = os.path.join(d, "bin")
    nvcc_log = os.path.join(d, "nvcc.log")
    host, job = socket.gethostname(), os.getpid()
    stand_in(run_bin, "srun", SRUN_STAND_IN.format(job=job, host=host))
    stand_in(run_bin, "nvcc", NVCC_STAND_IN.format(log=nvcc_log, nvcc=cuda_lib._nvcc()))
    cfg = community_config(N_HOMES, MAIN_HORIZON, end_after(DEPLOY_STEPS), bucketed="auto")
    path = write_config(os.path.join(d, "config.toml"), cfg)
    # No launcher's variable but the stand-in srun's reaches the run.
    launchers = {world.ENV_ADDRESS, world.ENV_NUM, world.ENV_ID, *world.TORCHRUN_VARS,
                 "MASTER_PORT", "LOCAL_RANK", world.OMPI_URI, *world.OMPI_VARS,
                 *world.SLURM_VARS, world.ENV_PORT}
    env = {k: v for k, v in os.environ.items() if k not in launchers}
    env["PATH"] = os.pathsep.join([run_bin, bin_dir, env.get("PATH", "")])
    out_path, err_path = os.path.join(d, "stdout.txt"), os.path.join(d, "stderr.txt")
    t_launch = time.time()
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(["bash", os.path.join(DEPLOY_DIR, "batch.sh"), "--config", path,
                                 "--outputs-dir", os.path.join(d, "out")],
                                stdout=out, stderr=err, env=env, start_new_session=True,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        rc = proc.wait(timeout=DEPLOY_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    seconds = time.time() - t_launch
    with open(err_path, errors="replace") as f:
        err_text = f.read()
    check(rc == 0, f"batch.sh under the stand-in srun: exit {rc}\n{err_text[-4000:]}")
    with open(nvcc_log) as f:
        nvcc_calls = [ln.strip() for ln in f if ln.strip()]
    return dict(cfg=cfg, rc=rc, seconds=seconds, t_launch=t_launch, host=host,
                port=job % 4096 + 61440, stderr=err_text, nvcc_calls=nvcc_calls,
                outputs=os.path.join(d, "out"))


def deploy_phase(outputs_dir: str, join, library: str) -> dict:
    """Phase 24 (module docstring): the run that :func:`deploy_run` started
    beside phase 13, checked, and held bit for bit against an in-process
    ``Aggregator(config, device="cuda").run()`` of the same config."""
    run = join()
    world_lines = [ln for ln in run["stderr"].splitlines() if ln.startswith("[run] ")]
    want = (f"[run] slurm: rank 0 of 1, local id 0, coordinator "
            f"{run['host']}:{run['port']}")
    check(world_lines == [want], f"the run's world: {world_lines}, wanted {want!r}")
    check(all(c == "--version" for c in run["nvcc_calls"]),
          f"the run started nvcc beyond --version: {run['nvcc_calls']}")
    results = [os.path.join(r, f) for r, _, fs in os.walk(run["outputs"]) for f in fs
               if f == "results.json"]
    check(len(results) == 1, f"the run's results.json files: {results}")
    with open(results[0]) as f:
        got = json.load(f)
    evs = events_of(os.path.dirname(os.path.dirname(results[0])))
    end = [e for e in evs if e["event"] == "run.end"]
    chunks = [e for e in evs if e["event"] == "chunk.done"]
    check(len(end) == 1 and end[0]["completed"] and chunks,
          f"the run's events: run.end {end}, {len(chunks)} chunk.done")
    launches, lib = end[0].get("kernel_launches") or {}, end[0].get("kernel_library") or {}
    check(lib.get("cache") == "hit" and lib.get("path") == library,
          f"the run's kernel library: {lib}, phase 2 built {library}")
    check(launches.get("banded_cholesky_t", 0) > 0 and launches.get("refined_banded_solve_t", 0) > 0
          and launches.get("factor_refined_solve_t") == 0 and launches.get(WINDOW) == 0,
          f"the run did not launch the split route's kernels alone: {launches}")
    # Ready: launch to the first chunk's start (its end less its seconds).
    ready_s = chunks[0]["t"] - chunks[0]["device_s"] - run["t_launch"]
    ref = card_run(os.path.join(outputs_dir, "deploy-ref"), run["cfg"])
    same_results(got, ref["results"], "batch.sh run vs in-process run")
    check(launches == ref["launches"], f"batch.sh run launched {launches}, in-process "
                                       f"{ref['launches']}")
    out = dict(homes=N_HOMES, steps=DEPLOY_STEPS, cluster="slurm", world=want,
               library=lib, nvcc_calls=run["nvcc_calls"], launches=launches,
               seconds=run["seconds"], ready_s=ready_s,
               s_per_step=got["Summary"]["phase_times"]["device_chunks"] / DEPLOY_STEPS,
               ref_s_per_step=ref["results"]["Summary"]["phase_times"]["device_chunks"]
               / DEPLOY_STEPS, bit_equal_to_in_process=True)
    log("deploy (batch.sh, stand-in srun, 10,000 homes, H = 24, beside phase 13): "
        + json.dumps(out))
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

    from dragg_tpu_torch.ops import cuda_lib

    # The kernel library's directory for the whole script, fresh and
    # outside the repo: phase 2 builds into it as the image does, and
    # every later phase and child loads from it.
    cache_dir = tempfile.mkdtemp(prefix="dragg-kernels-")
    bin_dir = tempfile.mkdtemp(prefix="dragg-chip-bin-")
    for d in (cache_dir, bin_dir):
        atexit.register(shutil.rmtree, d, True)
    os.environ["DRAGG_COMPILE_CACHE_DIR"] = cache_dir
    # "python" in a shell command (the Dockerfile's, batch.sh's) is this one.
    stand_in(bin_dir, "python", f'exec {sys.executable} "$@"\n')

    # Seconds of each phase, for the next slice's budget (the phases line).
    phases = {}

    def timed(phase: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phases[phase] = round(phases.get(phase, 0.0) + time.perf_counter() - t0, 1)
        return out

    t_start = time.perf_counter()
    # The build (the image's build step, its nvcc processes) runs beside
    # the bucket-shape discovery below, which builds engines and launches
    # no kernel.
    build = in_thread(timed, "2_build", image_build, cache_dir, bin_dir)

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
        image = build()
        check(cuda_lib.library_path() == image["kernels"],
              f"this process looks for {cuda_lib.library_path()}, the build made "
              f"{image['kernels']}")
        log(f"build: {phases['2_build']:.1f} s (the image's {image['command']!r}, "
            f"beside the shape discovery): {json.dumps(image)}")
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
        # Phases 13 and 14 and phase 22's legs b-c are host-bound runs of
        # one core each (the card mostly idle, PERF.md section 5): phase 14
        # runs in a process of its own and legs b-c in subprocesses, all
        # beside phase 13; phase 22 joins b-c before its leg a.
        t14 = time.perf_counter()
        fleet_rl_join = phase_in_own_process(d, "fleet_rl_phase",
                                             {"linear": {"s_per_step": rl["linear"]["s_per_step"]}})
        tools_bc = serving_tools_background(d)
        bench_ce = bench_tools_background(d)
        deploy_join = in_thread(deploy_run, d, bin_dir)
        fleet = timed("13_fleet", fleet_phase, d)
        fleet_rl = fleet_rl_join()
        phases["14_fleet_rl"] = round(time.perf_counter() - t14, 1)  # beside phase 13
        tel = timed("15_telemetry", telemetry_phase, d, stats, rstats, fleet, routes, cpu_conv)
        admm = timed("16_admm", admm_phase, d, [r for r in shapes if r[0] == MAIN_HORIZON],
                     grid_shapes)
        readers = timed("17_readers", readers_phase, d)
        supervised = timed("18_supervised", supervised_phase, d, card)
        sharding = timed("19_sharding", sharding_phase, d)
        serving = timed("20_serving", serving_phase, d)
        shard = timed("21_shard", shard_phase, d)
        tools = timed("22_serving_tools", serving_tools_phase, d, tools_bc)
        bench_tools = timed("23_bench_tools", bench_tools_phase, d, bench_ce,
                            torch.cuda.get_device_name(0))
        deploy = timed("24_deploy", deploy_phase, d, deploy_join, image["kernels"])

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
        """One call at each of ``rows``' bucket shapes (the grid block's,
        the sweep's), summed."""
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
            # Phase 16: the ADMM's band backend, ADMM_BAND_HOMES × ADMM_BAND_STEPS.
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
            # Phase 17: one call at each bucket shape of the sweep's runs
            # (H = 2, 4, 8; SWEEP_HOMES), summed over all and per horizon;
            # the sweep's launches per horizon; phase 18: the healthy
            # supervised child's (SUPERVISED_HOMES × 4 steps).
            sweep_shapes=dict(grid_block(readers["kernels"]["per_shape"], name),
                              max_abs_err=readers["kernels"]["max_abs_err"][name],
                              per_horizon={str(h): grid_block(
                                  [r for r in readers["kernels"]["per_shape"]
                                   if r["horizon"] == h], name)
                                  for h in SWEEP_HORIZONS}),
            launches_sweep={str(r["horizon"]): r["launches"][name] for r in readers["runs"]},
            launches_supervised=supervised["healthy"]["launches"][name],
            # Phase 19: each rank of the two sharing the card (leg b,
            # SHARDING_HOMES × SHARD_STEPS, split route).
            launches_sharded=[ln[name] for ln in sharding["launches_per_rank"]],
            # Phase 20: every batch the main daemon's workers served (10,000
            # homes and the 4 × 2,500-home fleet lane, split route), read
            # from the workers' beats.
            launches_serving=serving["launches"][name],
            # Phase 21: each shard worker of leg a's N = 1 and N = 2 runs
            # (4 × 2,500 homes, split route), read from the workers' beats.
            launches_shard=shard["launches"][name],
            # Phase 22: the batches the load ladder's worker served (4 ×
            # 2,500 homes, split route), read from its beats.
            launches_serving_tools=tools["launches"][name],
            # Phase 23: the bench's timed chunks (10,000 homes, 2 × 8
            # steps, split route), from its line's kernel_launches.
            launches_bench=bench_tools["launches"][name],
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
        launches_sweep={str(r["horizon"]): r["launches"][WINDOW] for r in readers["runs"]},
        launches_supervised=supervised["healthy"]["launches"][WINDOW],
        # Phase 19, leg d: ReLU-QP on two ranks routes the window to lax.
        launches_sharded=[ln[WINDOW] for ln in sharding["short"]["d_reluqp"]["launches"]],
        launches_serving=serving["launches"][WINDOW],
        launches_shard=shard["launches"][WINDOW],
        launches_serving_tools=tools["launches"][WINDOW],
        launches_bench=bench_tools["launches"][WINDOW],
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
                   "telemetry": tel, "admm": admm, "readers": readers,
                   "supervised": supervised, "sharding": sharding, "serving": serving,
                   "shard": shard, "serving_tools": tools, "bench_tools": bench_tools,
                   "image_build": image, "deploy": deploy, "phases": phases},
                  f, indent=1)
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
