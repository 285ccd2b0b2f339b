"""The community engine: one batched step for the whole community
(counterpart of ``dragg_tpu/engine.py``).

Each step, for every home-type bucket:

1. slices the environment windows (OAT/GHI/TOU) from device-resident
   series and builds the water-draw windows and the draw-mixed initial WH
   temperature (dragg/mpc_calc.py:193-204,281);
2. gates each home's HVAC season on the noisy OAT forecast, drawn from
   JAX's own threefry streams (``rng.py``) so the gate matches the JAX
   package home by home (dragg/mpc_calc.py:206-231,302-309);
3. assembles the fixed-shape batched QP and solves it with the configured
   solver family: the interior point (``ops/ipm.py``), whose band factor
   and solves run in the CUDA kernels of ``ops/band_kernels.py`` (or by
   cyclic reduction, ``tpu.band_kernel = "cr"``); ReLU-QP
   (``ops/reluqp.py``), whose check windows run in the CUDA kernel of
   ``ops/iter_kernels.py`` under ``tpu.iter_kernel = "pallas"``; or the
   ADMM (``ops/admm.py``), whose solve backend is resolved per bucket:
   a dense explicit inverse, or the band kernels
   (``tpu.admm_solve_backend = "band"``);
4. pins the first action to integer duty counts, in closed form
   (``integer_repair = "project"``) or by a second solve with the three
   k = 0 counts pinned in the box (``"resolve"``);
5. routes homes whose solve failed through the fallback controller
   (dragg/mpc_calc.py:527-596) and advances the state, the EV's charge
   and its trip drain included.

A fleet (``fleet.communities > 1``, ``homes.FleetSpec``) folds C
communities into the home axis, type-major, so each type bucket holds
every community's homes of that type; each home keeps its community's
seed for its forecast noise, its community's weather offset and its
community's row of the event timeline (``scenarios.timeline``): tariff
shocks added to the price, DR caps and outage islanding on an explicit
grid-power block, and comfort relief.

PyTorch runs eagerly, so a chunk is a Python loop over steps; the per-home
arrays (``HomeBatch``, ``CommunityState``, ``StepOutputs``) are
NamedTuples of tensors in the JAX package's layout, homes first.  The
ReLU-QP rho bank and the ADMM's ``FactorCarry`` are per-bucket carries
that live across the steps of a chunk and refresh on the chunk's first
step and every ``admm_refactor_every`` sim steps (``run_chunk``).
"""

from __future__ import annotations

from functools import reduce
from typing import NamedTuple

import numpy as np
import torch

from dragg_tpu_torch import rng
from dragg_tpu_torch.device import resolve_device
from dragg_tpu_torch.homes import TYPE_CODES, slice_batch, type_bucket_ranges
from dragg_tpu_torch.interop import home_batch_from_numpy
from dragg_tpu_torch.models.fallback import fallback_control
from dragg_tpu_torch.ops.admm import (
    _schur_structure_for,
    admm_solve_qp_cached,
    init_factor_carry,
    resolve_backend,
)
from dragg_tpu_torch.ops.banded import plan_for
from dragg_tpu_torch.ops.dual import primal
from dragg_tpu_torch.ops.ipm import band_plan, ipm_solve_qp
from dragg_tpu_torch.ops.precision import validate_precision
from dragg_tpu_torch.ops.reluqp import reluqp_solve_qp_cached
from dragg_tpu_torch.ops.qp import (
    QPLayout,
    TAP_TEMP,
    TYPE_SPECS,
    assemble_qp_step,
    build_qp_static,
    ev_charge_bounds,
    hp_cops,
    recover_solution,
    shift_warm_start,
    superset_spec_for,
)

F32 = torch.float32
WINTER_MAX_OAT = 30.0  # season switch threshold, degC (dragg/mpc_calc.py:303)

# ``tpu.bucketed = "auto"`` buckets by home type when both hold.
BUCKETED_MIN_HOMES = 32
BUCKETED_MIN_FRAC = 0.25

# --- The observatory (``telemetry.per_home``): per-bucket histograms of
# the solver's per-home final primal residual and convergence iterations,
# and the bucket's worst-k homes, folded on the device each step
# (:func:`per_home_obs`) and carried home in the StepOutputs the
# aggregator already copies.  The bins are the JAX package's fixed
# literals, so histograms of either package add up.
#
# Residual bins: index 0 = r_prim < 1e-7, then half-decade log10 bins over
# [1e-7, 10) (values >= 10 clip into the last log bin), and a final bin for
# certified-diverged / non-finite homes.
OBS_RES_LOG_LO = -7.0
OBS_RES_LOG_STEP = 0.5
OBS_RES_BINS = 18  # 1 underflow + 16 half-decade bins + 1 diverged
# Iteration bins: bin i holds conv_iters in (edge[i-1], edge[i]]; the last
# holds > 512.
OBS_ITER_EDGES = (2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
                  384, 512)
OBS_ITER_BINS = len(OBS_ITER_EDGES) + 1

# StepOutputs fields carrying the observatory fold: shaped per bucket
# ((n_buckets, bins) / (n_buckets * k,) a step), not per home, so the
# aggregator's home-column slicing skips them.
OBS_FIELDS = frozenset({
    "conv_hist", "iters_hist", "iters_sum", "diverged_count",
    "worst_idx", "worst_rp", "worst_rd", "worst_iters", "worst_bucket",
})


def resolve_bucket_plan(bucketed: str, type_code) -> list[tuple[str, int, int]] | None:
    """The contiguous ``(type_name, start, stop)`` buckets to solve at
    type-specialized shapes, or ``None`` for the one-batch superset path.
    ``"auto"`` buckets only when the community is big enough and enough
    homes are non-superset; ``"true"`` forces it (raising if the homes are
    not grouped by type); ``"false"`` forces the superset batch."""
    if bucketed == "false":
        return None
    ranges = type_bucket_ranges(type_code)
    if bucketed == "true":
        if ranges is None:
            raise ValueError(
                "tpu.bucketed=true needs homes grouped by type (the "
                "create_homes materialization order); this batch "
                "interleaves types")
        return ranges
    if ranges is None:
        return None
    codes = np.asarray(type_code)
    n = codes.size
    non_superset = int(np.sum(codes != TYPE_CODES["pv_battery"]))
    if n < BUCKETED_MIN_HOMES or non_superset < BUCKETED_MIN_FRAC * n:
        return None
    return ranges


class _TypeBucket(NamedTuple):
    """One bucket's shape context: its layout/static/pattern and its slice
    of every per-home device constant.  The unbucketed engine is the
    single bucket ``"superset"``."""

    name: str
    ordinal: int             # position in the engine's buckets (= the
                             # bucket_info() row the observatory's
                             # worst_bucket codes index)
    lay: QPLayout
    comm_start: int          # first home in community order
    n: int                   # homes in the bucket
    static: object           # ops.qp.HomeQPStatic
    batch: object            # HomeBatch of tensors
    check_mask: torch.Tensor  # (n,) float32
    noise_idx: torch.Tensor  # (n,) forecast-noise stream id per home: its
                             # index within its own community
    home_key: torch.Tensor   # (n, 2) per-home base PRNG key (its
                             # community's seed)
    home_idx: torch.Tensor   # (n,) int32 community-major fleet index (the
                             # observatory's worst-k names)
    env_off: torch.Tensor    # (n,) offset into the environment series
    comm_idx: torch.Tensor   # (n,) community: the event-timeline row
    solve_backend: str       # the ADMM's in-loop solve: "dense_inv" | "band"


class CommunityState(NamedTuple):
    """Per-home simulation state carried between timesteps."""

    temp_in: torch.Tensor     # (n,) one-step deterministic indoor temp
    temp_wh: torch.Tensor     # (n,) WH temp BEFORE next step's draw mixing
    e_batt: torch.Tensor      # (n,) battery SoC (kWh)
    e_ev: torch.Tensor        # (n,) EV SOC (kWh; zeros for non-EV homes)
    counter: torch.Tensor     # (n,) int32 solve_counter
    plan_cool: torch.Tensor   # (n, H) last feasible raw-duty plans (replay source)
    plan_heat: torch.Tensor   # (n, H)
    plan_wh: torch.Tensor     # (n, H)
    warm_x: torch.Tensor      # (n, nvar) warm-start primal (0 columns for the
                              # interior point unless ipm_warm)
    warm_y_box: torch.Tensor  # (n, nvar) warm-start box duals
    warm_rho: torch.Tensor    # (n,) warm-start rho (the ADMM's rho, ReLU-QP's
                              # bank hint)
    key: torch.Tensor         # (2,) PRNG key words (legacy carry, as in JAX)


class StepOutputs(NamedTuple):
    """Per-home observables for one timestep (the reference's Redis result
    hash fields, dragg/mpc_calc.py:482-524): kW for powers, duty fractions
    in [0, 1], ``cost`` on the raw s-scaled grid variable for optimal
    steps and on the physical one for fallback steps."""

    p_grid: torch.Tensor           # (n,)
    forecast_p_grid: torch.Tensor  # (n,)
    p_load: torch.Tensor           # (n,)
    temp_in: torch.Tensor          # (n,)
    temp_wh: torch.Tensor          # (n,)
    hvac_cool_on: torch.Tensor     # (n,) duty fraction
    hvac_heat_on: torch.Tensor     # (n,)
    wh_heat_on: torch.Tensor       # (n,)
    cost: torch.Tensor             # (n,)
    waterdraws: torch.Tensor       # (n,) liters
    correct_solve: torch.Tensor    # (n,) 1.0 / 0.0
    p_pv: torch.Tensor             # (n,) kW
    u_pv_curt: torch.Tensor        # (n,)
    e_batt: torch.Tensor           # (n,) kWh
    p_batt_ch: torch.Tensor        # (n,) kW
    p_batt_disch: torch.Tensor     # (n,) kW (non-positive)
    p_ev_ch: torch.Tensor          # (n,) kW EV charging (0 for non-EV homes)
    e_ev: torch.Tensor             # (n,) kWh EV SOC
    agg_load: torch.Tensor         # () masked sum of p_grid over homes
    forecast_load: torch.Tensor    # ()
    agg_cost: torch.Tensor         # ()
    admm_iters: torch.Tensor       # () solver iterations this step
    repair_failed: torch.Tensor    # () homes whose integer pin left the comfort band
    r_prim_max: torch.Tensor       # () max final primal residual (f32-max sentinel if non-finite)
    r_dual_max: torch.Tensor       # () max final dual residual
    bank_fallback_count: torch.Tensor  # () homes that needed ReLU-QP's exact-
                                       # refactorization tail (0 for the IPM)
    # --- The observatory fold (see the OBS_* constants): per-bucket
    # shapes, concatenated over the buckets; zero-width leaves when
    # ``telemetry.per_home = false``.
    conv_hist: torch.Tensor        # (n_buckets, OBS_RES_BINS) r_prim counts
    iters_hist: torch.Tensor       # (n_buckets, OBS_ITER_BINS) conv_iters counts
    iters_sum: torch.Tensor        # (n_buckets,) masked sum of conv_iters
    diverged_count: torch.Tensor   # (n_buckets,) certified-diverged homes
    worst_idx: torch.Tensor        # (n_buckets·k,) int32 community home index
                                   # of the bucket's worst-k by r_prim (−1 =
                                   # an empty slot)
    worst_rp: torch.Tensor         # (n_buckets·k,) their r_prim
    worst_rd: torch.Tensor         # (n_buckets·k,) their r_dual
    worst_iters: torch.Tensor      # (n_buckets·k,) their conv_iters
    worst_bucket: torch.Tensor     # (n_buckets·k,) int32 bucket ordinal


class StepAux(NamedTuple):
    """Assemble-phase intermediates consumed by the merge/collect phase."""

    draw0: torch.Tensor        # (n,) liters drawn this step
    temp_wh_init: torch.Tensor  # (n,) draw-mixed initial WH temp
    oat1: torch.Tensor         # () OAT at t+1 (fallback simulation forcing);
                               # (n,) under fleet weather offsets
    ghi_w: torch.Tensor        # (H+1,); (n, H+1) under fleet weather offsets
    price_total: torch.Tensor  # (n, H)
    cool_cap: torch.Tensor     # (n,)
    heat_cap: torch.Tensor     # (n,)


class EngineParams(NamedTuple):
    """Static engine configuration (the JAX package's EngineParams; the
    IPM's proximal term is ``reg``, the ADMM's initial rho ``warm_rho``)."""

    solver: str         # "ipm" | "reluqp" | "admm"
    horizon: int        # H — decision steps (hems horizon * dt)
    dt: int             # steps per hour
    s: float            # sub_subhourly_steps (duty-cycle denominator)
    discount: float
    start_index: int    # index of sim t=0 in the environment series
    reg: float          # proximal regularization (tpu.admm_reg)
    warm_rho: float     # initial warm_rho carry (tpu.admm_rho)
    admm_eps: float     # ADMM / ReLU-QP stopping tolerance (abs = rel)
    admm_sigma: float   # ADMM / ReLU-QP σ
    admm_alpha: float   # ADMM / ReLU-QP over-relaxation α
    admm_patience: int  # check windows without progress before stopping
    admm_refactor_every: int  # sim steps between factor / rho-bank refreshes
    admm_iters: int     # ADMM iteration cap
    admm_rho_update_every: int  # ADMM rho-update cadence (check windows)
    admm_matvec_dtype: str  # "f32" | "bf16" storage of the ADMM's dense Sinv
    admm_refine: int    # refinement passes per in-loop ADMM solve
    admm_anderson: int  # ADMM Anderson-acceleration depth (0 = off)
    admm_banded_factor: bool  # factor the ADMM's Schur complement by band Cholesky
    admm_solve_backend: str  # "auto" | "dense_inv" | "band"
    reluqp_rho: float   # centre of the rho bank
    reluqp_rho_factor: float  # geometric step of the rho bank
    reluqp_bank: int    # rho-bank entries
    reluqp_iters: int   # iteration cap of the banked loop
    reluqp_tail_iters: int  # fallback exact-refactorization tail budget
    precision: str      # hot-loop matmul policy ("f32" | "bf16x3")
    iter_kernel: str    # "auto" | "pallas" | "lax" (check-window route)
    ipm_iters: int      # Mehrotra iteration cap
    ipm_tail_frac: float  # straggler sub-batch fraction (0 disables)
    ipm_tail_iters: int   # tail-phase iteration cap (0 = ipm_iters)
    ipm_warm: bool      # seed the IPM from the receding-horizon shift
    ipm_eps: float      # IPM stopping tolerance
    ipm_freeze_zmax: float  # divergence-freeze dual threshold (scaled space)
    band_fused: bool    # factor + predictor solve in one kernel launch
    band_kernel: str    # "auto" | "pallas" (the CUDA kernels) | "xla" (plain
                        # versions) | "cr" (cyclic reduction; the ADMM: "xla")
    integer_first_action: bool  # pin the rounded k=0 duty counts
    integer_repair: str  # "project" (closed-form k=1 update) | "resolve" (pinned re-solve)
    repair_eps: float   # IPM tolerance of the "resolve" re-solve
    forecast_noise_cap: float  # max forecast-noise std, degC
    bucketed: str       # "auto" | "true" | "false"
    seed: int
    obs_per_home: bool  # the observatory fold (telemetry.per_home)
    obs_worst_k: int    # worst homes captured per bucket per step


class Engine:
    """The batched community step for one (community, config), with every
    per-home constant on ``device``.  Build via :func:`make_engine`."""

    def __init__(self, params: EngineParams, batch, env_oat, env_ghi, env_tou,
                 check_mask=None, device=None, fleet=None, events=None, hour0: int = 0):
        self.params = params
        self.device = dev = resolve_device(device)
        codes = np.asarray(batch.type_code)
        # A timeline that changes nothing is None, so an event-free run is
        # the same program, bit for bit, as one built without a timeline.
        self._events = None if events is None or events.inert else events
        if self._events is not None:
            want_c = 1 if fleet is None else fleet.n_communities
            if self._events.n_communities != want_c:
                raise ValueError(
                    f"event timeline covers {self._events.n_communities} "
                    f"communities but the engine runs {want_c}")
        # Grid events add the explicit p_grid block to every bucket's shape.
        grid_events = self._events is not None and self._events.has_grid
        # Hour of day at environment index 0: EV away windows are
        # wall-clock hours.
        self._hour0 = int(hour0)
        self._oat = torch.as_tensor(np.asarray(env_oat), dtype=F32, device=dev)
        self._ghi = torch.as_tensor(np.asarray(env_ghi), dtype=F32, device=dev)
        self._tou = torch.as_tensor(np.asarray(env_tou), dtype=F32, device=dev)
        # The (C, T) event series of the families the schedule uses.
        self._evt: dict[str, torch.Tensor] = {}
        if self._events is not None:
            ev = self._events
            for name, used, series in (("price", ev.has_price, ev.price),
                                       ("cap", ev.has_grid, ev.cap),
                                       ("floor", ev.has_grid, ev.floor),
                                       ("relax", ev.has_relax, ev.relax)):
                if used:
                    self._evt[name] = torch.as_tensor(np.asarray(series), dtype=F32,
                                                      device=dev)
        H = params.horizon
        self._noise_std = torch.minimum(
            torch.pow(torch.tensor(1.1, dtype=F32, device=dev),
                      torch.arange(H, dtype=F32, device=dev)),
            torch.tensor(params.forecast_noise_cap, dtype=F32, device=dev))
        # ReLU-QP always carries the receding-horizon warm start; the
        # interior point only under ipm_warm_start.
        self._carry_warm = params.solver != "ipm" or params.ipm_warm
        # The check-window route: "auto" stays on the einsum ("lax") path,
        # as in the JAX package; "pallas" runs ops/iter_kernels.fused_window
        # (the CUDA kernel on the card, its plain version on the CPU).
        self._iter_kernel = "lax" if params.iter_kernel == "auto" else params.iter_kernel
        # The ADMM carries its band factor as one array, so "cr" (whose
        # factor is a dict) runs the plain band versions there; the IPM
        # runs cyclic reduction fully.
        self._admm_band_kernel = "xla" if params.band_kernel == "cr" else params.band_kernel
        if check_mask is None:
            check_mask = np.ones(batch.n_homes)
        cmask = np.asarray(check_mask, dtype=np.float64)
        # Each batch row's fleet identity; one community is the C = 1 case.
        self._fleet = fleet
        n = batch.n_homes
        if fleet is None:
            rows = dict(home_idx=np.arange(n), noise_idx=np.arange(n),
                        env_off=np.zeros(n, np.int64), comm_idx=np.zeros(n, np.int64))
            seeds = (params.seed,)
        else:
            rows = dict(home_idx=np.asarray(fleet.global_idx, np.int64),
                        noise_idx=np.asarray(fleet.local_idx, np.int64),
                        env_off=np.asarray(fleet.env_offset, np.int64),
                        comm_idx=np.asarray(fleet.community, np.int64))
            seeds = fleet.seeds
        self._fleet_rows = rows
        # All-zero offsets keep the shared-window slice; any offset gathers
        # a window per home.
        self._per_home_env = bool(np.any(rows["env_off"]))
        keys = torch.stack([rng.prng_key(sd, dev) for sd in seeds])
        ranges = resolve_bucket_plan(params.bucketed, codes)
        self._bucketed = ranges is not None
        self.n_homes = batch.n_homes
        if ranges is None:
            ranges = [("superset", 0, batch.n_homes)]
        self._buckets: list[_TypeBucket] = []
        for ordinal, (tname, a, b) in enumerate(ranges):
            spec = (superset_spec_for(codes) if tname == "superset"
                    else TYPE_SPECS[tname])
            if grid_events:
                spec = spec._replace(has_grid=True)
            sub = slice_batch(batch, a, b)
            row = lambda k: torch.as_tensor(rows[k][a:b], dtype=torch.int64,  # noqa: E731
                                            device=dev)
            lay = QPLayout(H, spec)
            static = build_qp_static(sub, H, params.dt, spec, device=dev)
            # The ADMM's backend, per bucket (one shard): "auto" goes banded
            # only past BAND_AUTO_BYTES of dense Sinv.
            plan = (plan_for(_schur_structure_for(static.pattern), lay.m_eq)
                    if params.admm_banded_factor else None)
            backend = resolve_backend(
                params.admm_solve_backend, b - a, lay.m_eq, plan is not None,
                elem_bytes=2 if params.admm_matvec_dtype == "bf16" else 4)
            self._buckets.append(_TypeBucket(
                name=tname, ordinal=ordinal, lay=lay, comm_start=a, n=b - a,
                static=static,
                batch=home_batch_from_numpy(sub._asdict(), dev),
                check_mask=torch.as_tensor(cmask[a:b], dtype=F32, device=dev),
                noise_idx=row("noise_idx"),
                home_key=(keys[0].expand(b - a, 2) if fleet is None
                          else keys[row("comm_idx")]),
                home_idx=row("home_idx").to(torch.int32),
                env_off=row("env_off"),
                comm_idx=row("comm_idx"),
                solve_backend=backend,
            ))
        self._obs_edges = torch.tensor(OBS_ITER_EDGES, dtype=torch.int32, device=dev)

    @property
    def bucketed(self) -> bool:
        """Whether the community solves as per-type buckets."""
        return self._bucketed

    @property
    def warm_cols(self):
        """Width of the warm-start columns of CommunityState (a list, one
        per bucket, when bucketed): the layout's variable count where the
        solver carries a warm start, else 0."""
        widths = [c.lay.n if self._carry_warm else 0 for c in self._buckets]
        return widths if self._bucketed else widths[0]

    @property
    def iter_kernel(self) -> str:
        """The resolved ReLU-QP check-window route: "lax" or "pallas"."""
        return self._iter_kernel

    @property
    def admm_band_kernel(self) -> str:
        """The ADMM's band route: ``tpu.band_kernel``, with "cr" as "xla"."""
        return self._admm_band_kernel

    @property
    def solve_backends(self) -> list[str]:
        """The ADMM's resolved in-loop solve backend of each bucket."""
        return [c.solve_backend for c in self._buckets]

    def bucket_info(self) -> list[dict]:
        """One dict per bucket, in ordinal order (the observatory's
        ``worst_bucket`` codes index this list): its type, home and slot
        range, solved shape and the bandwidth of its Schur band factor.
        Slots are homes here (no shard padding)."""
        return [dict(name=c.name, comm_start=c.comm_start, n_real=c.n,
                     start_slot=c.comm_start, n_slots=c.n,
                     m_eq=c.lay.m_eq, n_var=c.lay.n,
                     nnz=c.static.pattern.nnz,
                     band_bw=band_plan(c.static.pattern).bw)
                for c in self._buckets]

    @property
    def obs_enabled(self) -> bool:
        """Whether the step folds the observatory (``telemetry.per_home``),
        the aggregator's gate for its emits."""
        return self.params.obs_per_home

    def state_slice(self, state, home_idx: int) -> dict:
        """One home's scalar carried state as floats (temp_in, temp_wh,
        e_batt, counter): the forensic dump's chunk-start snapshot.
        ``state`` is the engine's (tensors) or a host copy of it (numpy);
        ``home_idx`` is the community-major fleet index (``all_homes``
        order), mapped to its batch row first."""
        if not 0 <= home_idx < self.n_homes:
            return {}
        row = int(self.real_home_cols[home_idx])
        states = state if self._bucketed else (state,)
        for ctx, st in zip(self._buckets, states):
            if ctx.comm_start <= row < ctx.comm_start + ctx.n:
                local = row - ctx.comm_start
                return {f: float(getattr(st, f)[local])
                        for f in ("temp_in", "temp_wh", "e_batt", "counter")}
        return {}

    @property
    def events(self):
        """The engine's event timeline (``scenarios.EventTimeline``), None
        when it schedules nothing."""
        return self._events

    @property
    def fleet(self):
        """The ``homes.FleetSpec`` this engine was built with (None for one
        community)."""
        return self._fleet

    @property
    def n_communities(self) -> int:
        return 1 if self._fleet is None else self._fleet.n_communities

    @property
    def real_home_cols(self) -> np.ndarray:
        """Column of each home of the merged per-home outputs, in the
        community-major fleet order (the aggregator's ``all_homes``
        order): the identity for one community; for a fleet, whose batch
        is type-major, the inverse of the rows' fleet index."""
        cols = np.empty(self.n_homes, dtype=np.int64)
        cols[self._fleet_rows["home_idx"]] = np.arange(self.n_homes)
        return cols

    @property
    def real_home_pairs(self) -> np.ndarray:
        """(n_homes, 2) ``(community, output column)`` per home in the
        community-major fleet order: row j is home j % B of community
        j // B (community 0 throughout for one community)."""
        cols = self.real_home_cols
        if self._fleet is None:
            comm = np.zeros(len(cols), dtype=np.int64)
        else:
            comm = np.arange(len(cols)) // self._fleet.homes_per_community
        return np.stack([comm, cols], axis=1)

    def community_fold_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """``(comm_idx, mask)`` aligned with the merged per-home output
        columns, for per-community sums of a per-home series: summing
        ``vec * mask`` over each community's columns gives that
        community's share of ``agg_load``-style totals."""
        comm = self._fleet_rows["comm_idx"]
        mask = np.concatenate([c.check_mask.cpu().numpy() for c in self._buckets])
        return comm.astype(np.int32), mask.astype(np.float32)

    # ---------------------------------------------------------------- state
    def init_state(self):
        """t=0 initial conditions (dragg/mpc_calc.py:267-277); one
        CommunityState per bucket (a tuple) when bucketed."""
        states = tuple(self._init_state_bucket(c) for c in self._buckets)
        return states if self._bucketed else states[0]

    def _init_state_bucket(self, ctx: _TypeBucket) -> CommunityState:
        b, n, H, dev = ctx.batch, ctx.n, self.params.horizon, self.device
        nw = ctx.lay.n if self._carry_warm else 0
        zeros = lambda *shape: torch.zeros(shape, dtype=F32, device=dev)  # noqa: E731
        return CommunityState(
            temp_in=b.temp_in_init.clone(),
            temp_wh=b.temp_wh_init.clone(),
            e_batt=b.e_batt_init_frac * b.batt_capacity,
            e_ev=b.is_ev * b.ev_init_frac * b.ev_cap,
            counter=torch.zeros((n,), dtype=torch.int32, device=dev),
            plan_cool=zeros(n, H),
            plan_heat=zeros(n, H),
            plan_wh=zeros(n, H),
            warm_x=zeros(n, nw),
            warm_y_box=zeros(n, nw),
            warm_rho=torch.full((n,), self.params.warm_rho, dtype=F32, device=dev),
            key=rng.prng_key(self.params.seed, dev),
        )

    def init_factor(self):
        """The solver carry at a chunk's start, one per bucket (a tuple)
        when bucketed: the ADMM's zero ``FactorCarry``
        (``ops.admm.init_factor_carry``, its band factor transposed under
        the kernels), None for ReLU-QP, whose chunk's first step builds
        the scalings and rho bank afresh, and for the interior point,
        which carries nothing.  A chunk's first step always refreshes;
        ``_solve`` returns the carry the next step reuses."""
        carries = tuple(self._init_factor_bucket(c) for c in self._buckets)
        return carries if self._bucketed else carries[0]

    def _init_factor_bucket(self, ctx: _TypeBucket):
        p = self.params
        if p.solver != "admm":
            return None
        return init_factor_carry(ctx.n, ctx.static.pattern, device=self.device,
                                 matvec_dtype=p.admm_matvec_dtype,
                                 solve_backend=ctx.solve_backend,
                                 banded_factor=p.admm_banded_factor,
                                 band_kernel=self._admm_band_kernel)

    # ----------------------------------------------------------------- step
    def _prepare(self, ctx: _TypeBucket, state: CommunityState, t: int, rp):
        """Assemble phase for one bucket: water draws, environment windows,
        event windows, EV availability, the noisy seasonal gate, and the
        batched QP.  ``rp`` is the (H,) reward-price vector for this step,
        or (C, H), one row per community, routed to each home through its
        community index."""
        p, lay, b = self.params, ctx.lay, ctx.batch
        H, dt, s, dev = p.horizon, p.dt, p.s, self.device

        # --- Water draws (dragg/mpc_calc.py:193-204).
        width = H // dt + 1
        h0 = min(t // dt, b.draws_hourly.shape[1] - width)  # dynamic_slice clamp
        raw = torch.repeat_interleave(b.draws_hourly[:, h0:h0 + width], dt, dim=-1) / dt
        n_raw = raw.shape[-1]
        idx = torch.arange(H + 1, device=dev)
        prev_ok = (idx - 1 >= 0).to(F32)
        next_ok = (idx + 1 < n_raw).to(F32)
        take = lambda off: raw[:, torch.clamp(idx + off, 0, n_raw - 1)]  # noqa: E731
        rolled = (take(-1) * prev_ok + take(0) + take(1) * next_ok) / (prev_ok + 1.0 + next_ok)
        direct = raw[:, torch.clamp(idx, max=n_raw - 1)]
        draw_size = torch.where(idx < dt, direct, rolled)        # (n, H+1) liters
        tank = b.tank_size
        draw_frac = draw_size / tank[:, None]
        # Draw-mixed initial WH temperature (dragg/mpc_calc.py:271,281).
        temp_wh_init = (state.temp_wh * (tank - draw_size[:, 0])
                        + TAP_TEMP * draw_size[:, 0]) / tank

        # --- Environment windows (true values; dragg/mpc_calc.py:211-230).
        # Fleet weather offsets shift each home's window by its
        # community's offset (a gather per home); with every offset zero
        # all homes share one window.
        start = p.start_index + t
        rp_rows = rp[ctx.comm_idx] if rp.ndim == 2 else rp[None, :]
        if self._per_home_env:
            rows = start + ctx.env_off[:, None] + torch.arange(H + 1, device=dev)[None, :]
            oat_w, ghi_w = self._oat[rows], self._ghi[rows]        # (n, H+1)
            price_total = rp_rows + self._tou[rows[:, :H]]
            oat0, oat1, oat_fore = oat_w[:, 0], oat_w[:, 1], oat_w[:, 1:]
        else:
            oat_w = self._oat[start:start + H + 1]
            ghi_w = self._ghi[start:start + H + 1]
            tou_w = self._tou[start:start + H]
            price_total = rp_rows + tou_w[None, :]
            oat0, oat1, oat_fore = oat_w[0], oat_w[1], oat_w[None, 1:]

        # --- Event windows, gathered per home from its community's row.
        # Events are scheduled in sim time, never weather-offset.
        def evt_window(name, offset=0):
            series = self._evt[name]                               # (C, T)
            a = min(max(start + offset, 0), series.shape[1] - H)  # dynamic_slice clamp
            return series[:, a:a + H][ctx.comm_idx]                # (n, H)

        if "price" in self._evt:
            price_total = price_total + evt_window("price")
        grid_cap = evt_window("cap") if "cap" in self._evt else None
        grid_floor = evt_window("floor") if "floor" in self._evt else None
        # Comfort relief widens the bounded T_in entries, which sit at
        # t + k + 1: one step ahead of the control window.
        relax_w = evt_window("relax", 1) if "relax" in self._evt else None
        price_total = price_total.expand(ctx.n, H)

        # --- EV availability and departure-deadline bounds (hour of day
        # is wall clock: environment index → hour via the series' start).
        if lay.has_ev:
            ks = torch.arange(H, device=dev)
            hod_ctrl = ((p.start_index + t + ks) // dt + self._hour0) % 24
            hod_state = ((p.start_index + t + 1 + ks) // dt + self._hour0) % 24
            ev_avail, ev_floor = ev_charge_bounds(hod_ctrl, hod_state, b, state.e_ev, dt)
            e_ev_init = state.e_ev
        else:
            ev_avail = ev_floor = e_ev_init = None

        # --- Seasonal gate on the noisy forecast: each home's noise is a
        # function of (community seed, t, home index) alone, so bucketing
        # cannot perturb it.  The std is capped at forecast_noise_cap (the
        # reference's unbounded 1.1^k growth flips the gate beyond ~16 h).
        keys = rng.fold_in(rng.fold_in(ctx.home_key, t), ctx.noise_idx)
        noise = rng.normal(keys, H) * self._noise_std
        oat_ev_max = torch.maximum(oat0, torch.amax(oat_fore + noise, dim=1))
        winter = (oat_ev_max <= WINTER_MAX_OAT).to(F32)
        heat_cap = winter * s
        cool_cap = (1.0 - winter) * s

        qp = assemble_qp_step(
            ctx.static, lay, b,
            oat_window=oat_w, ghi_window=ghi_w, price_total=price_total,
            draw_frac=draw_frac,
            temp_in_init=state.temp_in, temp_wh_init=temp_wh_init,
            e_batt_init=state.e_batt,
            cool_cap=cool_cap, heat_cap=heat_cap, wh_cap=s,
            discount=p.discount,
            e_ev_init=e_ev_init, ev_avail=ev_avail, ev_floor=ev_floor,
            grid_cap=grid_cap, grid_floor=grid_floor, comfort_relax=relax_w,
        )
        aux = StepAux(
            draw0=draw_size[:, 0], temp_wh_init=temp_wh_init, oat1=oat1,
            ghi_w=ghi_w, price_total=price_total,
            cool_cap=cool_cap, heat_cap=heat_cap,
        )
        return qp, aux

    def _solve(self, ctx: _TypeBucket, state: CommunityState, qp, factor, refresh: bool):
        """Solve phase for one bucket: the configured solver on the relaxed
        QP, then the integer pin of the first action.  Returns (solution,
        solver carry, relaxed solution, repair_failed)."""
        p = self.params
        if p.solver == "ipm":
            def run_ipm(l_box, u_box, eps=p.ipm_eps):
                return ipm_solve_qp(
                    ctx.static.pattern, qp.vals, qp.b_eq, l_box, u_box, qp.q,
                    reg=p.reg, iters=p.ipm_iters,
                    tail_frac=p.ipm_tail_frac, tail_iters=p.ipm_tail_iters,
                    eps_abs=eps, eps_rel=eps,
                    x0=state.warm_x if p.ipm_warm else None,
                    freeze_zmax=p.ipm_freeze_zmax, fused=p.band_fused,
                    band_kernel=p.band_kernel)

            relaxed = run_ipm(qp.l_box, qp.u_box)
            # The pinned re-solve runs cold at the looser repair_eps: what
            # it applies is the pinned counts themselves.
            resolve = lambda l2, u2: run_ipm(l2, u2, eps=p.repair_eps)  # noqa: E731
        else:
            if p.solver == "reluqp":
                # The pre-factorized dense family: the carry holds the rho
                # bank; ``refresh`` re-equilibrates and rebuilds it.
                def run_solver(l_box, u_box, fac, ref, x0, y0, rho_w):
                    return reluqp_solve_qp_cached(
                        ctx.static.pattern, qp.vals, qp.b_eq, l_box, u_box, qp.q,
                        fac, ref,
                        rho0=p.reluqp_rho, rho_factor=p.reluqp_rho_factor,
                        bank=p.reluqp_bank, sigma=p.admm_sigma, alpha=p.admm_alpha,
                        eps_abs=p.admm_eps, eps_rel=p.admm_eps, reg=p.reg,
                        iters=p.reluqp_iters, patience=p.admm_patience,
                        tail_iters=p.reluqp_tail_iters, precision=p.precision,
                        iter_kernel=self._iter_kernel,
                        x0=x0, y_box0=y0, rho_warm=rho_w)
            else:
                # The ADMM: the carry holds the scalings and the Schur
                # factor; ``refresh`` re-equilibrates and refactors, and
                # between refreshes the solve refines against the stale
                # factor.
                def run_solver(l_box, u_box, fac, ref, x0, y0, rho_w):
                    return admm_solve_qp_cached(
                        ctx.static.pattern, qp.vals, qp.b_eq, l_box, u_box, qp.q,
                        fac, ref,
                        rho=p.warm_rho, sigma=p.admm_sigma, alpha=p.admm_alpha,
                        eps_abs=p.admm_eps, eps_rel=p.admm_eps, reg=p.reg,
                        iters=p.admm_iters, patience=p.admm_patience,
                        rho_update_every=p.admm_rho_update_every,
                        matvec_dtype=p.admm_matvec_dtype, precision=p.precision,
                        refine=p.admm_refine, anderson=p.admm_anderson,
                        banded_factor=p.admm_banded_factor,
                        solve_backend=ctx.solve_backend,
                        band_kernel=self._admm_band_kernel,
                        x0=x0, y_box0=y0, rho0=rho_w)

            # Both are warm-started from the receding-horizon shift of the
            # last relaxed solution; the pinned re-solve starts warm from
            # this step's relaxed solution on the factor (or bank) just built.
            relaxed, factor = run_solver(qp.l_box, qp.u_box, factor, refresh,
                                         state.warm_x, state.warm_y_box, state.warm_rho)
            resolve = lambda l2, u2: run_solver(  # noqa: E731
                l2, u2, factor, False, relaxed.x, relaxed.y_box, relaxed.rho)[0]
        if not p.integer_first_action:
            return (relaxed, factor, relaxed,
                    torch.zeros((), dtype=F32, device=self.device))
        sol, repair_failed = self._integerize_first_action(ctx, qp, relaxed, resolve)
        return sol, factor, relaxed, repair_failed

    def _integerize_first_action(self, ctx: _TypeBucket, qp, sol, resolve):
        """Pin the three k=0 duty counts to rounded values (the reference's
        integer duty cycles, dragg/mpc_calc.py:171-173), each bumped one
        count in the comfort-safe direction: the k=1 temperatures are
        affine in the k=0 counts.  ``integer_repair = "project"`` moves the
        k=1 entries by the same affine delta, with no second solve; homes
        whose pinned k=1 temperatures still leave their bands keep the
        relaxed action.  ``"resolve"`` pins the counts in the box and
        re-solves with ``resolve(l_box, u_box)``; homes whose re-solve
        fails keep the relaxed action.  Either way the solved flag and the
        per-home attribution stay the relaxed solve's."""
        lay, st, b = ctx.lay, ctx.static, ctx.batch
        a_in, awr, a_wh = st.a_in, st.awr, st.a_wh
        if len(st.hp_cool_pos):
            # Heat-pump buckets: the k = 0 thermal coefficients are the
            # COP-scaled values assemble wrote into the matrix, read back.
            pc = qp.vals[:, int(st.hp_cool_pos[0])] / a_in
            ph = -qp.vals[:, int(st.hp_heat_pos[0])] / a_in
        else:
            pc, ph = b.hvac_p_c, b.hvac_p_h
        pwh = b.wh_p
        col = lambda a, c: a[:, c]  # noqa: E731
        lo = lambda c: col(qp.l_box, c)  # noqa: E731
        hi = lambda c: col(qp.u_box, c)  # noqa: E731
        clip = lambda v, c: torch.minimum(torch.maximum(v, lo(c)), hi(c))  # noqa: E731
        x = sol.x
        cool_r, heat_r, wh_r = col(x, lay.i_cool), col(x, lay.i_heat), col(x, lay.i_wh)
        pin_c = clip(torch.round(cool_r), lay.i_cool)
        pin_h = clip(torch.round(heat_r), lay.i_heat)
        pin_w = clip(torch.round(wh_r), lay.i_wh)

        # k=1 indoor temp under the pin (row r_tind+0: affine delta).
        def t1_of(pc_pin, ph_pin):
            return col(x, lay.i_tin + 1) + a_in * (
                ph * (ph_pin - heat_r) - pc * (pc_pin - cool_r))

        heat_active = hi(lay.i_heat) > 0.5  # season gate (cool_cap/heat_cap)
        t1 = t1_of(pin_c, pin_h)
        need_up = t1 < lo(lay.i_tin + 1)    # too cold: +heat / -cool
        need_dn = t1 > hi(lay.i_tin + 1)    # too hot: -heat / +cool
        pin_h = torch.where(need_up & heat_active,
                            torch.minimum(pin_h + 1, hi(lay.i_heat)), pin_h)
        pin_c = torch.where(need_up & ~heat_active,
                            torch.maximum(pin_c - 1, lo(lay.i_cool)), pin_c)
        pin_h = torch.where(need_dn & heat_active,
                            torch.maximum(pin_h - 1, lo(lay.i_heat)), pin_h)
        pin_c = torch.where(need_dn & ~heat_active,
                            torch.minimum(pin_c + 1, hi(lay.i_cool)), pin_c)
        # k=1 WH temp under the pin, in both the EV row (r_twhd+0) and the
        # applied row (r_twh1): bump toward whichever bound the worse violates.
        dt1 = t1_of(pin_c, pin_h) - col(x, lay.i_tin + 1)
        dwh = lambda w: awr * dt1 + a_wh * pwh * (w - wh_r)  # noqa: E731
        twh_rows = lambda w: (col(x, lay.i_twh + 1) + dwh(w),  # noqa: E731
                              col(x, lay.i_twh1) + dwh(w))
        ev0, ap0 = twh_rows(pin_w)
        low = torch.minimum(ev0 - lo(lay.i_twh + 1), ap0 - lo(lay.i_twh1))
        high = torch.maximum(ev0 - hi(lay.i_twh + 1), ap0 - hi(lay.i_twh1))
        pin_w = torch.where(low < 0,
                            torch.minimum(pin_w + 1, hi(lay.i_wh)),
                            torch.where(high > 0,
                                        torch.maximum(pin_w - 1, lo(lay.i_wh)),
                                        pin_w))

        if self.params.integer_repair == "resolve":
            cols = [lay.i_cool, lay.i_heat, lay.i_wh]
            pinned = torch.stack([pin_c, pin_h, pin_w], dim=1)
            l2, u2 = qp.l_box.clone(), qp.u_box.clone()
            l2[:, cols] = pinned
            u2[:, cols] = pinned
            sol2 = resolve(l2, u2)
            # Adopt the re-solve only where both solves succeeded.
            keep = sol2.solved & sol.solved
            repair_failed = torch.sum(torch.where(sol.solved & ~sol2.solved,
                                                  ctx.check_mask, 0.0))
            pick = lambda a2, a: torch.where(  # noqa: E731
                keep.reshape(keep.shape + (1,) * (a.ndim - 1)), a2, a)
            return sol._replace(
                x=pick(sol2.x, sol.x), y_eq=pick(sol2.y_eq, sol.y_eq),
                y_box=pick(sol2.y_box, sol.y_box),
                r_prim=pick(sol2.r_prim, sol.r_prim), r_dual=pick(sol2.r_dual, sol.r_dual),
                iters=sol.iters + sol2.iters, rho=pick(sol2.rho, sol.rho)), repair_failed

        dwh1 = dwh(pin_w)
        t1f = col(x, lay.i_tin + 1) + dt1
        t1a = col(x, lay.i_tin1) + dt1
        twh1f, twh1a = twh_rows(pin_w)
        tol = 1e-3  # fp32 row-arithmetic slack
        in_band = (
            (t1f >= lo(lay.i_tin + 1) - tol) & (t1f <= hi(lay.i_tin + 1) + tol)
            & (t1a >= lo(lay.i_tin1) - tol) & (t1a <= hi(lay.i_tin1) + tol)
            & (twh1f >= lo(lay.i_twh + 1) - tol) & (twh1f <= hi(lay.i_twh + 1) + tol)
            & (twh1a >= lo(lay.i_twh1) - tol) & (twh1a <= hi(lay.i_twh1) + tol)
        )
        keep = in_band & sol.solved
        repair_failed = torch.sum(torch.where(sol.solved & ~in_band,
                                              ctx.check_mask, 0.0))
        x2 = x.clone()
        x2[:, [lay.i_cool, lay.i_heat, lay.i_wh]] = torch.stack([pin_c, pin_h, pin_w], dim=1)
        x2[:, lay.i_tin + 1] += dt1
        x2[:, lay.i_tin1] += dt1
        x2[:, lay.i_twh + 1] += dwh1
        x2[:, lay.i_twh1] += dwh1
        return sol._replace(x=torch.where(keep[:, None], x2, x)), repair_failed

    def _per_home_obs(self, ctx: _TypeBucket, sol) -> dict:
        """The observatory fold for one bucket (:func:`per_home_obs`) from
        the solver's per-home vectors; zero-width leaves, and no launch,
        with ``telemetry.per_home = false``."""
        p = self.params
        if not p.obs_per_home:
            z = torch.zeros((0,), dtype=F32, device=self.device)
            zi = torch.zeros((0,), dtype=torch.int32, device=self.device)
            return dict(conv_hist=z.reshape(1, 0), iters_hist=z.reshape(1, 0),
                        iters_sum=z, diverged_count=z, worst_idx=zi,
                        worst_rp=z, worst_rd=z, worst_iters=z, worst_bucket=zi)
        return per_home_obs(primal(sol.r_prim), primal(sol.r_dual), sol.conv_iters,
                            sol.diverged, ctx.check_mask, ctx.home_idx, ctx.ordinal,
                            min(p.obs_worst_k, ctx.n), self._obs_edges)

    def _finish(self, ctx: _TypeBucket, state: CommunityState, t: int, sol,
                aux: StepAux, warm_sol, repair_failed):
        """Merge/collect phase for one bucket: recover the physical series,
        route unsolved homes through the fallback controller, emit
        observables, advance the state."""
        p, lay, b = self.params, ctx.lay, ctx.batch
        H, dt, s, n, dev = p.horizon, p.dt, p.s, ctx.n, self.device
        price_total = aux.price_total
        zeros = torch.zeros((n,), dtype=F32, device=dev)

        mpc = recover_solution(sol.x, lay, b, aux.ghi_w, price_total, s)
        solved = sol.solved
        # Heat-pump homes deliver COP(OAT) thermal watts per electrical
        # watt: the fallback's thermal simulation runs on COP-scaled rates
        # (the electrical p_load below keeps the raw powers).
        pc_fb, ph_fb = b.hvac_p_c, b.hvac_p_h
        if lay.has_hp:
            oat1v = torch.broadcast_to(aux.oat1, (n,))
            cop_c1, cop_h1 = hp_cops(oat1v[:, None], b.hp_cop_base, b.hp_cop_slope)
            pc_fb = pc_fb * (1.0 + b.is_hp * (cop_c1[:, 0] - 1.0))
            ph_fb = ph_fb * (1.0 + b.is_hp * (cop_h1[:, 0] - 1.0))
        counter_inc = torch.where(solved, 0, state.counter + 1)
        ridx = torch.clamp(counter_inc, 0, H - 1).to(torch.long)[:, None]
        fb = fallback_control(
            counter_inc, t, H,
            torch.gather(state.plan_cool, 1, ridx)[:, 0],
            torch.gather(state.plan_heat, 1, ridx)[:, 0],
            torch.gather(state.plan_wh, 1, ridx)[:, 0],
            state.temp_in, aux.temp_wh_init, aux.oat1,
            b.hvac_r, b.hvac_c, pc_fb, ph_fb,
            b.wh_r, b.wh_c, b.wh_p,
            b.temp_in_min, b.temp_in_max, b.temp_wh_min, b.temp_wh_max,
            aux.cool_cap, aux.heat_cap, torch.full((n,), s, dtype=F32, device=dev),
            dt,
        )

        # --- Merge optimal / fallback per home.  The fallback idles the
        # battery and drops PV from p_grid (dragg/mpc_calc.py:590-593).
        pick = lambda a, fbv: torch.where(solved, a, fbv)  # noqa: E731
        cool0 = pick(mpc.cool[:, 0], fb.cool_on)
        heat0 = pick(mpc.heat[:, 0], fb.heat_on)
        wh0 = pick(mpc.wh[:, 0], fb.wh_on)
        p_ch0 = pick(mpc.p_ch[:, 0], zeros)
        p_d0 = pick(mpc.p_disch[:, 0], zeros)
        p_pv0 = pick(mpc.p_pv[:, 0], zeros)
        u_curt0 = pick(mpc.u_curt[:, 0], zeros)
        # EV: the applied k = 0 charge and the SOC it reaches; a vehicle
        # returning between t and t+1 lands with its trip drained.
        if lay.has_ev:
            p_ev0 = pick(mpc.p_ev_ch[:, 0], zeros)
            hod_t = ((p.start_index + t) // dt + self._hour0) % 24
            hod_t1 = ((p.start_index + t + 1) // dt + self._hour0) % 24
            away_now = (hod_t >= b.ev_away_start) & (hod_t < b.ev_away_end)
            away_next = (hod_t1 >= b.ev_away_start) & (hod_t1 < b.ev_away_end)
            e_ev_next = pick(mpc.e_ev[:, 1], state.e_ev)
            e_ev_next = torch.where((b.is_ev > 0) & away_now & ~away_next,
                                    torch.clamp(e_ev_next - b.ev_trip_kwh, min=0.0),
                                    e_ev_next)
        else:
            p_ev0, e_ev_next = zeros, state.e_ev
        p_load0 = b.hvac_p_c * cool0 + b.hvac_p_h * heat0 + b.wh_p * wh0
        p_grid0 = p_load0 + (p_ch0 + p_d0 + p_ev0) - p_pv0
        price0 = price_total[:, 0]
        # Optimal steps record cost on the raw (s-scaled) grid variable,
        # fallback steps on the physical one (dragg/mpc_calc.py:500 vs :594).
        cost0 = torch.where(solved, price0 * s * p_grid0, price0 * p_grid0)
        temp_in_next = pick(mpc.temp_in1, fb.temp_in)
        temp_wh_next = pick(mpc.temp_wh1, fb.temp_wh)
        e_batt_next = pick(mpc.e_batt[:, 1], state.e_batt)
        # forecast = the plan's step-1 grid power; the fallback's p_load.
        fore = mpc.p_grid[:, 1] / s if H > 1 else zeros
        fore = torch.where(solved, fore, p_load0)

        big = torch.tensor(3.4e38, dtype=F32, device=dev)

        def res_max(r):
            r = torch.where(ctx.check_mask > 0, r, 0.0)
            return torch.amax(torch.where(torch.isfinite(r), r, big))

        sel2 = solved[:, None]
        new_state = CommunityState(
            temp_in=temp_in_next,
            temp_wh=temp_wh_next,
            e_batt=e_batt_next,
            e_ev=e_ev_next,
            counter=torch.where(solved, 0, fb.counter).to(torch.int32),
            plan_cool=torch.where(sel2, mpc.cool, state.plan_cool),
            plan_heat=torch.where(sel2, mpc.heat, state.plan_heat),
            plan_wh=torch.where(sel2, mpc.wh, state.plan_wh),
            # Warm starts shift the RELAXED solution, never the pinned one.
            warm_x=(shift_warm_start(warm_sol.x, lay) if self._carry_warm
                    else state.warm_x),
            warm_y_box=(shift_warm_start(warm_sol.y_box, lay) if self._carry_warm
                        else state.warm_y_box),
            warm_rho=warm_sol.rho,
            key=state.key,
        )
        mask = ctx.check_mask
        out = StepOutputs(
            p_grid=p_grid0,
            forecast_p_grid=fore,
            p_load=p_load0,
            temp_in=temp_in_next,
            temp_wh=temp_wh_next,
            hvac_cool_on=cool0 / s,
            hvac_heat_on=heat0 / s,
            wh_heat_on=wh0 / s,
            cost=cost0,
            waterdraws=aux.draw0,
            correct_solve=solved.to(F32),
            p_pv=p_pv0,
            u_pv_curt=u_curt0,
            e_batt=e_batt_next,
            p_batt_ch=p_ch0,
            p_batt_disch=p_d0,
            p_ev_ch=p_ev0,
            e_ev=e_ev_next,
            agg_load=torch.sum(p_grid0 * mask),
            forecast_load=torch.sum(fore * mask),
            agg_cost=torch.sum(cost0 * mask),
            admm_iters=torch.tensor(sol.iters, dtype=torch.int32, device=dev),
            repair_failed=repair_failed,
            r_prim_max=res_max(sol.r_prim),
            r_dual_max=res_max(sol.r_dual),
            bank_fallback_count=(
                torch.sum(torch.where(sol.bank_fallback, mask, 0.0))
                if sol.bank_fallback is not None
                else torch.zeros((), dtype=F32, device=dev)),
            **self._per_home_obs(ctx, sol),
        )
        return new_state, out

    # Merge policy for per-bucket StepOutputs: per-home leaves concatenate
    # in bucket (= community) order, the masked sums add, the solver
    # telemetry scalars take the binding (max) bucket.
    _SUM_OUTPUTS = frozenset(
        {"agg_load", "forecast_load", "agg_cost", "repair_failed",
         "bank_fallback_count"})
    _MAX_OUTPUTS = frozenset({"admm_iters", "r_prim_max", "r_dual_max"})

    def _merge_outputs(self, outs: list) -> StepOutputs:
        merged = {}
        for f in StepOutputs._fields:
            leaves = [getattr(o, f) for o in outs]
            if f in self._SUM_OUTPUTS:
                merged[f] = reduce(torch.add, leaves)
            elif f in self._MAX_OUTPUTS:
                merged[f] = reduce(torch.maximum, leaves)
            else:
                merged[f] = torch.cat(leaves, dim=0)
        return StepOutputs(**merged)

    def _step_bucket(self, ctx, state_b, t, rp, refresh, factor_b):
        """assemble → solve → merge/collect for one bucket."""
        qp, aux = self._prepare(ctx, state_b, t, rp)
        sol, factor_b, warm_sol, repair_failed = self._solve(
            ctx, state_b, qp, factor_b, refresh)
        new_state, out = self._finish(ctx, state_b, t, sol, aux, warm_sol,
                                      repair_failed)
        return new_state, factor_b, out

    def _step(self, state, t: int, rp, refresh: bool, factor):
        """One community timestep: (new_state, new solver carry, outputs).
        Bucketed engines step each bucket at its own shape (state and carry
        are per-bucket tuples) and merge the outputs back into community
        order."""
        wrap = (lambda a: a) if self._bucketed else (lambda a: (a,))
        parts = [self._step_bucket(c, s, t, rp, refresh, f)
                 for c, s, f in zip(self._buckets, wrap(state), wrap(factor))]
        new_states, factors, outs = zip(*parts)
        unwrap = tuple if self._bucketed else (lambda a: a[0])
        return unwrap(new_states), unwrap(factors), self._merge_outputs(list(outs))

    # ------------------------------------------------------------------ api
    def _rp(self, rp) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rp), dtype=F32, device=self.device)

    def step(self, state, t: int, rp) -> tuple:
        """Run a single timestep: (new_state, StepOutputs); ``rp`` is (H,)
        or, per community, (C, H).  A single step always refreshes the
        solver carry."""
        state, _, out = self._step(state, int(t), self._rp(rp), True,
                                   self.init_factor())
        return state, out

    def run_chunk(self, state, t0: int, rps) -> tuple:
        """Run ``rps.shape[0]`` timesteps from sim step ``t0``; ``rps`` is
        (n_steps, H) reward prices (zeros for the baseline case), or
        (n_steps, C, H), one row per community.  Returns
        (final_state, outputs stacked along time).

        The solver carry is chunk-local, as the JAX package's ``_chunk``: it
        refreshes on the chunk's first step, then on every sim step t with
        ``t % admm_refactor_every == 0``, and is dropped at the chunk's end."""
        rps = self._rp(rps)
        K = max(1, self.params.admm_refactor_every)
        factor = self.init_factor()
        outs = []
        for i in range(rps.shape[0]):
            t = int(t0) + i
            state, factor, out = self._step(state, t, rps[i], i == 0 or t % K == 0,
                                            factor)
            outs.append(out)
        return state, StepOutputs(*[torch.stack(leaves) for leaves in zip(*outs)])


def per_home_obs(rp, rd, conv_iters, diverged, check_mask, home_idx, ordinal: int,
                 k: int, edges) -> dict:
    """The observatory fold for one bucket, on the device and without a
    host sync (counterpart of the JAX engine's ``_per_home_obs``): the
    per-home final primal residual ``rp``, dual residual ``rd``,
    convergence iterations and certified-divergence flags of the homes
    whose ``check_mask`` is set, folded into the fixed-bin residual and
    iteration histograms (0/1 weights added with ``index_add_``: exact in
    any order), the masked iteration sum and divergence count, and the
    bucket's ``k`` worst homes by ``rp``.

    Non-finite residuals rank as, and are reported as, the float32-max
    sentinel (the ``r_prim_max`` convention); masked homes score −1 and
    fill a slot only when the bucket has fewer than ``k`` real homes,
    named −1.  Ties (every diverged home scores the sentinel) go to the
    lower index first, as ``lax.top_k``'s do: a stable descending sort.
    ``home_idx`` names each home (int32, its community-major fleet
    index), ``ordinal`` the bucket, ``edges`` the int32 ``OBS_ITER_EDGES``
    on the device."""
    mask = check_mask > 0
    cit = conv_iters.to(torch.int32)
    fin = torch.isfinite(rp)
    w = torch.where(mask, 1.0, 0.0).to(F32)
    logr = torch.log10(torch.clamp(torch.where(fin, rp, 1.0), 1e-30, 1e30))
    rbin = torch.clamp(
        torch.floor((logr - OBS_RES_LOG_LO) / OBS_RES_LOG_STEP).to(torch.int32) + 1,
        0, OBS_RES_BINS - 2)
    rbin = torch.where(diverged | ~fin, OBS_RES_BINS - 1, rbin)
    rhist = torch.zeros((OBS_RES_BINS,), dtype=F32, device=rp.device).index_add_(
        0, rbin.to(torch.int64), w)
    ibin = torch.searchsorted(edges, cit, right=False)
    ihist = torch.zeros((OBS_ITER_BINS,), dtype=F32, device=rp.device).index_add_(
        0, ibin, w)
    iters_sum = torch.sum(torch.where(mask, cit.to(F32), 0.0))
    div_count = torch.sum(torch.where(mask, diverged.to(F32), 0.0))
    # Python scalars, not device tensors made from them: a host-to-device
    # copy would wait for the stream.
    rp_s = torch.where(fin, rp, 3.4e38)
    rd_s = torch.where(torch.isfinite(rd), rd, 3.4e38)
    score = torch.where(mask, rp_s, -1.0)
    top_s, top_ix = torch.sort(score, descending=True, stable=True)
    top_s, top_ix = top_s[:k], top_ix[:k]
    return dict(
        conv_hist=rhist[None, :],
        iters_hist=ihist[None, :],
        iters_sum=iters_sum[None],
        diverged_count=div_count[None],
        worst_idx=torch.where(top_s >= 0, home_idx[top_ix], -1).to(torch.int32),
        worst_rp=rp_s[top_ix],
        worst_rd=rd_s[top_ix],
        worst_iters=cit[top_ix].to(F32),
        worst_bucket=torch.full((k,), ordinal, dtype=torch.int32, device=rp.device),
    )


def engine_params(config, start_index: int) -> EngineParams:
    """The static engine configuration from a validated config dict.
    Settings outside this package's slice raise NotImplementedError naming
    their config key."""
    from dragg_tpu_torch.config import resolve_solver_family

    hems = config["home"]["hems"]
    dt = int(config["agg"]["subhourly_steps"])
    tpu_cfg = config.get("tpu", {})
    horizon = max(1, int(hems["prediction_horizon"]) * dt)
    solver = resolve_solver_family(config)
    repair_mode = str(tpu_cfg.get("integer_repair", "project"))
    if repair_mode not in ("project", "resolve"):
        raise ValueError(
            f"tpu.integer_repair must be project|resolve, got {repair_mode!r}")
    bucketed = str(tpu_cfg.get("bucketed", "auto")).lower()
    if bucketed not in ("auto", "true", "false"):
        raise ValueError(
            f"tpu.bucketed must be auto|true|false, got "
            f"{tpu_cfg.get('bucketed')!r}")
    kern = str(tpu_cfg.get("band_kernel", "auto"))
    if kern not in ("auto", "pallas", "xla", "cr"):
        raise ValueError(
            f"tpu.band_kernel must be auto|pallas|xla|cr, got {kern!r}")
    precision = validate_precision(str(tpu_cfg.get("precision", "f32")))
    iter_kernel = str(tpu_cfg.get("iter_kernel", "auto"))
    if iter_kernel not in ("auto", "pallas", "lax"):
        raise ValueError(
            f"tpu.iter_kernel must be auto|pallas|lax, got {iter_kernel!r}")
    if iter_kernel == "pallas" and precision != "f32":
        raise ValueError(
            "tpu.iter_kernel='pallas' requires tpu.precision='f32': the fused "
            "window computes its residual maxima in the kernel and is f32 "
            "end to end")
    return EngineParams(
        solver=solver,
        horizon=horizon,
        dt=dt,
        s=float(max(1, int(hems["sub_subhourly_steps"]))),
        discount=float(hems["discount_factor"]),
        start_index=int(start_index),
        reg=float(tpu_cfg.get("admm_reg", 1e-3)),
        warm_rho=float(tpu_cfg.get("admm_rho", 0.1)),
        admm_eps=float(tpu_cfg.get("admm_eps", 1e-4)),
        admm_sigma=float(tpu_cfg.get("admm_sigma", 1e-6)),
        admm_alpha=float(tpu_cfg.get("admm_alpha", 1.6)),
        admm_patience=int(tpu_cfg.get("admm_patience", 4)),
        admm_refactor_every=int(tpu_cfg.get("admm_refactor_every", 8)),
        admm_iters=int(tpu_cfg.get("admm_iters", 1500)),
        admm_rho_update_every=int(tpu_cfg.get("admm_rho_update_every", 4)),
        admm_matvec_dtype=str(tpu_cfg.get("admm_matvec_dtype", "f32")),
        admm_refine=int(tpu_cfg.get("admm_refine", 0)),
        admm_anderson=int(tpu_cfg.get("admm_anderson", 0)),
        admm_banded_factor=bool(tpu_cfg.get("admm_banded_factor", True)),
        admm_solve_backend=str(tpu_cfg.get("admm_solve_backend", "auto")),
        reluqp_rho=float(tpu_cfg.get("reluqp_rho", 0.1)),
        reluqp_rho_factor=float(tpu_cfg.get("reluqp_rho_factor", 6.0)),
        reluqp_bank=max(1, int(tpu_cfg.get("reluqp_bank", 5))),
        reluqp_iters=int(tpu_cfg.get("reluqp_iters", 2000)),
        reluqp_tail_iters=int(tpu_cfg.get("reluqp_tail_iters", 300)),
        precision=precision,
        iter_kernel=iter_kernel,
        # 0 = horizon-aware default (iterations needed grow with H).
        ipm_iters=int(tpu_cfg.get("ipm_iters", 0)) or 16 + horizon // 2,
        ipm_tail_frac=float(tpu_cfg.get("ipm_tail_frac", 0.25)),
        ipm_tail_iters=int(tpu_cfg.get("ipm_tail_iters", 0)),
        ipm_warm=bool(tpu_cfg.get("ipm_warm_start", False)),
        ipm_eps=float(tpu_cfg.get("ipm_eps", 2e-4)),
        ipm_freeze_zmax=float(tpu_cfg.get("ipm_freeze_zmax", 300.0)),
        band_fused=bool(tpu_cfg.get("band_fused", False)),
        band_kernel=kern,
        integer_first_action=bool(tpu_cfg.get("integer_first_action", True)),
        integer_repair=repair_mode,
        repair_eps=float(tpu_cfg.get("repair_eps", 1e-3)),
        forecast_noise_cap=float(tpu_cfg.get("forecast_noise_cap", 3.0)),
        bucketed=bucketed,
        seed=int(config["simulation"]["random_seed"]),
        obs_per_home=bool(config.get("telemetry", {}).get("per_home", True)),
        obs_worst_k=max(1, int(config.get("telemetry", {}).get("worst_k", 8))),
    )


def check_mask_for(batch, config) -> np.ndarray:
    """check_type → aggregate-reduction mask (dragg/aggregator.py:767-770)."""
    check_type = config["simulation"].get("check_type", "all")
    if check_type == "all":
        return np.ones(batch.n_homes)
    return (np.asarray(batch.type_code) == TYPE_CODES[check_type]).astype(np.float64)


def resolve_engine_events(config, env, params, fleet=None, data_dir=None):
    """The event timeline of the config's ``[scenarios]`` table for this
    fleet size and environment span (None when it schedules nothing)."""
    from dragg_tpu_torch.scenarios import timeline_for

    n_comm = 1 if fleet is None else fleet.n_communities
    return timeline_for(config, n_comm, len(np.asarray(env.oat)), params.dt,
                        params.start_index, data_dir=data_dir)


def env_hour0(env) -> int:
    """Hour of day at environment-series index 0 (``env.data_start``)."""
    ds = getattr(env, "data_start", None)
    return int(ds.hour) if ds is not None else 0


def make_engine(batch, env, config, start_index: int, device=None, fleet=None,
                events=None, data_dir=None) -> Engine:
    """An :class:`Engine` from a host HomeBatch + EnvironmentData +
    validated config dict, on ``device`` (None = the CUDA card).
    ``fleet`` (a ``homes.FleetSpec`` from ``build_fleet_batch``) folds C
    communities into the home axis; ``events`` overrides the event
    timeline (default: resolved from the config's ``[scenarios]``)."""
    params = engine_params(config, start_index)
    if events is None:
        events = resolve_engine_events(config, env, params, fleet=fleet, data_dir=data_dir)
    return Engine(params, batch, env.oat, env.ghi, env.tou,
                  check_mask=check_mask_for(batch, config), device=device,
                  fleet=fleet, events=events, hour0=env_hour0(env))
