"""Community aggregator — host-side orchestration around the engine
(counterpart of ``dragg_tpu/aggregator.py``).

Config + weather + price ingestion, seeded home synthesis (with the
``all_homes-<N>-config.json`` cache), the baseline simulation loop as
chunks of engine steps with a resumable checkpoint at every chunk
boundary, per-home data collection, the utility setpoint, and
results.json in the reference's directory layout.  The RL cases
(``simulation.run_rl_agg``, ``run_rl_simplified``) run after the
baseline, through :mod:`dragg_tpu_torch.rl.runner`.

The chunk loop is a two-slot host pipeline (``fleet.pipeline``, default
on): once chunk N has run, its outputs and the state after it are copied
into one of two host slots, and a worker thread collects them, rewrites
results.json and writes the checkpoint while the main thread drives chunk
N+1 on the card.  ``simulation.resume = true`` restores the latest
checkpoint.

A fleet (``fleet.communities > 1``) runs C communities, each drawn with
its own seed and seeing its own weather offset, in one engine; the home
list and results.json are community-major.  A ``[scenarios]`` pack
expands into the home mix and the event timeline before anything reads
them; a fleet's RL cases train one policy (or one per community) on all
C communities (:mod:`dragg_tpu_torch.rl.fleet`).

Sharding (``tpu.sharded``, :mod:`dragg_tpu_torch.parallel`): in a world of
several ranks (one process per card, ``$DRAGG_DISTRIBUTED=1`` or
``torchrun``) ``"auto"`` and ``true`` run a ``ShardedEngine`` on the
rank's block of homes; every rank drives the same chunk loop, rank 0
gathers the per-home rows and alone writes results.json and the
telemetry, and checkpoints are per-rank shard files published by the JAX
package's barrier protocol.  ``true`` without a group runs the world of
one, as the JAX package does on a host with one device.

Telemetry (``[telemetry]``, on by default as in the JAX package): the run
opens the bus (:mod:`dragg_tpu_torch.telemetry`) at
``<run_dir>/events.jsonl`` and writes ``run.start``, then for each chunk
``chunk.done`` and the observatory's ``solver.convergence`` (one a
bucket), ``solver.worst`` and ``solver.diverged`` from the fold the
engine's step carried home, then ``run.end`` and ``metrics.json``.
``telemetry.forensics`` dumps the chunk's worst homes to
``<run_dir>/forensics/``; ``tpu.profile_dir`` traces the second chunk
with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dragg_tpu_torch import telemetry
from dragg_tpu_torch.checkpoint import (
    host_snapshot,
    latest_checkpoint_dir,
    load_progress,
    load_pytree,
    load_pytree_local,
    save_checkpoint_dir,
    save_progress,
    save_pytree_local,
    shard_file_name,
    tree_flatten,
    tree_unflatten,
)
from dragg_tpu_torch.collector import SeriesCollector
from dragg_tpu_torch.config import configured_solver, default_config, load_config
from dragg_tpu_torch.data import (
    EnvironmentData,
    load_environment,
    load_waterdraw_profiles,
    parse_dt,
    waterdraw_path,
)
from dragg_tpu_torch.device import resolve_device
from dragg_tpu_torch.engine import OBS_FIELDS, Engine, StepOutputs, make_engine
from dragg_tpu_torch.homes import (
    build_fleet_batch,
    check_home_configs,
    create_fleet_homes,
    fleet_community_base,
    fleet_config,
)
from dragg_tpu_torch.layout import date_folder_name, run_dir_name
from dragg_tpu_torch.logger import Logger
from dragg_tpu_torch.parallel.mesh import make_sharded_engine, rank_device
from dragg_tpu_torch.parallel.world import current_world
from dragg_tpu_torch.resilience.devices import device_count
from dragg_tpu_torch.resilience.faults import fault_hook
from dragg_tpu_torch.resilience.heartbeat import beat
from dragg_tpu_torch.scenarios import apply_scenarios, describe_timeline, timeline_digest

# Per-home series appended each timestep, in the reference's result-hash
# vocabulary (dragg/aggregator.py:741-745) → StepOutputs field name.
_BASE_KEYS = {
    "p_grid_opt": "p_grid",
    "forecast_p_grid_opt": "forecast_p_grid",
    "p_load_opt": "p_load",
    "temp_in_opt": "temp_in",
    "temp_wh_opt": "temp_wh",
    "hvac_cool_on_opt": "hvac_cool_on",
    "hvac_heat_on_opt": "hvac_heat_on",
    "wh_heat_on_opt": "wh_heat_on",
    "cost_opt": "cost",
    "waterdraws": "waterdraws",
    "correct_solve": "correct_solve",
}
_PV_KEYS = {"p_pv_opt": "p_pv", "u_pv_curt_opt": "u_pv_curt"}
_BATT_KEYS = {"e_batt_opt": "e_batt", "p_batt_ch": "p_batt_ch", "p_batt_disch": "p_batt_disch"}
_EV_KEYS = {"p_ev_ch_opt": "p_ev_ch", "e_ev_opt": "e_ev"}
_SERIES_KEYS = {**_BASE_KEYS, **_PV_KEYS, **_BATT_KEYS, **_EV_KEYS}

# The observatory's per-bucket conv-iters metrics, one registered literal
# a home type; a bucket that is absent never observes.
_CONV_ITERS_METRICS = {
    "pv_battery": "solver.conv_iters_pv_battery",
    "pv_only": "solver.conv_iters_pv_only",
    "battery_only": "solver.conv_iters_battery_only",
    "base": "solver.conv_iters_base",
    "ev": "solver.conv_iters_ev",
    "heat_pump": "solver.conv_iters_heat_pump",
    "superset": "solver.conv_iters_superset",
}


class Aggregator:
    """Drop-in analog of the JAX package's Aggregator.

    Parameters
    ----------
    config : dict | str | None
        A validated config dict, a path to a TOML file, or None to resolve
        via ``$DATA_DIR/$CONFIG_FILE``.
    data_dir : str | None
        Where to look for nsrdb.csv / waterdraw profiles (``$DATA_DIR``).
    outputs_dir : str
        Root of the run-directory tree.
    device : str | torch.device | None
        Where the engine runs; None means the CUDA card (and raises when
        there is none — pass ``device="cpu"`` explicitly); in a world of
        several ranks, the rank's card, ``cuda:{local_rank}``.
    """

    def __init__(self, config=None, data_dir=None, outputs_dir="outputs",
                 device=None):
        # The process's ranks (parallel.init_from_env); the world of one
        # without a group.
        self.world = current_world()
        self.device = resolve_device(rank_device(self.world, device))
        self.log = Logger("aggregator")
        resolved = data_dir if data_dir is not None else os.path.expanduser(
            os.environ.get("DATA_DIR", "data"))
        explicit = data_dir is not None or "DATA_DIR" in os.environ
        self.data_dir = resolved if (explicit or os.path.isdir(resolved)) else None
        self.outputs_dir = outputs_dir
        os.makedirs(self.outputs_dir, exist_ok=True)

        self.config = config if isinstance(config, dict) else load_config(config)
        self.config = apply_scenarios(self.config, self.data_dir)
        sharded = self.config.get("tpu", {}).get("sharded", "auto")
        if sharded not in ("auto", True, False):
            raise ValueError(
                f"tpu.sharded must be 'auto', true, or false, got {sharded!r}")
        # [fleet]: C communities in one engine; community.total_number_homes
        # stays per community.  community_base is the global index of the
        # first: it shifts the seeds, the names and the weather.
        (self.n_communities, self._fleet_seed_stride,
         self._fleet_weather_off_h) = fleet_config(self.config)
        self._fleet_comm_base = fleet_community_base(self.config)
        self._check_rl_fleet()
        self.check_type = self.config["simulation"]["check_type"]
        self.case = "baseline"

        # Simulation window (dragg/aggregator.py:111-127).
        self.start_dt = parse_dt(self.config["simulation"]["start_datetime"])
        self.end_dt = parse_dt(self.config["simulation"]["end_datetime"])
        self.hours = int((self.end_dt - self.start_dt).total_seconds() / 3600)
        self.dt = int(self.config["agg"]["subhourly_steps"])
        self.num_timesteps = int(np.ceil(self.hours * self.dt))

        # The last community's weather runs (base + C - 1) · offset hours
        # ahead, so the series must cover that much past the horizon.
        self.env: EnvironmentData = load_environment(self.config, data_dir=self.data_dir)
        self.env.check_coverage(
            self.start_dt, self.end_dt,
            int(self.config["home"]["hems"]["prediction_horizon"])
            + (self._fleet_comm_base + self.n_communities - 1) * self._fleet_weather_off_h)
        self.start_index = self.env.start_index(self.start_dt)

        self.all_homes: list[dict] | None = None
        self.engine: Engine | None = None
        self.timestep = 0
        self.baseline_agg_load_list: list[float] = []
        self.all_rps = np.zeros(self.num_timesteps)
        self.all_sps = np.zeros(self.num_timesteps)
        self.agg_load = 0.0
        self.agg_cost = 0.0
        self.forecast_load = 0.0
        self.start_time = None
        self.end_time = None
        self.extra_summary: dict = {}  # case-specific Summary additions
        self.summary_only_case = False  # results.json without per-home blocks
        self.agent = None  # the RL agent of the last RL case run
        self.fleet_env = None  # a fleet RL run's environment carry after its last step
        self.collector: SeriesCollector | None = None
        self._home_static: dict = {}
        self.version = self.config["simulation"].get("named_version", "test")
        self.run_dir = None
        self._solve_iters: list[int] = []
        # Home-steps that needed ReLU-QP's exact-refactorization tail
        # (StepOutputs.bank_fallback_count summed; 0 for the IPM), since
        # the run started or resumed.
        self.bank_fallback_total = 0.0
        self.resumed_from: str | None = None  # checkpoint dir a run resumed from
        # Stop after N chunks (None: run to the end).  Each chunk ends at a
        # checkpoint, so stopping is a kill right after one: the hook the
        # resume tests and staged runs use.
        self.stop_after_chunks: int | None = None
        # Whether THIS aggregator opened the telemetry bus (run() →
        # _telemetry_open): the emits gate on it, not on telemetry.active(),
        # which a $DRAGG_TELEMETRY_DIR export would turn on regardless of
        # telemetry.enabled.
        self._telemetry_on = False
        self._forensics_on = False  # telemetry.forensics, set with the bus
        # The state at the start of the chunk being collected (host copy or
        # tensors): what a forensic dump slices.
        self._chunk_state0 = None
        self._next_state0 = None

    def _check_rl_fleet(self) -> None:
        """A fleet's RL cases: the ``[rl.fleet]`` table's ValueErrors, and
        for ``run_rl_agg`` under ``gradient = "mpc"`` a kernel route's
        (``rl.fleet.check_mpc_route``), before anything runs."""
        from dragg_tpu_torch.rl.fleet import check_mpc_route, fleet_params_from_config

        sim = self.config["simulation"]
        if self.n_communities > 1 and (sim.get("run_rl_agg", False)
                                       or sim.get("run_rl_simplified", False)):
            fleet_params_from_config(self.config, self.n_communities)
            if sim.get("run_rl_agg", False):
                check_mpc_route(self.config, self.device.type)

    # ----------------------------------------------------------- population
    @property
    def total_homes(self) -> int:
        """Homes across the whole fleet (the per-community count × C)."""
        return int(self.config["community"]["total_number_homes"]) * self.n_communities

    def _homes_cache_file(self) -> str:
        """``all_homes-<N>-config.json``; a fleet's name carries the
        community count too, so a 2 × 500 fleet and a 1,000-home
        community never reuse each other's population."""
        n = self.total_homes
        tag = f"{n}" if self.n_communities == 1 else f"{n}-{self.n_communities}comm"
        return os.path.join(self.outputs_dir, f"all_homes-{tag}-config.json")

    def get_homes(self) -> None:
        """Create or reload the home population: reuse
        ``all_homes-<N>-config.json`` unless overwrite_existing.  A fleet's
        is C communities, each drawn with its own seed, in one
        community-major list; each community is checked against the
        (per-community) config counts."""
        homes_file = self._homes_cache_file()
        if not self.config["community"].get("overwrite_existing", True) and os.path.isfile(homes_file):
            with open(homes_file) as f:
                self.all_homes = json.load(f)
        else:
            waterdraw = load_waterdraw_profiles(
                waterdraw_path(self.config, self.data_dir),
                seed=int(self.config["simulation"]["random_seed"]))
            self.all_homes = create_fleet_homes(
                self.config, self.num_timesteps, self.dt, waterdraw)
        B = len(self.all_homes) // self.n_communities
        for c in range(self.n_communities):
            check_home_configs(self.all_homes[c * B:(c + 1) * B], self.config)
        self.write_home_configs()

    def write_home_configs(self) -> None:
        """Persist the population (dragg/aggregator.py:846-854), atomically:
        every rank of a sharded run writes the same file."""
        path = self._homes_cache_file()
        tmp = f"{path}.tmp{self.world.rank}"
        with open(tmp, "w") as f:
            json.dump(self.all_homes, f, indent=4)
        os.replace(tmp, path)

    def reset_seed(self, new_seed: int) -> None:
        """Reset the population seed (dragg/aggregator.py:255-261); takes
        effect on the next ``get_homes()``."""
        self.config["simulation"]["random_seed"] = int(new_seed)

    def _build_engine(self) -> None:
        hems = self.config["home"]["hems"]
        horizon = max(1, int(hems["prediction_horizon"]) * self.dt)
        # A fleet's batch is type-major (each type's homes of every
        # community together, one QP pattern a type); real_home_cols maps
        # the outputs back to the community-major all_homes order.
        batch, fleet = build_fleet_batch(self.all_homes, self.config, horizon,
                                         self.dt, int(hems["sub_subhourly_steps"]))
        # Several ranks shard the home axis ("auto"); true/false force it.
        # Each rank builds the whole padded batch and keeps its block.
        sharded = self.config.get("tpu", {}).get("sharded", "auto")
        if sharded == "auto" and device_count() > 1 or sharded is True:
            self.engine = make_sharded_engine(
                batch, self.env, self.config, self.start_index, world=self.world,
                device=self.device, fleet=fleet, data_dir=self.data_dir)
            self.log.logger.info(
                f"sharded engine: {self.world.size} ranks on axis "
                f"{self.engine.axis_name!r} (rank {self.world.rank}, "
                f"{self.engine.n_local} slots here), {self.engine.n_homes} home "
                f"slots ({self.engine.true_n_homes} real)")
        else:
            self.engine = make_engine(batch, self.env, self.config, self.start_index,
                                      device=self.device, fleet=fleet,
                                      data_dir=self.data_dir)
        if fleet is not None:
            self.log.logger.info(
                f"fleet engine: {fleet.n_communities} communities × "
                f"{fleet.homes_per_community} homes (seeds {fleet.seeds[0]}.."
                f"{fleet.seeds[-1]}, weather offset {self._fleet_weather_off_h} "
                f"h/community)")
        if self.engine.events is not None:
            self.log.logger.info(
                f"scenario event timeline: {describe_timeline(self.engine.events)}")
        if self.engine.bucketed:
            self.log.logger.info(
                "type-bucketed engine: " + ", ".join(
                    f"{b['name']}×{b['n_real']} (m={b['m_eq']}, n={b['n_var']})"
                    for b in self.engine.bucket_info()))

    # ------------------------------------------------------------- data mgmt
    def _home_selected(self, home: dict) -> bool:
        """check_type selection (dragg/aggregator.py:767-770)."""
        return self.check_type == "all" or home["type"] == self.check_type

    def _home_keys(self, home: dict) -> list[str]:
        keys = list(_BASE_KEYS)
        if "pv" in home["type"]:
            keys += list(_PV_KEYS)
        if "battery" in home["type"]:
            keys += list(_BATT_KEYS)
        if home["type"] == "ev":
            keys += list(_EV_KEYS)
        return keys

    def reset_collected_data(self) -> None:
        """Initialize the per-home series store with the leading initial
        elements (dragg/aggregator.py:589-615)."""
        self.timestep = 0
        self.baseline_agg_load_list = []
        self._solve_iters = []
        self.bank_fallback_total = 0.0
        self.extra_summary = {}
        # Summary.phase_times: ``device_chunks`` the main thread's seconds
        # in run_chunk; ``collect`` the host's collect of a chunk's
        # outputs; ``state_snapshot`` the main thread's seconds staging a
        # chunk's outputs and state into a host slot; ``overlap_hidden_s``
        # the host work (collect, results.json, checkpoint) that ran while
        # the next chunk was still being driven (a lower bound: a window
        # that outlasts that chunk is not credited).
        self._phase_times = {"device_chunks": 0.0, "collect": 0.0,
                             "overlap_hidden_s": 0.0, "state_snapshot": 0.0}
        n = len(self.all_homes)
        self.collector = SeriesCollector(n)
        self._home_static = {}
        init = {k: np.zeros((1, n)) for k in ("temp_in_opt", "temp_wh_opt", "e_batt_opt")}
        for i, home in enumerate(self.all_homes):
            self._home_static[home["name"]] = {
                "type": home["type"],
                "temp_in_sp": home["hvac"]["temp_in_sp"],
                "temp_wh_sp": home["wh"]["temp_wh_sp"],
            }
            init["temp_in_opt"][0, i] = home["hvac"]["temp_in_init"]
            init["temp_wh_opt"][0, i] = home["wh"]["temp_wh_init"]
            if "battery" in home["type"]:
                init["e_batt_opt"][0, i] = home["battery"]["e_batt_init"]
        for key, arr in init.items():
            self.collector.add_chunk(key, arr)

    def _collect_chunk(self, outs: StepOutputs, track_setpoints: bool = True,
                       device_s: float | None = None, device_observed: bool = False) -> None:
        """Append a chunk of stacked step outputs, host arrays, to the
        series store, emit the chunk's telemetry, then track the setpoint
        per step.  ``track_setpoints=False`` skips the host's
        ``gen_setpoint``: the RL aggregator tracks the setpoint on the
        device and writes ``all_sps`` itself.

        ``device_s`` (the caller's seconds driving the chunk) feeds the
        step-latency telemetry (``device_observed``: a span already
        observed it).  The solver telemetry and the observatory ride the
        same host copy as the series: StepOutputs carries them.

        A sharded engine's per-home rows are its rank's block: they are
        gathered to rank 0 (``engine.gather_homes``), which alone collects
        the series, logs the failed homes and emits; every rank keeps the
        totals and the setpoint tracker."""
        # Per-home columns in all_homes order (a fleet's batch is type-major);
        # the observatory's leaves are per bucket, not per home.
        host = outs._asdict()
        per_home = {f: a for f, a in host.items() if a.ndim == 2 and f not in OBS_FIELDS}
        whole = self.engine.gather_homes(per_home)
        writer = whole is not None
        if writer:
            cols = self.engine.real_home_cols
            host.update({f: a[:, cols] for f, a in whole.items()})
            for out_key, field in _SERIES_KEYS.items():
                self.collector.add_chunk(out_key, host[field])
        n_steps = host["agg_load"].shape[0]
        agg_loads = host["agg_load"]
        self.baseline_agg_load_list.extend(float(v) for v in agg_loads)
        self._solve_iters.extend(int(v) for v in host["admm_iters"])
        self.bank_fallback_total += float(np.sum(host["bank_fallback_count"]))
        # $VERBOSE: one solver line a chunk, the reference's per-solve
        # verbosity toggle (dragg/mpc_calc.py:81-86) batched per chunk.
        if os.environ.get("VERBOSE") and writer:
            rate = float(host["correct_solve"].mean())
            self.log.logger.progress(
                f"chunk t={self.timestep}..{self.timestep + n_steps}: "
                f"solve_rate={rate:.4f}, "
                f"mean ADMM iters={host['admm_iters'].mean():.0f}, "
                f"agg_load range=[{agg_loads.min():.1f}, {agg_loads.max():.1f}] kW")
        n_repair_failed = float(np.sum(host["repair_failed"]))
        if self._telemetry_on:
            # One typed record per chunk on the run's stream.
            rate = float(host["correct_solve"].mean())
            mean_iters = float(host["admm_iters"].mean())
            rpm = float(host["r_prim_max"].max())
            rdm = float(host["r_dual_max"].max())
            fields = dict(t0=self.timestep, t1=self.timestep + n_steps,
                          n_steps=n_steps, solve_rate=round(rate, 4),
                          solver_iters=round(mean_iters, 1),
                          r_prim_max=rpm, r_dual_max=rdm,
                          repair_failed=int(n_repair_failed))
            if device_s is not None:
                fields["device_s"] = round(device_s, 3)
                fields["steps_per_s"] = round(n_steps / max(device_s, 1e-9), 3)
                if not device_observed:
                    telemetry.observe("engine.chunk_device_s", device_s)
                telemetry.observe("engine.chunk_steps_per_s", fields["steps_per_s"])
            telemetry.emit("chunk.done", **fields)
            telemetry.observe("engine.solve_iters", mean_iters)
            telemetry.set_gauge("engine.solve_rate", rate)
            telemetry.set_gauge("engine.r_prim_max", rpm)
            telemetry.set_gauge("engine.r_dual_max", rdm)
            telemetry.set_gauge("sim.timestep", self.timestep + n_steps)
            if n_repair_failed:
                telemetry.inc("engine.repair_failed", n_repair_failed)
            self._emit_observatory(host, n_steps)
        if n_repair_failed > 0 and writer:
            self.log.logger.progress(
                f"chunk t={self.timestep}..{self.timestep + n_steps}: "
                f"{int(n_repair_failed)} integer pins left the comfort band "
                f"(homes kept the relaxed fractional action)")
        if writer:
            self._log_home_failures(host["correct_solve"])
        # Ordering parity: the reference increments the timestep before
        # gen_setpoint, and the setpoint computed after step t is recorded
        # at step t+1 (dragg/aggregator.py:671-673,726,755).
        for k in range(n_steps):
            self.agg_load = float(agg_loads[k])
            self.forecast_load = float(host["forecast_load"][k])
            self.agg_cost = float(host["agg_cost"][k])
            self.timestep += 1
            if track_setpoints:
                self.agg_setpoint = self.gen_setpoint()
                if self.timestep < self.num_timesteps:
                    self.all_sps[self.timestep] = self.agg_setpoint

    def _emit_observatory(self, host: dict, n_steps: int) -> None:
        """The observatory's emits for one chunk: the per-bucket histograms
        and worst-k captures the engine folded on the device
        (``engine.per_home_obs``) → ``solver.convergence`` (one a bucket),
        ``solver.diverged`` (when any home diverged), ``solver.worst`` (the
        chunk's k worst homes, each at its worst step) and the per-bucket
        conv-iters metrics; then the forensic dump when
        ``telemetry.forensics`` is on."""
        if not self.engine.obs_enabled:
            return
        ch = np.asarray(host["conv_hist"])            # (T, nb, RBINS)
        if ch.size == 0:
            return
        t0, t1 = self.timestep, self.timestep + n_steps
        binfo = self.engine.bucket_info()
        isum = np.asarray(host["iters_sum"])          # (T, nb)
        dc = np.asarray(host["diverged_count"])       # (T, nb)
        ih = np.asarray(host["iters_hist"])
        for bi, b in enumerate(binfo):
            rhist = ch[:, bi, :].sum(axis=0)
            n_obs = float(rhist.sum())
            mean_iters = float(isum[:, bi].sum()) / max(n_obs, 1.0)
            telemetry.emit(
                "solver.convergence", t0=t0, t1=t1, bucket=b["name"],
                n_homes=b["n_real"],
                rprim_hist=[int(v) for v in rhist],
                iters_hist=[int(v) for v in ih[:, bi, :].sum(axis=0)],
                mean_iters=round(mean_iters, 2),
                diverged=int(dc[:, bi].sum()))
            telemetry.observe(_CONV_ITERS_METRICS[b["name"]], mean_iters)
        total_div = float(dc.sum())
        if total_div:
            telemetry.inc("solver.diverged_homes", total_div)
            telemetry.emit(
                "solver.diverged", t0=t0, t1=t1, total=int(total_div),
                by_bucket={b["name"]: int(dc[:, bi].sum())
                           for bi, b in enumerate(binfo)
                           if dc[:, bi].sum() > 0})
        # The chunk's worst k across its (step, bucket) captures (idx −1 =
        # an empty slot of a bucket with fewer than k homes).
        wi = np.asarray(host["worst_idx"])            # (T, nb·k)
        wrp = np.asarray(host["worst_rp"])
        wrd = np.asarray(host["worst_rd"])
        wit = np.asarray(host["worst_iters"])
        wb = np.asarray(host["worst_bucket"])
        ti, si = np.nonzero(wi >= 0)
        if ti.size == 0:
            return
        k = int(self.engine.params.obs_worst_k)
        # The fold reports non-finite residuals as the float32-max sentinel;
        # the where guards a NaN, which argsort would put last whatever its
        # sign, dropping the very homes the capture names.
        rank = wrp[ti, si]
        rank = np.where(np.isfinite(rank), rank, np.float32(3.4e38))
        order = np.argsort(-rank, kind="stable")
        # One entry a home, at its worst step: a home diverging all chunk
        # would otherwise fill every slot.
        entries, seen = [], set()
        for t, s in zip(ti[order], si[order]):
            home = int(wi[t, s])
            if home in seen:
                continue
            seen.add(home)
            entries.append(
                dict(home=home,
                     bucket=binfo[int(wb[t, s])]["name"],
                     t=t0 + int(t),
                     r_prim=float(wrp[t, s]), r_dual=float(wrd[t, s]),
                     iters=int(wit[t, s])))
            if len(entries) >= k:
                break
        telemetry.emit("solver.worst", t0=t0, t1=t1, homes=entries)
        telemetry.set_gauge("solver.worst_rprim", entries[0]["r_prim"])
        if self._forensics_on:
            self._write_forensics(t0, t1, entries)

    def _write_forensics(self, t0: int, t1: int, entries: list[dict]) -> None:
        """``telemetry.forensics``: one ``forensics/chunk_t<t0>.json`` a
        chunk with what an offline re-solve of the worst homes needs
        without re-running the community: each home's config, its scalar
        state at the chunk's start (``engine.state_slice``), its worst
        step and the chunk's reward prices."""
        if self.run_dir is None:
            return
        state0 = self._chunk_state0
        p = self.engine.params
        dump = {
            "t0": t0, "t1": t1, "case": self.case,
            "start_index": int(p.start_index),
            "solver": p.solver,
            "horizon": int(p.horizon),
            "integer_first_action": bool(p.integer_first_action),
            "integer_repair": p.integer_repair,
            "buckets": self.engine.bucket_info(),
            "reward_prices": [float(v) for v in self.all_rps[t0:t1]],
            "note": ("state_at_chunk_start is the carried state at t0; "
                     "replaying t0..t for one home reproduces the exact "
                     "(t, state, QP coefficients) of the worst step"),
            "homes": [
                {**e,
                 "name": self.all_homes[e["home"]]["name"],
                 "type": self.all_homes[e["home"]]["type"],
                 "state_at_chunk_start": (
                     self.engine.state_slice(state0, e["home"])
                     if state0 is not None else None),
                 "config": self.all_homes[e["home"]]}
                for e in entries
            ],
        }
        fdir = os.path.join(self.run_dir, "forensics")
        try:
            os.makedirs(fdir, exist_ok=True)
            path = os.path.join(fdir, f"chunk_t{t0:08d}.json")
            with open(path + ".tmp", "w") as f:
                json.dump(dump, f, indent=1, default=str)
            os.replace(path + ".tmp", path)
        except OSError:
            pass  # forensics never kill the run

    def _log_home_failures(self, correct_solve: np.ndarray) -> None:
        """One ``home_logs/<name>.log`` per home that fell back, appended
        lazily (dragg/mpc_calc.py:655-658)."""
        failed = np.argwhere(np.asarray(correct_solve) == 0.0)
        if failed.size == 0 or self.run_dir is None:
            return
        log_dir = os.path.join(self.run_dir, "home_logs")
        os.makedirs(log_dir, exist_ok=True)
        by_home: dict[int, list[int]] = {}
        for k, i in failed:
            by_home.setdefault(int(i), []).append(self.timestep + int(k))
        for i, steps in by_home.items():
            name = self.all_homes[i]["name"]
            with open(os.path.join(log_dir, f"{name}.log"), "a") as f:
                for t in steps:
                    f.write(
                        f"WARNING - {name} - timestep {t}: MPC solve failed "
                        f"tolerance; fallback controller engaged\n")

    # ----------------------------------------------------------- RL setpoint
    def gen_setpoint(self) -> float:
        """Utility setpoint: trailing average of community load
        (dragg/aggregator.py:677-696)."""
        prev_n = int(self.config["agg"].get("rl", {}).get("prev_timesteps", 12))
        if self.timestep < 2:
            self.tracked_loads = [0.5 * self._max_possible_load()] * prev_n
            self.max_load = -float("inf")
            self.min_load = float("inf")
        else:
            self.tracked_loads[:-1] = self.tracked_loads[1:]
            self.tracked_loads[-1] = self.agg_load
        self.avg_load = float(np.average(self.tracked_loads))
        if self.agg_load > self.max_load or self.timestep % 24 == 0:
            self.max_load = self.agg_load
        if self.agg_load < self.min_load or self.timestep % 24 == 0:
            self.min_load = self.agg_load
        return self.avg_load

    def _max_possible_load(self) -> float:
        """Sum of each home's max simultaneous load (dragg/mpc_calc.py:191),
        summed per community first."""
        return float(self._max_possible_load_per_community().sum())

    def _max_possible_load_per_community(self) -> np.ndarray:
        """(C,) max possible load per community (the fleet RL observation's
        normalizers); ``all_homes`` is community-major, so community c is
        the c-th block of B homes."""
        C = self.n_communities
        B = len(self.all_homes) // C
        return np.array([sum(
            max(float(h["hvac"]["p_c"]), float(h["hvac"]["p_h"])) + float(h["wh"]["p"])
            for h in self.all_homes[c * B:(c + 1) * B]) for c in range(C)])

    # ------------------------------------------------------------ checkpoint
    def _checkpoint_root(self) -> str:
        return os.path.join(self.run_dir, self.case, "checkpoint")

    def save_checkpoint(self, state, extra_json: dict | None = None) -> None:
        """Persist the carried state after the chunk just collected (the
        engine's, or for an RL case the engine's, the agent's and the
        environment's) and the host bookkeeping, so the run can resume
        here: one versioned directory (state.npz, collected.json,
        progress.json, and a JSON file for each ``extra_json`` entry)
        published through ``LATEST`` (``checkpoint.save_checkpoint_dir``).
        results.json stays a user-facing output; a resume never reads it.
        A process of a distributed run writes its rank's shard file
        instead (:meth:`_save_checkpoint_multiprocess`)."""
        if self.world.distributed:
            self._save_checkpoint_multiprocess(state, extra_json)
            return
        files = {"collected.json": lambda path: self.collector.write_json(
            path, self._results_plan(None))}
        for name, obj in (extra_json or {}).items():
            files[name] = lambda path, obj=obj: save_progress(path, obj)
        save_checkpoint_dir(self._checkpoint_root(), self.timestep, state,
                            self._progress_dict(), files=files)

    def _save_checkpoint_multiprocess(self, state, extra_json: dict | None = None) -> None:
        """The JAX package's multi-process protocol, for ranks that may not
        share a disk: (1) each rank writes ``state.proc<r>-of-<W>.npz``, its
        own blocks (``checkpoint.save_pytree_local``), and rank 0 the host
        bookkeeping and extras; (2) the ranks' write verdicts are
        all-gathered, and on any failure no rank publishes (the previous
        checkpoint stays authoritative); (3) a barrier, then every rank
        replaces its ``LATEST`` (identical bytes); (4) a barrier, then the
        superseded checkpoints are pruned.  A crash between (2) and (3)
        tears ``LATEST`` across ranks; :meth:`_try_resume_multiprocess`
        catches that."""
        w = self.world
        root = self._checkpoint_root()
        name = f"ckpt_t{self.timestep:08d}"
        final = os.path.join(root, name)
        ok = True
        try:
            os.makedirs(final, exist_ok=True)
            save_pytree_local(os.path.join(final, shard_file_name(w.rank, w.size)),
                              state, self.timestep, w.rank)
            if w.rank == 0:
                self.collector.write_json(os.path.join(final, "collected.json"),
                                          self._results_plan(None))
                for fname, obj in (extra_json or {}).items():
                    save_progress(os.path.join(final, fname), obj)
                save_progress(os.path.join(final, "progress.json"), self._progress_dict())
        except Exception:
            self.log.logger.exception(
                f"checkpoint write failed on process {w.rank}; skipping publish "
                f"of {name} (previous checkpoint remains authoritative)")
            ok = False
        if not w.all(ok, host=True):
            if ok:
                self.log.logger.warning(
                    f"checkpoint {name} aborted: another process failed its "
                    f"write; no LATEST update")
            return
        w.barrier()
        latest_tmp = os.path.join(root, f"LATEST.tmp{w.rank}")
        with open(latest_tmp, "w") as f:
            f.write(name)
        os.replace(latest_tmp, os.path.join(root, "LATEST"))
        w.barrier()
        for entry in os.listdir(root):
            if entry.startswith("ckpt_") and entry != name:
                shutil.rmtree(os.path.join(root, entry), ignore_errors=True)

    def _progress_dict(self) -> dict:
        return {
            "run_shape": self._run_shape(),
            "timestep": self.timestep,
            "elapsed": time.time() - self.start_time,
            "baseline_agg_load_list": self.baseline_agg_load_list,
            "all_rps": self.all_rps.tolist(),
            "all_sps": self.all_sps.tolist(),
            "solve_iters": self._solve_iters,
            "tracked_loads": getattr(self, "tracked_loads", None),
            "max_load": getattr(self, "max_load", None),
            "min_load": getattr(self, "min_load", None),
        }

    def clear_checkpoint(self) -> None:
        """Drop the resume checkpoint once a run completes, so a later run
        with ``resume = true`` starts afresh instead of appending to
        finished results."""
        shutil.rmtree(self._checkpoint_root(), ignore_errors=True)

    def _latest_checkpoint_dir(self) -> str | None:
        return latest_checkpoint_dir(self._checkpoint_root())

    def _run_shape(self) -> dict:
        """What a checkpoint is valid for, with the JAX package's keys: the
        restored bookkeeping arrays and the state are sized by these, and
        the solver family and precision set what the warm carry means, and
        the community count and the event timeline's content digest what
        the state and a step mean, so a config change between runs starts
        afresh instead of failing later in a shape check or running on.
        ``rl_fleet`` is what sizes a fleet RL run's carries
        (:meth:`_rl_fleet_shape`); ``process_count`` is the world's ranks
        and ``n_home_slots`` its padded slots, so a checkpoint of another
        world size starts afresh.  A single community's RL case
        adds ``rl``, what sizes its agent's and environment's carries (the
        core, its critic count or width, the setpoint window), a key the
        JAX package does not write: a config change there starts afresh
        too, where the JAX package's single-community run would fail in
        the leaf check."""
        eng = self.engine
        shape = {
            "num_timesteps": self.num_timesteps,
            "n_homes": len(self.all_homes) if self.all_homes else self.total_homes,
            "communities": self.n_communities,
            "solver": eng.params.solver if eng is not None else None,
            "precision": eng.params.precision if eng is not None else None,
            "n_home_slots": eng.n_homes if eng is not None else None,
            "warm_cols": eng.warm_cols if eng is not None else None,
            "buckets": ([[b["name"], b["n_slots"]] for b in eng.bucket_info()]
                        if eng is not None and eng.bucketed else None),
            "horizon": int(self.config["home"]["hems"]["prediction_horizon"]),
            "state_rev": 2,
            "events": timeline_digest(eng.events) if eng is not None else None,
            "rl_fleet": self._rl_fleet_shape(),
            "process_count": self.world.size,
        }
        if self.case == "rl_agg" and self.n_communities == 1:
            p = self.config["rl"]["parameters"]
            kind = str(p.get("agent", "linear"))
            core_shape = (int(self.config.get("tpu", {}).get("ddpg_hidden", 64))
                          if kind == "ddpg" else (2 if p.get("twin_q", True) else 1))
            shape["rl"] = [kind, core_shape,
                           int(self.config["agg"].get("rl", {}).get("prev_timesteps", 12))]
        return shape

    def _rl_fleet_shape(self) -> list | None:
        """The fleet RL run-shape key, the JAX package's (None without a
        fleet RL case): the policy layout and every setting that sizes a
        carry leaf (learner batch, gradient, event features, the DDPG
        width or the critic count, the setpoint window)."""
        from dragg_tpu_torch.rl.fleet import fleet_params_from_config

        sim = self.config["simulation"]
        if self.n_communities == 1 or not (sim.get("run_rl_agg", False)
                                           or sim.get("run_rl_simplified", False)):
            return None
        fp = fleet_params_from_config(self.config, self.n_communities)
        p = self.config["rl"]["parameters"]
        kind = str(p.get("agent", "linear"))
        core_shape = (int(self.config.get("tpu", {}).get("ddpg_hidden", 64))
                      if kind == "ddpg" else (2 if p.get("twin_q", True) else 1))
        prev_n = int(self.config["agg"].get("rl", {}).get("prev_timesteps", 12))
        return [fp.policy, kind, fp.learner_batch, fp.gradient,
                bool(fp.event_features), core_shape, prev_n]

    def try_resume(self, template_state):
        """(state, t) from the latest complete checkpoint when
        ``simulation.resume`` is on and one exists for this run shape, else
        (template_state, 0).  Sets ``resumed_from`` to the directory.  A
        process of a distributed run decides with the other ranks
        (:meth:`_try_resume_multiprocess`)."""
        self.resumed_from = None
        if not self.config["simulation"].get("resume", False):
            return template_state, 0
        if self.world.distributed:
            return self._try_resume_multiprocess(template_state)
        d = self._latest_checkpoint_dir()
        if d is None:
            return template_state, 0
        prog = load_progress(os.path.join(d, "progress.json"))
        want, got = self._run_shape(), prog.get("run_shape")
        if got != want:
            self.log.logger.warning(
                f"Checkpoint {d} was written for run shape {got}, current config is "
                f"{want}; ignoring it and starting fresh.")
            return template_state, 0
        state = load_pytree(os.path.join(d, "state.npz"), template_state)
        self._restore_from_progress(d, prog)
        self.timestep = int(prog["timestep"])
        self.resumed_from = d
        self.log.logger.info(f"Resuming {self.case} from timestep {self.timestep}.")
        return state, self.timestep

    def _try_resume_multiprocess(self, template_state):
        """Resume over per-rank shard files, every decision collective so
        that the ranks branch alike: rank 0 validates progress.json and the
        run shape and broadcasts the timestep (−1: start afresh); each rank
        checks its own shard file (present, and of that timestep) and the
        verdicts are all-gathered, any bad shard sending every rank back to
        t = 0.  The reward prices, setpoints and setpoint tracker, which
        every rank steps with, are broadcast from rank 0; the collected
        series stay rank 0's."""
        w = self.world
        root = self._checkpoint_root()
        t_resume, prog = -1, None
        if w.rank == 0:
            d = self._latest_checkpoint_dir()
            if d is not None:
                try:
                    prog = load_progress(os.path.join(d, "progress.json"))
                    if prog.get("run_shape") == self._run_shape():
                        t_resume = int(prog["timestep"])
                    else:
                        self.log.logger.warning(
                            f"Checkpoint {d} run shape {prog.get('run_shape')} != "
                            f"current {self._run_shape()}; starting fresh.")
                        prog = None
                except Exception as e:
                    self.log.logger.warning(f"Checkpoint {d} unreadable ({e!r}); starting fresh.")
                    prog = None
        t_resume = int(w.broadcast(np.asarray([t_resume], np.int64))[0])
        if t_resume < 0:
            return template_state, 0
        name = f"ckpt_t{t_resume:08d}"
        shard = os.path.join(root, name, shard_file_name(w.rank, w.size))
        local_ok = False
        if os.path.isfile(shard):
            try:
                with np.load(shard) as data:
                    local_ok = int(data["__timestep__"]) == t_resume
            except Exception:
                local_ok = False
        if not w.all(local_ok, host=True):
            self.log.logger.warning(
                f"Checkpoint {name}: shard missing/torn on some process (local "
                f"ok={local_ok}); all processes starting fresh.")
            return template_state, 0
        state = load_pytree_local(shard, template_state, expect_timestep=t_resume)
        rps, sps = np.zeros(self.num_timesteps), np.zeros(self.num_timesteps)
        prev_n = int(self.config["agg"].get("rl", {}).get("prev_timesteps", 12))
        tracker = np.zeros(prev_n + 3)    # [present, max_load, min_load, *tracked]
        if prog is not None:
            rps = np.asarray(prog["all_rps"], dtype=np.float64)
            sps = np.asarray(prog["all_sps"], dtype=np.float64)
            if prog.get("tracked_loads") is not None:
                tracked = list(prog["tracked_loads"])[:prev_n]
                tracker[:3] = (1.0, float(prog["max_load"]), float(prog["min_load"]))
                tracker[3:3 + len(tracked)] = tracked
        self.all_rps = w.broadcast(rps).astype(np.float64)
        self.all_sps = w.broadcast(sps).astype(np.float64)
        tracker = w.broadcast(tracker)
        if tracker[0] > 0:
            self.max_load, self.min_load = float(tracker[1]), float(tracker[2])
            self.tracked_loads = [float(v) for v in tracker[3:]]
        if w.rank == 0:
            self._restore_from_progress(os.path.join(root, name), prog,
                                        include_tracker=False)
        self.timestep = t_resume
        self.resumed_from = os.path.join(root, name)
        self.log.logger.info(
            f"Resuming {self.case} from timestep {t_resume} (process "
            f"{w.rank}/{w.size}).")
        return state, self.timestep

    def _restore_from_progress(self, d: str, prog: dict, include_tracker: bool = True) -> None:
        """The host bookkeeping of a checkpoint: the selected homes' series,
        the aggregate lists, the setpoint tracker (unless
        ``include_tracker`` is false: the ranks of a distributed run
        restore it by broadcast) and the elapsed time."""
        collected = load_progress(os.path.join(d, "collected.json"))
        for i, home in enumerate(self.all_homes):
            series = collected.get(home["name"])
            if not series or not self._home_selected(home):
                continue
            for key, values in series.items():
                if isinstance(values, list):
                    self.collector.import_series(key, i, values)
        self.baseline_agg_load_list = list(prog["baseline_agg_load_list"])
        self.all_rps = np.asarray(prog["all_rps"], dtype=np.float64)
        self.all_sps = np.asarray(prog["all_sps"], dtype=np.float64)
        self._solve_iters = list(prog["solve_iters"])
        if include_tracker and prog.get("tracked_loads") is not None:
            self.tracked_loads = list(prog["tracked_loads"])
            self.max_load = prog["max_load"]
            self.min_load = prog["min_load"]
        # Keep Summary.solve_time cumulative across the restart.
        self.start_time = time.time() - float(prog.get("elapsed", 0.0))

    # ------------------------------------------------------------------ run
    def run_baseline(self) -> None:
        """The baseline community simulation (dragg/aggregator.py:757-778):
        chunks of engine steps, with results.json and a checkpoint written
        at every chunk boundary before the end.

        Under ``fleet.pipeline`` (the default) chunk N's host work
        (:meth:`_process_chunk`) runs on a worker thread while this thread
        drives chunk N+1; it is joined before chunk N+1's hand-off, so the
        collector, ``timestep`` and the checkpoints advance in chunk order.
        ``fleet.pipeline = false`` does the host work here, in turn."""
        horizon_h = self.config["home"]["hems"]["prediction_horizon"]
        self.log.logger.info(f"Performing baseline run for horizon: {horizon_h}")
        self.start_time = time.time()
        state, t = self.try_resume(self.engine.init_state())
        H = self.engine.params.horizon
        pipelined = bool(self.config.get("fleet", {}).get("pipeline", True))
        # The state at the start of the next chunk to be collected, for the
        # forensic dump: a host copy of the first; after that, the state
        # the previous chunk staged (its slot is not re-staged until the
        # chunk after this one).
        self._next_state0 = host_snapshot(state) if self._forensics_on else None
        slots = (_HostSlot(self.device), _HostSlot(self.device))
        chunks = 0
        busy = None        # the worker's future for the chunk in host work
        pend = None        # the chunk that has run, its host work not started

        def more() -> bool:
            return t < self.num_timesteps and (
                self.stop_after_chunks is None or chunks < self.stop_after_chunks)

        # Supervised runs (resilience/): the heartbeat beats at each chunk's
        # start and after each chunk's host work, and ``sim_chunk`` is the
        # fault site before each chunk runs.  Under the pipeline, chunk N's
        # host work starts just after that site fires for chunk N+1, as in
        # the JAX package's loop, so a child killed there has checkpointed
        # chunk N-1 and not chunk N (in turn: chunk N).
        beat({"timestep": t})
        with ThreadPoolExecutor(max_workers=1, thread_name_prefix="chunk-host") as pool:
            while more():
                n_steps = min(self.checkpoint_interval, self.num_timesteps - t)
                fault_hook("sim_chunk")
                driving = None  # set once this chunk has run
                if pend is not None:
                    driving = threading.Event()
                    busy = pool.submit(self._process_chunk, pend, driving)
                # The first chunk builds the kernels and warms the caches.
                beat({"stage": ("first_chunk(compile+execute)" if chunks == 0
                                else "chunk_execute"), "timestep": t})
                d0 = time.perf_counter()
                with self._maybe_profile(chunks, t) as sp:
                    state, outs = self.engine.run_chunk(
                        state, t, np.zeros((n_steps, H), dtype=np.float32))
                device_s = time.perf_counter() - d0 if sp is None else sp.s
                if driving is not None:
                    driving.set()
                if busy is not None:
                    busy.result()
                    busy = None
                # Copies queued before the next chunk's kernels; the slot
                # was last read by the host work joined just above.
                slot = slots[chunks % 2]
                s0 = time.perf_counter()
                slot.stage(outs, state)
                t += n_steps
                chunks += 1
                pend = {"t_end": t, "slot": slot, "device_s": device_s,
                        "device_observed": sp is not None,
                        "snapshot_s": time.perf_counter() - s0}
                if not pipelined:
                    self._process_chunk(pend, None)
                    pend = None
            if pend is not None:
                self._process_chunk(pend, None)
        if self.stop_after_chunks is not None and t < self.num_timesteps:
            self.log.logger.info(f"Stopping early after {chunks} chunks.")

    def _process_chunk(self, pend: dict, driving: threading.Event | None) -> None:
        """Host work for one chunk that has run: collect its outputs and,
        before the run's end, rewrite results.json and checkpoint the state
        after it.  Reads only the chunk's host slot (numpy), never a device
        tensor.  ``driving`` is the next chunk's event: the host window is
        credited to ``overlap_hidden_s`` if that chunk was still running
        when the window closed."""
        host_t0 = time.perf_counter()
        outs, after_state = pend["slot"].wait()
        self._phase_times["device_chunks"] += pend["device_s"]
        self._phase_times["state_snapshot"] += pend["snapshot_s"]
        self._chunk_state0 = self._next_state0
        self._collect_chunk(outs, device_s=pend["device_s"],
                            device_observed=pend["device_observed"])
        collect_s = time.perf_counter() - host_t0
        self._phase_times["collect"] += collect_s
        if self._telemetry_on:
            telemetry.observe("engine.collect_s", collect_s)
        if self._forensics_on:
            self._next_state0 = after_state
        beat({"timestep": pend["t_end"]})
        if pend["t_end"] < self.num_timesteps:
            self.log.logger.info("Creating a checkpoint file.")
            self.write_outputs()
            self.save_checkpoint(after_state)
        if driving is not None and not driving.is_set():
            host_s = time.perf_counter() - host_t0
            self._phase_times["overlap_hidden_s"] += host_s
            if self._telemetry_on:
                telemetry.observe("engine.overlap_hidden_s", host_s)

    def _profile_dir(self) -> str:
        """Where the chunk trace goes: ``$JAX_PROFILE_DIR``, else
        ``tpu.profile_dir`` ("" = no trace).  The environment variable is
        the JAX package's, read here too so that one script traces a run
        of either package."""
        return os.environ.get("JAX_PROFILE_DIR",
                              self.config.get("tpu", {}).get("profile_dir", ""))

    @contextlib.contextmanager
    def _maybe_profile(self, chunk_idx: int, t0: int):
        """A ``torch.profiler`` trace (host and, on a card, the device's
        kernels) around the second chunk (the first builds the kernels and
        warms the caches), exported as a Chrome trace to
        ``<profile_dir>/chunk_t<t0>.pt.trace.json``; the chunk runs inside
        the bus span ``engine.chunk_device_s`` (yielded: its ``s`` is the
        chunk's seconds), which the trace shows as a range.  The traced
        chunk waits for the device before the trace closes, so it is
        serialized against the next.  Yields None for every other chunk."""
        profile_dir = self._profile_dir()
        if not profile_dir or chunk_idx != 1:
            yield None
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.log.logger.info(f"Writing profiler trace to {profile_dir}")
        with profile(activities=activities) as prof:
            with telemetry.span("engine.chunk_device_s") as sp:
                yield sp
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, f"chunk_t{t0:08d}.pt.trace.json"))

    def check_baseline_vals(self) -> list[str]:
        """Result-shape check over the selected homes
        (dragg/aggregator.py:698-709), surfaced in ``Summary.check_errors``;
        on the rank that collects the series (rank 0)."""
        errors: list[str] = []
        if self.world.rank != 0:
            return errors
        for i, home in enumerate(self.all_homes):
            if not self._home_selected(home):
                continue
            for k in self._home_keys(home):
                want = self.num_timesteps + 1 if k in ("temp_in_opt", "temp_wh_opt", "e_batt_opt") else self.num_timesteps
                got = self.collector.length(k, i)
                if got != want:
                    msg = f"Incorrect number of hours. {home['name']}: {k} {got}"
                    self.log.logger.error(msg)
                    errors.append(msg)
        if errors:
            self.extra_summary["check_errors"] = errors
        return errors

    # --------------------------------------------------------------- outputs
    def set_run_dir(self) -> None:
        """Reference directory layout (dragg/aggregator.py:818-829)."""
        cfg = self.config
        self.run_dir = os.path.join(
            self.outputs_dir,
            date_folder_name(self.start_dt, self.end_dt),
            run_dir_name(
                self.check_type,
                cfg["community"]["total_number_homes"],
                cfg["home"]["hems"]["prediction_horizon"],
                self.dt,
                int(cfg["home"]["hems"]["sub_subhourly_steps"]),
                configured_solver(cfg),
            ),
            f"version-{self.version}",
        )
        os.makedirs(self.run_dir, exist_ok=True)

    def summarize_baseline(self) -> dict:
        """The Summary block (dragg/aggregator.py:783-816)."""
        self.end_time = time.time()
        cfg = self.config
        sim_slice = slice(self.start_index, self.start_index + self.num_timesteps)
        summary = {
            "case": self.case,
            "start_datetime": self.start_dt.strftime("%Y-%m-%d %H"),
            "end_datetime": self.end_dt.strftime("%Y-%m-%d %H"),
            "solve_time": self.end_time - self.start_time,
            "horizon": cfg["home"]["hems"]["prediction_horizon"],
            "num_homes": cfg["community"]["total_number_homes"],
            "p_max_aggregate": max(self.baseline_agg_load_list, default=0.0),
            "p_grid_aggregate": list(self.baseline_agg_load_list),
            "OAT": self.env.oat[sim_slice].tolist(),
            "GHI": self.env.ghi[sim_slice].tolist(),
            "RP": self.all_rps.tolist(),
            "p_grid_setpoint": self.all_sps.tolist(),
            "solver_iterations": list(self._solve_iters),
            "phase_times": {k: round(v, 3) for k, v in
                            getattr(self, "_phase_times", {}).items()},
        }
        if self.n_communities > 1:
            summary["fleet"] = {
                "communities": self.n_communities,
                "homes_per_community": int(cfg["community"]["total_number_homes"]),
                "homes_total": self.total_homes,
                "seed_stride": self._fleet_seed_stride,
                "weather_offset_hours": self._fleet_weather_off_h,
            }
            summary["num_homes"] = self.total_homes
        summary["TOU"] = self.env.tou[sim_slice].tolist()
        summary.update(self.extra_summary)
        return summary

    def _results_plan(self, summary: dict | None) -> list[tuple]:
        """The streaming write plan for results.json: raw JSON fragments for
        structure/static fields, series references for the numeric arrays;
        without a Summary block when ``summary`` is None (a checkpoint's
        collected.json)."""
        plan: list[tuple] = [("raw", "{")]
        for i, home in enumerate(self.all_homes):
            if i:
                plan.append(("raw", ", "))
            statics = self._home_static[home["name"]]
            frag = json.dumps(home["name"]) + ": {"
            frag += ", ".join(f"{json.dumps(k)}: {json.dumps(v)}" for k, v in statics.items())
            plan.append(("raw", frag))
            selected = self._home_selected(home)
            for key in self._home_keys(home):
                plan.append(("raw", f", {json.dumps(key)}: "))
                if selected:
                    plan.append(("series", key, i))
                elif key == "temp_in_opt":
                    plan.append(("raw", json.dumps([home["hvac"]["temp_in_init"]])))
                elif key == "temp_wh_opt":
                    plan.append(("raw", json.dumps([home["wh"]["temp_wh_init"]])))
                elif key == "e_batt_opt":
                    plan.append(("raw", json.dumps([home["battery"]["e_batt_init"]])))
                else:
                    plan.append(("raw", "[]"))
            plan.append(("raw", "}"))
        if summary is not None:
            plan.append(("raw", (", " if self.all_homes else "")
                         + '"Summary": ' + json.dumps(summary)))
        plan.append(("raw", "}"))
        return plan

    def write_outputs(self) -> None:
        """Per-home series + Summary → <run_dir>/<case>/results.json
        (dragg/aggregator.py:831-844); only the Summary when the case has no
        community (``summary_only_case``, the simplified RL case).  Rank 0
        alone writes."""
        if self.world.rank != 0:
            return
        summary = self.summarize_baseline()
        case_dir = os.path.join(self.run_dir, self.case)
        os.makedirs(case_dir, exist_ok=True)
        path = os.path.join(case_dir, "results.json")
        if self.all_homes is not None and not self.summary_only_case:
            self.collector.write_json(path, self._results_plan(summary))
        else:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"Summary": summary}, f, indent=4)
            os.replace(tmp, path)

    def _checkpoint_steps(self) -> int:
        """hourly/daily/weekly → timesteps per chunk (dragg/aggregator.py:949-955)."""
        interval = self.config["simulation"].get("checkpoint_interval", "daily")
        return {
            "hourly": self.dt,
            "daily": self.dt * 24,
            "weekly": self.dt * 24 * 7,
        }.get(interval, 500)

    def _telemetry_open(self) -> bool:
        """Open the run's telemetry bus (``events.jsonl`` + in-memory
        metrics) when ``telemetry.enabled``, on rank 0 alone (a run of one
        process is rank 0).  The destination resolves
        ``telemetry.dir`` → ``$DRAGG_TELEMETRY_DIR`` → the run directory.
        A resumed run appends to the stream it left."""
        tcfg = {**default_config()["telemetry"], **self.config.get("telemetry", {})}
        if not tcfg["enabled"] or self.world.rank != 0:
            return False
        self._forensics_on = bool(tcfg.get("forensics", False))
        tdir = tcfg["dir"] or os.environ.get(telemetry.ENV_DIR) or self.run_dir
        telemetry.init_run(tdir)
        cfg = self.config
        telemetry.emit(
            "run.start",
            case=self.case,
            homes=cfg["community"]["total_number_homes"],
            horizon=cfg["home"]["hems"]["prediction_horizon"],
            solver=configured_solver(cfg),
            run_dir=self.run_dir,
        )
        return True

    def _telemetry_close(self, t0: float) -> None:
        telemetry.emit(
            "run.end",
            timestep=self.timestep,
            num_timesteps=self.num_timesteps,
            elapsed_s=round(time.time() - t0, 3),
            completed=self.timestep >= self.num_timesteps,
            **self._kernel_record(),
        )
        telemetry.write_snapshot()
        telemetry.close_run()

    def _kernel_record(self) -> dict:
        """On the card, ``run.end``'s record of the kernels: the process's
        launch counts and the library it loaded (``cuda_lib.loaded()``:
        its path, ``hit`` or ``miss``).  The JAX package's ``run.end``
        has neither."""
        if self.device.type != "cuda":
            return {}
        from dragg_tpu_torch.ops import band_kernels, cuda_lib, iter_kernels

        return {"kernel_launches": {**band_kernels.LAUNCHES, **iter_kernels.LAUNCHES},
                "kernel_library": cuda_lib.loaded()}

    def run(self) -> None:
        """Entry point (dragg/aggregator.py:941-970): the enabled cases in
        the reference's order, the baseline (``simulation.run_rbo_mpc``),
        then the RL aggregator (``run_rl_agg``) and the RL agent against
        the simplified community (``run_rl_simplified``), inside the run's
        telemetry bus."""
        self.log.logger.info("Made it to Aggregator Run")
        # Again here: callers switch the RL cases on in ``config`` after
        # construction (the CLI's and the tests' pattern).
        self._check_rl_fleet()
        self.checkpoint_interval = self._checkpoint_steps()
        self.version = self.config["simulation"].get("named_version", "test")
        self.set_run_dir()
        self._telemetry_on = self._telemetry_open()
        t_run0 = time.time()
        try:
            self._run_cases()
        finally:
            if self._telemetry_on:
                self._telemetry_close(t_run0)
                self._telemetry_on = False

    def _run_cases(self) -> None:
        """The enabled simulation cases, in the reference's order."""
        sim = self.config["simulation"]
        if sim.get("run_rbo_mpc", True):
            self.case = "baseline"
            self.get_homes()
            self._build_engine()
            self.reset_collected_data()
            self.run_baseline()
            if self.timestep < self.num_timesteps:
                # Stopped early at a chunk boundary, where results.json and
                # the checkpoint were already written: behave as a kill and
                # do not go on to the RL cases.
                return
            self.check_baseline_vals()
            self.write_outputs()
            self.clear_checkpoint()
        if sim.get("run_rl_agg", False):
            from dragg_tpu_torch.rl.runner import run_rl_agg

            run_rl_agg(self)
            if self.timestep < self.num_timesteps:
                return  # stopped at a chunk boundary, as above
        if sim.get("run_rl_simplified", False):
            from dragg_tpu_torch.rl.runner import run_rl_simplified

            run_rl_simplified(self)


class _HostSlot:
    """Host buffers one chunk's outputs and the state after it are copied
    into: pinned memory on a CUDA device, so the copies run asynchronously.
    The main thread queues the copies on the device's stream before it
    launches the next chunk, so they run ahead of that chunk's kernels; the
    thread that processes the chunk waits on the copies' event alone,
    never on the stream (a ``.cpu()`` there would queue behind the next
    chunk), and reads numpy views."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: list[torch.Tensor] = []
        self._structure = None
        self._event = None

    def stage(self, outs: StepOutputs, state) -> None:
        """Queue the copies of ``(outs, state)`` (main thread)."""
        leaves, self._structure = tree_flatten((outs, state))
        if [(b.shape, b.dtype) for b in self._bufs] != [(a.shape, a.dtype) for a in leaves]:
            pin = self.device.type == "cuda"
            self._bufs = [torch.empty(a.shape, dtype=a.dtype, pin_memory=pin and a.numel() > 0)
                          for a in leaves]
        for buf, a in zip(self._bufs, leaves):
            buf.copy_(a, non_blocking=True)
        if self.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(self.device))

    def wait(self) -> tuple:
        """``(outs, state)`` as numpy views once the copies have landed."""
        if self._event is not None:
            self._event.synchronize()
        return tree_unflatten(self._structure, [b.numpy() for b in self._bufs])
