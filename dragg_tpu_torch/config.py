"""Config loading + schema validation (a copy of ``dragg_tpu/config.py``).

Mirrors the reference's TOML schema and required-key validation
(dragg/aggregator.py:38-50,88-109 and dragg/data/config.toml:1-71).  The same
TOML files the reference ships are loadable unchanged.  Differences:

* reading uses the stdlib ``tomllib`` (the reference used the ``toml``
  package);
* validation raises ``ConfigError`` instead of calling ``sys.exit(1)``;
* ``default_config()`` provides the full default configuration as a dict so
  the framework runs standalone without a data directory.
"""

from __future__ import annotations

import copy
import os
import tomllib
from typing import Any

# Required-key schema — parity with dragg/aggregator.py:38-50.  The reference
# requires home.wh.c_dist but never uses it (WH capacitance is derived from
# tank size, dragg/mpc_calc.py:183-184); we therefore do NOT require it.
REQUIRED_KEYS: dict[str, Any] = {
    "community": {"total_number_homes"},
    "home": {
        "hvac": {"r_dist", "c_dist", "p_cool_dist", "p_heat_dist", "temp_sp_dist", "temp_deadband_dist"},
        "wh": {"r_dist", "p_dist", "sp_dist", "deadband_dist", "size_dist", "waterdraw_file"},
        "battery": {"max_rate", "capacity", "lower_bound", "upper_bound", "charge_eff", "discharge_eff"},
        "pv": {"area", "efficiency"},
        "hems": {"prediction_horizon", "sub_subhourly_steps", "discount_factor"},
    },
    "simulation": {"start_datetime", "end_datetime", "random_seed", "check_type", "run_rbo_mpc"},
    "agg": {"base_price", "subhourly_steps"},
}


class ConfigError(ValueError):
    """Raised when a config file fails schema validation."""


def _validate(data: dict, required: dict, path: str = "") -> None:
    for key, sub in required.items():
        if key not in data:
            raise ConfigError(f"Missing required config key: {path}{key}")
        if not isinstance(data[key], dict):
            raise ConfigError(f"Config section {path}{key} must be a table, got {type(data[key]).__name__}")
        if isinstance(sub, dict):
            _validate(data[key], sub, path=f"{path}{key}.")
        elif isinstance(sub, set):
            missing = sub - set(data[key].keys())
            if missing:
                raise ConfigError(f"Parameters for {path}{key}: {sorted(missing)} must be specified")


def validate_config(data: dict) -> dict:
    _validate(data, REQUIRED_KEYS)
    return data


def configured_solver(config: dict) -> str:
    """The raw configured solver name, with the framework default applied.

    Every consumer of ``home.hems.solver`` (run-directory naming, home
    metadata, and the engine, which maps reference solver names onto the
    batched families) reads it here, so a config that omits the key gets
    one identity everywhere."""
    return str(config["home"]["hems"].get("solver", "ipm"))


# Batched solver families of the JAX package (this package runs all three),
# plus the mapping from the reference's solver names (the GLPK_MI/ECOS/
# GUROBI table, dragg/mpc_calc.py:141-145, and the shipped config.toml
# default "GLPK_MI") onto them, so an unmodified reference config runs: the
# MILP semantics are covered by the relaxation + integer_first_action
# contract (ops/qp.py), and ECOS, itself an interior-point code, maps to
# the IPM.
SOLVER_FAMILIES = ("ipm", "admm", "reluqp")
REFERENCE_SOLVER_MAP = {
    "glpk_mi": "ipm", "glpk": "ipm", "gurobi": "ipm", "ecos": "ipm",
}


def resolve_solver_family(config: dict) -> str:
    """The batched solver family the config selects — ``configured_solver``
    lowered and mapped through :data:`REFERENCE_SOLVER_MAP`.  Raises
    ``ConfigError`` for names in neither table."""
    name = configured_solver(config).lower()
    name = REFERENCE_SOLVER_MAP.get(name, name)
    if name not in SOLVER_FAMILIES:
        raise ConfigError(
            f"home.hems.solver must be one of {'|'.join(SOLVER_FAMILIES)} "
            f"(or a reference solver name "
            f"{'|'.join(sorted(REFERENCE_SOLVER_MAP))}), got "
            f"{config['home']['hems'].get('solver')!r}")
    return name


def load_config(path: str | None = None) -> dict:
    """Load and validate a TOML config.

    Resolution mirrors the reference (dragg/aggregator.py:31-35): if ``path``
    is None, use ``$DATA_DIR/$CONFIG_FILE`` (defaults ``data/config.toml``).
    Falls back to :func:`default_config` if no file exists at the default
    location and none was explicitly requested.
    """
    explicit = path is not None
    if path is None:
        data_dir = os.path.expanduser(os.environ.get("DATA_DIR", "data"))
        path = os.path.join(data_dir, os.environ.get("CONFIG_FILE", "config.toml"))
    if not os.path.exists(path):
        if explicit:
            raise ConfigError(f"Configuration file does not exist: {path}")
        return default_config()
    with open(path, "rb") as f:
        data = tomllib.load(f)
    return validate_config(data)


# Default configuration — the same parameter distributions and simulation
# window as the reference's shipped config (dragg/data/config.toml:1-71),
# plus the JAX package's own sections, kept key for key so that one TOML
# file loads in both packages.  Keys of features this package does not run
# yet are kept at their defaults; a value that would turn one on raises
# NotImplementedError where the aggregator or the engine reads it.
_DEFAULT: dict[str, Any] = {
    "community": {
        "total_number_homes": 10,
        "homes_battery": 0,
        "homes_pv": 4,
        "homes_pv_battery": 0,
        "homes_ev": 0,           # scenario home types (0 keeps the
        "homes_heat_pump": 0,    # reference's four-type population)
        "overwrite_existing": True,
        "house_p_avg": 1.2,
    },
    "simulation": {
        "start_datetime": "2015-01-01 00",
        "end_datetime": "2015-01-04 00",
        "random_seed": 12,
        "n_nodes": 4,
        "load_zone": "LZ_HOUSTON",
        "check_type": "all",
        "run_rbo_mpc": True,
        "run_rl_agg": False,         # the RL aggregator over the MPC community
        "run_rl_simplified": False,  # the RL agent against the linear model
        "checkpoint_interval": "daily",  # steps per chunk: hourly|daily|weekly
        "named_version": "test",
    },
    "agg": {
        "base_price": 0.07,
        "subhourly_steps": 1,
        "tou_enabled": True,
        "spp_enabled": False,        # ERCOT settlement-point prices for TOU
        "rl": {
            "action_horizon": 1,
            "forecast_horizon": 1,
            "prev_timesteps": 12,    # utility setpoint's trailing window
            "max_rp": 0.02,
        },
        "tou": {
            "shoulder_times": [9, 21],
            "shoulder_price": 0.09,
            "peak_times": [14, 18],
            "peak_price": 0.13,
        },
        "simplified": {"response_rate": 0.3, "offset": 0.0},
    },
    "home": {
        "hvac": {
            "r_dist": [6.8, 9.2],
            "c_dist": [4.25, 5.75],
            "p_cool_dist": [3.5, 3.5],
            "p_heat_dist": [3.5, 3.5],
            "temp_sp_dist": [18, 22],
            "temp_deadband_dist": [2, 3],
        },
        "wh": {
            "r_dist": [18.7, 25.3],
            "p_dist": [2.5, 2.5],
            "sp_dist": [45.5, 48.5],
            "deadband_dist": [9, 12],
            "size_dist": [200, 300],
            "waterdraw_file": "waterdraw_profiles.csv",
        },
        "battery": {
            "max_rate": [3, 5],
            "capacity": [9.0, 13.5],
            "lower_bound": [0.01, 0.15],
            "upper_bound": [0.85, 0.99],
            "charge_eff": [0.85, 0.95],
            "discharge_eff": [0.97, 0.99],
        },
        "pv": {"area": [20, 32], "efficiency": [0.15, 0.2]},
        # Scenario-type parameter distributions (uniform bounds, like every
        # other [home.*] table; homes.EV_PARAM_DEFAULTS mirrors these so a
        # reference TOML, which lacks the tables, still loads).
        "ev": {
            "capacity": [40.0, 80.0],
            "max_rate": [3.3, 9.6],
            "charge_eff": [0.88, 0.95],
            "target_soc": [0.7, 0.9],
            "init_soc": [0.3, 0.6],
            "away_start": [7.0, 9.0],
            "away_duration": [7.0, 10.0],
            "trip_kwh": [6.0, 14.0],
        },
        "heat_pump": {
            "cop_base": [2.4, 3.2],
            "cop_slope": [0.04, 0.08],
        },
        "hems": {
            "prediction_horizon": 6,
            "sub_subhourly_steps": 6,
            "discount_factor": 0.92,
            # Solver family (reference analog: the GLPK_MI/ECOS/GUROBI
            # table, dragg/mpc_calc.py:141-145): "ipm" (the batched Mehrotra
            # predictor-corrector), "reluqp" or "admm".
            "solver": "ipm",
        },
    },
    # The RL price-signal agent; rl.fleet applies with
    # fleet.communities > 1 (dragg_tpu_torch/rl/fleet.py).  gradient =
    # "mpc" runs on the plain routes only (rl.fleet.check_mpc_route).
    "rl": {
        "utility": {"action_space": [-0.02, 0.02]},
        "parameters": {
            "agent": "linear",
            "alpha": 0.0625,
            "beta": 1.0,
            "epsilon": 0.05,
            "batch_size": 32,
            "twin_q": True,
        },
        "fleet": {
            "policy": "shared",
            "learner_batch": 0,
            "gradient": "score",
            "mpc_weight": 0.25,
            "event_features": True,
        },
    },
    # Supervised device execution (resilience/, ``run --supervised``).
    "resilience": {
        "deadline_s": 3600.0,    # hard wall-clock limit per supervised child
        "stall_s": 900.0,        # kill a child whose heartbeat grows older
                                 # than this; 0 disables
        "retries": 1,            # card attempts after the first failure
        "backoff_s": 30.0,       # base of the probe-gated exponential backoff
        "probe_timeout_s": 60.0,  # the subprocess CUDA probe's hard timeout
        "degrade_to_cpu": True,  # on a card lost mid-run, resume the same
                                 # run on the CPU from the latest checkpoint
                                 # (the transition recorded in the
                                 # provenance JSON)
    },
    # MPC serving daemon (dragg_tpu_torch/serve, ``python -m
    # dragg_tpu_torch serve``), the JAX package's keys and defaults.
    "serve": {
        "host": "127.0.0.1",
        "port": 8070,            # HTTP surface (0 = ephemeral)
        "workers": 1,            # worker slots of the default lane (each
                                 # holds one warm engine child)
        "queue_max": 256,        # pending + assigned cap; beyond it POST
                                 # /solve answers 429 + Retry-After
        "batch_max": 0,          # requests per coalesced group (0 = the
                                 # serving community size)
        "fleet_slots": 1,        # community slots C per worker engine: a
                                 # C-community fleet of identical copies of
                                 # the serving community, so one solve
                                 # coalesces up to C request groups
        "batch_window_ms": 25.0,  # a dispatchable group waits up to this
                                  # long for more same-timestep groups;
                                  # dispatch fires early when all C slots
                                  # fill (granularity = poll_s)
        "max_streams": 32,       # concurrent /result?stream=1 consumers;
                                 # past the cap streams answer 429
        "max_steps": 96,         # cap on a request's multi-chunk steps
        "patterns": [],          # extra pattern lanes warmed at boot, each
                                 # {name, horizon_hours?, homes?,
                                 # fleet_slots?, workers?} (serve/patterns)
        "spill_patterns": 1,     # lanes built on demand for inline pattern
                                 # specs no lane serves; beyond it 429
        "request_deadline_s": 120.0,  # default per-request queueing
                                      # deadline (a request's deadline_s wins)
        "request_retries": 2,    # re-dispatches after worker deaths before
                                 # a request fails terminally
        "batch_deadline_s": 120.0,  # wall-clock limit per dispatched batch
                                    # (× steps); expiry kills the worker
        "worker_stall_s": 900.0,  # heartbeat-stall kill for workers (hung
                                  # warm-up or solve); 0 disables.  The
                                  # staged warm-up beats only between
                                  # stages, and a cold nvcc build of the
                                  # kernel library is one stage
        "backoff_s": 2.0,        # base of the relaunch backoff
        "probe_timeout_s": 60.0,  # the subprocess CUDA probe's timeout
        "retry_after_s": 2.0,    # Retry-After of a 429
        "poll_s": 0.05,          # dispatch tick and worker inbox poll
        "drain_s": 30.0,         # graceful-drain budget on SIGTERM
        "journal_fsync": True,   # fsync every journal append
        "results_cache": 4096,   # answers kept for /result (the journal
                                 # keeps all)
        "degrade_to_cpu": True,  # a card the probe finds dead moves serving
                                 # to CPU workers (journaled transition)
    },
    # Scenario packs (data/packs/<pack>.toml: a home mix and events) and
    # inline events: tariff shocks, DR calls, outages (scenarios/).
    "scenarios": {
        "pack": "",
        "events": [],
    },
    # Multi-community fleets: C communities, each with its own seed and
    # weather offset, in one engine (an RL case needs communities = 1).
    "fleet": {
        "communities": 1,
        "seed_stride": 1,            # community c's seed = random_seed + c·stride
        "community_base": 0,         # global index of the first community
        "weather_offset_hours": 0,
        "pipeline": True,            # chunk N's host work (collect, results,
                                     # checkpoint) on a worker thread while
                                     # the card runs chunk N+1; false: in turn
    },
    # Cross-process fleet sharding (dragg_tpu_torch/shard, ``python -m
    # dragg_tpu_torch.shard``), the JAX package's keys and defaults.
    "shard": {
        "workers": 1,
        "chunk_steps": 8,
        "deadline_s": 0.0,
        "stall_s": 0.0,
        "restarts": 3,
        "degrade_after": 1,
        "poll_s": 0.05,
        "transport": "spool",
        "transport_retry_s": 10.0,
        "listen": "127.0.0.1:0",
    },
    # Run telemetry (dragg_tpu_torch/telemetry), the JAX package's defaults.
    "telemetry": {
        "enabled": True,   # <run_dir>/events.jsonl + a final metrics.json;
                           # false: no bus, no files
        "dir": "",         # destination ("" = $DRAGG_TELEMETRY_DIR, else
                           # the run directory)
        "per_home": True,  # the observatory: per-bucket residual and
                           # iteration histograms and the worst-k homes,
                           # folded on the device each step; false leaves
                           # the fold out of the step
        "worst_k": 8,      # worst homes captured per bucket per step
        "forensics": False,  # per-chunk dumps of the worst homes (config
                             # and chunk-start state) to <run_dir>/forensics/
        "trace": False,    # causal trace ids on every record (read by
                           # the serving daemon: request → batch → worker
                           # chunk spans; and the shard coordinator:
                           # worker chunk → wire push → merge)
        "flush_interval_s": 0.0,  # > 0: periodic metrics.json flush (the
                                  # serving daemon and the shard
                                  # coordinator export it to their workers)
    },
    # Solver and engine settings (no reference analog).
    "tpu": {
        # ADMM and ReLU-QP solver settings.  Both read
        # admm_refactor_every (sim steps between factor / rho-bank
        # refreshes), admm_patience, precision and, below,
        # admm_sigma/admm_alpha/admm_eps/admm_reg/admm_rho; ReLU-QP the
        # five reluqp_* keys and iter_kernel.  admm_rho and admm_reg also
        # set the IPM's warm_rho carry and proximal term.
        "admm_iters": 1500,
        "admm_refactor_every": 8,
        "admm_patience": 4,
        "admm_rho_update_every": 4,  # rho updates every N check windows
        "admm_matvec_dtype": "f32",  # "bf16": the dense Sinv stored in bf16
        "admm_refine": 0,         # refinement passes per in-loop solve
        "admm_anderson": 0,       # Anderson-acceleration depth (0 = off)
        "admm_banded_factor": True,  # factor S by RCM + band Cholesky
        "admm_solve_backend": "auto",  # "dense_inv" | "band" (the band
                                       # kernels) | "auto": band past 1 GiB
                                       # of a bucket's dense Sinv
        "reluqp_rho": 0.1,
        "reluqp_rho_factor": 6.0,
        "reluqp_bank": 5,
        "reluqp_iters": 2000,
        "reluqp_tail_iters": 300,
        "precision": "f32",       # ReLU-QP's and the ADMM's dense hot-loop
                                  # matmuls: "f32" | "bf16x3"
        "iter_kernel": "auto",    # ReLU-QP check window: "auto" = "lax" (einsum
                                  # chain); "pallas" = the fused CUDA kernel of
                                  # ops/iter_kernels.py (f32 only)
        # Interior point.
        "ipm_warm_start": False,  # seed the IPM from the receding-horizon shift
        "ipm_iters": 0,           # Mehrotra iteration cap; 0 = 16 + (decision steps)/2
        "ipm_tail_frac": 0.25,    # after a short full-batch phase, finish the
                                  # worst 25 % of homes alone; 0 disables
        "ipm_tail_iters": 0,      # tail-phase iteration cap (0 = ipm_iters)
        "integer_first_action": True,  # pin the three k=0 duty counts to
                                       # integers, as the reference's GLPK_MI
                                       # applies integer duty counts
                                       # (dragg/mpc_calc.py:171-173)
        "integer_repair": "project",  # "project": closed-form k=1 state
                                      # update, no second solve; "resolve":
                                      # re-solve with the counts pinned
        "repair_eps": 1e-3,       # IPM tolerance of the "resolve" re-solve
        "ipm_freeze_zmax": 300.0,  # divergence freeze: stop a home whose rp
                                   # stalls while its box duals (scaled
                                   # space) exceed this
        "ipm_eps": 2e-4,          # IPM stopping tolerance
        "band_fused": False,      # factor + predictor solve in one CUDA
                                  # launch (band_factor_solve_t) instead of
                                  # the factor kernel then the solve kernel
        "band_kernel": "auto",    # "auto" | "pallas": the band kernels of
                                  # ops/band_kernels.py; "xla": their plain
                                  # versions; "cr": cyclic reduction
                                  # (ops/block_cr.py) for the IPM, the
                                  # plain versions for the ADMM
        "bucketed": "auto",       # solve each home-type bucket at its own
                                  # (n, m) shape; "auto" buckets when the
                                  # community has >= 32 homes and >= 25 % of
                                  # them are not pv_battery
                                  # (engine.BUCKETED_MIN_*); true/false force
        "forecast_noise_cap": 3.0,  # max forecast-noise std (degC): the
                                    # reference's unbounded 1.1^k growth
                                    # breaks the season gate beyond ~16 h
        "compile_cache": True,    # reuse built libraries; false builds
                                  # into a fresh directory of the process's
        "compile_cache_dir": "",  # where the kernel and host libraries
                                  # live; "" = $DRAGG_COMPILE_CACHE_DIR,
                                  # else dragg_tpu_torch/_build
                                  # (kernel_cache.py)
        "admm_rho": 0.1,
        "admm_sigma": 1e-6,
        "admm_reg": 1e-3,
        "admm_alpha": 1.6,
        "admm_eps": 1e-4,
        "fix_tou_peak": False,  # reference bug parity: peak price is overwritten by shoulder (dragg/aggregator.py:214-215)
        "mesh_axis": "homes",     # the home axis's name in the sharded
                                  # engine's log (the port has no named axes)
        "sharded": "auto",        # shard the home axis over the ranks of a
                                  # distributed run (parallel/): "auto" when
                                  # there are several, true/false force it
        "profile_dir": "",        # torch.profiler trace of the second chunk
                                  # ($JAX_PROFILE_DIR overrides it)
        "ddpg_actor_lr": 1e-3,
        "ddpg_critic_lr": 1e-3,
        "ddpg_tau": 0.01,
        "ddpg_policy_delay": 2,
        "ddpg_hidden": 64,
    },
}

def default_config() -> dict:
    """Return a deep copy of the default configuration."""
    return copy.deepcopy(_DEFAULT)


# The legacy bench mix of home types (40 % pv_only, 10 % battery_only,
# 10 % pv_battery, the rest base), the mixed community that chip_smoke.py
# and profile_step run.
LEGACY_MIX = {"homes_pv": 0.4, "homes_battery": 0.1, "homes_pv_battery": 0.1}


def mixed_community_config(n_homes: int, horizon: int, end: str, **tpu) -> dict:
    """The default config for ``n_homes`` homes in the legacy mix, from
    2015-01-01 00 to ``end``, at a ``horizon``-hour MPC horizon and hourly
    steps; ``tpu`` overrides ``[tpu]`` keys."""
    cfg = default_config()
    cfg["community"]["total_number_homes"] = n_homes
    for key, frac in LEGACY_MIX.items():
        cfg["community"][key] = int(frac * n_homes)
    cfg["simulation"]["start_datetime"] = "2015-01-01 00"
    cfg["simulation"]["end_datetime"] = end
    cfg["home"]["hems"]["prediction_horizon"] = horizon
    cfg["agg"]["subhourly_steps"] = 1
    cfg["tpu"].update(tpu)
    return cfg


def pack_fleet_config(homes_per_community: int, horizon: int, steps: int,
                      communities: int = 1, pack: str = "stress_dr_outage", **tpu) -> dict:
    """``mixed_community_config`` under the scenario pack ``pack`` (its mix
    replaces the legacy one) with ``tpu.fix_tou_peak``: ``communities``
    communities of ``homes_per_community`` homes, 24 h of weather apart,
    ``steps`` hourly steps from 2015-01-01 00 (the fleet of chip_smoke.py
    phase 13)."""
    from datetime import datetime, timedelta

    end = (datetime(2015, 1, 1) + timedelta(hours=steps)).strftime("%Y-%m-%d %H")
    cfg = mixed_community_config(homes_per_community, horizon, end,
                                 **{"bucketed": "auto", "fix_tou_peak": True, **tpu})
    cfg["scenarios"]["pack"] = pack
    cfg["fleet"].update(communities=communities, weather_offset_hours=24)
    return cfg
