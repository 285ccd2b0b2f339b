"""The system under test: the port's engine (``dragg_tpu_torch``), built
from the benchmark's inputs.  This is the one module of the harness that
imports the program; it takes from it the engine, its chunk loop, its
phase split and its kernel counters, and hands the benchmark's own home
arrays over as the program's home batch.
"""

from __future__ import annotations

import copy

import numpy as np

# StepOutputs fields copied to the host after each chunk: every per-home
# series and the community totals.  A chunk is complete once they are.
HOME_FIELDS = ("p_grid", "p_load", "temp_in", "temp_wh", "hvac_cool_on", "hvac_heat_on",
               "wh_heat_on", "cost", "waterdraws", "correct_solve", "p_pv", "u_pv_curt",
               "e_batt", "p_batt_ch", "p_batt_disch", "forecast_p_grid")
STEP_FIELDS = ("agg_load", "admm_iters")


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)


def program_config(cfg_file: dict, traffic: dict, inputs: dict) -> dict:
    """The program's config dict: its defaults, the configuration file's
    sections over them, the fleet of the traffic mix, and the seed."""
    from dragg_tpu_torch.config import default_config

    cfg = default_config()
    _merge(cfg, cfg_file["config"])
    n = inputs["n_per_community"]
    counts = {t: int((inputs["homes"]["type_code"] == i).sum()) // inputs["communities"]
              for i, t in enumerate(("pv_battery", "pv_only", "battery_only", "base"))}
    cfg["community"].update(total_number_homes=n, homes_pv_battery=counts["pv_battery"],
                            homes_pv=counts["pv_only"], homes_battery=counts["battery_only"])
    cfg["simulation"]["random_seed"] = inputs["program_seed"]
    cfg["fleet"].update(communities=inputs["communities"], seed_stride=inputs["seed_stride"],
                        weather_offset_hours=int(traffic.get("weather_offset_hours", 0)))
    return cfg


def home_batch(inputs: dict):
    """The benchmark's homes as the program's ``HomeBatch`` (host arrays):
    per-step powers are the totals over ``s``; draws are preceded by the
    ``H // dt + 1`` empty hours the reference's draw schedule starts with."""
    from dragg_tpu_torch.homes import HomeBatch

    h, s, H, dt = inputs["homes"], inputs["s"], inputs["H"], inputs["dt"]
    n = len(h["type_code"])
    zeros, ones = np.zeros(n), np.ones(n)
    draws = np.concatenate([np.zeros((n, H // dt + 1)), h["draws"]], axis=1)
    return HomeBatch(
        type_code=h["type_code"].astype(np.int32), has_pv=h["has_pv"], has_batt=h["has_batt"],
        hvac_r=h["hvac_r"], hvac_c=h["hvac_c"], hvac_p_c=h["p_cool"] / s,
        hvac_p_h=h["p_heat"] / s, temp_in_min=h["temp_in_min"], temp_in_max=h["temp_in_max"],
        temp_in_init=h["temp_in_init"], wh_r=h["wh_r"], wh_c=h["tank_size"] * 4.2,
        wh_p=h["p_wh"] / s, temp_wh_min=h["temp_wh_min"], temp_wh_max=h["temp_wh_max"],
        temp_wh_init=h["temp_wh_init"], tank_size=h["tank_size"], draws_hourly=draws,
        batt_max_rate=h["batt_max_rate"], batt_cap_min=h["batt_cap_min"],
        batt_cap_max=h["batt_cap_max"], batt_ch_eff=h["batt_ch_eff"],
        batt_disch_eff=h["batt_disch_eff"], e_batt_init_frac=h["e_batt_init_frac"],
        batt_capacity=h["batt_capacity"], pv_area=h["pv_area"], pv_eff=h["pv_eff"],
        is_ev=zeros, ev_cap=zeros, ev_rate=zeros, ev_ch_eff=ones, ev_init_frac=zeros,
        ev_target_kwh=zeros, ev_away_start=zeros, ev_away_end=zeros, ev_trip_kwh=zeros,
        is_hp=zeros, hp_cop_base=ones, hp_cop_slope=zeros)


def fleet_spec(inputs: dict, traffic: dict):
    """The program's ``FleetSpec`` for a fleet of C > 1 communities, else
    None: each row's community, its index inside it and the community's
    seed and weather offset."""
    C = inputs["communities"]
    if C == 1:
        return None
    from dragg_tpu_torch.homes import FleetSpec

    h = inputs["homes"]
    return FleetSpec(
        n_communities=C, homes_per_community=inputs["n_per_community"],
        seeds=tuple(inputs["program_seed"] + c * inputs["seed_stride"] for c in range(C)),
        community=h["community"].astype(np.int32), global_idx=h["global_idx"].astype(np.int32),
        local_idx=h["local_idx"].astype(np.int32),
        env_offset=inputs["env_offset"].astype(np.int32))


class System:
    """The port's engine on the card (or ``device``), with the chunk call
    the window drives and the copy of its outputs to the host."""

    def __init__(self, cfg_file: dict, traffic: dict, inputs: dict, device=None):
        import torch

        from dragg_tpu_torch.data import load_environment
        from dragg_tpu_torch.engine import make_engine

        self.torch = torch
        self.cfg = program_config(cfg_file, traffic, inputs)
        env = load_environment(self.cfg)
        self.engine = make_engine(home_batch(inputs), env, self.cfg, inputs["start_index"],
                                  device=device, fleet=fleet_spec(inputs, traffic))
        self.device = self.engine.device
        self.H = self.engine.params.horizon

    def init_state(self):
        """The community's seeded starting state."""
        return self.engine.init_state()

    def run_chunk(self, state, t0: int, n_steps: int):
        """One chunk of ``n_steps`` from sim step ``t0`` at zero reward
        price; returns (state, outputs on the host: per-home arrays (steps,
        homes) and per-step totals (steps,))."""
        rps = np.zeros((n_steps, self.H), dtype=np.float32)
        state, outs = self.engine.run_chunk(state, t0, rps)
        return state, self.to_host(outs)

    def to_host(self, outs) -> dict:
        return {k: getattr(outs, k).cpu().numpy() for k in HOME_FIELDS + STEP_FIELDS}

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def phase_split(self, state, t: int) -> dict:
        """Seconds of one step's three phases (assemble, solve, merge and
        collect), each queued alone and synchronized, at sim step ``t``."""
        import time

        prep, solve, fin = self.engine.phase_fns()
        rp = np.zeros((self.H,), dtype=np.float32)
        factor = self.engine.init_factor()
        self.sync()
        t0 = time.perf_counter()
        qp, aux = prep(state, t, rp)
        self.sync()
        t1 = time.perf_counter()
        sol, _, warm, rf = solve(state, qp, factor, True)
        self.sync()
        t2 = time.perf_counter()
        fin(state, t, sol, aux, warm, rf)
        self.sync()
        t3 = time.perf_counter()
        return {"assemble": t1 - t0, "solve": t2 - t1, "merge_collect": t3 - t2}
