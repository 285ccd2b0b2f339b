"""The RL run modes ``run_rl_agg`` and ``run_rl_simplified`` (counterpart
of ``dragg_tpu/rl/runner.py``).

The reference documents three cases (README.md:54-56): the RBO-MPC
baseline, the RL price-signal aggregator driving the MPC community, and
the RL agent against the simplified linear community model.  Each
timestep of an RL case is {observation → agent step → reward price →
community response → setpoint tracking}, run step by step on the
engine's device: a chunk reads nothing back to the host until it ends,
when its stacked outputs, agent records, prices and setpoints are copied
over in one go.  A fleet (``fleet.communities > 1``) runs the fleet form
of both cases (:mod:`~dragg_tpu_torch.rl.fleet`); one community stays on
this module's path.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from dragg_tpu_torch.checkpoint import host_snapshot, to_host
from dragg_tpu_torch.engine import StepOutputs
from dragg_tpu_torch.rl.agent import UtilityAgent
from dragg_tpu_torch.rl.core import StepRecord
from dragg_tpu_torch.rl.env import (
    EnvCarry,
    init_env_carry,
    init_tracker,
    observe,
    simplified_response,
    tracker_step,
)

F32 = torch.float32


def _rl_settings(config: dict) -> dict:
    rl_cfg = config["agg"].get("rl", {})
    return {
        "prev_n": int(rl_cfg.get("prev_timesteps", 12)),
        "max_rp": float(rl_cfg.get("max_rp", 0.02)),
        "action_horizon": int(rl_cfg.get("action_horizon", 1)),
    }


def _reward_price(agent, acarry, max_rp: float) -> torch.Tensor:
    """The agent's next action clipped to its action space, then to
    ±``max_rp``: the announced reward price."""
    p = agent.params
    action = torch.clamp(acarry.next_action, p.action_low, p.action_high)
    return torch.clamp(action, -max_rp, max_rp)


# --------------------------------------------------------------------------
# RL aggregator driving the MPC community (case "rl_agg")
# --------------------------------------------------------------------------

def _fused_step(engine, agent, dt: int, norm: float, max_rp: float, rp_len: int,
                carry, factor, t: int, t0: int):
    """One RL + community-MPC timestep, in the reference's order: the agent
    trains on the previous step's measurements (dragg/agent.py:130-149),
    the new reward price is announced (dragg/aggregator.py:664-675), the
    community solves, and the setpoint tracker advances
    (dragg/aggregator.py:726-755).

    ``rp_len = action_horizon·dt`` is the announced window: one hour or
    less (or the whole horizon) broadcasts across the MPC horizon, as the
    reference's length-1 price list does (dragg/mpc_calc.py:353); a longer
    window prices its first ``rp_len`` steps and zero beyond.  The solver
    carry ``factor`` refreshes on the chunk's first step and every
    ``admm_refactor_every`` steps, as ``Engine.run_chunk``'s."""
    cstate, acarry, env = carry
    obs = observe(env, t, dt, norm)
    acarry, rec = agent.scan_step(acarry, obs)
    rp = _reward_price(agent, acarry, max_rp)
    H = engine.params.horizon
    if rp_len <= dt or rp_len >= H:
        rp_vec = rp.expand(H)
    else:
        rp_vec = torch.where(torch.arange(H, device=rp.device) < rp_len, rp, 0.0)
    K = max(1, engine.params.admm_refactor_every)
    cstate, factor, outs = engine._step(cstate, t, rp_vec, t == t0 or t % K == 0, factor)
    tracker, sp = tracker_step(env.tracker, outs.agg_load, t + 1)
    new_env = EnvCarry(
        agg_load=outs.agg_load,
        forecast_load=outs.forecast_load,
        prev_forecast_load=env.forecast_load,
        setpoint=sp,
        prev_action=env.action,
        action=rp,
        tracker=tracker,
    )
    return (cstate, acarry, new_env), factor, (outs, rec, rp, env.setpoint)


def _stack(rows: list, kind):
    return kind(*(torch.stack(leaves) for leaves in zip(*rows)))


def run_chunk(engine, agent, settings: dict, norm: float, carry, t0: int, n_steps: int):
    """``n_steps`` fused steps from sim step ``t0``: (carry after them,
    (StepOutputs, StepRecord, prices, setpoints) stacked along time, on
    the device).  The solver carry is chunk-local."""
    dt = engine.params.dt
    factor = engine.init_factor()
    outs, recs, rps, sps = [], [], [], []
    for t in range(t0, t0 + n_steps):
        carry, factor, (o, r, rp, sp) = _fused_step(
            engine, agent, dt, norm, settings["max_rp"], settings["action_horizon"] * dt,
            carry, factor, t, t0)
        outs.append(o)
        recs.append(r)
        rps.append(rp)
        sps.append(sp)
    return carry, (_stack(outs, StepOutputs), _stack(recs, StepRecord),
                   torch.stack(rps), torch.stack(sps))


def run_rl_agg(agg) -> None:
    """The RL price-signal aggregator over the whole MPC community, in
    chunks of ``simulation.checkpoint_interval`` with results.json and a
    resumable checkpoint (the agent's and the environment's carries and
    rl_data.json beside the community state) at every boundary before the
    end.  A fleet runs :func:`~dragg_tpu_torch.rl.fleet.run_rl_agg_fleet`."""
    if agg.n_communities > 1:
        from dragg_tpu_torch.rl.fleet import run_rl_agg_fleet

        return run_rl_agg_fleet(agg)
    config = agg.config
    agg.case = "rl_agg"
    if agg.all_homes is None:
        agg.get_homes()
    if agg.engine is None:
        agg._build_engine()
    agg.reset_collected_data()
    agg.all_rps = np.zeros(agg.num_timesteps)
    agg.all_sps = np.zeros(agg.num_timesteps)

    settings = _rl_settings(config)
    norm = agg._max_possible_load()
    agent = UtilityAgent(config, device=agg.device)
    env = init_env_carry(len(agg.all_homes), settings["prev_n"], norm, agg.device)
    agg.checkpoint_interval = agg._checkpoint_steps()
    if agg.run_dir is None:
        agg.set_run_dir()
    agg.log.logger.info(
        f"Performing RL AGG run for horizon: {config['home']['hems']['prediction_horizon']}")
    agg.start_time = time.time()
    case_dir = os.path.join(agg.run_dir, agg.case)
    carry, t = agg.try_resume((agg.engine.init_state(), agent.carry, env))
    if agg.resumed_from is not None:
        # The agent's telemetry, saved in the same checkpoint directory.
        rl_file = os.path.join(agg.resumed_from, "rl_data.json")
        if os.path.isfile(rl_file):
            with open(rl_file) as f:
                agent.rl_data = json.load(f)
    chunks = 0
    while t < agg.num_timesteps:
        n_steps = min(agg.checkpoint_interval, agg.num_timesteps - t)
        # The community state at the chunk's start, for a forensic dump.
        agg._chunk_state0 = host_snapshot(carry[0]) if agg._forensics_on else None
        d0 = time.perf_counter()
        carry, stacked = run_chunk(agg.engine, agent, settings, norm, carry, t, n_steps)
        outs, recs, rps, sps = host_snapshot(stacked)
        agg._phase_times["device_chunks"] += time.perf_counter() - d0
        c0 = time.perf_counter()
        # The chunk's prices first: a forensic dump of it records them.
        agg.all_rps[t:t + n_steps] = rps
        agg.all_sps[t:t + n_steps] = sps
        agg._collect_chunk(outs, track_setpoints=False)
        agent.record_chunk(recs)
        agg._phase_times["collect"] += time.perf_counter() - c0
        t += n_steps
        chunks += 1
        if t < agg.num_timesteps:
            agg.write_outputs()
            agg.save_checkpoint(carry, extra_json={"rl_data.json": agent.rl_data})
            if agg.stop_after_chunks is not None and chunks >= agg.stop_after_chunks:
                agg.log.logger.info(f"Stopping early after {chunks} chunks.")
                break
    agent.carry = carry[1]
    agg.agent = agent
    if t < agg.num_timesteps:
        return
    agg.check_baseline_vals()
    agg.write_outputs()
    agent.write_rl_data(case_dir)
    agg.clear_checkpoint()


# --------------------------------------------------------------------------
# RL agent against the simplified linear community model (case "simplified")
# --------------------------------------------------------------------------

def run_rl_simplified(agg) -> None:
    """The RL agent against ``test_response``'s linear model: no MPC
    community is built; results.json holds only the Summary.  A fleet runs
    :func:`~dragg_tpu_torch.rl.fleet.run_rl_simplified_fleet`."""
    if agg.n_communities > 1:
        from dragg_tpu_torch.rl.fleet import run_rl_simplified_fleet

        return run_rl_simplified_fleet(agg)
    config = agg.config
    agg.case = "simplified"
    settings = _rl_settings(config)
    c_rate = float(config["agg"].get("simplified", {}).get("response_rate", 0.3))
    n_homes = int(config["community"]["total_number_homes"])
    house_p_avg = float(config["community"].get("house_p_avg", 1.2))
    # No MPC community: normalize by its average-power proxy
    # (set_dummy_rl_parameters, dragg/aggregator.py:872-874).
    norm = max(1.0, house_p_avg * n_homes * 2.5)
    dt = agg.dt
    dev = agg.device

    agent = UtilityAgent(config, device=dev)
    max_rp = settings["max_rp"]
    tr = init_tracker(settings["prev_n"], house_p_avg * n_homes * 2.5, dev)
    sp0 = float(np.mean(to_host(tr.tracked)))
    # The t = 0 community load: setpoint + 10 % (test_response,
    # dragg/aggregator.py:904-905).
    load0 = torch.full((), 1.1 * sp0, dtype=F32, device=dev)
    zero = torch.zeros((), dtype=F32, device=dev)
    env = EnvCarry(agg_load=load0, forecast_load=load0, prev_forecast_load=load0,
                   setpoint=torch.full((), sp0, dtype=F32, device=dev),
                   prev_action=zero, action=zero, tracker=tr)

    agg.log.logger.info("Performing RL simplified-response run")
    agg.start_time = time.time()
    acarry = agent.carry
    rows = []
    for t in range(agg.num_timesteps):
        obs = observe(env, t, dt, norm)
        acarry, rec = agent.scan_step(acarry, obs)
        rp = _reward_price(agent, acarry, max_rp)
        load, cost = simplified_response(env.agg_load, rp, env.setpoint, c_rate)
        tracker, sp = tracker_step(env.tracker, load, t + 1)
        rows.append((rec, load, cost, rp, env.setpoint))
        env = EnvCarry(agg_load=load, forecast_load=load, prev_forecast_load=env.agg_load,
                       setpoint=sp, prev_action=env.action, action=rp, tracker=tracker)
    agent.carry = acarry
    recs = _stack([r[0] for r in rows], StepRecord)
    loads, costs, rps, sps = (to_host(torch.stack([r[k] for r in rows])) for k in range(1, 5))
    agent.record_chunk(recs)

    # The aggregator's Summary and results writer, without per-home series.
    agg._solve_iters = []
    agg.baseline_agg_load_list = loads.tolist()
    agg.all_rps = np.asarray(rps, dtype=np.float64)
    agg.all_sps = np.asarray(sps, dtype=np.float64)
    agg.extra_summary = {"agg_cost": costs.tolist()}
    agg.summary_only_case = True
    if agg.run_dir is None:
        agg.set_run_dir()
    agg.write_outputs()
    agg.extra_summary = {}
    agg.summary_only_case = False
    agent.write_rl_data(os.path.join(agg.run_dir, agg.case))
    agg.agent = agent
