"""Environment side of the RL loop (counterpart of ``dragg_tpu/rl/env.py``).

* the utility's setpoint tracker: ``gen_setpoint``'s trailing-average
  load (dragg/aggregator.py:677-696) as an update of a carried window;
* the simplified linear community response, ``test_response``'s
  ``load ← load - c·rp·(setpoint - load)`` (dragg/aggregator.py:898-911);
* the observation the agent sees, built from the community's
  measurements.

The timestep is a host integer (the chunk loop's counter); every other
quantity is a float32 tensor on the carry's device.  A fleet's carry
(:func:`init_fleet_env_carry`) gives every leaf a leading community axis,
and the tracker and :func:`observe` broadcast over it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dragg_tpu_torch.rl.core import RLObservation

F32 = torch.float32


class SetpointTracker(NamedTuple):
    """The trailing-load window of ``gen_setpoint``; the setpoint is its
    mean.  The reference's ``max_load`` / ``min_load`` are consumed by
    nothing and are not carried."""

    tracked: torch.Tensor   # (prev_n,)


def init_tracker(prev_n: int, max_poss_load: float, device) -> SetpointTracker:
    """timestep < 2: tracked ← 0.5·max possible load
    (dragg/aggregator.py:683-686)."""
    return SetpointTracker(torch.full((prev_n,), 0.5 * max_poss_load, dtype=F32,
                                      device=device))


def tracker_step(tr: SetpointTracker, agg_load: torch.Tensor,
                 timestep: int) -> tuple[SetpointTracker, torch.Tensor]:
    """(new tracker, setpoint = mean of the window) after the latest
    community load (dragg/aggregator.py:687-696); over a fleet's (C,)
    loads and (C, prev_n) windows alike."""
    tracked = tr.tracked
    if timestep >= 2:
        tracked = torch.cat([tracked[..., 1:], agg_load.reshape(tracked.shape[:-1] + (1,))],
                            dim=-1)
    return SetpointTracker(tracked), torch.mean(tracked, dim=-1)


class EnvCarry(NamedTuple):
    """The community measurements the agent's state reads
    (setup_rl_agg_run, dragg/aggregator.py:876-896)."""

    agg_load: torch.Tensor
    forecast_load: torch.Tensor
    prev_forecast_load: torch.Tensor
    setpoint: torch.Tensor
    prev_action: torch.Tensor  # action applied two steps ago
    action: torch.Tensor       # action applied last step
    tracker: SetpointTracker


def init_env_carry(n_homes: int, prev_n: int, max_poss_load: float, device) -> EnvCarry:
    """setup_rl_agg_run's initial guesses: forecast = aggregate = 3 kW a
    home (dragg/aggregator.py:889-893)."""
    fl = torch.full((), 3.0 * n_homes, dtype=F32, device=device)
    tr = init_tracker(prev_n, max_poss_load, device)
    zero = torch.zeros((), dtype=F32, device=device)
    return EnvCarry(agg_load=fl, forecast_load=fl.clone(), prev_forecast_load=fl.clone(),
                    setpoint=torch.mean(tr.tracked), prev_action=zero,
                    action=zero.clone(), tracker=tr)


def init_fleet_env_carry(n_homes: int, prev_n: int, max_poss_load, device) -> EnvCarry:
    """:func:`init_env_carry` for a fleet: every leaf gains a leading
    community axis.  ``n_homes`` is per community; ``max_poss_load`` holds
    the (C,) per-community max possible loads (each community is its own
    seeded population, so their normalizers differ)."""
    mpl = torch.as_tensor(np.asarray(max_poss_load, dtype=np.float32), device=device)
    C = mpl.shape[0]
    fl = torch.full((C,), 3.0 * n_homes, dtype=F32, device=device)
    # 0.5·max possible load, rounded to float32 as init_tracker's fill.
    tracked = (0.5 * mpl)[:, None].expand(C, prev_n).contiguous()
    zero = torch.zeros((C,), dtype=F32, device=device)
    return EnvCarry(agg_load=fl, forecast_load=fl.clone(), prev_forecast_load=fl.clone(),
                    setpoint=torch.mean(tracked, dim=-1), prev_action=zero,
                    action=zero.clone(), tracker=SetpointTracker(tracked))


def observe(env: EnvCarry, t: int, dt: int, norm) -> RLObservation:
    """The agent's observation and reward from the community's
    measurements: forecast error and trend over the normalizer, the time
    of day, the change in action, and the negative squared tracking
    error.  A fleet's (C,) leaves take a (C,) tensor of normalizers."""
    day = 24 * dt
    err = (env.agg_load - env.setpoint) / norm
    tod = float(np.float32(t % day) / np.float32(day))
    return RLObservation(
        fcst_error=(env.forecast_load - env.setpoint) / norm,
        forecast_trend=(env.forecast_load - env.prev_forecast_load) / norm,
        time_of_day=torch.full(env.agg_load.shape, tod, dtype=F32,
                               device=env.agg_load.device),
        delta_action=env.action - env.prev_action,
        reward=-(err * err),
    )


def simplified_response(agg_load, rp, setpoint, response_rate: float):
    """One step of the linear community model (dragg/aggregator.py:903-909):
    ``load ← load - c·rp·(setpoint - load)``; cost = load·rp."""
    load = agg_load - response_rate * rp * (setpoint - agg_load)
    return load, load * rp
