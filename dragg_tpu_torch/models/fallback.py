"""Vectorized rule-based fallback controller (counterpart of
``dragg_tpu/models/fallback.py``).

When a home's MPC solve fails (dragg/mpc_calc.py:527-596): (i) replay the
last feasible plan shifted by ``solve_counter`` and patch it bang-bang
where the simulated temperatures would violate bounds, else (ii) pure
bang-bang on the current thermal state.  Branch-free over the batch:
every home evaluates both paths and ``torch.where`` selects.  Duties are
raw counts in [0, s].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dragg_tpu_torch.models.thermal import hvac_step, wh_step


class FallbackResult(NamedTuple):
    cool_on: torch.Tensor   # raw duty [0, s]
    heat_on: torch.Tensor
    wh_on: torch.Tensor
    temp_in: torch.Tensor   # simulated next indoor temp
    temp_wh: torch.Tensor   # simulated next WH temp
    counter: torch.Tensor   # updated solve_counter


def fallback_control(
    counter,            # (n,) solve_counter already incremented for this failure
    timestep,           # int
    horizon: int,
    replay_cool,        # (n,) raw-duty plan value at index `counter` of the last feasible plan
    replay_heat,
    replay_wh,
    temp_in_init,       # (n,)
    temp_wh_init,       # (n,) (after draw mixing)
    oat1,               # scalar or (n,) OAT at step t+1
    hvac_r, hvac_c, hvac_p_c, hvac_p_h,
    wh_r, wh_c, wh_p,
    temp_in_min, temp_in_max, temp_wh_min, temp_wh_max,
    cool_max, heat_max, wh_max,  # (n,) seasonal duty caps (0 or s)
    dt: int,
) -> FallbackResult:
    """Fallback duties + simulated temps for every home; the caller applies
    them only where the solve failed."""
    zero = torch.zeros_like(temp_in_init)

    # --- Path A: replay last feasible plan, shifted (dragg/mpc_calc.py:533-557).
    replay_ok = (counter < horizon) & (timestep > 0)
    a_cool, a_heat, a_wh = replay_cool, replay_heat, replay_wh
    t_in_a = hvac_step(temp_in_init, oat1, hvac_r, hvac_c, dt, a_cool, a_heat, hvac_p_c, hvac_p_h)
    t_wh_a = wh_step(temp_wh_init, t_in_a, wh_r, wh_c, dt, a_wh, wh_p)
    too_hot = t_in_a > temp_in_max
    too_cold = t_in_a < temp_in_min
    a_heat = torch.where(too_hot, zero, torch.where(too_cold, heat_max, a_heat))
    a_cool = torch.where(too_hot, cool_max, torch.where(too_cold, zero, a_cool))
    a_wh = torch.where(t_wh_a < temp_wh_min, wh_max, a_wh)

    # --- Path B: pure bang-bang on current state (dragg/mpc_calc.py:559-574).
    hot0 = temp_in_init > temp_in_max
    cold0 = temp_in_init < temp_in_min
    b_heat = torch.where(cold0, heat_max, zero)
    b_cool = torch.where(hot0, cool_max, zero)
    b_wh = torch.where(temp_wh_init < temp_wh_min, wh_max, zero)
    counter_b = torch.clamp(counter, min=horizon)

    cool = torch.where(replay_ok, a_cool, b_cool)
    heat = torch.where(replay_ok, a_heat, b_heat)
    wh = torch.where(replay_ok, a_wh, b_wh)
    new_counter = torch.where(replay_ok, counter, counter_b)

    # Final forward simulation with the chosen duties (dragg/mpc_calc.py:576-582).
    new_temp_in = hvac_step(temp_in_init, oat1, hvac_r, hvac_c, dt, cool, heat, hvac_p_c, hvac_p_h)
    new_temp_wh = wh_step(temp_wh_init, new_temp_in, wh_r, wh_c, dt, wh, wh_p)

    return FallbackResult(
        cool_on=cool, heat_on=heat, wh_on=wh,
        temp_in=new_temp_in, temp_wh=new_temp_wh, counter=new_counter,
    )
