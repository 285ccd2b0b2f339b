"""RC thermal dynamics for HVAC and water heater (dragg/mpc_calc.py:313-342
and its fallback simulator :541-582), elementwise on tensors.

Units follow the reference: R in degC/kW, C in kJ/degC (the home dict's
``c`` × 1000), powers in kW per sub-subhourly step (total power / s), dt in
steps-per-hour, duties are raw counts in [0, s].
"""

from __future__ import annotations


def hvac_step(temp_in, oat_next, hvac_r, hvac_c, dt, cool_on, heat_on, p_c, p_h):
    """One indoor-temperature RC step (dragg/mpc_calc.py:313-317).

    T' = T + 3600 * ((OAT - T)/R - cool*Pc + heat*Ph) / (C * dt)
    """
    return temp_in + 3600.0 * (
        (oat_next - temp_in) / hvac_r - cool_on * p_c + heat_on * p_h
    ) / (hvac_c * dt)


def wh_mix(temp_wh, draw, tank_size, tap_temp=15.0):
    """Water-draw mixing (dragg/mpc_calc.py:271,281):
    T' = (T*(size - draw) + tap*draw) / size."""
    return (temp_wh * (tank_size - draw) + tap_temp * draw) / tank_size


def wh_step(temp_wh, temp_in_next, wh_r, wh_c, dt, wh_on, wh_p):
    """One water-heater RC step (dragg/mpc_calc.py:336-338):
    T' = T + 3600 * ((Tin - T)/Rwh + wh*Pwh) / (Cwh * dt)
    """
    return temp_wh + 3600.0 * (
        (temp_in_next - temp_wh) / wh_r + wh_on * wh_p
    ) / (wh_c * dt)
