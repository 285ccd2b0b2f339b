"""Battery state-of-charge dynamics (dragg/mpc_calc.py:363-372)."""

from __future__ import annotations


def battery_step(e_batt, p_ch, p_disch, ch_eff, disch_eff, dt):
    """E' = E + (eta_ch * p_ch + p_disch / eta_disch) / dt.

    ``p_disch`` is non-positive by convention (dragg/mpc_calc.py:369-370).
    """
    return e_batt + (ch_eff * p_ch + p_disch / disch_eff) / dt
