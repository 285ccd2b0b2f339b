"""PV generation model (dragg/mpc_calc.py:380-385)."""

from __future__ import annotations


def pv_power(ghi, area, eff, u_curt):
    """p_pv = area * eff * GHI * (1 - u_curt) / 1000  [kW], GHI in W/m2."""
    return area * eff * ghi * (1.0 - u_curt) / 1000.0
