"""Polynomial × Fourier feature bases of the linear RL agent (counterpart
of ``dragg_tpu/rl/basis.py``).

Quadratic bases in each state scalar, outer products flattened with the
constant term dropped, crossed with a Fourier time-of-day basis
(dragg/agent.py:88-111).  Dimensions: state basis 23, state-action basis
71.  Every argument may carry leading batch dimensions; the features
land on the last axis.
"""

from __future__ import annotations

import math

import torch

STATE_DIM = 23
STATE_ACTION_DIM = 71


def _quad(x: torch.Tensor) -> torch.Tensor:
    """(1, x, x²) in a scalar, on a new last axis."""
    return torch.stack([torch.ones_like(x), x, x * x], dim=-1)


def _time_fourier(time_of_day: torch.Tensor) -> torch.Tensor:
    """(1, sin 2πt, cos 2πt) (dragg/agent.py:91)."""
    ang = 2.0 * math.pi * time_of_day
    return torch.stack([torch.ones_like(time_of_day), torch.sin(ang), torch.cos(ang)], dim=-1)


def _outer_tail(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``outer(a, b).flatten()[1:]`` over the last axis."""
    return (a[..., :, None] * b[..., None, :]).flatten(-2)[..., 1:]


def state_basis(fcst_error, forecast_trend, time_of_day) -> torch.Tensor:
    """φ(s) ∈ R^23 (dragg/agent.py:88-96)."""
    phi = _outer_tail(_quad(fcst_error), _quad(forecast_trend))
    return _outer_tail(phi, _time_fourier(time_of_day))


def state_action_basis(fcst_error, forecast_trend, time_of_day, delta_action,
                       action) -> torch.Tensor:
    """φ(s, a) ∈ R^71 (dragg/agent.py:98-111)."""
    ab, dab = _quad(action), _quad(delta_action)
    fe, ft = _quad(fcst_error), _quad(forecast_trend)
    phi = torch.cat([_outer_tail(ft, ab), _outer_tail(fe, ab), _outer_tail(fe, dab)], dim=-1)
    return _outer_tail(phi, _time_fourier(time_of_day))
