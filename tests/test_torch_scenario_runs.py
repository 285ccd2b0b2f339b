"""The port's engine under scenario events, the interior point, against
the JAX engine: 12 homes of the six types (two each: pv_battery, pv_only,
battery_only, ev, heat_pump, base), a tariff shock, a DR call and an
outage, 7 hourly steps at H = 4, each step from the JAX engine's state
(``check_event_run``, shared with tests/test_torch_scenario_reluqp.py).

Solved flags are equal on every home-step, and every series on every
home-step within SERIES_ATOL, test_torch_engine.py's 1e-4 (the community
totals within the sum of their homes' bounds).  Both packages run the
interior point at ``tpu.ipm_eps = 5e-5``: at the default 2e-4 the two
float32 solves stop at points up to 3.2e-4 apart on the battery of a
pv_battery home in the outage (e_batt; u_pv_curt 2.3e-4, p_grid 1.2e-4),
at 5e-5 within 9.5e-5 (u_pv_curt), every other series within 8e-6.  No
bucket of this run reaches the iteration cap: all 84 home-steps stop
below it.  On both packages' solved homes the DR cap and the islanding
hold within one duty count per appliance (the integer pin rounds the
applied action; tests/test_scenarios.py).

Where a run does hold homes at the cap (the EV daily cycle of
tests/test_torch_scenarios.py: an EV whose departure floor is its
reachable charge less 1e-3 kWh), whether the last iterate passes the
solved test is float32 noise, and ``flip_aware_compare`` compares home by
home: each home-step whose bucket stopped below the cap in both packages
(``bucket_iterations``) has equal flags and its series within
SERIES_ATOL, at least ``min_compared`` of them.
"""

import warnings

import numpy as np
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu_torch import engine as te
from dragg_tpu_torch.interop import engine_state_from_numpy
from test_torch_scenarios import DR_STEPS, OUTAGE_STEPS, PER_HOME, TOTALS, _engines, _mixed

SERIES_ATOL = 1e-4
EVENT_IPM_EPS = 5e-5


def bucket_iterations(engine, broadcast, cat):
    """Make ``engine``'s merged ``admm_iters`` per home: the iteration
    count of each home's bucket (the engines merge it as the largest over
    buckets).  ``broadcast`` and ``cat`` are the engine's array library's."""
    merge = engine._merge_outputs

    def merged(outs):
        return merge(outs)._replace(admm_iters=cat(
            [broadcast(o.admm_iters, o.correct_solve.shape) for o in outs]))

    engine._merge_outputs = merged


def home_iterations(out):
    """(steps, homes) iteration counts of stacked outputs: per home after
    ``bucket_iterations``, else one bucket's per step."""
    iters = np.asarray(out.admm_iters)
    shape = np.shape(out.correct_solve)
    return np.broadcast_to(iters.reshape(shape[0], -1), shape)


def flip_aware_compare(out_j, out_t, cap, min_compared, min_agree=1.0):
    """out_t (the port's) against out_j (the JAX package's), ``cap`` the
    solver's iteration cap: on every home-step whose bucket stopped below
    it in both, equal solved flags and each series within SERIES_ATOL (at
    least ``min_compared`` such home-steps); flags equal on ``min_agree``
    of all home-steps.  Returns both packages' flags and the count of
    compared home-steps."""
    ok_j = np.asarray(out_j.correct_solve) > 0
    ok_t = out_t.correct_solve.numpy() > 0
    below = (home_iterations(out_j) < cap) & (home_iterations(out_t) < cap)
    assert below.sum() >= min_compared, f"{below.sum()} home-steps below the cap"
    agree = ok_j == ok_t
    assert agree[below].all(), f"solved flags differ below the cap at {np.argwhere(~agree & below)}"
    assert agree.mean() >= min_agree, f"solved flags agree on {agree.mean():.3f}"
    for f in PER_HOME:
        a, b = np.asarray(getattr(out_j, f)), getattr(out_t, f).numpy()
        np.testing.assert_allclose(b[below], a[below], rtol=0, atol=SERIES_ATOL, err_msg=f)
    return ok_j, ok_t, int(below.sum())


def assert_events_held(outs, batch, ok):
    """DR cap and islanding on solved homes, within one duty count per
    appliance (the integer pin's rounding) plus 0.05 kW."""
    pg = np.asarray(outs.p_grid) if not torch.is_tensor(outs.p_grid) else outs.p_grid.numpy()
    slack = float(np.max(np.asarray(batch.hvac_p_c) + np.asarray(batch.hvac_p_h)
                         + np.asarray(batch.wh_p)))
    dr = [k for k in DR_STEPS if k < len(pg)]
    out = [k for k in OUTAGE_STEPS if k < len(pg)]
    assert ok[dr + out].any()
    assert np.all(pg[dr][ok[dr]] <= 4.0 + slack + 0.05)
    assert np.all(np.abs(pg[out][ok[out]]) <= slack + 0.05)


def stepwise_runs(ej, et, steps):
    """``steps`` one-step chunks of each engine, both starting every step
    from the JAX engine's state (so the comparison sees one step's solver
    difference, not a drift carried on); the outputs stacked in time."""
    rp = np.zeros((1, ej.params.horizon), np.float32)
    state = ej.init_state()
    outs_j, outs_t = [], []
    for t in range(steps):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            nxt, oj = ej.run_chunk(state, t, rp)
        _, ot = et.run_chunk(engine_state_from_numpy(state, "cpu"), t, rp)
        outs_j.append(oj)
        outs_t.append(ot)
        state = nxt
    stack_j = type(outs_j[0])(*[np.concatenate([np.asarray(getattr(o, f)) for o in outs_j])
                                for f in outs_j[0]._fields])
    stack_t = te.StepOutputs(*[torch.cat([getattr(o, f) for o in outs_t])
                               for f in te.StepOutputs._fields])
    return stack_j, stack_t


def check_event_run(solver, horizon, steps):
    """12 homes of the six types, ``steps`` hourly steps from 2015-01-01
    00: the shock on hours 1-3, the DR call (4 kW) on 2-4, the outage on
    5-6; each step from the JAX engine's state; flags equal and every
    series within SERIES_ATOL on every home-step.  ReLU-QP's iteration cap
    is 250 (and its exact tail 50) in both packages: 2,000 iterations of
    twelve homes' windows take minutes on the CPU."""
    import jax.numpy as jnp

    cfg = _mixed(horizon, solver)
    if solver == "reluqp":
        cfg["tpu"].update(reluqp_iters=250, reluqp_tail_iters=50)
    else:
        cfg["tpu"]["ipm_eps"] = EVENT_IPM_EPS
    ej, et, batch = _engines(cfg)
    assert [b["name"] for b in et.bucket_info()] == [
        "pv_battery", "pv_only", "battery_only", "ev", "heat_pump", "base"]
    assert all(c.lay.has_grid for c in et._buckets)
    assert et.iter_kernel == "lax"
    bucket_iterations(ej, jnp.broadcast_to, jnp.concatenate)
    bucket_iterations(et, lambda a, shape: a.expand(shape), torch.cat)
    out_j, out_t = stepwise_runs(ej, et, steps)
    ok_j = np.asarray(out_j.correct_solve) > 0
    ok_t = out_t.correct_solve.numpy() > 0
    np.testing.assert_array_equal(ok_t, ok_j)
    for f in PER_HOME:
        np.testing.assert_allclose(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)),
                                   rtol=0, atol=SERIES_ATOL, err_msg=f)
    n_homes = ok_j.shape[1]
    for f in TOTALS:
        np.testing.assert_allclose(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)),
                                   rtol=0, atol=n_homes * SERIES_ATOL, err_msg=f)
    assert_events_held(out_j, batch, ok_j)
    assert_events_held(out_t, batch, ok_t)
    return home_iterations(out_t)


def test_event_run_matches_jax():
    iters = check_event_run("ipm", 4, 7)
    assert iters.max() < 16 + 4 // 2  # every bucket below engine_params' cap at H = 4
