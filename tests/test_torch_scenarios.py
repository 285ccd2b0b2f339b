"""The port's scenario layer (dragg_tpu_torch/scenarios/) and its engine
under events and the ev / heat_pump home types, against the JAX package:

* pack expansion, the dense event timelines (every kind, one community
  and three), their digest and summary, and the errors of bad events and
  packs: exactly equal;
* a timeline that changes nothing gives the run without a timeline, bit
  for bit;
* the heat pump's COP-scaled fallback from the same state;
* the EV's daily cycle over 24 hourly steps with the interior point (4 EV
  homes, H = 6, ``tpu.ipm_eps = 5e-5`` in both packages, each step from
  the JAX engine's state, compared home-step by home-step below the
  iteration cap as tests/test_torch_scenario_runs.py's
  ``flip_aware_compare`` does, series within 1e-4): the charge and the state
  of charge the JAX engine gives, no charging while away, the state of
  charge within [0, capacity], the trip drained on the return step, and
  the departure target met by homes that can reach it
  (tests/test_scenarios.py::test_ev_daily_cycle).

The engine runs under events are tests/test_torch_scenario_runs.py (the
interior point) and tests/test_torch_scenario_reluqp.py (ReLU-QP).
"""

import copy

import jax.numpy as jnp

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu import data as jd
from dragg_tpu import engine as je
from dragg_tpu import homes as jh
from dragg_tpu import scenarios as js
from dragg_tpu_torch import engine as te
from dragg_tpu_torch import scenarios as ts
from dragg_tpu_torch.config import default_config
from dragg_tpu_torch.interop import engine_state_from_numpy

EVENTS = [
    dict(kind="tariff_shock", start_hour=1, duration_hours=3, price_delta=0.1),
    dict(kind="dr", start_hour=2, duration_hours=3, p_cap_kw=4.0, comfort_relax_degc=1.5),
    dict(kind="outage", start_hour=5, duration_hours=2, comfort_relax_degc=2.0),
]
DR_STEPS, OUTAGE_STEPS = [2, 3, 4], [5, 6]
PER_HOME = ("p_grid", "forecast_p_grid", "p_load", "temp_in", "temp_wh", "hvac_cool_on",
            "hvac_heat_on", "wh_heat_on", "cost", "waterdraws", "p_pv", "u_pv_curt",
            "e_batt", "p_batt_ch", "p_batt_disch", "p_ev_ch", "e_ev")
TOTALS = ("agg_load", "forecast_load", "agg_cost")


def _mixed(horizon=4, solver="ipm", events=EVENTS):
    cfg = default_config()
    cfg["community"].update(total_number_homes=12, homes_pv=2, homes_battery=2,
                            homes_pv_battery=2, homes_ev=2, homes_heat_pump=2)
    cfg["home"]["hems"].update(prediction_horizon=horizon, solver=solver)
    cfg["tpu"].update(fix_tou_peak=True, bucketed="true")
    cfg["scenarios"]["events"] = copy.deepcopy(events)
    return cfg


def _engines(cfg, events=None):
    cfg = ts.apply_scenarios(cfg)
    env = jd.load_environment(cfg)
    wd = jd.load_waterdraw_profiles(jd.waterdraw_path(cfg, None), seed=12)
    H = int(cfg["home"]["hems"]["prediction_horizon"])
    batch = jh.build_home_batch(jh.create_homes(cfg, 48, 1, wd), H, 1, 6)
    start = env.start_index(jd.parse_dt(cfg["simulation"]["start_datetime"]))
    return (je.make_engine(batch, env, cfg, start, events=events),
            te.make_engine(batch, env, cfg, start, device="cpu", events=events), batch)


# -------------------------------------------------------- packs, timelines
@pytest.mark.parametrize("pack,events", [
    ("stress_dr_outage", []), ("", EVENTS), ("stress_dr_outage", EVENTS[1:])],
    ids=["shipped-pack", "inline-events", "pack-and-inline"])
def test_apply_scenarios_matches_jax(pack, events):
    cfg = default_config()
    cfg["community"]["total_number_homes"] = 37
    cfg["scenarios"].update(pack=pack, events=copy.deepcopy(events))
    got, want = ts.apply_scenarios(cfg), js.apply_scenarios(cfg)
    assert got == want
    assert ts.apply_scenarios(got) is got  # idempotent
    assert ts.load_pack(ts.pack_path("stress_dr_outage")) == js.load_pack(
        js.pack_path("stress_dr_outage"))


@pytest.mark.parametrize("communities", [1, 3])
@pytest.mark.parametrize("kind", ["tariff_shock", "dr", "outage"])
def test_timeline_for_matches_jax(kind, communities):
    """Each kind's dense series, repeated daily or once, for every community
    or some, at an hourly and a quarter-hourly grid."""
    ev = {"tariff_shock": dict(price_delta=0.07, repeat_hours=24),
          "dr": dict(p_cap_kw=2.5, comfort_relax_degc=1.0, repeat_hours=12),
          "outage": dict(comfort_relax_degc=2.0)}[kind]
    events = [dict(kind=kind, start_hour=3, duration_hours=2.5, **ev),
              dict(kind=kind, start_hour=30, duration_hours=1, **ev,
                   communities=list(range(0, communities, 2)))]
    cfg = default_config()
    cfg["tpu"]["fix_tou_peak"] = True
    cfg["scenarios"]["events"] = events
    for dt, start_index in ((1, 0), (4, 37)):
        got = ts.timeline_for(cfg, communities, 200, dt, start_index)
        want = js.timeline_for(cfg, communities, 200, dt, start_index)
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
            assert getattr(got, f).dtype == np.float32
        assert ts.timeline_digest(got) == js.timeline_digest(want)
        assert ts.describe_timeline(got) == js.describe_timeline(want)
    assert ts.timeline_for(default_config(), communities, 50, 1, 0) is None
    assert ts.describe_timeline(None) == js.describe_timeline(None)


@pytest.mark.parametrize("bad", [
    [dict(kind="nope", start_hour=0, duration_hours=1)],
    [dict(kind="dr", start_hour=0, duration_hours=0, p_cap_kw=1.0)],
    [dict(kind="dr", start_hour=0, duration_hours=4, repeat_hours=2, p_cap_kw=1.0)],
    [dict(kind="dr", start_hour=0, duration_hours=4, repeat_hours=-1, p_cap_kw=1.0)],
    [dict(kind="dr", start_hour=0, duration_hours=1, p_cap_kw=1.0, communities=[3])],
], ids=["kind", "duration", "repeat", "negative-repeat", "communities"])
def test_bad_events_raise_as_jax(bad):
    with pytest.raises(js.ScenarioError) as want:
        js.build_timeline(bad, 2, 10, 1, 0)
    with pytest.raises(ts.ScenarioError) as got:
        ts.build_timeline(bad, 2, 10, 1, 0)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("pack", [
    "[mix]\nsolar = 0.2\n", "[mix]\nev = 1.5\n", "[mix]\nev = 0.6\nheat_pump = 0.6\n",
    '[[events]]\nkind = "blackout"\n', None,
], ids=["unknown-type", "fraction", "sum", "event-kind", "not-found"])
def test_bad_packs_raise_as_jax(tmp_path, pack):
    name = "no_such_pack"
    if pack is not None:
        (tmp_path / "bad.toml").write_text(pack)
        name = str(tmp_path / "bad.toml")
    cfg = default_config()
    cfg["scenarios"]["pack"] = name
    with pytest.raises(js.ScenarioError) as want:
        js.apply_scenarios(cfg)
    with pytest.raises(ts.ScenarioError) as got:
        ts.apply_scenarios(cfg)
    assert str(got.value) == str(want.value)


def test_unexpanded_pack_warns_and_is_ignored():
    cfg = default_config()
    cfg["scenarios"]["pack"] = "stress_dr_outage"
    with pytest.warns(UserWarning, match="never expanded"):
        assert ts.timeline_for(cfg, 1, 50, 1, 0) is None


def test_inert_timeline_is_bit_equal_to_none():
    """An all-default timeline, and events whose effect is nil, run the
    program of no timeline at all, bit for bit."""
    cfg = _mixed(events=[])
    _, et0, batch = _engines(cfg)
    n_env = len(et0._oat)
    inert = ts.empty_timeline(1, n_env)
    assert inert.inert
    assert ts.build_timeline([dict(kind="tariff_shock", start_hour=0, duration_hours=2,
                                   price_delta=0.0)], 1, n_env, 1, 0) is None
    _, et1, _ = _engines(cfg, events=inert)
    assert et1.events is None and [b["m_eq"] for b in et1.bucket_info()] == [
        b["m_eq"] for b in et0.bucket_info()]
    rps = np.zeros((3, 4), np.float32)
    _, o0 = et0.run_chunk(et0.init_state(), 0, rps)
    _, o1 = et1.run_chunk(et1.init_state(), 0, rps)
    for f in te.StepOutputs._fields:
        assert torch.equal(getattr(o0, f), getattr(o1, f)), f


def test_heat_pump_fallback_matches_jax():
    """The heat-pump bucket's finish with every home routed to the
    fallback controller (its COP-scaled rates), from the same state."""
    ej, et, _ = _engines(_mixed(events=[]))
    b = [c.name for c in et._buckets].index("heat_pump")
    cj, ct = ej._buckets[b], et._buckets[b]
    sj = ej.init_state()[b]
    st = engine_state_from_numpy(sj, "cpu")
    # Replayed plans, so the fallback's counts are not all zero.
    plans = np.random.default_rng(3).uniform(0, 6, (3,) + tuple(st.plan_heat.shape))
    sj = sj._replace(plan_cool=jnp.asarray(plans[0], jnp.float32),
                     plan_heat=jnp.asarray(plans[1], jnp.float32),
                     plan_wh=jnp.asarray(plans[2], jnp.float32))
    st = st._replace(plan_cool=torch.tensor(plans[0], dtype=torch.float32),
                     plan_heat=torch.tensor(plans[1], dtype=torch.float32),
                     plan_wh=torch.tensor(plans[2], dtype=torch.float32))
    for t in (0, 5):
        qj, aj = ej._prepare(cj, sj, t, jnp.zeros(4, jnp.float32))
        qt, at = et._prepare(ct, st, t, torch.zeros(4))
        sol_j = ej._solve(cj, sj, qj, ej._init_factor_bucket(cj), True)[0]
        sol_t = et._solve(ct, st, qt, None, True)[0]
        sol_j = sol_j._replace(solved=jnp.zeros_like(sol_j.solved))
        sol_t = sol_t._replace(solved=torch.zeros_like(sol_t.solved))
        nj, oj = ej._finish(cj, sj, t, sol_j, aj, sol_j)
        nt, ot = et._finish(ct, st, t, sol_t, at, sol_t, torch.zeros(()))
        assert np.asarray(ct.batch.is_hp).all()
        for f in ("temp_in", "temp_wh", "hvac_cool_on", "hvac_heat_on", "wh_heat_on",
                  "p_load", "p_grid", "cost"):
            np.testing.assert_allclose(getattr(ot, f).numpy(), np.asarray(getattr(oj, f)),
                                       rtol=0, atol=1e-5, err_msg=f)
        np.testing.assert_array_equal(nt.counter.numpy(), np.asarray(nj.counter))


def test_ev_daily_cycle_matches_jax():
    from test_torch_scenario_runs import EVENT_IPM_EPS, flip_aware_compare, stepwise_runs

    cfg = default_config()
    cfg["community"].update(total_number_homes=4, homes_pv=0, homes_ev=4)
    cfg["simulation"]["random_seed"] = 3
    cfg["home"]["hems"]["prediction_horizon"] = 6
    cfg["tpu"]["ipm_eps"] = EVENT_IPM_EPS
    env = jd.load_environment(cfg, data_dir=None)
    wd = jd.load_waterdraw_profiles(None, seed=3)
    batch = jh.build_home_batch(jh.create_homes(cfg, 48, 1, wd), 6, 1, 6)

    ej = je.make_engine(batch, env, cfg, 0)
    et = te.make_engine(batch, env, cfg, 0, device="cpu")
    out_j, out_t = stepwise_runs(ej, et, 24)
    # The away hours hold the homes at the cap (module docstring of
    # test_torch_scenario_runs.py): their flags are noise there.
    # 40 of the 96 home-steps stop below it; flags agree on 0.927 of all.
    _, ok_t, _ = flip_aware_compare(out_j, out_t, et.params.ipm_iters,
                                    min_compared=40, min_agree=0.85)
    p_ev, e_ev = out_t.p_ev_ch.numpy(), out_t.e_ev.numpy()
    b = {k: np.asarray(getattr(batch, k)) for k in (
        "ev_away_start", "ev_away_end", "ev_cap", "ev_target_kwh", "ev_rate", "ev_ch_eff",
        "ev_init_frac", "ev_trip_kwh")}
    hours = np.arange(24)[:, None]
    away = (hours >= b["ev_away_start"]) & (hours < b["ev_away_end"])
    assert np.all(p_ev[away] <= 1e-4)
    assert np.all(e_ev >= -1e-4) and np.all(e_ev <= b["ev_cap"] + 1e-3)
    assert p_ev.max() > 1.0  # the vehicles charged
    init = b["ev_init_frac"] * b["ev_cap"]
    for i in range(4):
        dep, ret = int(np.ceil(b["ev_away_start"][i])), int(np.ceil(b["ev_away_end"][i]))
        drop = e_ev[ret - 2, i] - e_ev[ret - 1, i]
        np.testing.assert_allclose(drop, min(b["ev_trip_kwh"][i], e_ev[ret - 2, i]), atol=5e-3)
        reach = init[i] + dep * b["ev_rate"][i] * b["ev_ch_eff"][i]
        if reach >= b["ev_target_kwh"][i] and ok_t[:dep, i].all():
            assert e_ev[dep - 1, i] >= b["ev_target_kwh"][i] - 5e-2
