"""The port's aggregator with a fleet (dragg_tpu_torch/aggregator.py) on
the CPU: a 2-community run's results.json against the JAX aggregator's
(the same homes, keys and Summary, the fleet block included; series to
1e-4, the legacy four-type mix), a community base with a weather offset
against the JAX aggregator, a fleet run stopped at a checkpoint and
resumed bit for bit, the checkpoint's run shape changing with the
community count and the event timeline, and a fleet's RL cases
constructing with the JAX package's ``rl_fleet`` run shape."""

import copy
import json
import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu.aggregator import Aggregator as JaxAggregator
from dragg_tpu_torch.aggregator import Aggregator
from dragg_tpu_torch.config import default_config


def _cfg(communities=2, end="2015-01-01 06", base=0, weather_off=24):
    cfg = default_config()
    cfg["community"].update(total_number_homes=6, homes_pv=1, homes_battery=1,
                            homes_pv_battery=1)
    cfg["simulation"]["end_datetime"] = end
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["fleet"].update(communities=communities, seed_stride=5, community_base=base,
                        weather_offset_hours=weather_off)
    cfg["tpu"]["sharded"] = False
    return cfg


def _results(agg):
    with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
        return json.load(f)


def _same_series(rt, rj, atol):
    assert list(rt) == list(rj)
    for name, series in rj.items():
        if name == "Summary":
            continue
        assert list(rt[name]) == list(series), name
        for key, v in series.items():
            if isinstance(v, list):
                np.testing.assert_allclose(rt[name][key], v, rtol=0, atol=atol,
                                           err_msg=f"{name}.{key}")
            else:
                assert rt[name][key] == v
        assert rt[name]["correct_solve"] == series["correct_solve"]


@pytest.mark.parametrize("communities,base", [(2, 0), (1, 2)], ids=["fleet", "base-offset"])
def test_aggregator_matches_jax(tmp_path, communities, base):
    """A 2-community fleet with 24 h weather offsets; one community at base
    2 with the same offset (its weather 48 h on)."""
    cfg = _cfg(communities=communities, base=base)
    ja = JaxAggregator(config=copy.deepcopy(cfg), outputs_dir=str(tmp_path / "jax"))
    ja.run()
    ta = Aggregator(config=copy.deepcopy(cfg), outputs_dir=str(tmp_path / "torch"),
                    device="cpu")
    ta.run()
    rj, rt = _results(ja), _results(ta)
    _same_series(rt, rj, 1e-4)
    sj, st = rj["Summary"], rt["Summary"]
    for key in ("OAT", "GHI", "TOU", "RP", "solver_iterations", "num_homes", "fleet"):
        assert st.get(key) == sj.get(key), key
    np.testing.assert_allclose(st["p_grid_aggregate"], sj["p_grid_aggregate"], atol=1e-4)
    np.testing.assert_allclose(st["p_grid_setpoint"], sj["p_grid_setpoint"], atol=1e-4)
    names = [n for n in rj if n != "Summary"]
    assert len(names) == 6 * communities
    assert names[0].startswith(f"c{base}-")
    assert os.path.basename(ta._homes_cache_file()) == os.path.basename(ja._homes_cache_file())
    assert ta._run_shape() == {k: v for k, v in ja._run_shape().items()}


def test_fleet_resume_bit_exact(tmp_path):
    """Hourly chunks: stopped after 2 of 4 and resumed, the results equal
    the uninterrupted run's bit for bit."""
    cfg = _cfg(end="2015-01-01 04")
    cfg["simulation"]["checkpoint_interval"] = "hourly"
    full = Aggregator(copy.deepcopy(cfg), outputs_dir=str(tmp_path / "full"), device="cpu")
    full.run()
    cfg["simulation"]["resume"] = True
    part = Aggregator(copy.deepcopy(cfg), outputs_dir=str(tmp_path / "res"), device="cpu")
    part.stop_after_chunks = 2
    part.run()
    assert part.timestep == 2
    res = Aggregator(copy.deepcopy(cfg), outputs_dir=str(tmp_path / "res"), device="cpu")
    res.run()
    assert res.resumed_from is not None
    want, got = _results(full), _results(res)
    for name, series in want.items():
        keys = ("p_grid_aggregate", "p_grid_setpoint", "solver_iterations") \
            if name == "Summary" else [k for k, v in series.items() if isinstance(v, list)]
        for key in keys:
            assert got[name][key] == series[key], (name, key)


def test_run_shape_follows_communities_and_events(tmp_path):
    """A checkpoint is for one community count and one event timeline: a
    change of either starts afresh (its run shape differs), as in the JAX
    package."""
    shapes = {}
    events = [dict(kind="dr", start_hour=1, duration_hours=2, p_cap_kw=3.0)]
    for tag, comms, evs in (("c2", 2, []), ("c1", 1, []), ("c2-dr", 2, events),
                            ("c2-dr2", 2, [dict(events[0], p_cap_kw=2.0)])):
        cfg = _cfg(communities=comms)
        cfg["scenarios"]["events"] = evs
        agg = Aggregator(cfg, outputs_dir=str(tmp_path / tag), device="cpu")
        agg.get_homes()
        agg._build_engine()
        jagg = JaxAggregator(copy.deepcopy(cfg), outputs_dir=str(tmp_path / f"j{tag}"))
        jagg.get_homes()
        jagg._build_engine()
        shapes[tag] = agg._run_shape()
        for key in ("communities", "events", "n_homes", "buckets", "n_home_slots"):
            assert shapes[tag][key] == jagg._run_shape()[key], (tag, key)
    assert shapes["c2"]["communities"] == 2 and shapes["c1"]["communities"] == 1
    assert shapes["c2"]["events"] is None and shapes["c2-dr"]["events"] is not None
    assert len({json.dumps(s, sort_keys=True) for s in shapes.values()}) == 4


@pytest.mark.parametrize("case", ["run_rl_agg", "run_rl_simplified"])
def test_fleet_rl_case_raises(tmp_path, case):
    """A fleet's RL case no longer raises: it constructs, with the JAX
    package's ``rl_fleet`` run shape (tests/test_torch_rl_fleet_runner.py
    runs it)."""
    cfg = _cfg()
    cfg["simulation"][case] = True
    got = Aggregator(cfg, outputs_dir=str(tmp_path), device="cpu")._run_shape()["rl_fleet"]
    want = JaxAggregator(copy.deepcopy(cfg), outputs_dir=str(tmp_path / "jax"))._run_shape()
    assert got == want["rl_fleet"] == ["shared", "linear", 32, "score", True, 2, 12]
