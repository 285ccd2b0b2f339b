"""The port's fleet RL cases end to end (``Aggregator(config,
device="cpu").run()`` with ``fleet.communities > 1``) against the JAX
package's, on the CPU.

* rl_agg, 2 communities × 4 homes (one PV, one battery, one PV + battery
  home each), H = 4, 8 hourly steps, the shared linear and DDPG agents,
  score gradient: results.json with the JAX package's keys, per-home
  series and the Summary's aggregates within 1e-4 with solved flags
  equal (tests/test_torch_rl_runner.py's class), the reward prices per
  community (Summary.fleet_rl) within 1e-6, the rest of the fleet_rl
  block equal; the agent's rl_data within 1e-4 of each series' largest
  magnitude, ``action_by_community`` included.
* simplified, 8 communities: the Summary's series and the fleet_rl
  block within 1e-5 of each series' largest magnitude.
* A checkpoint of the fleet carry ``(state, agent, FleetEnvCarry(env,
  drda))`` has the JAX package's files (``fleet_rl.json`` among them),
  progress keys, run shape and leaves in order (DDPG kernels
  transposed); a run stopped after its first hourly chunk resumes bit
  for bit (results.json, fleet_rl, rl_data).
* ``_run_shape()["rl_fleet"]`` equals the JAX package's for each layout.
* C = 1 with a ``[fleet]`` block runs the single-community path: equal
  bit for bit to the run without one, no fleet_rl in the Summary.
"""

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

AGENTS = ("linear", "ddpg")
SERIES_ATOL = 1e-4


def _config(agent="linear", communities=2, **sim):
    cfg = default_config()
    cfg["community"].update(total_number_homes=4, homes_pv=1, homes_battery=1,
                            homes_pv_battery=1)
    cfg["simulation"].update(end_datetime="2015-01-01 08", checkpoint_interval="hourly",
                             run_rbo_mpc=False, run_rl_agg=True, run_rl_simplified=False)
    cfg["simulation"].update(sim)
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["fleet"].update(communities=communities, seed_stride=5)
    cfg["tpu"]["sharded"] = False
    cfg["rl"]["parameters"]["agent"] = agent
    return cfg


def _read(agg, case: str, name: str = "results.json") -> dict:
    with open(os.path.join(agg.run_dir, case, name)) as f:
        return json.load(f)


def _layout(agg) -> dict:
    """The last checkpoint the run left (its clear_checkpoint disabled)."""
    root = os.path.join(agg.run_dir, "rl_agg", "checkpoint")
    with open(os.path.join(root, "LATEST")) as f:
        d = os.path.join(root, f.read().strip())
    with np.load(os.path.join(d, "state.npz")) as data:
        keys = sorted(data.files, key=lambda k: int(k.rsplit("_", 1)[1]))
        leaves = [(data[k].shape, data[k].dtype) for k in keys]
    with open(os.path.join(d, "progress.json")) as f:
        progress = json.load(f)
    with open(os.path.join(d, "fleet_rl.json")) as f:
        fleet_rl = json.load(f)
    return {"name": os.path.basename(d), "files": sorted(os.listdir(d)), "leaves": leaves,
            "progress": progress, "fleet_rl": fleet_rl}


def _run(cls, outputs_dir, cfg, keep_checkpoint=False, stop=None, **kw):
    agg = cls(config=cfg, outputs_dir=str(outputs_dir), **kw)
    if keep_checkpoint:
        agg.clear_checkpoint = lambda: None
    agg.stop_after_chunks = stop
    agg.run()
    return agg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for agent in AGENTS:
        root = tmp_path_factory.mktemp(agent)
        out[agent] = {}
        for name, cls, kw in (("jax", JaxAggregator, {}), ("torch", Aggregator,
                                                           {"device": "cpu"})):
            agg = _run(cls, root / name, _config(agent), keep_checkpoint=True, **kw)
            out[agent][name] = {"rl_agg": _read(agg, "rl_agg"),
                                "agent": _read(agg, "rl_agg", "utility_agent-results.json"),
                                "layout": _layout(agg), "agg": agg}
    return out


def _close_rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want), initial=0.0)
    assert err <= tol * max(np.max(np.abs(want), initial=0.0), 1e-30), (what, err)


def _check_fleet_block(got, want, price_atol):
    assert list(got) == list(want)
    for key, v in want.items():
        if key in ("RP_by_community", "mean_abs_rp_by_community"):
            np.testing.assert_allclose(got[key], v, rtol=0, atol=price_atol, err_msg=key)
        elif key == "setpoint_by_community":
            np.testing.assert_allclose(got[key], v, rtol=0, atol=SERIES_ATOL, err_msg=key)
        else:
            assert got[key] == v, key


@pytest.mark.parametrize("agent", AGENTS)
def test_fleet_rl_agg_matches_jax(runs, agent):
    rj, rt = runs[agent]["jax"]["rl_agg"], runs[agent]["torch"]["rl_agg"]
    assert list(rt) == list(rj)
    assert len(rj) == 2 * 4 + 1
    for name, series in rj.items():
        assert list(rt[name]) == list(series), name
        if name == "Summary":
            continue
        assert rt[name]["correct_solve"] == series["correct_solve"], name
        for key, v in series.items():
            if isinstance(v, list):
                np.testing.assert_allclose(rt[name][key], v, rtol=0, atol=SERIES_ATOL,
                                           err_msg=f"{name}.{key}")
            else:
                assert rt[name][key] == v
    sj, st = rj["Summary"], rt["Summary"]
    assert list(st) == list(sj)
    for key in ("OAT", "GHI", "TOU", "horizon", "num_homes", "solver_iterations", "fleet"):
        assert st[key] == sj[key], key
    for key in ("p_grid_aggregate", "p_grid_setpoint", "p_max_aggregate"):
        np.testing.assert_allclose(st[key], sj[key], rtol=0, atol=SERIES_ATOL, err_msg=key)
    np.testing.assert_allclose(st["RP"], sj["RP"], rtol=0, atol=1e-6)
    _check_fleet_block(st["fleet_rl"], sj["fleet_rl"], 1e-6)
    rp = np.asarray(st["fleet_rl"]["RP_by_community"])
    assert rp.shape == (2, 8) and np.max(np.abs(rp)) <= 0.02 + 1e-9
    assert not np.allclose(rp[0], rp[1])  # per-community exploration


@pytest.mark.parametrize("agent", AGENTS)
def test_fleet_agent_results_match_jax(runs, agent):
    uj, ut = runs[agent]["jax"]["agent"], runs[agent]["torch"]["agent"]
    assert list(ut) == list(uj)
    assert ut["parameters"] == uj["parameters"]
    assert ut["parameters"]["fleet"]["communities"] == 2
    for key, v in uj.items():
        if key != "parameters":
            assert len(ut[key]) == len(v) == 8, key
            _close_rel(ut[key], v, 1e-4, key)


@pytest.mark.parametrize("agent", AGENTS)
def test_fleet_checkpoint_layout_matches_jax(runs, agent):
    """The same files (fleet_rl.json among them), progress keys and run
    shape, the same leaves in the same order: PRNG keys int64 where the
    JAX package stores uint32, DDPG weights (out, in) where flax's
    kernels are (in, out)."""
    got, want = runs[agent]["torch"]["layout"], runs[agent]["jax"]["layout"]
    assert got["name"] == want["name"] == "ckpt_t00000007"
    assert got["files"] == want["files"] == [
        "collected.json", "fleet_rl.json", "progress.json", "rl_data.json", "state.npz"]
    assert set(got["progress"]) == set(want["progress"])
    assert got["progress"]["run_shape"] == want["progress"]["run_shape"]
    assert got["progress"]["run_shape"]["rl_fleet"] is not None
    assert len(got["leaves"]) == len(want["leaves"])
    for (sg, dg), (sw, dw) in zip(got["leaves"], want["leaves"]):
        assert sg == sw or (agent == "ddpg" and sg == sw[::-1]), (sg, sw)
        assert dg == dw or (dg, dw) == (np.int64, np.uint32)
    for key in ("rps", "sps"):
        np.testing.assert_allclose(got["fleet_rl"][key], want["fleet_rl"][key], rtol=0,
                                   atol=SERIES_ATOL, err_msg=key)


@pytest.mark.parametrize("agent", AGENTS)
def test_fleet_resume_bit_exact(runs, agent, tmp_path):
    """Stopped after its first hourly chunk and resumed, the run's
    results.json (fleet_rl included) and rl_data equal the uninterrupted
    run's bit for bit."""
    part = _run(Aggregator, tmp_path, _config(agent), stop=1, device="cpu")
    assert part.timestep == 1 and part._latest_checkpoint_dir() is not None
    res = _run(Aggregator, tmp_path, _config(agent, resume=True), device="cpu")
    assert res.resumed_from is not None and res.timestep == 8
    want = runs[agent]["torch"]
    got = _read(res, "rl_agg")
    for name, series in want["rl_agg"].items():
        if name == "Summary":
            for key in ("p_grid_aggregate", "p_grid_setpoint", "RP", "solver_iterations",
                        "fleet_rl"):
                assert got[name][key] == series[key], key
        else:
            assert got[name] == series, name
    assert _read(res, "rl_agg", "utility_agent-results.json") == want["agent"]
    assert res._latest_checkpoint_dir() is None


def test_fleet_simplified_matches_jax(tmp_path):
    """8 communities against the linear community model (no engine)."""
    cfg = _config(communities=8, run_rl_agg=False, run_rl_simplified=True)
    ja = _run(JaxAggregator, tmp_path / "jax", copy.deepcopy(cfg))
    ta = _run(Aggregator, tmp_path / "torch", cfg, device="cpu")
    sj, st = _read(ja, "simplified")["Summary"], _read(ta, "simplified")["Summary"]
    assert list(st) == list(sj) and st["case"] == "simplified"
    for key in ("p_grid_aggregate", "RP", "p_grid_setpoint", "agg_cost"):
        assert len(st[key]) == 8, key
        _close_rel(st[key], sj[key], 1e-5, key)
    fj, ft = sj["fleet_rl"], st["fleet_rl"]
    assert list(ft) == list(fj) and ft["communities"] == 8
    for key, v in fj.items():
        if isinstance(v, list):
            _close_rel(ft[key], v, 1e-5, key)
        else:
            assert ft[key] == v, key
    assert len({tuple(r) for r in ft["RP_by_community"]}) == 8
    uj, ut = _read(ja, "simplified", "utility_agent-results.json"), _read(
        ta, "simplified", "utility_agent-results.json")
    assert list(ut) == list(uj) and ut["parameters"] == uj["parameters"]
    for key, v in uj.items():
        if key != "parameters":
            _close_rel(ut[key], v, 1e-4, key)


@pytest.mark.parametrize("change", [
    None, ("rl", "fleet", "policy", "per_community"), ("rl", "parameters", "agent", "ddpg"),
    ("tpu", None, "ddpg_hidden", 32), ("rl", "fleet", "learner_batch", 64),
    ("rl", "fleet", "gradient", "mpc"), ("rl", "fleet", "event_features", False),
    ("agg", "rl", "prev_timesteps", 6), ("simulation", None, "run_rl_agg", False),
])
def test_run_shape_rl_fleet_matches_jax(tmp_path, change):
    cfg = _config(run_rl_simplified=True)
    cfg["rl"]["parameters"]["agent"] = "ddpg"
    cfg["tpu"]["band_kernel"] = "xla"  # the mpc gradient's plain route
    if change is not None:
        section, sub, key, value = change
        table = cfg[section] if sub is None else cfg[section].setdefault(sub, {})
        table[key] = value
    want = JaxAggregator(config=copy.deepcopy(cfg), data_dir="",
                         outputs_dir=str(tmp_path / "jax"))._run_shape()["rl_fleet"]
    got = Aggregator(config=cfg, outputs_dir=str(tmp_path), device="cpu")._run_shape()
    assert got["rl_fleet"] == want and want is not None
    assert "rl" not in got


def test_c1_fleet_block_is_the_single_community_run(tmp_path):
    """``fleet.communities = 1`` with a [fleet] and [rl.fleet] block runs
    the single-community path: bit for bit the run without them."""
    plain = _config(communities=1, checkpoint_interval="daily", run_rl_simplified=True)
    fleet = copy.deepcopy(plain)
    fleet["fleet"]["seed_stride"] = 7
    fleet["rl"]["fleet"].update(policy="per_community", learner_batch=64)
    a = _run(Aggregator, tmp_path / "fleet", fleet, device="cpu")
    b = _run(Aggregator, tmp_path / "plain", plain, device="cpu")
    assert a._run_shape()["rl_fleet"] is None
    for case in ("rl_agg", "simplified"):
        ra, rb = _read(a, case), _read(b, case)
        assert "fleet_rl" not in ra["Summary"]
        ra["Summary"].pop("solve_time"), rb["Summary"].pop("solve_time")
        ra["Summary"].pop("phase_times"), rb["Summary"].pop("phase_times")
        assert ra == rb, case
        assert _read(a, case, "utility_agent-results.json") == _read(
            b, case, "utility_agent-results.json")
