"""The port's RL cases end to end (dragg_tpu_torch/rl/runner.py through
``Aggregator(config, device="cpu").run()``) against the JAX package's, on
a 6-home community (one PV, one battery, one PV + battery home), 4 h
horizon, 8 hourly steps, ``run_rl_agg`` and ``run_rl_simplified`` in one
run, for the linear and the DDPG agent.

* rl_agg: results.json with the JAX package's keys; per-home series and
  the Summary's aggregates within 1e-4 absolute, as the baseline's
  (tests/test_torch_aggregator.py), solved flags equal; the reward price
  within 1e-6 (it lies in ±0.02).  No count flipped at this size, so the
  run is compared whole, not step by step.
* simplified: results.json holds only the Summary; ``p_grid_aggregate``,
  ``RP``, ``p_grid_setpoint`` and ``agg_cost`` within 1e-5 of each
  series' largest magnitude.
* utility_agent-results.json: the same keys and parameters, each series
  within 1e-4 of its largest magnitude.
* A checkpoint has the JAX package's files, progress.json keys and leaves
  (for DDPG the flax kernels transposed), and ``run_shape`` one key more,
  ``rl``; a run stopped after one hourly chunk resumes bit for bit; a
  checkpoint of one agent is not loaded into the other.
* ``fleet.communities = 2`` with an RL case constructs, with the JAX
  package's ``rl_fleet`` run shape.
"""

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


def _config(agent: str, **sim):
    cfg = default_config()
    cfg["community"].update(total_number_homes=6, homes_pv=1, homes_battery=1,
                            homes_pv_battery=1)
    cfg["simulation"].update(end_datetime="2015-01-01 08", checkpoint_interval="hourly",
                             run_rbo_mpc=False, run_rl_agg=True, run_rl_simplified=True)
    cfg["simulation"].update(sim)
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["tpu"]["sharded"] = False
    cfg["rl"]["parameters"]["agent"] = agent
    return cfg


def _read(agg, case: str, name: str = "results.json") -> dict:
    with open(os.path.join(agg.run_dir, case, name)) as f:
        return json.load(f)


def _layout(agg) -> dict:
    """The checkpoint the run left (its clear_checkpoint is disabled): the
    last one, after step 7."""
    root = os.path.join(agg.run_dir, "rl_agg", "checkpoint")
    with open(os.path.join(root, "LATEST")) as f:
        d = os.path.join(root, f.read().strip())
    with np.load(os.path.join(d, "state.npz")) as data:
        keys = sorted(data.files, key=lambda k: int(k.rsplit("_", 1)[1]))
        leaves = [(data[k].shape, data[k].dtype) for k in keys]
    with open(os.path.join(d, "progress.json")) as f:
        progress = json.load(f)
    return {"name": os.path.basename(d), "files": sorted(os.listdir(d)), "leaves": leaves,
            "progress": progress}


def _run(cls, outputs_dir, cfg, keep_checkpoint=False, stop=None, **kw):
    agg = cls(config=cfg, outputs_dir=str(outputs_dir), **kw)
    if keep_checkpoint:
        agg.clear_checkpoint = lambda: None
    agg.stop_after_chunks = stop
    agg.run()
    return agg


def _outputs(agg) -> dict:
    return {"rl_agg": _read(agg, "rl_agg"), "simplified": _read(agg, "simplified"),
            "agent_rl_agg": _read(agg, "rl_agg", "utility_agent-results.json"),
            "agent_simplified": _read(agg, "simplified", "utility_agent-results.json"),
            "layout": _layout(agg), "agg": agg}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for agent in AGENTS:
        root = tmp_path_factory.mktemp(agent)
        out[agent] = {
            "jax": _outputs(_run(JaxAggregator, root / "jax", _config(agent),
                                 keep_checkpoint=True)),
            "torch": _outputs(_run(Aggregator, root / "torch", _config(agent),
                                   keep_checkpoint=True, device="cpu")),
        }
    return out


def _close_rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want), initial=0.0)
    assert err <= tol * max(np.max(np.abs(want), initial=0.0), 1e-30), (what, err)


@pytest.mark.parametrize("agent", AGENTS)
def test_rl_agg_matches_jax(runs, agent):
    rj, rt = runs[agent]["jax"]["rl_agg"], runs[agent]["torch"]["rl_agg"]
    ja, ta = runs[agent]["jax"]["agg"], runs[agent]["torch"]["agg"]
    assert os.path.relpath(ta.run_dir, ta.outputs_dir) == os.path.relpath(
        ja.run_dir, ja.outputs_dir)
    assert list(rt) == list(rj)
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
    assert st["case"] == sj["case"] == "rl_agg"
    for key in ("OAT", "GHI", "TOU", "horizon", "num_homes", "solver_iterations"):
        assert st[key] == sj[key], key
    for key in ("p_grid_aggregate", "p_grid_setpoint", "p_max_aggregate"):
        np.testing.assert_allclose(st[key], sj[key], rtol=0, atol=SERIES_ATOL, err_msg=key)
    np.testing.assert_allclose(st["RP"], sj["RP"], rtol=0, atol=1e-6)
    assert max(abs(v) for v in st["RP"]) <= 0.02 + 1e-9
    assert len(set(st["RP"])) > 1  # the agent acted


@pytest.mark.parametrize("agent", AGENTS)
def test_simplified_matches_jax(runs, agent):
    rj, rt = runs[agent]["jax"]["simplified"], runs[agent]["torch"]["simplified"]
    assert list(rt) == list(rj) == ["Summary"]
    sj, st = rj["Summary"], rt["Summary"]
    assert list(st) == list(sj) and st["case"] == "simplified"
    assert st["solver_iterations"] == sj["solver_iterations"] == []
    for key in ("p_grid_aggregate", "RP", "p_grid_setpoint", "agg_cost"):
        assert len(st[key]) == 8, key
        _close_rel(st[key], sj[key], 1e-5, key)


@pytest.mark.parametrize("agent", AGENTS)
@pytest.mark.parametrize("case", ["rl_agg", "simplified"])
def test_agent_results_match_jax(runs, agent, case):
    uj = runs[agent]["jax"][f"agent_{case}"]
    ut = runs[agent]["torch"][f"agent_{case}"]
    assert list(ut) == list(uj)
    assert ut["parameters"] == uj["parameters"]
    assert ut["parameters"]["agent"] == agent
    for key, v in uj.items():
        if key != "parameters":
            assert len(ut[key]) == len(v) == 8, key
            _close_rel(ut[key], v, 1e-4, f"{case}.{key}")


@pytest.mark.parametrize("agent", AGENTS)
def test_checkpoint_layout_matches_jax(runs, agent):
    """The same files and progress.json keys; run_shape the JAX package's
    keys and values plus ``rl``; the same leaves in the same order, the
    PRNG keys int64 where the JAX package stores uint32, and the DDPG
    weights (out, in) where flax's kernels are (in, out)."""
    got, want = runs[agent]["torch"]["layout"], runs[agent]["jax"]["layout"]
    assert got["name"] == want["name"] == "ckpt_t00000007"
    assert got["files"] == want["files"] == [
        "collected.json", "progress.json", "rl_data.json", "state.npz"]
    assert set(got["progress"]) == set(want["progress"])
    rs_got, rs_want = got["progress"]["run_shape"], want["progress"]["run_shape"]
    assert set(rs_got) - set(rs_want) == {"rl"}
    assert {k: v for k, v in rs_got.items() if k != "rl"} == rs_want
    assert rs_got["rl"] == [agent, 64 if agent == "ddpg" else 2, 12]
    assert len(got["leaves"]) == len(want["leaves"])
    for (sg, dg), (sw, dw) in zip(got["leaves"], want["leaves"]):
        assert sg == sw or (agent == "ddpg" and sg == sw[::-1]), (sg, sw)
        assert dg == dw or (dg, dw) == (np.int64, np.uint32)
    for key in ("timestep", "solve_iters"):
        assert got["progress"][key] == want["progress"][key], key
    for key in ("all_rps", "all_sps", "baseline_agg_load_list"):
        np.testing.assert_allclose(got["progress"][key], want["progress"][key], rtol=0,
                                   atol=SERIES_ATOL, err_msg=key)


@pytest.mark.parametrize("agent", AGENTS)
def test_resume_bit_exact(runs, agent, tmp_path):
    """Stopped after its first hourly chunk and resumed, the run's
    results.json, RP and rl_data equal the uninterrupted run's bit for
    bit."""
    part = _run(Aggregator, tmp_path, _config(agent), stop=1, device="cpu")
    assert part.timestep == 1 and part._latest_checkpoint_dir() is not None
    assert not os.path.exists(os.path.join(part.run_dir, "simplified"))
    res = _run(Aggregator, tmp_path, _config(agent, resume=True), device="cpu")
    assert res.resumed_from is not None and res.timestep == 8
    want = runs[agent]["torch"]
    got = _read(res, "rl_agg")
    for name, series in want["rl_agg"].items():
        if name == "Summary":
            for key in ("p_grid_aggregate", "p_grid_setpoint", "RP", "solver_iterations"):
                assert got[name][key] == series[key], key
        else:
            assert got[name] == series, name
    assert _read(res, "rl_agg", "utility_agent-results.json") == want["agent_rl_agg"]
    assert res._latest_checkpoint_dir() is None  # cleared at the end


def test_checkpoint_of_another_agent_starts_fresh(tmp_path):
    _run(Aggregator, tmp_path, _config("linear", run_rl_simplified=False), stop=1,
         device="cpu")
    res = _run(Aggregator, tmp_path, _config("ddpg", resume=True, run_rl_simplified=False),
               device="cpu")
    assert res.resumed_from is None and res.timestep == 8


@pytest.mark.parametrize("case", ["run_rl_agg", "run_rl_simplified"])
def test_rl_fleet_raises(tmp_path, case):
    """An RL case with ``fleet.communities = 2`` no longer raises: the
    config constructs on the CPU with the JAX package's fleet RL run shape
    (tests/test_torch_rl_fleet_runner.py runs it)."""
    cfg = _config("linear", run_rl_agg=False, run_rl_simplified=False)
    cfg["simulation"][case] = True
    cfg["fleet"]["communities"] = 2
    got = Aggregator(config=cfg, outputs_dir=str(tmp_path), device="cpu")._run_shape()
    want = JaxAggregator(config=cfg, outputs_dir=str(tmp_path / "jax"))._run_shape()
    assert got["rl_fleet"] == want["rl_fleet"] == ["shared", "linear", 32, "score", True, 2, 12]
