"""The PyTorch port's baseline run end to end (dragg_tpu_torch/aggregator.py
on the CPU) against the JAX package's, on the tests/test_engine.py day-run
community: results.json carries the same keys, and the same series to
1e-4 absolute (two float32 solvers ~1e-5 apart; see test_torch_engine).
Also: a CPU run of the port, resumed from a checkpoint too, its RL cases
(both agents), and a fleet with the shipped scenario pack, its RL cases
under the mpc gradient included, load neither jax nor dragg_tpu; an Aggregator built without a device needs a CUDA
card; settings outside the port raise; and a community base without a
weather offset runs the JAX package's homes on its weather."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu.aggregator import Aggregator as JaxAggregator
from dragg_tpu_torch.aggregator import Aggregator
from dragg_tpu_torch.config import default_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT_SUMMARY = ("OAT", "GHI", "TOU", "RP", "solver_iterations", "case", "horizon",
                 "num_homes", "start_datetime", "end_datetime")


def _day_config():
    cfg = default_config()
    cfg["community"].update(total_number_homes=6, homes_pv=1, homes_battery=1,
                            homes_pv_battery=1)
    cfg["simulation"]["end_datetime"] = "2015-01-02 00"
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["tpu"]["sharded"] = False
    return cfg


def _results(agg):
    with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def day_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("outputs")
    ja = JaxAggregator(config=_day_config(), outputs_dir=str(out / "jax"))
    ja.run()
    ta = Aggregator(config=_day_config(), outputs_dir=str(out / "torch"), device="cpu")
    ta.run()
    return ja, _results(ja), ta, _results(ta)


def test_results_schema_matches(day_runs):
    ja, rj, ta, rt = day_runs
    assert os.path.relpath(ta.run_dir, ta.outputs_dir) == os.path.relpath(
        ja.run_dir, ja.outputs_dir)
    assert list(rt) == list(rj)
    for name in rj:
        assert list(rt[name]) == list(rj[name]), name
    assert ta.check_baseline_vals() == []


def test_series_match(day_runs):
    _, rj, _, rt = day_runs
    for name, series in rj.items():
        if name == "Summary":
            continue
        for key, v in series.items():
            if isinstance(v, list):
                np.testing.assert_allclose(rt[name][key], v, rtol=0, atol=1e-4,
                                           err_msg=f"{name}.{key}")
            else:
                assert rt[name][key] == v
        assert rt[name]["correct_solve"] == series["correct_solve"]
    sj, st = rj["Summary"], rt["Summary"]
    for key in EXACT_SUMMARY:
        assert st[key] == sj[key], key
    for key in ("p_grid_aggregate", "p_grid_setpoint", "p_max_aggregate"):
        np.testing.assert_allclose(st[key], sj[key], rtol=0, atol=1e-4, err_msg=key)


def test_cpu_run_loads_no_jax(tmp_path):
    cfg_path, out = str(tmp_path / "cfg.toml"), str(tmp_path / "out")
    code = (
        "import sys\n"
        "from dragg_tpu_torch.__main__ import main\n"
        "from dragg_tpu_torch.aggregator import Aggregator\n"
        f"main(['run', '--config', {cfg_path!r}, '--outputs-dir', {out!r}, "
        "'--device', 'cpu'])\n"
        # The same run stopped after its first hourly chunk, then resumed.
        f"part = Aggregator(config={cfg_path!r}, outputs_dir={out + '-resumed'!r}, "
        "device='cpu')\n"
        "part.stop_after_chunks = 1\n"
        "part.run()\n"
        f"res = Aggregator(config={cfg_path!r}, outputs_dir={out + '-resumed'!r}, "
        "device='cpu')\n"
        "res.run()\n"
        "print('RESUMED', part.timestep, res.resumed_from is not None, res.timestep)\n"
        # The RL cases after the baseline: rl_agg (linear agent) and
        # simplified, then rl_agg with the DDPG agent.
        f"rl = Aggregator(config={cfg_path!r}, outputs_dir={out + '-rl'!r}, device='cpu')\n"
        "rl.config['simulation'].update(run_rl_agg=True, run_rl_simplified=True)\n"
        "rl.run()\n"
        f"dd = Aggregator(config={cfg_path!r}, outputs_dir={out + '-ddpg'!r}, device='cpu')\n"
        "dd.config['simulation'].update(run_rbo_mpc=False, run_rl_agg=True)\n"
        "dd.config['rl']['parameters']['agent'] = 'ddpg'\n"
        "dd.run()\n"
        "print('RL', rl.agent.kind, dd.agent.kind, rl.timestep, dd.timestep)\n"
        # A 2-community fleet under the shipped pack (six home types,
        # tariff shocks, DR calls, the outage) with weather offsets.
        "from dragg_tpu_torch.config import load_config\n"
        f"fc = load_config({cfg_path!r})\n"
        "fc['community']['total_number_homes'] = 10\n"
        "fc['fleet'].update(communities=2, weather_offset_hours=24)\n"
        "fc['scenarios']['pack'] = 'stress_dr_outage'\n"
        "fc['tpu']['fix_tou_peak'] = True\n"
        f"fl = Aggregator(config=fc, outputs_dir={out + '-fleet'!r}, device='cpu')\n"
        "fl.run()\n"
        "print('FLEET', fl.engine.n_communities, fl.engine.events is not None, "
        "len(fl.all_homes), fl.timestep)\n"
        # The same fleet's RL cases, the shared policy's mpc gradient
        # differentiating the engine step (forward-mode AD).
        "fl.config['simulation'].update(run_rbo_mpc=False, run_rl_agg=True, "
        "run_rl_simplified=True)\n"
        "fl.config['rl']['fleet']['gradient'] = 'mpc'\n"
        "fl.run()\n"
        "print('FLEET RL', fl.agent.fparams.gradient, fl.agent.fparams.n_communities, "
        "fl.timestep)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dragg_tpu' or m.startswith('dragg_tpu.')]\n"
        "print('LOADED', bad)\n")
    # The shipped example config, cut to 3 homes × 3 hourly chunks, with
    # resume on; its [telemetry] (enabled, per_home) as shipped.
    toml = open(os.path.join(REPO, "data", "config.example.toml")).read()
    for a, b in (("total_number_homes = 10", "total_number_homes = 3"),
                 ("homes_pv = 4", "homes_pv = 1"),
                 ('end_datetime = "2015-01-04 00"', 'end_datetime = "2015-01-01 03"'),
                 ('checkpoint_interval = "daily"',
                  'checkpoint_interval = "hourly"\nresume = true')):
        assert a in toml, a
        toml = toml.replace(a, b)
    (tmp_path / "cfg.toml").write_text(toml)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "LOADED []"
    assert lines[-2] == "FLEET RL mpc 2 3"
    assert lines[-3] == "FLEET 2 True 20 3"
    assert lines[-4] == "RL linear ddpg 3 3"
    assert lines[-5] == "RESUMED 1 True 3"
    assert os.path.exists(os.path.join(lines[-6], "baseline", "results.json"))
    for name in ("events.jsonl", "metrics.json"):
        assert os.path.exists(os.path.join(lines[-6], name)), name
    base = str(tmp_path / "out")
    rl_dir = lines[-6].replace(base, base + "-rl", 1)
    for case in ("baseline", "rl_agg", "simplified"):
        assert os.path.exists(os.path.join(rl_dir, case, "results.json")), case
    for case in ("rl_agg", "simplified"):
        assert os.path.exists(os.path.join(rl_dir, case, "utility_agent-results.json")), case


def test_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Aggregator(config=_day_config(), outputs_dir=str(tmp_path))


@pytest.mark.parametrize("section,key,value", [
    ("tpu", "profile_dir", "trace"),
    ("telemetry", "enabled", True),
    ("fleet", "communities", 2),
    ("scenarios", "pack", "dr_heavy"),
    ("agg", "spp_enabled", True),
    ("fleet", "community_base", 2),
    ("simulation", "run_rl_agg", True),
])
def test_out_of_slice_settings_raise(tmp_path, section, key, value):
    """Settings that once lay outside the port construct and run as in the
    JAX package: the chunk trace (``tpu.profile_dir``: each package traces
    one chunk, the port's results bit-equal to its run without the trace)
    and telemetry (the same event names in order).  Fleets, a community
    base with a weather offset, SPP prices and an RL case with a fleet
    construct as in the JAX package (the last with its ``rl_fleet`` run
    shape); a pack that is not shipped raises the JAX package's own
    error."""
    cfg = _day_config()
    if key in ("profile_dir", "enabled"):
        cfg["simulation"].update(end_datetime="2015-01-01 02", checkpoint_interval="hourly")
        value = str(tmp_path / value) if key == "profile_dir" else value
    cfg[section][key] = value
    if key == "community_base":
        # A base shifts the weather window only together with an offset.
        cfg["fleet"]["weather_offset_hours"] = 24
    if key == "run_rl_agg":
        cfg["fleet"]["communities"] = 2
        got = Aggregator(config=cfg, outputs_dir=str(tmp_path), device="cpu")._run_shape()
        want = JaxAggregator(config=cfg, outputs_dir=str(tmp_path / "jax"))._run_shape()
        assert got["rl_fleet"] == want["rl_fleet"] is not None
        return
    if key in ("profile_dir", "enabled"):
        ta = Aggregator(config=cfg, outputs_dir=str(tmp_path / "torch"), device="cpu")
        ta.run()
        ja = JaxAggregator(config=cfg, outputs_dir=str(tmp_path / "jax"))
        ja.run()
        if key == "enabled":
            names = [[json.loads(line)["event"] for line in open(os.path.join(a.run_dir,
                                                                              "events.jsonl"))]
                     for a in (ta, ja)]
            assert names[0] == names[1] and names[0].count("chunk.done") == 2
            return
        traced = [f for _, _, fs in os.walk(value) for f in fs]
        assert "chunk_t00000001.pt.trace.json" in traced  # the port's: the second chunk
        assert sum(f.endswith(".xplane.pb") for f in traced) == 1  # the JAX package's
        assert len(traced) == 3
        cfg["tpu"]["profile_dir"] = ""
        plain = Aggregator(config=cfg, outputs_dir=str(tmp_path / "plain"), device="cpu")
        plain.run()
        got, want = _results(ta), _results(plain)
        for res in (got, want):
            for k in ("solve_time", "phase_times"):
                res["Summary"].pop(k)
        assert got == want
        return
    if key == "pack":
        from dragg_tpu.scenarios import ScenarioError as JaxScenarioError

        from dragg_tpu_torch.scenarios import ScenarioError

        with pytest.raises(JaxScenarioError, match="dr_heavy") as want:
            JaxAggregator(config=cfg, outputs_dir=str(tmp_path / "jax"))
        with pytest.raises(ScenarioError, match="dr_heavy") as got:
            Aggregator(config=cfg, outputs_dir=str(tmp_path), device="cpu")
        assert str(got.value) == str(want.value)
        return
    ta = Aggregator(config=cfg, outputs_dir=str(tmp_path), device="cpu")
    ja = JaxAggregator(config=cfg, outputs_dir=str(tmp_path / "jax"))
    for f in ("oat", "ghi", "tou"):
        np.testing.assert_array_equal(getattr(ta.env, f), getattr(ja.env, f), err_msg=f)
    assert (ta.n_communities, ta.total_homes, ta.start_index) == (
        ja.n_communities, ja.total_homes, ja.start_index)


def test_community_base_without_offset_matches_jax(tmp_path):
    """A community base alone renames and reseeds the community (its homes
    are the JAX package's) and keeps the weather window: 6 homes, 8 steps,
    the series within 1e-4 of the JAX aggregator's."""
    cfg = _day_config()
    cfg["simulation"]["end_datetime"] = "2015-01-01 08"
    cfg["fleet"].update(community_base=2, weather_offset_hours=0)
    ja = JaxAggregator(config=cfg, outputs_dir=str(tmp_path / "jax"))
    ja.run()
    ta = Aggregator(config=cfg, outputs_dir=str(tmp_path / "torch"), device="cpu")
    ta.run()
    rj, rt = _results(ja), _results(ta)
    assert list(rt) == list(rj)
    assert all(name.startswith("c2-") for name in rj if name != "Summary")
    for name, series in rj.items():
        if name == "Summary":
            continue
        for key, v in series.items():
            if isinstance(v, list):
                np.testing.assert_allclose(rt[name][key], v, rtol=0, atol=1e-4,
                                           err_msg=f"{name}.{key}")
        assert rt[name]["correct_solve"] == series["correct_solve"]
