"""The port's run telemetry on the fleet and RL paths (on the CPU) against
the JAX package's: a fleet of C = 2 communities under the shipped
``stress_dr_outage`` pack (its ev and heat_pump buckets among six), and
``run_rl_agg`` with the linear agent, each over 2 hourly chunks at H = 4.

Held as in tests/test_torch_observatory_runs.py: the same event names in
order, the same field keys, equal deterministic fields (bucket names and
sizes, chunk bounds, solve rate, divergence and repair counts), the same
metric names (the per-bucket ``solver.conv_iters_ev`` and
``solver.conv_iters_heat_pump`` among them), and every histogram summing
to the bucket's homes × steps.  An RL case's chunks emit what the
baseline's do, without ``device_s``, as the JAX runners' do.
"""

import json
import os

import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu.aggregator import Aggregator as JaxAggregator
from dragg_tpu_torch.aggregator import Aggregator
from dragg_tpu_torch.config import default_config
from tests.test_torch_observatory_runs import _metric_names, assert_streams_match, records


def _config(case: str):
    cfg = default_config()
    cfg["community"].update(total_number_homes=6, homes_pv=1, homes_battery=1,
                            homes_pv_battery=1)
    cfg["simulation"].update(end_datetime="2015-01-01 02", checkpoint_interval="hourly")
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["tpu"].update(sharded=False)
    if case == "fleet":
        cfg["community"]["total_number_homes"] = 12
        cfg["fleet"].update(communities=2, weather_offset_hours=24)
        cfg["scenarios"]["pack"] = "stress_dr_outage"
        cfg["tpu"].update(bucketed="true", fix_tou_peak=True)
    else:
        cfg["simulation"].update(run_rbo_mpc=False, run_rl_agg=True)
    return cfg


@pytest.mark.parametrize("case", ["fleet", "rl_agg"])
def test_case_stream_matches_jax(tmp_path, case):
    ja = JaxAggregator(config=_config(case), outputs_dir=str(tmp_path / "jax"))
    ja.run()
    ta = Aggregator(config=_config(case), outputs_dir=str(tmp_path / "torch"), device="cpu")
    ta.run()
    got, want = records(ta.run_dir), records(ja.run_dir)
    assert_streams_match(got, want)
    assert _metric_names(ta.run_dir) == _metric_names(ja.run_dir)
    done = [r for r in got if r["event"] == "chunk.done"]
    assert [r["t0"] for r in done] == [0, 1]
    binfo = ta.engine.bucket_info()
    conv = [r for r in got if r["event"] == "solver.convergence"]
    assert [r["bucket"] for r in conv] == [b["name"] for b in binfo] * 2
    for r in conv:
        assert sum(r["rprim_hist"]) == sum(r["iters_hist"]) == r["n_homes"]
    with open(os.path.join(ta.run_dir, "metrics.json")) as f:
        hists = set(json.load(f)["histograms"])
    if case == "fleet":
        assert {"ev", "heat_pump"} <= {b["name"] for b in binfo}
        assert sum(b["n_real"] for b in binfo) == 24
        assert {"solver.conv_iters_ev", "solver.conv_iters_heat_pump"} <= hists
        assert all("device_s" in r for r in done)
    else:
        assert ta.agent is not None and all("device_s" not in r for r in done)
        assert got[0]["case"] == "baseline"
