"""A two-community fleet under the ``stress_dr_outage`` pack on the ADMM's
band backend (dragg_tpu_torch's aggregator on the CPU) against the JAX
aggregator: the pack's six home types, every bucket with the explicit grid
block, which gives the band factor its widest shapes.  Tolerances: those
of tests/test_torch_engine_admm.py (its module docstring)."""

import json
import os

import numpy as np
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu.aggregator import Aggregator as JaxAggregator  # noqa: E402
from dragg_tpu_torch.aggregator import Aggregator  # noqa: E402
from dragg_tpu_torch.config import default_config  # noqa: E402


def _fleet_config():
    cfg = default_config()
    cfg["community"].update(total_number_homes=12, homes_pv=1, homes_battery=1,
                            homes_pv_battery=1)
    cfg["simulation"].update(end_datetime="2015-01-01 02")
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["home"]["hems"]["solver"] = "admm"
    cfg["fleet"].update(communities=2, weather_offset_hours=24)
    cfg["scenarios"]["pack"] = "stress_dr_outage"
    cfg["tpu"].update(sharded=False, bucketed="true", fix_tou_peak=True,
                      admm_solve_backend="band")
    return cfg


def test_fleet_under_pack_matches_jax(tmp_path):
    """2 communities × 12 homes of the pack's six types, two steps through
    the aggregators on the band backend: every bucket carries the explicit
    grid block, results.json matches the JAX aggregator's (flags equal,
    series within 1e-3)."""
    ja = JaxAggregator(config=_fleet_config(), outputs_dir=str(tmp_path / "jax"))
    ja.run()
    tg = Aggregator(config=_fleet_config(), outputs_dir=str(tmp_path / "torch"), device="cpu")
    tg.run()
    binfo = tg.engine.bucket_info()
    assert [b["name"] for b in binfo] == [b["name"] for b in ja.engine.bucket_info()]
    assert {"ev", "heat_pump"} <= {b["name"] for b in binfo}
    assert all(c.lay.has_grid for c in tg.engine._buckets)
    assert tg.engine.solve_backends == ["band"] * len(binfo)
    res = []
    for agg in (ja, tg):
        with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
            res.append(json.load(f))
    rj, rt = res
    assert list(rt) == list(rj)
    for name, series in rj.items():
        if name == "Summary":
            continue
        assert rt[name]["correct_solve"] == series["correct_solve"], name
        for key, v in series.items():
            if isinstance(v, list):
                np.testing.assert_allclose(rt[name][key], v, rtol=0, atol=1e-3,
                                           err_msg=f"{name}.{key}")
