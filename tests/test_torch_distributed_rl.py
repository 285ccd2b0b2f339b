"""The RL aggregator (``simulation.run_rl_agg``) of the port's sharded run
as two gloo ranks on the CPU (tests/test_torch_distributed_run.py's
launcher): every rank steps the agent from the all-reduced loads, and
rank 0 alone writes results.json and ``utility_agent-results.json``.

* One community against the JAX package's Aggregator on two devices:
  ``p_grid_aggregate`` and ``RP`` within tests/test_parallel.py:302-303's
  1e-3 / 1e-4.
* A fleet of two communities, whose per-community sums (and, under the
  ``"mpc"`` gradient, their tangents) are all-reduced, against the JAX
  package's fleet on two devices, under the ``"score"`` and ``"mpc"``
  gradients: ``p_grid_aggregate``, ``RP`` and ``RP_by_community`` within
  the same bounds; and under ``"mpc"`` also within those bounds of the
  port's own one-process run.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu.aggregator import Aggregator as JaxAggregator  # noqa: E402
from dragg_tpu_torch.aggregator import Aggregator  # noqa: E402
from tests.test_torch_distributed_run import (  # noqa: E402
    day_config,
    find_files,
    jax_on_two_devices,
    run_rank_script,
)


def _rl_config(**fleet) -> dict:
    cfg = day_config()
    cfg["simulation"]["run_rbo_mpc"] = False
    cfg["simulation"]["run_rl_agg"] = True
    if fleet:
        cfg["fleet"].update(communities=2, weather_offset_hours=24)
        cfg["rl"]["fleet"] = fleet
    return cfg


def _rank_summary(dirs) -> dict:
    got = [p for p in find_files(dirs[0], "results.json") if os.sep + "rl_agg" + os.sep in p]
    assert len(got) == 1
    assert find_files(dirs[0], "utility_agent-results.json")
    assert not find_files(dirs[1], "utility_agent-results.json")
    assert not find_files(dirs[1], "results.json")
    with open(got[0]) as f:
        return json.load(f)["Summary"]


def _summary(agg) -> dict:
    with open(os.path.join(agg.run_dir, "rl_agg", "results.json")) as f:
        return json.load(f)["Summary"]


def _assert_close(got: dict, want: dict) -> None:
    assert len(got["RP"]) == len(want["RP"]) == 24
    np.testing.assert_allclose(got["p_grid_aggregate"], want["p_grid_aggregate"],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["RP"], want["RP"], rtol=1e-3, atol=1e-4)


def test_rl_agg_two_ranks_as_jax(tmp_path, monkeypatch):
    dirs = [tmp_path / f"rank{r}" for r in range(2)]
    done = run_rank_script(tmp_path, _rl_config(), dirs)
    assert [d["engine"] for d in done] == ["ShardedEngine"] * 2
    got = _rank_summary(dirs)
    jax_on_two_devices(monkeypatch)
    ja = JaxAggregator(config=_rl_config(), outputs_dir=str(tmp_path / "jax"))
    ja.run()
    assert ja.engine.mesh.devices.size == 2
    _assert_close(got, _summary(ja))


_FLEET_RUNS: dict = {}


def _fleet_two_ranks(tmp_path_factory, gradient: str) -> dict:
    """The two-rank fleet run's Summary under ``gradient`` (run once a
    module: the JAX and the one-process comparisons share it)."""
    if gradient not in _FLEET_RUNS:
        root = tmp_path_factory.mktemp(f"fleet_{gradient}")
        dirs = [root / f"rank{r}" for r in range(2)]
        run_rank_script(root, _rl_config(gradient=gradient), dirs)
        _FLEET_RUNS[gradient] = _rank_summary(dirs)
    return _FLEET_RUNS[gradient]


def _assert_fleet_close(got: dict, want: dict) -> None:
    _assert_close(got, want)
    np.testing.assert_allclose(np.asarray(got["fleet_rl"]["RP_by_community"]),
                               np.asarray(want["fleet_rl"]["RP_by_community"]),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("gradient", ["score", "mpc"])
def test_fleet_rl_two_ranks_as_jax(tmp_path, tmp_path_factory, monkeypatch, gradient):
    got = _fleet_two_ranks(tmp_path_factory, gradient)
    jax_on_two_devices(monkeypatch)
    ja = JaxAggregator(config=_rl_config(gradient=gradient), outputs_dir=str(tmp_path / "jax"))
    ja.run()
    assert ja.engine.mesh.devices.size == 2
    _assert_fleet_close(got, _summary(ja))


def test_fleet_rl_mpc_two_ranks_as_one(tmp_path, tmp_path_factory):
    cfg = _rl_config(gradient="mpc")
    got = _fleet_two_ranks(tmp_path_factory, "mpc")
    one = Aggregator(copy.deepcopy(cfg), outputs_dir=str(tmp_path / "one"), device="cpu")
    one.run()
    _assert_fleet_close(got, _summary(one))
