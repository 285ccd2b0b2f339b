"""The result line, the episode reset and the import check."""

import sys
import types

import numpy as np
import pytest

from conftest import manifest, run_tiny, tiny_cell


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    res = run_tiny(trace=trace)
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert res["attempted"] > 0 and 0 <= res["failed"] <= res["attempted"]
    names = set(res["metrics"])
    m = manifest()
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and "breakdown" in res
        assert names <= {x["name"] for x in m["per_layer"]}
        assert {"solve_share", "solver_iters_per_step"} <= names
    else:
        assert names == {x["name"] for x in m["end_to_end"]}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_episode_reset_repeats_the_same_hours(fake_clock):
    """Each episode starts from the seeded state at the same hour, so its
    outputs repeat bit for bit."""
    from perfbench.harness import inputs as inputs_mod, runner
    from perfbench.harness.system import System

    cfg, traffic, _, _ = tiny_cell()
    inp = inputs_mod.make_inputs(cfg, traffic, 9, runner.ROOT)
    system = System(cfg, traffic, inp, device="cpu")
    records, _ = runner.window(system, traffic, seconds=9.5)
    assert [(r["episode"], r["t0"]) for r in records] == [(0, 0), (0, 4), (1, 0), (1, 4)]
    for a, b in zip(records[:2], records[2:]):
        for k in a["host"]:
            np.testing.assert_array_equal(a["host"][k], b["host"][k])


def test_import_check_compares_whole_top_level_names(monkeypatch):
    from perfbench.harness import runner

    import dragg_tpu_torch  # noqa: F401  the port's name begins with the JAX package's

    for name in ("jax", "jaxlib", "flax", "dragg_tpu"):
        assert name not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dragg_tpu_torchx", types.ModuleType("dragg_tpu_torchx"))
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dragg_tpu.engine", types.ModuleType("dragg_tpu.engine"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert runner.forbidden_modules() == ["dragg_tpu", "jaxlib"]


def test_inputs_follow_the_seed():
    from perfbench.harness import inputs as inputs_mod, runner

    cfg, traffic, _, _ = tiny_cell(communities=2)
    a = inputs_mod.make_inputs(cfg, traffic, 2**40 + 3, runner.ROOT)
    b = inputs_mod.make_inputs(cfg, traffic, 2**40 + 3, runner.ROOT)
    c = inputs_mod.make_inputs(cfg, traffic, 2**40 + 4, runner.ROOT)
    for k in a["homes"]:
        np.testing.assert_array_equal(a["homes"][k], b["homes"][k])
    # Another seed: the same homes, in another order inside each type.
    assert not np.array_equal(a["homes"]["hvac_r"], c["homes"]["hvac_r"])
    for code in np.unique(a["homes"]["type_code"]):
        rows = a["homes"]["type_code"] == code
        np.testing.assert_array_equal(np.sort(a["homes"]["hvac_r"][rows]),
                                      np.sort(c["homes"]["hvac_r"][rows]))
    # The fleet's rows are type-major and every community is whole.
    assert np.all(np.diff(a["homes"]["type_code"]) >= 0)
    assert np.bincount(a["homes"]["community"]).tolist() == [40, 40]


def test_idle_share_is_over_an_untraced_episode():
    """The card's busy seconds of the traced episode over the wall time of
    the untraced whole episodes, not over the traced episode's longer
    span; nothing to read without an untraced whole episode."""
    from perfbench.harness import runner, trace as trace_mod
    from perfbench.metrics import device_idle_share

    e = np.zeros(0)
    tr = trace_mod.Trace(np.array(["k", "k"], dtype=object), np.array([0.0, 5.0]),
                         np.array([1.0, 2.0]), np.array([True, True]),
                         np.zeros(0, dtype=object), e, e, window_s=30.0)
    run = runner.Run()
    run.trace = tr

    def rec(ep, traced, seconds):
        return {"episode": ep, "traced": traced, "seconds": seconds}

    run.records = [rec(0, 1, 15.0), rec(0, 1, 15.0), rec(1, 0, 5.0), rec(1, 0, 5.0)]
    assert device_idle_share.read(run) == pytest.approx(70.0)
    run.records = [rec(0, 1, 15.0), rec(0, 1, 15.0), rec(1, 0, 5.0), rec(1, 2, 9.0)]
    assert device_idle_share.read(run) is None
