"""Shared set-up of the benchmark's own tests: the checkout's root on the
path, and a tiny cell on the CPU built from a committed configuration."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_cell(workload="northstar_card.day1", homes=40, horizon=6, communities=1):
    """(configuration, traffic, limits, metrics) of ``workload`` cut to a
    size a test can hold: ``homes`` homes, a ``horizon``-hour horizon, an
    episode of 8 steps in chunks of 4 (and, by :func:`small_sample`, 16
    sampled home-steps)."""
    from perfbench.harness import runner

    _, cfg, traffic, limits, metrics = runner.cell(workload)
    cfg = copy.deepcopy(cfg)
    cfg["homes"] = homes
    cfg["config"]["home"]["hems"]["prediction_horizon"] = horizon
    traffic = dict(traffic, episode_steps=8, chunk_steps=4, communities=communities)
    return cfg, traffic, limits, metrics


@pytest.fixture(autouse=True)
def small_sample(monkeypatch):
    """16 home-steps priced for ``mpc_gap``, a tiny community's share."""
    from perfbench.harness import compare

    monkeypatch.setattr(compare, "MPC_SAMPLE", 16)


@pytest.fixture
def fake_clock(monkeypatch):
    """The runner's clock advances one second a reading, so a window of
    ``seconds`` runs a fixed number of chunks whatever the CPU's speed."""
    from perfbench.harness import runner

    t = {"now": 0.0}

    def tick():
        t["now"] += 1.0
        return t["now"]

    monkeypatch.setattr(runner.time, "perf_counter", tick)
    return t


def run_tiny(seconds=1.0, trace=False, seed=2**33 + 17, **kw):
    from perfbench.harness import runner

    cfg, traffic, limits, metrics = tiny_cell(**kw)
    return runner.run_cell("tiny", seed, seconds, trace, 0.0, device="cpu", cfg_file=cfg,
                           traffic=traffic, limits=limits, metrics=metrics)


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
