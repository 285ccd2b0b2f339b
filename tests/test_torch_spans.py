"""The port's spans and counters inside the engine step and the interior
point (``dragg_tpu_torch.telemetry``: ``span``, ``recording``), and the
benchmark's readers of them (``perfbench/metrics``).

A tiny bucketed community's chunk under a recording: one ``engine.step_s``
a step with its ``t``, each bucket's phases under it with their
``bucket``, the interior point's loops under the solve with their
iteration counts, and ``ipm.host_syncs`` equal to what those counts
give; the outputs bit-equal with the recording on and off; a span with
nothing on makes no record, no event and no histogram; the recording's
clock is the profiler's; the readers on a traced CPU run, on a program
without the recording, and on a synthetic trace; an aggregator run's
events as before.
"""

import collections
import copy
import json
import os
import statistics

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu_torch import telemetry as ttel  # noqa: E402
from dragg_tpu_torch.aggregator import Aggregator  # noqa: E402
from dragg_tpu_torch.config import default_config  # noqa: E402
from perfbench.harness import compare, inputs as inputs_mod, runner  # noqa: E402
from perfbench.harness.system import System  # noqa: E402
from perfbench.harness.trace import Trace  # noqa: E402
from perfbench.metrics import (  # noqa: E402
    _program,
    host_syncs_per_step,
    ipm_idle_ms_per_step,
    ipm_span_share,
)

READERS = (host_syncs_per_step, ipm_span_share, ipm_idle_ms_per_step)
SEED = 2**33 + 17


@pytest.fixture(autouse=True)
def closed(monkeypatch):
    """No bus open and no telemetry directory exported, before and after."""
    monkeypatch.delenv(ttel.ENV_DIR, raising=False)
    ttel.close_run()
    yield
    ttel.close_run()


def _tiny_cell(episode_steps=4):
    """The 25k cell's configuration cut to 40 homes at H = 6: four type
    buckets (two of them too small for the straggler tail)."""
    _, cfg, traffic, limits, metrics = runner.cell("northstar_card.day1")
    cfg = copy.deepcopy(cfg)
    cfg["homes"] = 40
    cfg["config"]["home"]["hems"]["prediction_horizon"] = 6
    traffic = dict(traffic, episode_steps=episode_steps, chunk_steps=4, communities=1)
    return cfg, traffic, limits, metrics


@pytest.fixture(scope="module")
def system():
    cfg, traffic, _, _ = _tiny_cell()
    return System(cfg, traffic, inputs_mod.make_inputs(cfg, traffic, SEED, runner.ROOT),
                  device="cpu")


def _children(records, i):
    return [r for r in records if r["parent"] == i]


def test_step_spans_nest_with_t_and_bucket(system):
    buckets = [c.name for c in system.engine._buckets]
    assert len(buckets) == 4
    with ttel.recording() as rec:
        system.run_chunk(system.init_state(), 8, 3)
    recs = rec.records
    assert all(r["end_ns"] is not None and r["end_ns"] >= r["start_ns"] for r in recs)
    steps = [i for i, r in enumerate(recs) if r["name"] == "engine.step_s"]
    assert [recs[i]["attrs"] for i in steps] == [{"t": 8}, {"t": 9}, {"t": 10}]
    assert all(recs[i]["parent"] is None for i in steps)
    for i in steps:
        t = recs[i]["attrs"]["t"]
        phases = _children(recs, i)
        assert [(r["name"], r["attrs"]) for r in phases] == [
            (name, {"t": t, "bucket": b}) for b in buckets
            for name in ("engine.assemble_s", "engine.solve_s", "engine.finish_s")]
        for p in phases:
            assert recs[i]["start_ns"] <= p["start_ns"] <= p["end_ns"] <= recs[i]["end_ns"]
        for solve in (recs.index(p) for p in phases if p["name"] == "engine.solve_s"):
            inner = _children(recs, solve)
            names = [r["name"] for r in inner]
            assert names[0] == "ipm.phase1_s" and names[-1] == "engine.pin_s"
            assert names[1:-1] in ([], ["ipm.tail_s"])
            for r in inner:
                assert r["attrs"]["t"] == t and r["attrs"]["bucket"] == recs[solve]["attrs"]["bucket"]
                assert ("iterations" in r["attrs"]) == r["name"].startswith("ipm.")
    # Every span this step path opens is one of these, and none of them
    # wrote a span event or a histogram: no bus was open.
    assert {r["name"] for r in recs} == {
        "engine.step_s", "engine.assemble_s", "engine.solve_s", "engine.finish_s",
        "engine.pin_s", "ipm.phase1_s", "ipm.tail_s"}
    assert rec.dropped == 0 and ttel.snapshot() == {"active": False}


def test_steps_table_gathers_each_steps_buckets(system):
    """``Recording.steps``: a row a step with its ``t``, and each bucket's
    phases' seconds and loops' iterations as the step's spans give them."""
    with ttel.recording() as rec:
        _, host = system.run_chunk(system.init_state(), 8, 3)
    rows = rec.steps()
    assert [r["t"] for r in rows] == [8, 9, 10]
    buckets = [c.name for c in system.engine._buckets]
    for row, iters in zip(rows, host["admm_iters"]):
        assert list(row["buckets"]) == buckets
        for b in row["buckets"].values():
            assert {"assemble_s", "solve_s", "pin_s", "finish_s", "phase1_s",
                    "phase1_iterations"} <= set(b) <= {
                "assemble_s", "solve_s", "pin_s", "finish_s", "phase1_s",
                "phase1_iterations", "tail_s", "tail_iterations"}
            assert b["pin_s"] + b["phase1_s"] + b.get("tail_s", 0.0) <= b["solve_s"]
        assert sum(b["assemble_s"] + b["solve_s"] + b["finish_s"]
                   for b in row["buckets"].values()) <= row["step_s"]
        assert int(iters) == max(b["phase1_iterations"] + b.get("tail_iterations", 0)
                                 for b in row["buckets"].values())


def test_host_syncs_equal_what_the_iterations_give(system):
    """Each step alone: in ``ops/ipm.py``, two syncs an iteration in every
    bucket's loops, one before each straggler tail and the solve's eight
    index copies, as the ipm spans count them; the step path's other
    sites the same number every step, a bucket's copies of index arrays
    and scalars and the chunk's prices."""
    state, others = system.init_state(), []
    for t in range(6, 10):
        with ttel.recording() as rec:
            state, host = system.run_chunk(state, t, 1)
        ipm = [r for r in rec.records if r["name"].startswith("ipm.")]
        tails = [r for r in ipm if r["name"] == "ipm.tail_s"]
        solves = [r for r in ipm if r["name"] == "ipm.phase1_s"]
        iters = sum(r["attrs"]["iterations"] for r in ipm)
        assert len(solves) == 4
        assert rec.counters["ipm.host_syncs"] == 2 * iters + len(tails) + 8 * len(solves)
        others.append(rec.counters["engine.host_syncs"])
        # The step reports its binding bucket's iterations.
        per_bucket = collections.Counter()
        for r in ipm:
            per_bucket[r["attrs"]["bucket"]] += r["attrs"]["iterations"]
        assert int(host["admm_iters"][0]) == max(per_bucket.values())
    assert others == [others[0]] * 4 and others[0] > 0


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in _leaves(t)]


def _chunk_outputs(system):
    """Every tensor of a chunk's final state (a tuple a bucket) and outputs."""
    return _leaves(system.engine.run_chunk(system.init_state(), 8,
                                           np.zeros((3, system.H), np.float32)))


def test_outputs_bit_equal_with_recording_on_and_off(system, tmp_path):
    off = _chunk_outputs(system)
    with ttel.recording():
        on = _chunk_outputs(system)
    ttel.init_run(str(tmp_path))
    with ttel.recording():
        bus_on = _chunk_outputs(system)
    ttel.close_run()
    for a, b, c in zip(off, on, bus_on):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_span_with_nothing_on_makes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert not ttel.active()

    def refuse(*a, **k):
        raise AssertionError("a span with nothing on reached the recording")

    monkeypatch.setattr(ttel.bus.Recording, "_open", refuse)
    with ttel.span("engine.step_s", event=False, t=0) as sp:
        sp.set(iterations=3)
    with ttel.span("engine.collect_s") as old:
        pass
    assert sp.s is None and old.s is None
    assert sp._node is None and sp._ann is None
    assert ttel.snapshot() == {"active": False}
    assert os.listdir(tmp_path) == []


def test_bus_keeps_span_events_of_the_old_spans_only(tmp_path):
    ttel.init_run(str(tmp_path))
    with ttel.span("engine.collect_s"):
        pass
    with ttel.span("engine.step_s", event=False, t=0):
        pass
    snap = ttel.snapshot()
    ttel.close_run()
    with open(tmp_path / "events.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [(r["event"], r["name"]) for r in recs] == [("span", "engine.collect_s")]
    assert {k: h["count"] for k, h in snap["histograms"].items()} == {
        "engine.collect_s": 1, "engine.step_s": 1}


def test_span_clock_is_the_profilers():
    """A span and the profiler range it opens agree to within 100 µs at
    both ends (the median of 20, after one warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    with ttel.recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(21):
            with ttel.span("engine.step_s", event=False, t=0):
                torch.ones(256).sum()
    ranges = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name() == "engine.step_s")
    spans = sorted((r["start_ns"], r["end_ns"]) for r in rec.records)
    assert len(ranges) == len(spans) == 21
    d_start = [abs(s[0] - r[0]) for s, r in zip(spans[1:], ranges[1:])]
    d_end = [abs(s[1] - r[1]) for s, r in zip(spans[1:], ranges[1:])]
    assert statistics.median(d_start) <= 100_000
    assert statistics.median(d_end) <= 100_000


def test_recording_is_one_at_a_time_and_bounded(monkeypatch):
    monkeypatch.setattr(ttel.bus, "RECORDING_CAP", 2)
    with ttel.recording() as rec:
        with pytest.raises(RuntimeError):
            with ttel.recording():
                pass
        with ttel.span("engine.step_s", event=False, t=1):
            for b in ("a", "b"):
                with ttel.span("engine.solve_s", event=False, bucket=b):
                    ttel.inc("ipm.host_syncs", 2)
    assert [(r["name"], r["attrs"]) for r in rec.records] == [
        ("engine.step_s", {"t": 1}), ("engine.solve_s", {"t": 1, "bucket": "a"})]
    assert rec.dropped == 1 and rec.counters == {"ipm.host_syncs": 4.0}
    monkeypatch.setattr(ttel.bus, "RECORDING_CAP", 0)
    with ttel.recording() as rec:
        with ttel.span("engine.step_s", event=False):
            ttel.inc("ipm.host_syncs")
    assert rec.records == [] and rec.dropped == 1 and rec.counters == {"ipm.host_syncs": 1.0}


@pytest.fixture(scope="module")
def traced_line():
    cfg, traffic, limits, metrics = _tiny_cell(episode_steps=8)
    old = compare.MPC_SAMPLE
    compare.MPC_SAMPLE = 16
    try:
        return runner.run_cell("tiny", SEED, 1.0, True, 0.0, device="cpu", cfg_file=cfg,
                               traffic=traffic, limits=limits, metrics=metrics)
    finally:
        compare.MPC_SAMPLE = old


def test_readers_on_a_traced_cpu_run(traced_line):
    got = traced_line["metrics"]
    assert traced_line["correct"]
    iters = got["solver_iters_per_step"]["value"]
    # Two syncs an iteration in the binding bucket alone, at least.
    assert got["host_syncs_per_step"]["value"] >= 2 * iters > 0
    assert got["host_syncs_per_step"]["unit"] == "syncs"
    assert 0 < got["ipm_span_share"]["value"] < 100
    # No card, no device trace: nothing to cut.
    assert "ipm_idle_ms_per_step" not in got


def test_readers_none_without_the_programs_recording(system, monkeypatch):
    """A program without ``telemetry.recording`` (an older commit): every
    reader instruments without raising and reads None."""
    monkeypatch.delattr(ttel, "recording")
    run = runner.Run()
    with _program.recorded(run), ipm_span_share.instrument(run):
        system.run_chunk(system.init_state(), 8, 1)
    run.trace = _trace([0.0, 1.0], [0.5, 0.5])
    assert _program.KEY not in run.counters
    assert [m.read(run) for m in READERS] == [None, None, None]
    assert [m.read(runner.Run()) for m in READERS] == [None, None, None]


def _trace(starts, durs):
    k = len(starts)
    return Trace(np.array(["k"] * k, dtype=object), np.asarray(starts, dtype=np.float64),
                 np.asarray(durs, dtype=np.float64), np.ones(k, dtype=bool),
                 np.zeros(0, dtype=object), np.zeros(0), np.zeros(0), 0.0)


class _Rec:
    def __init__(self, records, counters):
        self.records, self.counters = records, counters


def _span(name, a, b):
    return {"name": name, "start_ns": int(a * 1e9), "end_ns": int(b * 1e9),
            "parent": None, "attrs": {}}


def test_readers_on_a_synthetic_recording():
    """Two steps of 10 s; ipm spans over [1, 4] and [12, 13] s; the card
    busy over [0, 2], [3, 5] and [12.5, 20] s: idle inside the ipm spans is
    [2, 3] and [12, 12.5] s, 0.75 s a step."""
    run = runner.Run()
    run.counters[_program.KEY] = _Rec(
        [_span("engine.step_s", 0, 10), _span("ipm.phase1_s", 1, 4),
         _span("engine.step_s", 10, 20), _span("ipm.tail_s", 12, 13)],
        {"ipm.host_syncs": 30.0})
    run.trace = _trace([0.0, 3.0, 12.5], [2.0, 2.0, 7.5])
    assert host_syncs_per_step.read(run) == 15.0
    assert ipm_span_share.read(run) == pytest.approx(20.0)
    assert ipm_idle_ms_per_step.read(run) == pytest.approx(750.0)
    g0, glen = np.array([2.0, 5.0]), np.array([1.0, 7.5])
    assert ipm_idle_ms_per_step.idle_inside(g0, glen, np.array([0.0, 6.0]),
                                            np.array([2.5, 20.0])) == pytest.approx(7.0)


def test_aggregator_events_as_before(tmp_path):
    """A run with telemetry on writes the event names and counts it wrote
    before the step's spans existed; the spans reach its histograms."""
    cfg = default_config()
    cfg["community"].update(total_number_homes=3, homes_pv=1, homes_battery=0,
                            homes_pv_battery=0)
    cfg["simulation"].update(end_datetime="2015-01-01 02", checkpoint_interval="hourly")
    cfg["home"]["hems"]["prediction_horizon"] = 2
    agg = Aggregator(config=cfg, outputs_dir=str(tmp_path), device="cpu")
    agg.run()
    with open(os.path.join(agg.run_dir, "events.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert collections.Counter(r["event"] for r in recs) == {
        "run.start": 1, "chunk.done": 2, "solver.convergence": 2, "solver.worst": 2,
        "run.end": 1}
    with open(os.path.join(agg.run_dir, "metrics.json")) as f:
        hists = json.load(f)["histograms"]
    assert hists["engine.step_s"]["count"] == 2
