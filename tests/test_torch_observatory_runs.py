"""The port's run telemetry end to end (dragg_tpu_torch/aggregator.py on the
CPU) against the JAX aggregator's: a 6-home community (four type buckets)
at H = 4 over 3 hourly chunks, ``telemetry.forensics`` on, in both
packages.

Held: the same sequence of event names, the same field keys on every
record, equal deterministic fields (chunk bounds, bucket names and sizes,
solve rate, divergence and repair counts; the run's case, size and
solver), the same metric names in ``metrics.json`` (but
``engine.overlap_hidden_s``, observed only when a chunk's host work
outlasted the next chunk, a matter of timing in both packages, and the
port's own spans and counters inside its step), and the
same ``forensics/`` files with the same keys, the chunk-start states
within the engines' 1e-4.  Also: telemetry and the observatory change no
bit of results.json; a resumed run appends to the stream it left; and
``tpu.profile_dir`` (or ``$JAX_PROFILE_DIR``) writes a trace of the
second chunk holding the bus's span.
"""

import json
import os

import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu.aggregator import Aggregator as JaxAggregator
from dragg_tpu_torch.aggregator import Aggregator
from dragg_tpu_torch.config import default_config
from tests.test_torch_telemetry import PORT_METRICS

DETERMINISTIC = ("event", "t0", "t1", "n_steps", "bucket", "n_homes", "solve_rate", "diverged",
                 "repair_failed", "case", "homes", "horizon", "solver", "timestep",
                 "num_timesteps", "completed", "total", "by_bucket")
ENVELOPE = {"t", "mono", "pid", "seq"}
TIMED_METRICS = {"engine.overlap_hidden_s"}


def _config(**telemetry):
    cfg = default_config()
    cfg["community"].update(total_number_homes=6, homes_pv=1, homes_battery=1,
                            homes_pv_battery=1)
    cfg["simulation"].update(end_datetime="2015-01-01 03", checkpoint_interval="hourly")
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["tpu"].update(bucketed="true", sharded=False)
    cfg["telemetry"].update(telemetry)
    return cfg


def records(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _metric_names(run_dir: str) -> dict:
    """The metric names of a run's ``metrics.json`` that both packages
    write: without the timed ones, and without the port's own spans and
    counters inside its step (``PORT_METRICS``, which the JAX package's
    one compiled step has no counterpart of)."""
    with open(os.path.join(run_dir, "metrics.json")) as f:
        snap = json.load(f)
    return {k: set(snap[k]) - TIMED_METRICS - PORT_METRICS
            for k in ("counters", "gauges", "histograms")}


def assert_streams_match(got: list[dict], want: list[dict]) -> None:
    """The port's stream against the JAX package's: event names in order,
    key sets, deterministic fields."""
    assert [r["event"] for r in got] == [r["event"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), (g["event"], set(g) ^ set(w))
        assert ENVELOPE <= set(g)
        if g["event"] == "solver.worst":
            # Which homes are worst is the solvers' float32 noise (see
            # tests/test_torch_observatory.py); what a capture holds is not.
            assert [set(h) for h in g["homes"]] == [set(h) for h in w["homes"]]
            continue
        for k in DETERMINISTIC:
            if k in w:
                assert g[k] == w[k], (g["event"], k, g[k], w[k])
        if g["event"] == "solver.convergence":
            assert sum(g["rprim_hist"]) == sum(w["rprim_hist"])
            assert sum(g["iters_hist"]) == sum(w["iters_hist"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("outputs")
    ja = JaxAggregator(config=_config(forensics=True), outputs_dir=str(out / "jax"))
    ja.run()
    ta = Aggregator(config=_config(forensics=True), outputs_dir=str(out / "torch"),
                    device="cpu")
    ta.run()
    return ja, ta


def test_event_stream_matches_jax(runs):
    ja, ta = runs
    got, want = records(ta.run_dir), records(ja.run_dir)
    assert_streams_match(got, want)
    names = [r["event"] for r in got]
    assert names[0] == "run.start" and names[-1] == "run.end"
    assert names.count("chunk.done") == 3
    buckets = [b["name"] for b in ta.engine.bucket_info()]
    assert len(buckets) == 4
    conv = [r for r in got if r["event"] == "solver.convergence"]
    assert [r["bucket"] for r in conv] == buckets * 3
    for r in conv:
        assert sum(r["rprim_hist"]) == sum(r["iters_hist"]) == r["n_homes"] * (r["t1"] - r["t0"])
    done = [r for r in got if r["event"] == "chunk.done"]
    assert [r["t0"] for r in done] == [0, 1, 2] and all("device_s" in r for r in done)
    for w in (r for r in got if r["event"] == "solver.worst"):
        c = next(r for r in done if r["t0"] == w["t0"])
        assert max(h["r_prim"] for h in w["homes"]) == c["r_prim_max"]
        assert all(0 <= h["home"] < 6 for h in w["homes"])
    assert _metric_names(ta.run_dir) == _metric_names(ja.run_dir)
    with open(os.path.join(ta.run_dir, "metrics.json")) as f:
        hists = json.load(f)["histograms"]
    # The port's step spans: one engine.step_s a step, a phase a bucket.
    assert hists["engine.step_s"]["count"] == 3
    assert hists["engine.solve_s"]["count"] == 3 * len(buckets)


def test_forensics_match_jax(runs):
    ja, ta = runs
    fj, ft = (os.path.join(a.run_dir, "forensics") for a in (ja, ta))
    assert sorted(os.listdir(ft)) == sorted(os.listdir(fj)) == [
        f"chunk_t{t:08d}.json" for t in range(3)]
    for name in os.listdir(fj):
        with open(os.path.join(fj, name)) as f:
            dj = json.load(f)
        with open(os.path.join(ft, name)) as f:
            dt = json.load(f)
        assert set(dt) == set(dj)
        for k in ("t0", "t1", "case", "start_index", "solver", "horizon",
                  "integer_first_action", "integer_repair", "reward_prices"):
            assert dt[k] == dj[k], k
        assert [set(b) for b in dt["buckets"]] == [set(b) for b in dj["buckets"]]
        assert [b["name"] for b in dt["buckets"]] == [b["name"] for b in dj["buckets"]]
        by_home = {h["home"]: h for h in dj["homes"]}
        for h in dt["homes"]:
            assert set(h) == set(by_home[h["home"]])
            assert h["name"] == by_home[h["home"]]["name"] and h["config"]["type"] == h["type"]
            sj, st = by_home[h["home"]]["state_at_chunk_start"], h["state_at_chunk_start"]
            assert set(st) == set(sj) == {"temp_in", "temp_wh", "e_batt", "counter"}
            for k in st:
                assert abs(st[k] - sj[k]) <= 1e-4, (name, h["home"], k)


def _results(agg) -> dict:
    with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
        res = json.load(f)
    for k in ("solve_time", "phase_times"):
        res["Summary"].pop(k)
    return res


@pytest.mark.parametrize("solver", ["ipm", "reluqp"])
def test_telemetry_changes_no_result(tmp_path, solver):
    """results.json bit for bit with the telemetry and the observatory on
    (the defaults) and off; the run with it off writes no stream."""
    on = _config()
    on["home"]["hems"]["solver"] = solver
    off = _config(enabled=False, per_home=False)
    off["home"]["hems"]["solver"] = solver
    a_on = Aggregator(config=on, outputs_dir=str(tmp_path / "on"), device="cpu")
    a_on.run()
    a_off = Aggregator(config=off, outputs_dir=str(tmp_path / "off"), device="cpu")
    a_off.run()
    assert _results(a_on) == _results(a_off)
    assert os.path.exists(os.path.join(a_on.run_dir, "metrics.json"))
    assert not {"events.jsonl", "metrics.json"} & set(os.listdir(a_off.run_dir))


def test_resumed_run_appends_to_its_stream(tmp_path):
    cfg = _config()
    cfg["simulation"]["resume"] = True
    part = Aggregator(config=cfg, outputs_dir=str(tmp_path), device="cpu")
    part.stop_after_chunks = 1
    part.run()
    first = records(part.run_dir)
    assert first[-1]["event"] == "run.end" and first[-1]["completed"] is False
    res = Aggregator(config=cfg, outputs_dir=str(tmp_path), device="cpu")
    res.run()
    assert res.resumed_from is not None
    recs = records(res.run_dir)
    assert recs[:len(first)] == first
    names = [r["event"] for r in recs]
    assert names.count("run.start") == names.count("run.end") == 2
    assert [r["t0"] for r in recs if r["event"] == "chunk.done"] == [0, 1, 2]
    assert recs[-1]["completed"] is True


@pytest.mark.parametrize("route", ["config", "env"])
def test_profile_dir_traces_the_second_chunk(tmp_path, monkeypatch, route):
    cfg = _config()
    trace_dir = tmp_path / "trace"
    if route == "config":
        cfg["tpu"]["profile_dir"] = str(trace_dir)
    else:
        monkeypatch.setenv("JAX_PROFILE_DIR", str(trace_dir))
    agg = Aggregator(config=cfg, outputs_dir=str(tmp_path / "out"), device="cpu")
    agg.run()
    assert os.listdir(trace_dir) == ["chunk_t00000001.pt.trace.json"]
    with open(trace_dir / "chunk_t00000001.pt.trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "engine.chunk_device_s" in names
    assert any(str(n).startswith("aten::") for n in names)
    spans = [r for r in records(agg.run_dir) if r["event"] == "span"]
    assert [r["name"] for r in spans] == ["engine.chunk_device_s"]
    done = [r for r in records(agg.run_dir) if r["event"] == "chunk.done"]
    assert len(done) == 3
    with open(os.path.join(agg.run_dir, "metrics.json")) as f:
        assert json.load(f)["histograms"]["engine.chunk_device_s"]["count"] == 3
