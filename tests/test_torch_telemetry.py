"""The port's telemetry package (dragg_tpu_torch/telemetry) against the JAX
package's (dragg_tpu/telemetry), both loaded in one process.

The port's registries hold the JAX package's name for name and kind for
kind, and add only the port's own spans and counters; unregistered
names raise in both; a span lands in the metrics snapshot and the stream;
no bus writes nothing; ``$DRAGG_TELEMETRY_DIR`` is joined lazily; the same
emits give records with the same keys from both buses, with the trace
context off (the plain envelope) and on (trace/span/parent added); and the
JAX package's readers (``rollup.fold_rollup``, ``prometheus_text``,
``traces.trace_report``) and the port's copies give equal results on the
same streams, one of them a port run's own ``events.jsonl``.
"""

import json
import os
import time

import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu import telemetry as jtel
from dragg_tpu_torch import telemetry as ttel
from dragg_tpu_torch.aggregator import Aggregator
from dragg_tpu_torch.config import default_config

BOTH = [pytest.param(jtel, id="jax"), pytest.param(ttel, id="torch")]


@pytest.fixture(autouse=True)
def closed(monkeypatch):
    """Every test starts and ends with both buses closed and neither
    environment variable set."""
    for var in (jtel.ENV_DIR, jtel.ENV_FLUSH, jtel.trace.ENV_CTX):
        monkeypatch.delenv(var, raising=False)
    for tel in (jtel, ttel):
        tel.close_run()
        tel.trace.disable()
    yield
    for tel in (jtel, ttel):
        tel.close_run()
        tel.trace.disable()


def _lines(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_default_telemetry_config_equals_jax():
    from dragg_tpu.config import default_config as jax_default_config

    assert default_config()["telemetry"] == jax_default_config()["telemetry"]
    assert default_config()["tpu"]["profile_dir"] == jax_default_config()["tpu"]["profile_dir"]


# What the port adds to the JAX package's registry and exports: the spans
# and counters inside its engine step and interior point, the profiler
# ranges of its ADMM factorization and ReLU-QP bank build, and the
# in-memory recording.
PORT_METRICS = {
    "engine.step_s", "engine.assemble_s", "engine.solve_s", "engine.pin_s",
    "engine.finish_s", "ipm.phase1_s", "ipm.tail_s", "ipm.host_syncs",
    "engine.host_syncs", "admm_factor", "reluqp_bank_build",
}
PORT_EXPORTS = {"recording"}


def test_registries_equal():
    """Every entry of the JAX package's registries is in the port's,
    unchanged, and the port adds only the names written above."""
    assert ttel.EVENTS == jtel.EVENTS
    assert {k: ttel.METRICS[k] for k in jtel.METRICS} == jtel.METRICS
    assert set(ttel.METRICS) - set(jtel.METRICS) == PORT_METRICS
    assert (ttel.ENV_DIR, ttel.ENV_FLUSH, ttel.EVENTS_FILE, ttel.METRICS_FILE) == (
        jtel.ENV_DIR, jtel.ENV_FLUSH, jtel.EVENTS_FILE, jtel.METRICS_FILE)
    assert ttel.trace.ENV_CTX == jtel.trace.ENV_CTX
    assert set(jtel.__all__) <= set(ttel.__all__)
    assert set(ttel.__all__) - set(jtel.__all__) == PORT_EXPORTS


@pytest.mark.parametrize("tel", BOTH)
@pytest.mark.parametrize("call", [
    lambda t: t.emit("no.such.event"),
    lambda t: t.inc("no.such.counter"),
    lambda t: t.set_gauge("no.such.gauge", 1.0),
    lambda t: t.observe("no.such.histogram", 1.0),
    lambda t: t.span("no.such.span"),
    lambda t: t.inc("engine.solve_rate"),  # a gauge used as a counter
], ids=["emit", "inc", "set_gauge", "observe", "span", "kind"])
def test_unregistered_names_raise(tmp_path, tel, call):
    with pytest.raises(ValueError):
        call(tel)               # no bus open
    tel.init_run(str(tmp_path))
    with pytest.raises(ValueError):
        call(tel)               # a bus open
    tel.close_run()
    assert _lines(tmp_path / "events.jsonl") == []


@pytest.mark.parametrize("tel", BOTH)
def test_span_and_snapshot_round_trip(tmp_path, tel):
    assert tel.init_run(str(tmp_path)) == str(tmp_path / "events.jsonl")
    with tel.span("engine.chunk_device_s") as sp:
        time.sleep(0.01)
    tel.inc("engine.repair_failed", 2)
    tel.set_gauge("sim.timestep", 3)
    tel.observe("engine.solve_iters", 5.0)
    snap = tel.snapshot()
    assert tel.write_snapshot() == str(tmp_path / "metrics.json")
    tel.close_run()
    with open(tmp_path / "metrics.json") as f:
        disk = json.load(f)
    assert {k: disk[k] for k in ("counters", "gauges", "histograms")} == {
        k: snap[k] for k in ("counters", "gauges", "histograms")}
    h = disk["histograms"]["engine.chunk_device_s"]
    assert h["count"] == 1 and h["sum"] == sp.s >= 0.01
    assert disk["counters"] == {"engine.repair_failed": 2.0}
    assert disk["gauges"] == {"sim.timestep": 3.0}
    (rec,) = _lines(tmp_path / "events.jsonl")
    assert rec["event"] == "span" and rec["name"] == "engine.chunk_device_s"
    assert rec["s"] == round(sp.s, 6) and rec["seq"] == 1


@pytest.mark.parametrize("tel", BOTH)
def test_no_bus_writes_nothing(tmp_path, tel, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert not tel.active() and tel.snapshot() == {"active": False}
    tel.emit("chunk.done", t0=0, t1=1)
    tel.inc("engine.repair_failed")
    with tel.span("engine.collect_s"):
        pass
    assert tel.write_snapshot() is None and tel.events_path() is None
    assert os.listdir(tmp_path) == []


def test_disabled_run_writes_nothing(tmp_path, monkeypatch):
    """``telemetry.enabled = false``: the run opens no bus, emits nothing
    into the one a ``$DRAGG_TELEMETRY_DIR`` export offers, and leaves no
    stream."""
    monkeypatch.setenv(ttel.ENV_DIR, str(tmp_path / "exported"))
    cfg = default_config()
    cfg["community"].update(total_number_homes=3, homes_pv=1, homes_battery=0,
                            homes_pv_battery=0)
    cfg["simulation"]["end_datetime"] = "2015-01-01 02"
    cfg["home"]["hems"]["prediction_horizon"] = 2
    cfg["telemetry"]["enabled"] = False
    agg = Aggregator(config=cfg, outputs_dir=str(tmp_path / "out"), device="cpu")
    agg.run()
    assert not agg._telemetry_on
    assert not {"events.jsonl", "metrics.json"} & set(os.listdir(agg.run_dir))
    exported = tmp_path / "exported" / "events.jsonl"
    assert not exported.exists() or _lines(exported) == []


@pytest.mark.parametrize("tel", BOTH)
def test_env_dir_join(tmp_path, tel, monkeypatch):
    monkeypatch.setenv(tel.ENV_DIR, str(tmp_path / "joined"))
    tel.close_run()             # re-arms the lazy join
    assert tel.active() and tel.run_dir() == str(tmp_path / "joined")
    tel.emit("run.start", case="baseline")
    assert tel.events_path() == str(tmp_path / "joined" / "events.jsonl")
    tel.close_run(write_metrics=True)
    (rec,) = _lines(tmp_path / "joined" / "events.jsonl")
    assert rec["event"] == "run.start" and rec["case"] == "baseline"
    assert os.path.exists(tmp_path / "joined" / "metrics.json")


def _emit_sample(tel) -> None:
    tel.emit("run.start", case="baseline", homes=3)
    tel.emit("chunk.done", t0=0, t1=1, solve_rate=1.0)
    tel.emit("solver.worst", t0=0, t1=1, homes=[], **tel.trace.child_fields())
    with tel.span("engine.collect_s"):
        pass
    tel.emit("run.end", completed=True)


@pytest.mark.parametrize("traced", [False, True])
def test_same_emits_same_keys(tmp_path, traced):
    recs = {}
    for name, tel in (("jax", jtel), ("torch", ttel)):
        if traced:
            tel.trace.enable(trace_id="feedfacefeedface")
        tel.init_run(str(tmp_path / name))
        _emit_sample(tel)
        tel.close_run()
        tel.trace.disable()
        recs[name] = _lines(tmp_path / name / "events.jsonl")
    assert [set(r) for r in recs["torch"]] == [set(r) for r in recs["jax"]]
    for r in recs["torch"]:
        assert ("trace" in r) == traced
        if traced:
            assert r["trace"] == "feedfacefeedface"
    if traced:
        worst = recs["torch"][2]
        assert worst["parent"] == recs["torch"][0]["span"] != worst["span"]


def _port_run(out: str) -> str:
    cfg = default_config()
    cfg["community"].update(total_number_homes=3, homes_pv=1, homes_battery=0,
                            homes_pv_battery=0)
    cfg["simulation"].update(end_datetime="2015-01-01 02", checkpoint_interval="hourly")
    cfg["home"]["hems"]["prediction_horizon"] = 2
    agg = Aggregator(config=cfg, outputs_dir=out, device="cpu")
    agg.run()
    return agg.run_dir


def _traced_shard_run(run_dir: str) -> str:
    """A traced stream with a shard sub-stream and a clock-skew record,
    written by the port's bus."""
    ttel.trace.enable(trace_id="0123456789abcdef")
    ttel.init_run(run_dir)
    _emit_sample(ttel)
    ttel.emit("shard.plan", workers=1, communities=1)
    ttel.set_gauge("engine.solve_rate", 0.5)
    ttel.write_snapshot()
    ttel.close_run()
    ttel.init_run(os.path.join(run_dir, "shard0"))
    ttel.emit("chunk.done", t0=0, t1=4, solve_rate=1.0, device_s=0.5)
    ttel.emit("trace.skew", shard=0, offset_s=0.0, rtt_s=0.001)
    ttel.inc("wire.retries", 2)
    ttel.write_snapshot()
    ttel.close_run()
    ttel.trace.disable()
    return run_dir


@pytest.mark.parametrize("stream", ["port_run", "traced_shards"])
def test_readers_equal_on_the_same_stream(tmp_path, stream):
    run_dir = (_port_run(str(tmp_path / "out")) if stream == "port_run"
               else _traced_shard_run(str(tmp_path / "traced")))
    now = time.time()
    want = jtel.rollup.fold_rollup(run_dir, now=now)
    got = ttel.rollup.fold_rollup(run_dir, now=now)
    assert got == want
    assert ttel.rollup.prometheus_text(got) == jtel.rollup.prometheus_text(want)
    assert ttel.traces.trace_report(run_dir) == jtel.traces.trace_report(run_dir)
    assert ttel.tail_events_dir(os.path.join(run_dir, "events.jsonl")) == \
        jtel.tail_events_dir(os.path.join(run_dir, "events.jsonl"))
    if stream == "port_run":
        names = [r["event"] for r in _lines(os.path.join(run_dir, "events.jsonl"))]
        assert names[0] == "run.start" and names[-1] == "run.end" and "chunk.done" in names
        assert "engine.solve_rate" in got["streams"]["main"]["metrics"]["gauges"]
    else:
        assert set(got["streams"]) == {"main", "shard0"}
        assert got["fleet_counters"]["wire.retries"] == 2


def test_event_follower_and_selftest(tmp_path):
    ttel.init_run(str(tmp_path))
    fol = ttel.EventFollower(str(tmp_path / "events.jsonl"))
    ttel.emit("chunk.done", t0=0, t1=1)
    assert [r["event"] for r in fol.poll()] == ["chunk.done"]
    ttel.emit("run.end", completed=True)
    assert [r["event"] for r in fol.poll(contains=b'"run.end"')] == ["run.end"]
    assert fol.poll() == []
    ttel.close_run()
    # The port's registry holds the JAX package's and its own additions.
    assert ttel.selftest() == {**jtel.selftest(),
                               "metrics": len(jtel.METRICS) + len(PORT_METRICS)}


def test_bus_shared_by_threads(tmp_path):
    """The aggregator's pipeline emits a chunk's records from its worker
    thread while the main thread emits the run's: 16 threads (more than
    the cores here) emit and count through one bus with a short switch
    interval; no update is lost, every line is whole, the sequence
    numbers are 1..N once each."""
    import sys
    import threading

    n_threads, n_each = 16, 200
    ttel.init_run(str(tmp_path))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(n_each):
                ttel.emit("chunk.done", t0=i, t1=i + 1)
                ttel.inc("engine.repair_failed")
                ttel.observe("engine.collect_s", 0.0)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    snap = ttel.snapshot()
    ttel.close_run()
    total = n_threads * n_each
    assert snap["counters"]["engine.repair_failed"] == total
    assert snap["histograms"]["engine.collect_s"]["count"] == total
    recs = _lines(tmp_path / "events.jsonl")
    assert sorted(r["seq"] for r in recs) == list(range(1, total + 1))
