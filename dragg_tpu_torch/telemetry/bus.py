"""Run-scoped event bus + metrics registry + span API — stdlib only
(a copy of ``dragg_tpu/telemetry/bus.py``).

One process-wide bus, explicitly opened by entry points
(:func:`init_run`) or joined automatically from ``$DRAGG_TELEMETRY_DIR``
(how a child process lands its events in the same stream as the parent
that launched it).  While a bus is open:

* :func:`emit` appends one typed JSON record per call to
  ``<run_dir>/events.jsonl`` (append-only; each record carries wall
  time, a monotonic offset, pid, and a per-process sequence number, so
  merged multi-process streams stay ordered and attributable);
* :func:`inc` / :func:`set_gauge` / :func:`observe` update the in-memory
  metrics registry; :func:`snapshot` reads it and
  :func:`write_snapshot` persists it as ``<run_dir>/metrics.json``;
* :func:`span` times a block into a histogram metric (and emits a
  ``span`` event), wrapping ``torch.profiler.record_function`` when torch
  is ALREADY imported in this process, so the span shows in a profiler
  trace — this module never imports torch itself.

One lock covers every update and every write, so threads share the bus:
the aggregator's pipeline emits a chunk's records from its worker thread
while the main thread emits the run's.

Disabled mode (no bus open, env unset) is the default and near-free:
every entry point is a registry membership check plus one module-global
load.  Name discipline is enforced even when disabled: an unregistered
name raises ValueError so a typo cannot hide until a run is
instrumented.  IO failures, by contrast, are swallowed — telemetry must
never kill the workload it observes.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from dragg_tpu_torch.telemetry import registry, trace

ENV_DIR = "DRAGG_TELEMETRY_DIR"
ENV_FLUSH = "DRAGG_TELEMETRY_FLUSH_S"
EVENTS_FILE = "events.jsonl"
METRICS_FILE = "metrics.json"
SCHEMA_VERSION = 1
_SAMPLE_CAP = 256  # bounded per-histogram sample tail kept in snapshots


def _jsonable(o):
    """Fallback serializer: numpy scalars -> float, everything else str."""
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


class _Hist:
    __slots__ = ("count", "total", "vmin", "vmax", "last", "samples")

    def __init__(self):
        import collections

        self.count = 0
        self.total = 0.0
        self.vmin = self.vmax = self.last = None
        # A true bounded TAIL (the newest _SAMPLE_CAP observations), not
        # a prefix: consumers like bench's chunk_rates want steady-state
        # samples, and a prefix would silently drop the warmed-up end of
        # a long series.
        self.samples: "collections.deque[float]" = collections.deque(
            maxlen=_SAMPLE_CAP)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.last = v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        self.samples.append(v)

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin,
            "max": self.vmax,
            "mean": self.total / self.count if self.count else None,
            "last": self.last,
            "samples": list(self.samples),
        }


class _Bus:
    def __init__(self, run_dir: str | None, jsonl: bool = True,
                 flush_s: float | None = None):
        self.run_dir = run_dir
        self.lock = threading.RLock()
        self.seq = 0
        self.mono0 = time.monotonic()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, _Hist] = {}
        self.path = None
        self._fh = None
        if flush_s is None:
            try:
                flush_s = float(os.environ.get(ENV_FLUSH) or 0.0)
            except ValueError:
                flush_s = 0.0
        self.flush_s = max(0.0, flush_s)
        self._next_flush = self.mono0 + self.flush_s
        if run_dir and jsonl:
            os.makedirs(run_dir, exist_ok=True)
            self.path = os.path.join(run_dir, EVENTS_FILE)
            self._fh = open(self.path, "a", encoding="utf-8")

    def emit(self, event: str, fields: dict) -> None:
        with self.lock:
            self.seq += 1
            rec = {"event": event, "t": round(time.time(), 3),
                   "mono": round(time.monotonic() - self.mono0, 6),
                   "pid": os.getpid(), "seq": self.seq}
            rec.update(fields)
            # Causal trace context: when tracing is on, every
            # record carries trace/span/parent.  setdefault lets an
            # emitter's finer span win; with tracing off NOTHING is
            # added, keeping the off-mode stream byte-identical.
            ctx = trace.current()
            if ctx is not None:
                rec.setdefault("trace", ctx["trace"])
                rec.setdefault("span", ctx["span"])
                if "parent" not in rec and ctx["parent"] is not None:
                    rec["parent"] = ctx["parent"]
            if self._fh is not None:
                try:
                    # One full line per write: POSIX O_APPEND keeps lines
                    # from different processes whole in a shared file.
                    self._fh.write(json.dumps(rec, default=_jsonable) + "\n")
                    self._fh.flush()
                except (OSError, ValueError):
                    pass  # telemetry never kills the workload
            # Periodic in-progress metrics flush (the live-rollup feed):
            # a kill -9 between flushes loses at most flush_s of metric
            # deltas instead of the whole metrics.json.  Off (0.0) by
            # default — such runs write metrics.json only at close.
            if self.flush_s and self.run_dir:
                now = time.monotonic()
                if now >= self._next_flush:
                    self._next_flush = now + self.flush_s
                    _write_snapshot_locked(self)

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "schema": SCHEMA_VERSION,
                "written_at": round(time.time(), 3),
                "run_dir": self.run_dir,
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: h.summary() for k, h in self.hists.items()},
            }

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


_bus: _Bus | None = None
_env_checked = False
_state_lock = threading.Lock()


def _current() -> _Bus | None:
    """The active bus, joining ``$DRAGG_TELEMETRY_DIR`` lazily on first
    use (re-checked after every :func:`close_run`)."""
    global _bus, _env_checked
    bus = _bus
    if bus is not None or _env_checked:
        return bus
    with _state_lock:
        if _bus is None and not _env_checked:
            _env_checked = True
            d = os.environ.get(ENV_DIR)
            if d:
                try:
                    _bus = _Bus(d)
                except OSError:
                    _bus = None
        return _bus


def init_run(run_dir: str | None = None, jsonl: bool = True,
             flush_s: float | None = None) -> str | None:
    """Open the process bus.  ``run_dir=None`` gives a memory-only bus
    (metrics + spans work, no events file).  Returns the
    events.jsonl path, or None when memory-only.  ``flush_s`` > 0 turns
    on the periodic in-progress metrics flush (default: read
    ``$DRAGG_TELEMETRY_FLUSH_S``, else off)."""
    global _bus, _env_checked
    with _state_lock:
        if _bus is not None:
            _bus.close()
        _bus = _Bus(run_dir, jsonl=jsonl, flush_s=flush_s)
        _env_checked = True
        return _bus.path


def close_run(write_metrics: bool = False) -> None:
    """Close the bus (optionally persisting a final metrics snapshot
    first) and re-arm the ``$DRAGG_TELEMETRY_DIR`` auto-join."""
    global _bus, _env_checked
    with _state_lock:
        if _bus is not None:
            if write_metrics and _bus.run_dir:
                _write_snapshot_locked(_bus)
            _bus.close()
        _bus = None
        _env_checked = False


def active() -> bool:
    return _current() is not None


def events_path() -> str | None:
    bus = _current()
    return bus.path if bus else None


def run_dir() -> str | None:
    bus = _current()
    return bus.run_dir if bus else None


# ------------------------------------------------------------------ emits
def emit(event: str, **fields) -> None:
    """Append one typed event record to the run stream (no-op when no
    bus is open; unregistered names raise regardless)."""
    registry.check_event(event)
    bus = _current()
    if bus is not None:
        bus.emit(event, fields)


def inc(name: str, value: float = 1.0) -> None:
    registry.check_metric(name, "counter")
    bus = _current()
    if bus is not None:
        with bus.lock:
            bus.counters[name] = bus.counters.get(name, 0.0) + float(value)


def set_gauge(name: str, value: float) -> None:
    registry.check_metric(name, "gauge")
    bus = _current()
    if bus is not None:
        with bus.lock:
            bus.gauges[name] = float(value)


def observe(name: str, value: float) -> None:
    registry.check_metric(name, "histogram")
    bus = _current()
    if bus is not None:
        with bus.lock:
            bus.hists.setdefault(name, _Hist()).observe(float(value))


class span:
    """``with telemetry.span("engine.chunk_device_s") as sp: ...`` — times
    the block into the named histogram metric, emits a ``span`` event, and
    leaves the duration on ``sp.s``.  Wraps the block in a
    ``torch.profiler.record_function`` when torch is already imported and
    a bus is open (so spans show up in profiler traces, the counterpart of
    the JAX bus's ``jax.profiler.TraceAnnotation``) — never imports torch
    itself."""

    __slots__ = ("name", "s", "_t0", "_ann")

    def __init__(self, name: str):
        registry.check_metric(name, "histogram")
        self.name = name
        self.s = None
        self._ann = None

    def __enter__(self):
        if "torch" in sys.modules and _current() is not None:
            try:
                from torch.profiler import record_function

                self._ann = record_function(self.name)
                self._ann.__enter__()
            except Exception:
                self._ann = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.s = time.perf_counter() - self._t0
        if self._ann is not None:
            try:
                self._ann.__exit__(*exc)
            except Exception:
                pass
        bus = _current()
        if bus is not None:
            with bus.lock:
                bus.hists.setdefault(self.name, _Hist()).observe(self.s)
            bus.emit("span", {"name": self.name, "s": round(self.s, 6)})
        return False


def tail_events(events_path: str, limit: int = 50,
                tail_bytes: int = 262_144) -> list[dict]:
    """Last ``limit`` parseable event records of an events.jsonl — reads
    a bounded byte tail, so tailing a huge in-progress stream stays
    O(limit) not O(run).  Torn/mid-write lines are skipped.  Shared by
    the dashboard's ``/live`` surface and the serving daemon's
    ``/events.jsonl`` endpoint (one tailer, one dialect)."""
    try:
        with open(events_path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - tail_bytes))
            lines = f.read().decode("utf-8", "replace").splitlines()
    except OSError:
        return []
    out: list[dict] = []
    for line in reversed(lines):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            continue  # torn first line of the tail window / mid-write
        if len(out) >= limit:
            break
    return list(reversed(out))


def stream_paths(events_path: str) -> list[str]:
    """The events.jsonl streams of one run: the main file plus any
    per-shard sub-streams (``shard<k>/events.jsonl`` — the shard slots
    export one per worker child so concurrent shards never interleave
    into one bus file; dragg_tpu/shard/slots.py).  Ordered main-first,
    then shards by index."""
    paths = [events_path]
    run_dir = os.path.dirname(events_path)
    try:
        names = os.listdir(run_dir)
    except OSError:
        return paths
    shards = []
    for name in names:
        if name.startswith("shard"):
            try:
                idx = int(name[len("shard"):])
            except ValueError:
                continue
            p = os.path.join(run_dir, name, EVENTS_FILE)
            if os.path.isfile(p):
                shards.append((idx, p))
    paths.extend(p for _i, p in sorted(shards))
    return paths


def skew_offsets(records) -> dict:
    """Per-emitter wall-clock corrections from ``trace.skew`` records:
    ``{(_stream, pid): offset_s}`` (last record wins).  The offsets come
    from the shard wire's clock handshake (shard/transport.py) — on a
    single host they are ~0, on a real multi-host fleet they are the
    honesty correction merged ordering needs."""
    offsets: dict = {}
    for rec in records:
        if rec.get("event") == "trace.skew":
            try:
                offsets[(rec.get("_stream", "main"), rec.get("pid"))] = \
                    float(rec.get("offset_s") or 0.0)
            except (TypeError, ValueError):
                continue
    return offsets


def tail_events_dir(events_path: str, limit: int = 50,
                    tail_bytes: int = 262_144) -> list[dict]:
    """Merged tail across one run's streams (:func:`stream_paths`):
    the newest ``limit`` records across the main stream AND every shard
    sub-stream, ordered by ``(t, pid, seq)`` — wall time first, then
    pid and per-process seq so cross-process ties interleave
    DETERMINISTICALLY (tests/test_trace.py pins the order).  When a
    stream carries ``trace.skew`` records (the wire clock handshake),
    each emitter's ``t`` is skew-corrected before ordering; without
    them, wall clocks are trusted as-is — the documented caveat for
    multi-host runs without the tcp transport.  Each record carries a
    ``_stream`` key naming its source (``"main"`` or ``"shard<k>"``)
    so a merged view stays attributable.  A run with no sub-streams
    reduces to :func:`tail_events` plus the ``_stream`` annotation."""
    labelled: list[dict] = []
    for path in stream_paths(events_path):
        label = os.path.basename(os.path.dirname(path))
        if path == events_path:
            label = "main"
        for rec in tail_events(path, limit=limit, tail_bytes=tail_bytes):
            labelled.append({**rec, "_stream": label})
    offsets = skew_offsets(labelled)
    merged = []
    for rec in labelled:
        off = offsets.get((rec["_stream"], rec.get("pid")), 0.0)
        merged.append((rec.get("t", 0.0) + off, rec.get("pid") or 0,
                       rec.get("seq", 0), rec))
    merged.sort(key=lambda r: (r[0], r[1], r[2]))
    return [rec for _t, _p, _s, rec in merged[-limit:]]


class EventFollower:
    """Incremental reader of one events.jsonl stream — the counterpart
    of :func:`tail_events` for consumers that poll repeatedly (the
    serving daemon's ``/result?stream=1`` transport, the load harness
    watching ``serve.done`` for daemon-side completion times): each
    ``poll()`` costs O(new bytes), never a re-read of the tail."""

    def __init__(self, path: str, *, tail_bytes: int | None = None):
        """``tail_bytes`` bounds the FIRST read to the file's last N
        bytes (opening a follower on a long-lived events file reads a
        bounded backlog, then goes incremental); a torn first line is
        dropped by the JSON parse."""
        self.path = path
        self._pos = 0
        self._buf = b""
        self._tail_bytes = tail_bytes
        self._primed = tail_bytes is None

    def poll(self, *, contains: bytes | None = None) -> list[dict]:
        """Records appended since the last poll (torn tails wait for the
        next poll).  ``contains`` pre-filters raw lines by substring
        BEFORE the JSON parse — a consumer watching one event kind on a
        busy stream (e.g. ``b'"serve.chunk"'``) skips the parse cost of
        everything else."""
        try:
            with open(self.path, "rb") as f:
                if not self._primed:
                    f.seek(0, os.SEEK_END)
                    self._pos = max(0, f.tell() - int(self._tail_bytes))
                    self._primed = True
                f.seek(self._pos)
                data = f.read()
                self._pos = f.tell()
        except OSError:
            return []
        if not data:
            return []
        self._buf += data
        out = []
        while b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            if contains is not None and contains not in line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out


# -------------------------------------------------------------- snapshots
def snapshot() -> dict:
    """The current metrics registry as one JSON-able dict
    (``{"active": False}`` when no bus is open)."""
    bus = _current()
    if bus is None:
        return {"active": False}
    return bus.snapshot()


def _write_snapshot_locked(bus: _Bus, name: str | None = None) -> str | None:
    if not bus.run_dir:
        return None
    path = os.path.join(bus.run_dir, name or METRICS_FILE)
    try:
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(bus.snapshot(), f, indent=1, default=_jsonable)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def write_snapshot(name: str | None = None) -> str | None:
    """Persist the metrics registry as ``<run_dir>/metrics.json``
    (atomic tmp+rename).  Returns the path, or None when memory-only /
    no bus / write failure.  ``name`` overrides the file name — pass a
    distinct one when several processes share a stream dir and each
    wants its own snapshot, since
    the default is last-writer-wins."""
    bus = _current()
    if bus is None:
        return None
    return _write_snapshot_locked(bus, name)


def selftest() -> dict:
    """Plumbing check: a throwaway bus in a temp dir, one emit,
    one metric, parse the line back.  Never touches the process bus."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="dragg_tel_") as d:
        bus = _Bus(d)
        try:
            bus.emit("telemetry.selftest", {"ok": True})
            with bus.lock:
                bus.hists.setdefault("probe.elapsed_s", _Hist()).observe(0.0)
            with open(bus.path) as f:
                rec = json.loads(f.read().strip().splitlines()[-1])
            ok = rec["event"] == "telemetry.selftest" and rec["seq"] == 1
            return {"ok": ok, "events": len(registry.EVENTS),
                    "metrics": len(registry.METRICS)}
        finally:
            bus.close()
