"""Unified run telemetry: event bus + metrics registry + span API (the
counterpart of ``dragg_tpu/telemetry``, copied so this package imports
nothing of the JAX package).

A run leaves one correlated record: ``<run_dir>/events.jsonl``
(append-only typed events: ``run.start``, one ``chunk.done`` per chunk,
the observatory's ``solver.convergence`` / ``solver.worst`` /
``solver.diverged``, ``run.end``) plus a final ``metrics.json``
snapshot, every name from the central registry
(:mod:`~dragg_tpu_torch.telemetry.registry`: the JAX package's, and the
port's own spans and counters).
A stream of this package reads as one of the JAX package's: the same
names, fields and envelope.

Usage::

    from dragg_tpu_torch import telemetry

    telemetry.init_run(run_dir)            # or $DRAGG_TELEMETRY_DIR joins lazily
    telemetry.emit("chunk.done", t0=0, t1=24, solve_rate=1.0)
    with telemetry.span("engine.chunk_device_s"):
        ...device work...
    telemetry.write_snapshot()             # <run_dir>/metrics.json
    telemetry.close_run()

The port adds spans and counters of its own inside the engine step and
the interior point (``engine.step_s`` and each bucket's phases,
``ipm.phase1_s`` / ``ipm.tail_s``, ``ipm.host_syncs``), which write no
``span`` event; a profiler recording sees them as ranges, and
:func:`recording` keeps them in memory on the profiler's clock::

    with telemetry.recording() as rec:
        engine.run_chunk(state, t0, rps)
    rec.records   # [{name, start_ns, end_ns, parent, attrs}, ...]
    rec.counters  # {"ipm.host_syncs": ..., ...}

The modules here import only the standard library, but for
``compile_obs`` (the staged warm-up of a serving worker's engine), which
imports torch inside its functions and is not imported here.
"""

from dragg_tpu_torch.telemetry import rollup, trace, traces
from dragg_tpu_torch.telemetry.bus import (
    ENV_DIR,
    ENV_FLUSH,
    EVENTS_FILE,
    METRICS_FILE,
    EventFollower,
    active,
    close_run,
    emit,
    events_path,
    inc,
    init_run,
    observe,
    recording,
    run_dir,
    selftest,
    set_gauge,
    skew_offsets,
    snapshot,
    span,
    stream_paths,
    tail_events,
    tail_events_dir,
    write_snapshot,
)
from dragg_tpu_torch.telemetry.registry import EVENTS, METRICS

__all__ = [
    "ENV_DIR", "ENV_FLUSH", "EVENTS_FILE", "METRICS_FILE", "EVENTS",
    "METRICS", "EventFollower",
    "active", "close_run", "emit", "events_path", "inc", "init_run",
    "observe", "recording", "rollup", "run_dir", "selftest", "set_gauge",
    "skew_offsets", "snapshot", "span", "stream_paths", "tail_events",
    "tail_events_dir", "trace", "traces", "write_snapshot",
]
