"""Unified run telemetry: event bus + metrics registry + span API (the
counterpart of ``dragg_tpu/telemetry``, copied so this package imports
nothing of the JAX package).

A run leaves one correlated record: ``<run_dir>/events.jsonl``
(append-only typed events: ``run.start``, one ``chunk.done`` per chunk,
the observatory's ``solver.convergence`` / ``solver.worst`` /
``solver.diverged``, ``run.end``) plus a final ``metrics.json``
snapshot, every name from the central registry
(:mod:`~dragg_tpu_torch.telemetry.registry`, equal to the JAX package's).
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

The modules here import only the standard library.  ``compile_obs`` (the
JAX package's staged-compile spans) is not copied: only serving and the
doctor use it there.
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
    "observe", "rollup", "run_dir", "selftest", "set_gauge",
    "skew_offsets", "snapshot", "span", "stream_paths", "tail_events",
    "tail_events_dir", "trace", "traces", "write_snapshot",
]
