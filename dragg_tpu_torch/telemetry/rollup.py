"""Live fleet metrics rollup (a copy of ``dragg_tpu/telemetry/rollup.py``,
so a run of this package can be read without the JAX package): fold the main
process's and every shard sub-stream's in-progress metrics snapshots
plus stream tails into ONE fleet view, with a per-shard health
scoreboard — served as ``/rollup.json`` and as Prometheus text
exposition at ``/metrics`` by the serve daemon, the shard chunk-ingest
server, and the dashboard.

The feed is the periodic snapshot flush (``telemetry.init_run``'s
``flush_s`` / ``$DRAGG_TELEMETRY_FLUSH_S``, plus the shard worker's
per-chunk flush): each process rewrites its own ``metrics.json``
atomically mid-run, so a kill -9 loses at most one flush interval of
metric deltas and the coordinator's post-mortem still sees the victim's
last interval.  Stdlib only.
"""

from __future__ import annotations

import json
import os
import time

from dragg_tpu_torch.telemetry import bus


def _load_metrics(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def fold_rollup(run_dir: str, now: float | None = None,
                tail_limit: int = 200) -> dict:
    """The fleet rollup for one run directory: per-stream metrics
    snapshots (main + every ``shard<k>``), fleet-summed counters, and
    the per-shard health scoreboard (last-beat age, chunk-frontier lag,
    degradation state, wire retry/dedup counters)."""
    now = time.time() if now is None else now
    events_path = os.path.join(run_dir, bus.EVENTS_FILE)
    streams: dict = {}
    for path in bus.stream_paths(events_path):
        label = os.path.basename(os.path.dirname(path))
        if path == events_path:
            label = "main"
        snap = _load_metrics(os.path.join(os.path.dirname(path),
                                          bus.METRICS_FILE))
        streams[label] = {"metrics": snap, "path": path}
    # One bounded merged tail feeds every stream's liveness fields.
    tail = bus.tail_events_dir(events_path, limit=tail_limit)
    last_t: dict = {}
    frontier: dict = {}
    platform: dict = {}
    wire_counts: dict = {}
    for rec in tail:
        label = rec.get("_stream", "main")
        t = rec.get("t")
        if t is not None:
            last_t[label] = max(last_t.get(label, 0.0), t)
        ev = rec.get("event")
        if ev == "chunk.done" and rec.get("t1") is not None:
            frontier[label] = max(frontier.get(label, 0),
                                  int(rec["t1"]))
        elif ev == "shard.chunk" and rec.get("t1") is not None:
            # The coordinator's merge record names the shard — the
            # frontier survives even when a shard stream is lost.
            lab = f"shard{rec.get('shard')}"
            frontier[lab] = max(frontier.get(lab, 0), int(rec["t1"]))
        elif ev in ("shard.transition", "degrade.transition"):
            lab = (f"shard{rec['shard']}" if rec.get("shard") is not None
                   else label)
            platform[lab] = rec.get("to_platform")
        elif ev == "shard.launch":
            platform.setdefault(f"shard{rec.get('shard')}",
                                rec.get("platform"))
    fleet_counters: dict = {}
    for label, entry in streams.items():
        snap = entry["metrics"]
        counters = (snap or {}).get("counters") or {}
        for name, v in counters.items():
            fleet_counters[name] = fleet_counters.get(name, 0.0) + v
        if label.startswith("shard"):
            wire_counts[label] = {
                "retries": counters.get("wire.retries", 0),
                "dedup": counters.get("wire.dedup", 0)}
        entry["written_at"] = (snap or {}).get("written_at")
        entry.pop("path", None)
    # Server-side dedup lands on the MAIN stream's counters; surface it
    # on the scoreboard too (the client-side view can undercount when a
    # lost ack hid the dup from the worker).
    main_counters = ((streams.get("main") or {}).get("metrics")
                     or {}).get("counters") or {}
    shards = sorted(lab for lab in set(streams) | set(frontier)
                    if lab.startswith("shard"))
    target = max(frontier.values(), default=0)
    scoreboard = []
    for lab in shards:
        beat_t = last_t.get(lab)
        snap = (streams.get(lab) or {}).get("metrics")
        scoreboard.append({
            "shard": lab,
            "last_event_age_s": (round(now - beat_t, 3)
                                 if beat_t else None),
            "frontier_t": frontier.get(lab),
            "frontier_lag": (target - frontier[lab]
                             if lab in frontier else None),
            "platform": platform.get(lab),
            "wire_retries": (wire_counts.get(lab) or {}).get("retries", 0),
            "wire_dedup_client": (wire_counts.get(lab)
                                  or {}).get("dedup", 0),
            "metrics_written_at": (snap or {}).get("written_at"),
        })
    return {
        "schema": 1,
        "run_dir": run_dir,
        "folded_at": round(now, 3),
        "streams": streams,
        "fleet_counters": fleet_counters,
        "wire_dedup_server": main_counters.get("wire.dedup", 0),
        "frontier_t": target or None,
        "shards": scoreboard,
    }


def _prom_name(name: str) -> str:
    return "dragg_" + "".join(c if c.isalnum() else "_" for c in name)


def prometheus_text(rollup: dict) -> str:
    """Prometheus text exposition (version 0.0.4) of a rollup: every
    stream's counters/gauges labelled by stream, histograms as
    ``_count``/``_sum`` pairs, plus the per-shard health scoreboard."""
    lines: list[str] = []
    typed: set = set()

    def sample(name: str, kind: str, labels: dict, value) -> None:
        if value is None:
            return
        pname = _prom_name(name)
        base = pname.removesuffix("_count").removesuffix("_sum")
        if base not in typed and kind in ("counter", "gauge"):
            typed.add(base)
            lines.append(f"# TYPE {base} {kind}")
        lab = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        lines.append(f"{pname}{{{lab}}} {float(value)}")

    for label, entry in sorted((rollup.get("streams") or {}).items()):
        snap = entry.get("metrics") or {}
        for name, v in sorted((snap.get("counters") or {}).items()):
            sample(name, "counter", {"stream": label}, v)
        for name, v in sorted((snap.get("gauges") or {}).items()):
            sample(name, "gauge", {"stream": label}, v)
        for name, h in sorted((snap.get("histograms") or {}).items()):
            sample(f"{name}_count", "histogram", {"stream": label},
                   h.get("count"))
            sample(f"{name}_sum", "histogram", {"stream": label},
                   h.get("sum"))
    for row in rollup.get("shards") or []:
        labels = {"shard": row["shard"]}
        sample("shard.last_event_age_s", "gauge", labels,
               row.get("last_event_age_s"))
        sample("shard.frontier_t", "gauge", labels, row.get("frontier_t"))
        sample("shard.frontier_lag", "gauge", labels,
               row.get("frontier_lag"))
        sample("shard.wire_retries", "gauge", labels,
               row.get("wire_retries"))
        sample("shard.wire_dedup", "gauge", labels,
               row.get("wire_dedup_client"))
    if rollup.get("frontier_t") is not None:
        sample("fleet.frontier_t", "gauge", {"run": "current"},
               rollup["frontier_t"])
    return "\n".join(lines) + "\n"
