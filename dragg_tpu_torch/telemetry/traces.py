"""Trace assembler — causal trees + critical-path attribution from a
run's merged event streams (a copy of ``dragg_tpu/telemetry/traces.py``,
so a run of this package can be read without the JAX package).

A *span* is declared implicitly: any event record carrying a ``span``
field extends that span's node; the first ``parent`` seen for a span id
fixes its tree edge.  The assembler reads the FULL main stream plus
every ``shard<k>`` sub-stream (not the bounded tails the dashboard
uses), applies the wire clock-skew correction (``trace.skew`` records),
groups spans by ``trace`` id, and reports:

* per-trace causal trees (roots = spans with no parent, orphans =
  spans whose parent id never appears — a complete trace has >= 1 root
  and ZERO orphans, the acceptance invariant);
* critical-path attribution — seconds bucketed into queue / compile /
  device / collect / wire / merge / other from the duration fields the
  instrumented layers already emit;
* an ASCII timeline (one bar per span, indented by tree depth).

Everything here is stdlib-only.
"""

from __future__ import annotations

import json
import os

from dragg_tpu_torch.telemetry import bus

# Duration fields -> attribution bucket.  Each entry names (event,
# field) pairs whose values are seconds spent in that phase; the
# emitting layers are cited so the mapping stays auditable.
ATTRIBUTION = {
    # oldest request's wait inside the coalescing window (serve daemon)
    "queue": (("serve.assign", "window_wait_s"),),
    # staged-compile stage seconds (telemetry/compile_obs)
    "compile": (("compile.stage", "s"),),
    # device wall seconds per engine chunk (aggregator / shard worker)
    "device": (("chunk.done", "device_s"),),
    # host collect seconds per chunk (span event over engine.collect_s)
    "collect": (("span:engine.collect_s", "s"),),
    # wire client push wall seconds, retries included (shard/transport)
    "wire": (("wire.push", "s"),),
    # coordinator merge seconds per shard chunk (shard/coordinator)
    "merge": (("shard.chunk", "s"),),
}


def read_records(run_dir: str) -> list[dict]:
    """Every parseable record of a run's streams (main + shard
    sub-streams), each labelled ``_stream``, ordered by the same
    skew-corrected ``(t, pid, seq)`` key as
    :func:`telemetry.tail_events_dir` — but over the FULL files."""
    events_path = os.path.join(run_dir, bus.EVENTS_FILE)
    labelled: list[dict] = []
    for path in bus.stream_paths(events_path):
        label = os.path.basename(os.path.dirname(path))
        if path == events_path:
            label = "main"
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                lines = f.read().splitlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn mid-write tail
            if isinstance(rec, dict):
                labelled.append({**rec, "_stream": label})
    offsets = bus.skew_offsets(labelled)
    labelled.sort(key=lambda r: (
        r.get("t", 0.0) + offsets.get((r["_stream"], r.get("pid")), 0.0),
        r.get("pid") or 0, r.get("seq", 0)))
    return labelled


def _event_key(rec: dict) -> str:
    """The ATTRIBUTION lookup key: span events are keyed by the metric
    they observed (``span:<name>``), everything else by event name."""
    if rec.get("event") == "span":
        return f"span:{rec.get('name')}"
    return str(rec.get("event"))


def _bucket_seconds(rec: dict) -> tuple[str, float] | None:
    key = _event_key(rec)
    for bucket, pairs in ATTRIBUTION.items():
        for ev, field in pairs:
            if key == ev and rec.get(field) is not None:
                try:
                    return bucket, float(rec[field])
                except (TypeError, ValueError):
                    return None
    return None


def assemble(records: list[dict]) -> dict:
    """Causal trees from labelled records.  Returns::

        {"traces": {trace_id: {"spans": {span_id: node},
                               "roots": [span_id...],
                               "orphans": [span_id...]}},
         "untraced": <records with no trace field>}

    where each node is ``{"span", "parent", "t0", "t1", "events":
    [event names], "streams": [...], "first": <first record>,
    "seconds": {bucket: s}}``."""
    traces: dict = {}
    untraced = 0
    for rec in records:
        tid = rec.get("trace")
        if tid is None:
            untraced += 1
            continue
        sid = rec.get("span")
        if sid is None:
            continue
        tr = traces.setdefault(tid, {"spans": {}, "roots": [],
                                     "orphans": []})
        node = tr["spans"].get(sid)
        if node is None:
            node = tr["spans"][sid] = {
                "span": sid, "parent": None, "t0": None, "t1": None,
                "events": [], "streams": [], "first": rec,
                "seconds": {}}
        if node["parent"] is None and rec.get("parent") is not None:
            node["parent"] = rec["parent"]
        t = rec.get("t")
        if t is not None:
            node["t0"] = t if node["t0"] is None else min(node["t0"], t)
            node["t1"] = t if node["t1"] is None else max(node["t1"], t)
        node["events"].append(str(rec.get("event")))
        if rec["_stream"] not in node["streams"]:
            node["streams"].append(rec["_stream"])
        hit = _bucket_seconds(rec)
        if hit is not None:
            b, s = hit
            node["seconds"][b] = node["seconds"].get(b, 0.0) + s
    for tr in traces.values():
        spans = tr["spans"]
        for sid, node in spans.items():
            if node["parent"] is None:
                tr["roots"].append(sid)
            elif node["parent"] not in spans:
                tr["orphans"].append(sid)
    return {"traces": traces, "untraced": untraced}


def _children(tr: dict) -> dict:
    kids: dict = {}
    for sid, node in tr["spans"].items():
        if node["parent"] in tr["spans"]:
            kids.setdefault(node["parent"], []).append(sid)
    for v in kids.values():
        v.sort(key=lambda s: (tr["spans"][s]["t0"] or 0.0, s))
    return kids


def critical_path(tr: dict) -> dict:
    """The root-to-leaf chain with the largest attributed seconds, plus
    the whole trace's per-bucket attribution.  Chains are weighted by
    the sum of their nodes' bucketed seconds (falling back to span wall
    extent for unattributed spans), so the answer names WHERE the time
    went, not just which subtree had the most events."""
    kids = _children(tr)

    def node_w(node: dict) -> float:
        s = sum(node["seconds"].values())
        if s:
            return s
        if node["t0"] is not None and node["t1"] is not None:
            return node["t1"] - node["t0"]
        return 0.0

    best_chain: list[str] = []
    best_w = -1.0

    def walk(sid: str, chain: list[str], w: float) -> None:
        nonlocal best_chain, best_w
        chain = chain + [sid]
        w += node_w(tr["spans"][sid])
        if sid not in kids:
            if w > best_w:
                best_w, best_chain = w, chain
            return
        for kid in kids[sid]:
            walk(kid, chain, w)

    for root in tr["roots"]:
        walk(root, [], 0.0)
    total: dict = {}
    for node in tr["spans"].values():
        for b, s in node["seconds"].items():
            total[b] = total.get(b, 0.0) + s
    path_secs: dict = {}
    for sid in best_chain:
        for b, s in tr["spans"][sid]["seconds"].items():
            path_secs[b] = path_secs.get(b, 0.0) + s
    return {"path": best_chain,
            "path_seconds": {b: round(s, 6) for b, s in path_secs.items()},
            "path_total_s": round(max(best_w, 0.0), 6),
            "trace_seconds": {b: round(s, 6) for b, s in total.items()}}


def render_ascii(tr: dict, width: int = 60) -> str:
    """One bar per span, indented by depth, scaled to the trace extent."""
    spans = tr["spans"]
    if not spans:
        return "(empty trace)"
    t0s = [n["t0"] for n in spans.values() if n["t0"] is not None]
    t1s = [n["t1"] for n in spans.values() if n["t1"] is not None]
    lo, hi = (min(t0s), max(t1s)) if t0s else (0.0, 1.0)
    extent = max(hi - lo, 1e-9)
    kids = _children(tr)
    lines = []

    def bar(node: dict) -> str:
        if node["t0"] is None:
            return " " * width
        a = int((node["t0"] - lo) / extent * (width - 1))
        b = int((node["t1"] - lo) / extent * (width - 1))
        return " " * a + "#" * max(1, b - a + 1) + " " * (width - 1 - b)

    def walk(sid: str, depth: int) -> None:
        node = spans[sid]
        label = f"{'  ' * depth}{sid} [{node['events'][0]}"
        if len(node["events"]) > 1:
            label += f" +{len(node['events']) - 1}"
        label += "]"
        secs = " ".join(f"{b}={s:.3f}s"
                        for b, s in sorted(node["seconds"].items()))
        lines.append(f"{label:<44.44} |{bar(node)}| {secs}")
        for kid in kids.get(sid, []):
            walk(kid, depth + 1)

    for root in sorted(tr["roots"],
                       key=lambda s: (spans[s]["t0"] or 0.0, s)):
        walk(root, 0)
    for orphan in tr["orphans"]:
        node = spans[orphan]
        lines.append(f"ORPHAN {orphan} (parent {node['parent']}) "
                     f"[{node['events'][0]}]")
    return "\n".join(lines)


def trace_report(run_dir: str, records: list[dict] | None = None) -> dict:
    """The JSON artifact: every trace's tree summary, critical path,
    and completeness verdict for one run directory.  Pass ``records``
    (from :func:`read_records`) to avoid a second full-stream read."""
    if records is None:
        records = read_records(run_dir)
    asm = assemble(records)
    out = {"run_dir": run_dir, "records": len(records),
           "untraced_records": asm["untraced"], "traces": {}}
    for tid, tr in asm["traces"].items():
        out["traces"][tid] = {
            "spans": len(tr["spans"]),
            "roots": tr["roots"],
            "orphans": tr["orphans"],
            "complete": bool(tr["roots"]) and not tr["orphans"],
            "critical_path": critical_path(tr),
        }
    out["complete"] = bool(out["traces"]) and all(
        t["complete"] for t in out["traces"].values())
    return out


def completeness_problems(report: dict) -> list[str]:
    """Human-readable reasons a report fails the zero-orphan invariant
    (empty list = complete)."""
    problems = []
    if not report["traces"]:
        problems.append("no traced records found (tracing off?)")
    for tid, tr in report["traces"].items():
        if not tr["roots"]:
            problems.append(f"trace {tid}: no root span")
        if tr["orphans"]:
            problems.append(
                f"trace {tid}: {len(tr['orphans'])} orphan span(s): "
                f"{tr['orphans'][:5]}")
    return problems


def phase_breakdown(records: list[dict], ids) -> dict:
    """Per-request phase decomposition for the serving tools: for each
    request id, seconds spent in queue (accept -> batch dispatch,
    including the coalescing window), solve (dispatch -> terminal
    answer), stream (streamed-connection lifetime), and compile
    (staged-compile stages overlapping the request's solve window —
    spill-lane compiles land here).  Built from the daemon's own
    records, so SLO gating can name the guilty phase server-side."""
    ids = set(ids)
    accept_t: dict = {}
    done: dict = {}        # id -> (t, batch)
    assigns: dict = {}     # batch -> (t, window_wait_s)
    stream_s: dict = {}
    compiles: list = []    # (t, s)
    for rec in records:
        ev = rec.get("event")
        if ev == "serve.request" and rec.get("id") in ids:
            accept_t[rec["id"]] = rec.get("t")
        elif ev == "serve.assign":
            assigns[rec.get("batch")] = (rec.get("t"),
                                         float(rec.get("window_wait_s")
                                               or 0.0))
        elif ev == "serve.done" and rec.get("id") in ids:
            done[rec["id"]] = (rec.get("t"), rec.get("batch"))
        elif ev == "serve.stream" and rec.get("id") in ids:
            stream_s[rec["id"]] = float(rec.get("elapsed_s") or 0.0)
        elif ev == "compile.stage" and rec.get("s") is not None:
            compiles.append((rec.get("t"), float(rec["s"])))
    out = {}
    for rid, (t_done, batch) in done.items():
        t_acc = accept_t.get(rid)
        t_asn, _wait = assigns.get(batch, (None, 0.0))
        phases = {"queue_s": None, "solve_s": None,
                  "stream_s": stream_s.get(rid), "compile_s": 0.0}
        if t_acc is not None and t_asn is not None:
            phases["queue_s"] = max(0.0, t_asn - t_acc)
        if t_asn is not None and t_done is not None:
            phases["solve_s"] = max(0.0, t_done - t_asn)
            phases["compile_s"] = round(sum(
                s for tc, s in compiles
                if tc is not None and t_asn <= tc <= t_done), 6)
        out[rid] = phases
    return out
