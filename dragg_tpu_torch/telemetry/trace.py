"""Causal trace context — run-scoped ``trace_id`` plus per-process
``span_id``/``parent_id`` riding the existing event envelope (a copy of
``dragg_tpu/telemetry/trace.py``).  Stdlib only, and ZERO-COST when
tracing is off:
with no context enabled and ``$DRAGG_TRACE_CTX`` unset, every entry
point is one module-global load, and the bus adds NO fields to emitted
records — off-mode ``events.jsonl`` streams carry the plain envelope.

The context is process-wide (one root span per process, like the bus
itself) and crosses process boundaries three ways, mirroring how the
telemetry dir already travels:

* **env** — a parent exports ``$DRAGG_TRACE_CTX = "<trace>:<span>"``
  (``env_value()``); the child joins LAZILY on its first emit
  (``current()``), minting its own process span with the exported span
  as parent.  The resilience supervisor and the shard/serve slot
  launchers do this export.
* **HTTP** — the serve daemon answers ``X-Dragg-Trace`` /
  ``X-Dragg-Span`` response headers and records a client-supplied
  ``X-Dragg-Parent`` on the request's ``serve.request`` record as
  ``client_parent`` (informational — the in-stream tree stays rooted
  at the daemon even when the client's span never appears in it).
* **wire** — the trace fields ride the DRGW frame's JSON doc body
  (no codec change), so a chunk pushed over TCP carries its span to
  the coordinator's merge.

Emitters open FINER spans explicitly by splatting
``**trace.child_fields()`` into an emit — the bus's envelope injection
uses ``setdefault``, so explicit span/parent fields always win over the
process root context.
"""

from __future__ import annotations

import os
import threading
import uuid

ENV_CTX = "DRAGG_TRACE_CTX"  # "<trace_id>:<parent_span_id>"

_ctx: dict | None = None
_env_checked = False
_lock = threading.Lock()


def _new_id(n: int) -> str:
    return uuid.uuid4().hex[:n]


def new_span() -> str:
    """A fresh span id (callers link it to a parent explicitly)."""
    return _new_id(12)


def enable(trace_id: str | None = None,
           parent: str | None = None) -> dict:
    """Open this process's trace context: adopt (or mint) the run-scoped
    trace id and mint the process root span.  Returns a copy of the
    context ``{"trace", "span", "parent"}``."""
    global _ctx, _env_checked
    with _lock:
        _ctx = {"trace": trace_id or _new_id(16),
                "span": _new_id(12),
                "parent": parent}
        _env_checked = True
        return dict(_ctx)


def disable() -> None:
    """Drop the context and re-arm the ``$DRAGG_TRACE_CTX`` auto-join
    (the :func:`telemetry.close_run` counterpart for tests)."""
    global _ctx, _env_checked
    with _lock:
        _ctx = None
        _env_checked = False


def current() -> dict | None:
    """The active context, joining ``$DRAGG_TRACE_CTX`` lazily on first
    use — how supervised children (which never call :func:`enable`)
    land inside the parent's trace.  None = tracing off."""
    global _ctx, _env_checked
    ctx = _ctx
    if ctx is not None or _env_checked:
        return ctx
    with _lock:
        if _ctx is None and not _env_checked:
            _env_checked = True
            raw = os.environ.get(ENV_CTX) or ""
            if ":" in raw:
                tid, _, parent = raw.partition(":")
                if tid:
                    _ctx = {"trace": tid, "span": _new_id(12),
                            "parent": parent or None}
        return _ctx


def enabled() -> bool:
    return current() is not None


def env_value(span: str | None = None) -> str | None:
    """The ``$DRAGG_TRACE_CTX`` export for a child whose root span
    should parent on ``span`` (default: this process's root span).
    None when tracing is off — callers then export nothing."""
    ctx = current()
    if ctx is None:
        return None
    return f"{ctx['trace']}:{span or ctx['span']}"


def child_fields(parent: str | None = None) -> dict:
    """Fields for an emit that opens a NEW child span: a fresh span id
    parented on ``parent`` (default: this process's root span).  Empty
    when tracing is off, so ``emit(..., **trace.child_fields())`` adds
    no keys to an untraced stream."""
    ctx = current()
    if ctx is None:
        return {}
    return {"span": _new_id(12), "parent": parent or ctx["span"]}


def span_fields(span: str, parent: str | None = None) -> dict:
    """Fields for an emit inside an EXISTING span (e.g. several events
    of one chunk span).  Empty when tracing is off."""
    ctx = current()
    if ctx is None:
        return {}
    out = {"span": span}
    if parent is not None:
        out["parent"] = parent
    return out
