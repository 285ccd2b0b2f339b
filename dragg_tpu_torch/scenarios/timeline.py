"""Community event timelines: scenario events compiled into the step as
data (counterpart of ``dragg_tpu/scenarios/timeline.py``).

DR curtailment windows, grid-outage islanding and tariff shocks are data,
not code.  A timeline is four dense per-community series over the whole
environment span (the resolution of OAT/GHI/TOU), keyed per community so
one fleet runs different event schedules under one set of QP patterns;
the engine gathers an (n_homes, H) window of each per step, as it does
the weather windows (``Engine._prepare``).

A timeline without events is ``None`` end to end, so an event-free run
is the same program, bit for bit, as one built with no timeline.
"""

from __future__ import annotations

import warnings
from typing import Any, NamedTuple

import numpy as np

EVENT_KINDS = ("tariff_shock", "dr", "outage")


class ScenarioError(ValueError):
    """Raised for malformed scenario events / pack files."""


class EventTimeline(NamedTuple):
    """Dense per-community event series.  Shapes are (C, T) with C the
    fleet size and T the environment-series length (weather resolution),
    so step-t windows are plain dynamic slices.

    * ``price``  — additive $/kWh tariff shock (0 default);
    * ``cap``    — per-home grid-power upper bound, kW (+inf default;
      DR curtailment tightens it, outage pins it to 0);
    * ``floor``  — per-home grid-power lower bound, kW (−inf default;
      outage islanding pins it to 0: no import AND no export);
    * ``relax``  — indoor comfort-band widening, degC (0 default; DR and
      outage windows grant relief so tightened grid caps trade against
      comfort instead of infeasibility).
    """

    price: np.ndarray   # (C, T) f32
    cap: np.ndarray     # (C, T) f32
    floor: np.ndarray   # (C, T) f32
    relax: np.ndarray   # (C, T) f32

    @property
    def n_communities(self) -> int:
        return int(self.price.shape[0])

    @property
    def has_price(self) -> bool:
        return bool(np.any(self.price != 0.0))

    @property
    def has_grid(self) -> bool:
        return bool(np.any(np.isfinite(self.cap))
                    or np.any(np.isfinite(self.floor)))

    @property
    def has_relax(self) -> bool:
        return bool(np.any(self.relax != 0.0))

    @property
    def inert(self) -> bool:
        """True when the timeline changes nothing — the engine must then
        behave byte-identically to one built with no timeline at all."""
        return not (self.has_price or self.has_grid or self.has_relax)


def empty_timeline(n_communities: int, n_steps: int) -> EventTimeline:
    return EventTimeline(
        price=np.zeros((n_communities, n_steps), np.float32),
        cap=np.full((n_communities, n_steps), np.inf, np.float32),
        floor=np.full((n_communities, n_steps), -np.inf, np.float32),
        relax=np.zeros((n_communities, n_steps), np.float32),
    )


def _event_windows(ev: dict, t_env: int, dt: int, start_index: int):
    """Series index ranges [a, b) covered by one event, clipped to the
    environment span (windows crossing either edge clip, never error —
    the fuzz suite exercises horizon-edge events)."""
    start_h = float(ev.get("start_hour", 0.0))
    dur_h = float(ev.get("duration_hours", 0.0))
    if dur_h <= 0:
        raise ScenarioError(
            f"event {ev.get('kind')!r} needs duration_hours > 0, got {dur_h}")
    rep_h = float(ev.get("repeat_hours", 0.0))
    if rep_h < 0:
        raise ScenarioError(f"repeat_hours must be >= 0, got {rep_h}")
    if 0 < rep_h <= dur_h:
        raise ScenarioError(
            f"repeat_hours ({rep_h}) must exceed duration_hours ({dur_h}) "
            f"— overlapping repeats of one event are a schedule bug")
    a0 = start_index + int(round(start_h * dt))
    width = max(1, int(round(dur_h * dt)))
    stride = int(round(rep_h * dt))
    out = []
    a = a0
    while a < t_env:
        b = min(a + width, t_env)
        if b > max(a, 0):
            out.append((max(a, 0), b))
        if stride <= 0:
            break
        a += stride
    return out


def _event_communities(ev: dict, n_communities: int) -> list[int]:
    comms = ev.get("communities", [])
    if not comms:
        return list(range(n_communities))
    bad = [c for c in comms if not 0 <= int(c) < n_communities]
    if bad:
        raise ScenarioError(
            f"event {ev.get('kind')!r} names communities {bad} but the "
            f"fleet has {n_communities}")
    return [int(c) for c in comms]


def build_timeline(events: list[dict], n_communities: int, t_env: int,
                   dt: int, start_index: int) -> EventTimeline | None:
    """Expand declarative event dicts (docs/scenarios.md schema) into the
    dense :class:`EventTimeline`.  Returns ``None`` for an empty / inert
    schedule so callers keep the no-events fast path.

    ``start_hour`` is SIM-relative (hours from the simulation start, which
    sits at ``start_index`` in the environment series); ``repeat_hours``
    re-applies the window periodically (e.g. 24 = daily DR call)."""
    if not events:
        return None
    tl = empty_timeline(n_communities, t_env)
    for ev in events:
        kind = ev.get("kind")
        if kind not in EVENT_KINDS:
            raise ScenarioError(
                f"unknown event kind {kind!r} (expected one of "
                f"{'|'.join(EVENT_KINDS)})")
        comms = _event_communities(ev, n_communities)
        relax = float(ev.get("comfort_relax_degc", 0.0))
        for a, b in _event_windows(ev, t_env, dt, start_index):
            for c in comms:
                if kind == "tariff_shock":
                    tl.price[c, a:b] += np.float32(ev["price_delta"])
                elif kind == "dr":
                    # Overlapping DR windows compose as the TIGHTEST cap.
                    tl.cap[c, a:b] = np.minimum(
                        tl.cap[c, a:b], np.float32(ev["p_cap_kw"]))
                    tl.relax[c, a:b] = np.maximum(tl.relax[c, a:b], relax)
                else:  # outage: islanded — no import, no export
                    tl.cap[c, a:b] = 0.0
                    tl.floor[c, a:b] = 0.0
                    tl.relax[c, a:b] = np.maximum(tl.relax[c, a:b], relax)
    return None if tl.inert else tl


def timeline_for(config: dict, n_communities: int, t_env: int, dt: int,
                 start_index: int, data_dir: str | None = None
                 ) -> EventTimeline | None:
    """The resolved event timeline of a config's ``[scenarios]`` table —
    the ``events`` list, which after :func:`packs.apply_scenarios` also
    carries the named pack's events.  ``None`` when the config schedules
    nothing.

    A pack that was NEVER expanded is ignored WITH A WARNING rather than
    half-applied: resolving its events here while its ``[mix]`` never
    reached home synthesis would run the pack's schedule against a
    population it did not declare (``apply_scenarios`` is the one
    expansion point — packs.py).

    Tariff shocks compose with the TOU ladder — and were designed against
    the FIXED ladder (``tpu.fix_tou_peak = true``): under the default
    bug-parity ladder the peak price the shock was calibrated against
    never applies (dragg/aggregator.py:214-215 — docs/config.md), so a
    shock schedule running on the bug-parity path warns loudly."""
    from dragg_tpu_torch.scenarios.packs import _EXPANDED_FLAG

    del data_dir  # packs resolve only through apply_scenarios
    scn = config.get("scenarios", {}) or {}
    events = list(scn.get("events", []) or [])
    if scn.get("pack") and not scn.get(_EXPANDED_FLAG):
        warnings.warn(
            f"scenarios.pack = {scn['pack']!r} is set but was never "
            f"expanded — call dragg_tpu_torch.scenarios.apply_scenarios(config) "
            f"BEFORE synthesizing homes / building the engine (the "
            f"Aggregator does).  Ignoring the pack here: applying only its events "
            f"against a population missing its [mix] would run a schedule "
            f"the pack did not declare.",
            stacklevel=2)
    if not events:
        return None
    if any(e.get("kind") == "tariff_shock" for e in events) \
            and not config.get("tpu", {}).get("fix_tou_peak", False):
        warnings.warn(
            "scenario tariff shocks are composing with the BUG-PARITY TOU "
            "ladder (tpu.fix_tou_peak = false): the reference's peak price "
            "is silently overwritten by the shoulder assignment "
            "(dragg/aggregator.py:214-215), so shock deltas stack on a "
            "ladder whose peak tier never applies.  Set "
            "tpu.fix_tou_peak = true for the intended tiering.",
            stacklevel=2)
    return build_timeline(events, n_communities, t_env, dt, start_index)


def timeline_digest(tl: EventTimeline | None) -> str | None:
    """Content hash of the dense timeline series — the checkpoint
    `run_shape` key, so ANY schedule edit (a cap magnitude, a price
    delta, a community retarget) invalidates a resume even when the
    step-count summary is unchanged (the arrays are deterministic
    functions of the config, so the digest is stable across runs)."""
    if tl is None:
        return None
    import hashlib

    h = hashlib.sha256()
    for a in (tl.price, tl.cap, tl.floor, tl.relax):
        h.update(np.ascontiguousarray(a, dtype=np.float32).tobytes())
    return h.hexdigest()[:16]


def describe_timeline(tl: EventTimeline | None) -> dict[str, Any]:
    """Small JSON-able summary for logs / bench artifacts."""
    if tl is None:
        return {"events": False}
    return {
        "events": True,
        "communities": tl.n_communities,
        "shock_steps": int(np.sum(np.any(tl.price != 0, axis=0))),
        "dr_steps": int(np.sum(np.any(
            np.isfinite(tl.cap) & (tl.cap > 0), axis=0))),
        "outage_steps": int(np.sum(np.any(tl.cap == 0, axis=0))),
    }
