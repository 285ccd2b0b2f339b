"""Scenario packs and community event timelines (counterpart of
``dragg_tpu/scenarios``): only the identity case is ported — a config
that names no pack and schedules no events runs unchanged."""

from __future__ import annotations


def apply_scenarios(config: dict, data_dir: str | None = None) -> dict:
    """Return ``config`` unchanged when its ``[scenarios]`` table is empty;
    a pack or an event schedule raises NotImplementedError."""
    scn = config.get("scenarios", {}) or {}
    for key in ("pack", "events"):
        if scn.get(key):
            raise NotImplementedError(
                f"scenarios.{key}: scenario packs and events are not ported")
    return config
