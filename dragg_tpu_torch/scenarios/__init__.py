"""Scenario packs and community event timelines (counterpart of
``dragg_tpu/scenarios``): pack files expand into home mixes and event
lists (``packs.py``), and the events compile into dense per-community
series the engine gathers a window of every step (``timeline.py``).  The
ev and heat_pump home types themselves live where home types live
(``homes.HOME_TYPES``, ``ops/qp.TYPE_SPECS``)."""

from dragg_tpu_torch.scenarios.packs import (  # noqa: F401 — re-exported API
    MIX_KEYS,
    apply_scenarios,
    load_pack,
    pack_path,
    packs_dir,
)
from dragg_tpu_torch.scenarios.timeline import (  # noqa: F401 — re-exported API
    EVENT_KINDS,
    EventTimeline,
    ScenarioError,
    build_timeline,
    describe_timeline,
    empty_timeline,
    timeline_digest,
    timeline_for,
)
