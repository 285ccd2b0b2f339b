"""Scenario-pack loader: TOML packs expand into home mixes and event lists
(counterpart of ``dragg_tpu/scenarios/packs.py``).

A pack (``data/packs/<name>.toml``) declares a home-type mix and a
community event schedule; the ``[scenarios]`` config table names one
(``scenarios.pack``) and/or carries inline ``[[scenarios.events]]``
entries.  :func:`apply_scenarios` is the one entry point that rewrites a
config from its pack (mix fractions → per-type ``community.homes_*``
counts; the pack's events appended to ``scenarios.events``), so home
synthesis and the engine see the same expansion.
"""

from __future__ import annotations

import copy
import os
import tomllib

from dragg_tpu_torch.scenarios.timeline import EVENT_KINDS, ScenarioError

# [mix] keys a pack may set, and the community count key each expands to.
MIX_KEYS = {
    "pv_only": "homes_pv",
    "battery_only": "homes_battery",
    "pv_battery": "homes_pv_battery",
    "ev": "homes_ev",
    "heat_pump": "homes_heat_pump",
}
_EXPANDED_FLAG = "_pack_expanded"


def packs_dir(data_dir: str | None = None) -> str | None:
    """Directory pack names resolve under: ``<data_dir>/packs`` when a data
    dir is configured, else the repo's bundled ``data/packs``."""
    if data_dir:
        return os.path.join(data_dir, "packs")
    from dragg_tpu_torch.data import bundled_data_dir

    bundled = bundled_data_dir()
    return os.path.join(bundled, "packs") if bundled else None


def pack_path(name: str, data_dir: str | None = None) -> str:
    """Resolve a pack name to a file path: a literal ``.toml`` path wins,
    else ``<packs_dir>/<name>.toml``."""
    if name.endswith(".toml") and os.path.isfile(name):
        return name
    base = packs_dir(data_dir)
    candidate = os.path.join(base, f"{name}.toml") if base else None
    if candidate and os.path.isfile(candidate):
        return candidate
    raise ScenarioError(
        f"scenario pack {name!r} not found (looked for {candidate!r}; "
        f"packs live under data/packs/ — docs/scenarios.md)")


def load_pack(path: str) -> dict:
    """Load and schema-check one pack file."""
    with open(path, "rb") as f:
        pack = tomllib.load(f)
    mix = pack.get("mix", {})
    unknown = set(mix) - set(MIX_KEYS)
    if unknown:
        raise ScenarioError(
            f"pack {path}: unknown [mix] home types {sorted(unknown)} "
            f"(known: {sorted(MIX_KEYS)})")
    total = 0.0
    for t, frac in mix.items():
        if not 0.0 <= float(frac) <= 1.0:
            raise ScenarioError(
                f"pack {path}: mix.{t} must be a fraction in [0, 1], "
                f"got {frac}")
        total += float(frac)
    if total > 1.0 + 1e-9:
        raise ScenarioError(
            f"pack {path}: mix fractions sum to {total:.3f} > 1")
    for ev in pack.get("events", []):
        if ev.get("kind") not in EVENT_KINDS:
            raise ScenarioError(
                f"pack {path}: event kind {ev.get('kind')!r} not in "
                f"{EVENT_KINDS}")
    return pack


def apply_scenarios(config: dict, data_dir: str | None = None) -> dict:
    """Expand ``[scenarios]`` into the config: the named pack's ``[mix]``
    fractions become per-type ``community.homes_*`` counts (of
    ``total_number_homes``, per community like every other count) and its
    events are appended to the inline ones.  Returns a new config; a
    second application is a no-op, and a config with no pack and no
    events comes back unchanged."""
    scn = config.get("scenarios", {}) or {}
    if not scn or scn.get(_EXPANDED_FLAG):
        return config
    name = scn.get("pack", "")
    events = list(scn.get("events", []) or [])
    if not name and not events:
        return config
    cfg = copy.deepcopy(config)
    if name:
        pack = load_pack(pack_path(name, data_dir))
        n = int(cfg["community"]["total_number_homes"])
        mix = pack.get("mix", {})
        for t, count_key in MIX_KEYS.items():
            if t in mix:
                cfg["community"][count_key] = int(float(mix[t]) * n)
        total = sum(int(cfg["community"].get(k, 0))
                    for k in MIX_KEYS.values())
        if total > n:
            raise ScenarioError(
                f"pack {name!r}: expanded mix counts ({total}) exceed "
                f"total_number_homes ({n})")
        events += list(pack.get("events", []))
    cfg.setdefault("scenarios", {})
    cfg["scenarios"]["events"] = events
    cfg["scenarios"][_EXPANDED_FLAG] = True
    return cfg
