"""Seeded home-population synthesis (counterpart of ``dragg_tpu/homes.py``,
with numpy in place of pandas).

Capability parity with the reference's ``create_homes``
(dragg/aggregator.py:273-587): given parameter distributions and per-type
counts, produce the community as (a) a list of JSON-serializable home dicts
with the reference's exact schema (so cached ``all_homes-<N>-config.json``
files interoperate) and (b) a :class:`HomeBatch` struct-of-arrays padded to a
single superset shape so the whole community solves as one batched tensor
program (base homes get zero-width battery/PV blocks; SURVEY.md §7 step 2).

Seeding: the numpy parameter streams are drawn in the reference's exact order
(dragg/aggregator.py:281-359 then the per-type loops :393-578), so home
parameters are reproducible home-by-home for a given seed.  Home *names* use
an embedded name pool instead of the third-party ``names`` package, and the
water-draw profile sampling uses the same global-numpy-RNG calls in a
documented order (pandas' internal ``DataFrame.sample`` RNG consumption is
version-dependent and not reproducible bit-for-bit).
"""

from __future__ import annotations

import random
import string
from typing import Any, NamedTuple

import numpy as np

from dragg_tpu_torch.config import configured_solver
from dragg_tpu_torch.data import WaterdrawProfiles, hourly_sums
from dragg_tpu_torch.names_data import FIRST_NAMES

# Home types.  The first four are the reference's (dragg/aggregator.py
# per-type loops); "ev" and "heat_pump" are scenario types (ROADMAP item 4,
# docs/architecture.md §15 — no reference analog), APPENDED so the legacy
# type codes (and every artifact/checkpoint keyed on them) are unchanged.
# Materialization order in create_homes is pv_battery, pv_only,
# battery_only, ev, heat_pump, base — new-type parameter draws happen
# inside their own loops, so a zero-count config consumes no RNG and
# reproduces the pre-scenario population byte-for-byte.
HOME_TYPES = ("pv_battery", "pv_only", "battery_only", "base", "ev",
              "heat_pump")
TYPE_CODES = {t: i for i, t in enumerate(HOME_TYPES)}

# Scenario-type parameter distributions, used when a config predates the
# [home.ev] / [home.heat_pump] tables (an unmodified reference TOML must
# keep loading — config.REQUIRED_KEYS is NOT extended).
EV_PARAM_DEFAULTS: dict[str, list] = {
    "capacity": [40.0, 80.0],       # kWh usable pack
    "max_rate": [3.3, 9.6],         # kW home charger
    "charge_eff": [0.88, 0.95],
    "target_soc": [0.7, 0.9],       # fraction of capacity due at departure
    "init_soc": [0.3, 0.6],
    "away_start": [7.0, 9.0],       # hour of day the vehicle departs
    "away_duration": [7.0, 10.0],   # hours away (deadline window length)
    "trip_kwh": [6.0, 14.0],        # SOC consumed by the daily trip
}
HP_PARAM_DEFAULTS: dict[str, list] = {
    "cop_base": [2.4, 3.2],         # heating COP at 0 degC OAT
    "cop_slope": [0.04, 0.08],      # COP change per degC (ops/qp.hp_cops)
}


def _uniform(rng_cfg, n):
    return np.random.uniform(rng_cfg[0], rng_cfg[1], n)


def _make_name() -> str:
    first = random.choice(FIRST_NAMES)
    suffix = "".join(random.choices(string.ascii_uppercase + string.digits, k=5))
    return f"{first}-{suffix}"


def _battery_params(cfg: dict) -> dict:
    b = cfg["home"]["battery"]
    return {
        "max_rate": np.random.uniform(b["max_rate"][0], b["max_rate"][1]),
        "capacity": np.random.uniform(b["capacity"][0], b["capacity"][1]),
        "capacity_lower": np.random.uniform(b["lower_bound"][0], b["lower_bound"][1]),
        "capacity_upper": np.random.uniform(b["upper_bound"][0], b["upper_bound"][1]),
        "ch_eff": np.random.uniform(b["charge_eff"][0], b["charge_eff"][1]),
        "disch_eff": np.random.uniform(b["discharge_eff"][0], b["discharge_eff"][1]),
        "e_batt_init": np.random.uniform(b["lower_bound"][1], b["upper_bound"][0]),
    }


def _pv_params(cfg: dict) -> dict:
    p = cfg["home"]["pv"]
    return {
        "area": np.random.uniform(p["area"][0], p["area"][1]),
        "eff": np.random.uniform(p["efficiency"][0], p["efficiency"][1]),
    }


def _scenario_dist(tbl: dict, key: str, defaults: dict) -> float:
    lo, hi = tbl.get(key, defaults[key])
    return float(np.random.uniform(lo, hi))


def _ev_params(cfg: dict) -> dict:
    e = cfg["home"].get("ev", {})
    d = lambda k: _scenario_dist(e, k, EV_PARAM_DEFAULTS)
    cap = d("capacity")
    start = d("away_start")
    return {
        "capacity": cap,
        "max_rate": d("max_rate"),
        "charge_eff": d("charge_eff"),
        "target_soc": d("target_soc"),
        "init_soc": d("init_soc"),
        "away_start": start,
        "away_end": start + d("away_duration"),
        "trip_kwh": d("trip_kwh"),
    }


def _hp_params(cfg: dict) -> dict:
    h = cfg["home"].get("heat_pump", {})
    d = lambda k: _scenario_dist(h, k, HP_PARAM_DEFAULTS)
    return {"cop_base": d("cop_base"), "cop_slope": d("cop_slope")}


def create_homes(
    config: dict,
    num_timesteps: int,
    dt: int,
    waterdraw: WaterdrawProfiles,
) -> list[dict[str, Any]]:
    """Synthesize the home population.  Returns the reference-schema list of
    home dicts (order: pv_battery, pv_only, battery_only, base — parity with
    dragg/aggregator.py:393-578)."""
    seed = int(config["simulation"]["random_seed"])
    np.random.seed(seed)
    random.seed(seed)
    n = int(config["community"]["total_number_homes"])
    hvac = config["home"]["hvac"]
    wh = config["home"]["wh"]

    # HVAC parameter streams (order parity: dragg/aggregator.py:285-322).
    home_r = _uniform(hvac["r_dist"], n)
    home_c = _uniform(hvac["c_dist"], n)
    p_cool = _uniform(hvac["p_cool_dist"], n)
    p_heat = _uniform(hvac["p_heat_dist"], n)
    t_sp = _uniform(hvac["temp_sp_dist"], n)
    t_db = _uniform(hvac["temp_deadband_dist"], n)
    t_init_pos = np.random.uniform(0.25, 0.75, n)
    t_min = t_sp - 0.5 * t_db
    t_max = t_sp + 0.5 * t_db
    t_init = t_min + t_init_pos * t_db

    # Water-heater parameter streams (order parity: dragg/aggregator.py:325-359).
    wh_r = _uniform(wh["r_dist"], n)
    wh_p = _uniform(wh["p_dist"], n)
    wh_sp = _uniform(wh["sp_dist"], n)
    wh_db = _uniform(wh["deadband_dist"], n)
    wh_init_pos = np.random.uniform(0.25, 0.75, n)
    wh_min = wh_sp - 0.5 * wh_db
    wh_max = wh_sp + 0.5 * wh_db
    wh_init = wh_min + wh_init_pos * wh_db
    wh_size = _uniform(wh["size_dist"], n)

    # Water-draw events (dragg/aggregator.py:361-377): per-cell lognormal-ish
    # noise, hourly resample, then per home pick a random profile column and
    # ndays random days, clipped to tank size.
    ndays = num_timesteps // (24 * dt) + 1
    n_min, n_prof = waterdraw.values.shape
    noisy = waterdraw.values * (1 + 0.2 * np.random.randn(n_prof, n_min).T)
    hourly = hourly_sums(noisy, waterdraw.minutes)
    n_hours_data, n_cols = hourly.shape
    n_days_data = n_hours_data // 24
    draw_sizes_all = []
    for j in range(n):
        col = int(np.random.choice(n_cols))
        this_house = hourly[: n_days_data * 24, col].reshape(-1, 24)
        days = np.random.choice(this_house.shape[0], ndays)
        this_house = this_house[days].flatten()
        draw_sizes_all.append(np.clip(this_house, 0, wh_size[j]).tolist())

    hems = {
        "horizon": config["home"]["hems"]["prediction_horizon"],
        "hourly_agg_steps": dt,
        "sub_subhourly_steps": config["home"]["hems"]["sub_subhourly_steps"],
        "solver": configured_solver(config),
        "discount_factor": config["home"]["hems"]["discount_factor"],
    }

    def _common(i):
        return {
            "hvac": {
                "r": home_r[i], "c": home_c[i], "p_c": p_cool[i], "p_h": p_heat[i],
                "temp_in_min": t_min[i], "temp_in_max": t_max[i],
                "temp_in_sp": t_sp[i], "temp_in_init": t_init[i],
            },
            "wh": {
                "r": wh_r[i], "p": wh_p[i],
                "temp_wh_min": wh_min[i], "temp_wh_max": wh_max[i],
                "temp_wh_sp": wh_sp[i], "temp_wh_init": wh_init[i],
                "tank_size": wh_size[i], "draw_sizes": draw_sizes_all[i],
            },
            "hems": hems,
        }

    comm = config["community"]
    n_pvb = int(comm.get("homes_pv_battery", 0))
    n_pv = int(comm.get("homes_pv", 0))
    n_b = int(comm.get("homes_battery", 0))
    n_ev = int(comm.get("homes_ev", 0))
    n_hp = int(comm.get("homes_heat_pump", 0))
    n_base = n - n_pvb - n_pv - n_b - n_ev - n_hp
    if n_base < 0:
        raise ValueError("Per-type home counts exceed total_number_homes")

    all_homes: list[dict[str, Any]] = []
    i = 0
    for _ in range(n_pvb):
        name = _make_name()
        battery = _battery_params(config)
        pv = _pv_params(config)
        all_homes.append({"name": name, "type": "pv_battery", **_common(i), "battery": battery, "pv": pv})
        i += 1
    for _ in range(n_pv):
        name = _make_name()
        pv = _pv_params(config)
        all_homes.append({"name": name, "type": "pv_only", **_common(i), "pv": pv})
        i += 1
    for _ in range(n_b):
        name = _make_name()
        battery = _battery_params(config)
        all_homes.append({"name": name, "type": "battery_only", **_common(i), "battery": battery})
        i += 1
    # Scenario types (ROADMAP item 4) draw their parameters inside their
    # own loops — zero counts consume no RNG, keeping legacy populations
    # byte-identical — and sit BEFORE base so the list stays grouped by
    # type (the bucketed engine's slicing invariant).
    for _ in range(n_ev):
        name = _make_name()
        ev = _ev_params(config)
        all_homes.append({"name": name, "type": "ev", **_common(i), "ev": ev})
        i += 1
    for _ in range(n_hp):
        name = _make_name()
        hp = _hp_params(config)
        all_homes.append({"name": name, "type": "heat_pump", **_common(i), "heat_pump": hp})
        i += 1
    for _ in range(n_base):
        name = _make_name()
        all_homes.append({"name": name, "type": "base", **_common(i)})
        i += 1
    return all_homes


def check_home_configs(all_homes: list[dict], config: dict) -> None:
    """Population check — counts of each home type must match config
    (parity with dragg/aggregator.py:232-253)."""
    counts = {t: sum(1 for h in all_homes if h["type"] == t) for t in HOME_TYPES}
    comm = config["community"]
    expect = {
        "pv_battery": int(comm.get("homes_pv_battery", 0)),
        "pv_only": int(comm.get("homes_pv", 0)),
        "battery_only": int(comm.get("homes_battery", 0)),
        "ev": int(comm.get("homes_ev", 0)),
        "heat_pump": int(comm.get("homes_heat_pump", 0)),
    }
    expect["base"] = int(comm["total_number_homes"]) - sum(expect.values())
    for t, c in expect.items():
        if counts[t] != c:
            raise ValueError(f"Incorrect number of {t} homes: {counts[t]} != {c}")


class FleetSpec(NamedTuple):
    """Static description of a multi-community fleet folded into one home
    batch (ROADMAP item 3 / architecture.md §14).

    The fleet batch is TYPE-MAJOR: all communities' homes of one type are
    contiguous, so the type-bucketed engine solves ``C·B_type`` homes per
    bucket under the SAME compiled pattern set as a single community
    (compile cost flat in C by construction).  The arrays below are per
    fleet-batch row (type-major order) and map each row back to its
    community identity:

    * ``community[i]``  — which community row ``i`` belongs to;
    * ``global_idx[i]`` — the row's COMMUNITY-MAJOR fleet index
      (``c * B + local``) — the index into the aggregator's flat
      ``all_homes`` list, and the order ``Engine.real_home_cols`` maps
      merged outputs back to;
    * ``local_idx[i]``  — the row's index within its own community's
      standalone batch.  The forecast-noise stream is keyed on
      ``(community seed, local_idx)`` so every home draws EXACTLY the
      noise it would draw in a standalone run of its community — fleet
      batching must not perturb per-community trajectories (parity:
      tests/test_fleet.py);
    * ``env_offset[i]`` — per-home offset (in sim steps) into the
      environment series, so communities can see time-shifted weather
      (``fleet.weather_offset_hours``); all-zero keeps the engine on the
      scalar shared-window path.
    """

    n_communities: int
    homes_per_community: int
    seeds: tuple               # per-community population seed
    community: np.ndarray      # (N,) int32
    global_idx: np.ndarray     # (N,) int32 community-major fleet index
    local_idx: np.ndarray      # (N,) int32 within-community index
    env_offset: np.ndarray     # (N,) int32 env-series offset (sim steps)


def fleet_config(config: dict) -> tuple[int, int, int]:
    """The resolved ``[fleet]`` knobs: (communities, seed_stride,
    weather_offset_hours).  ``communities = 1`` (the default) is the
    single-community engine unchanged."""
    f = config.get("fleet", {})
    c = int(f.get("communities", 1))
    if c < 1:
        raise ValueError(f"fleet.communities must be >= 1, got {c}")
    off = int(f.get("weather_offset_hours", 0))
    if off < 0:
        # A negative offset would UNDERSHOOT the startup coverage check
        # (horizon + (C-1)*off shrinks) while the traced gather clamps
        # its negative indices to 0 — silently wrong weather instead of
        # a loud error.
        raise ValueError(
            f"fleet.weather_offset_hours must be >= 0, got {off}")
    return (c, int(f.get("seed_stride", 1)), off)


def fleet_community_base(config: dict) -> int:
    """``fleet.community_base`` — the GLOBAL index of this engine's first
    community (cross-process sharding, architecture.md §19): a shard
    worker running communities ``[base, base + C)`` of a larger fleet
    sets it so every community keeps its global identity — population
    seed ``random_seed + (base + c) * seed_stride``, name prefix
    ``c<base+c>-``, weather offset ``(base + c) * weather_offset_hours``
    — and the shard's per-community outputs are bit-identical to the
    same communities inside the in-process fleet.  Default 0 (the whole
    fleet in one engine; every legacy path unchanged)."""
    base = int(config.get("fleet", {}).get("community_base", 0))
    if base < 0:
        raise ValueError(f"fleet.community_base must be >= 0, got {base}")
    return base


def create_fleet_homes(config: dict, num_timesteps: int, dt: int,
                       waterdraw: WaterdrawProfiles) -> list[dict[str, Any]]:
    """Synthesize C independent communities (``fleet.communities``), each
    drawn with its OWN seed (``random_seed + c * seed_stride``) so the
    fleet is C distinct populations, not C copies.  Returns the flat
    COMMUNITY-MAJOR list (community 0's homes, then community 1's, …);
    names are prefixed ``c<k>-`` so a 100k-home fleet cannot collide in
    the results.json / home_logs namespaces."""
    n_comm, stride, _off = fleet_config(config)
    base = fleet_community_base(config)
    if n_comm == 1 and base == 0:
        return create_homes(config, num_timesteps, dt, waterdraw)
    import copy as _copy

    base_seed = int(config["simulation"]["random_seed"])
    all_homes: list[dict[str, Any]] = []
    for c in range(n_comm):
        cfg_c = _copy.deepcopy(config)
        cfg_c["simulation"]["random_seed"] = base_seed + (base + c) * stride
        homes_c = create_homes(cfg_c, num_timesteps, dt, waterdraw)
        for h in homes_c:
            h["name"] = f"c{base + c}-{h['name']}"
        all_homes.extend(homes_c)
    return all_homes


def fleet_spec_for(all_homes: list[dict], config: dict) -> FleetSpec | None:
    """Derive the :class:`FleetSpec` from a community-major ``all_homes``
    list + config (``None`` when ``fleet.communities == 1``).  Works on
    freshly synthesized AND cache-reloaded home lists — everything is
    recomputed from the list structure, so a reloaded
    ``all_homes-<N>-config.json`` reconstructs the identical fleet.

    Raises when the list is not C equal blocks each grouped by type —
    the slicing the type-bucketed fleet engine depends on."""
    n_comm, stride, off_hours = fleet_config(config)
    base = fleet_community_base(config)
    if n_comm == 1 and base == 0:
        return None
    n_total = len(all_homes)
    if n_total % n_comm:
        raise ValueError(
            f"fleet of {n_comm} communities needs len(all_homes) divisible "
            f"by it, got {n_total}")
    B = n_total // n_comm
    dt = int(config["agg"]["subhourly_steps"])
    base_seed = int(config["simulation"]["random_seed"])
    codes = np.asarray([TYPE_CODES[h["type"]] for h in all_homes])
    # Per-community type runs must be identical across blocks (same config
    # synthesizes the same counts) and grouped (create_homes order).
    ranges0 = type_bucket_ranges(codes[:B])
    if ranges0 is None:
        raise ValueError("fleet communities must be grouped by home type "
                         "(the create_homes materialization order)")
    for c in range(1, n_comm):
        if type_bucket_ranges(codes[c * B:(c + 1) * B]) != ranges0:
            raise ValueError(
                f"fleet community {c} has a different type partition than "
                f"community 0 — all communities must share one config")
    # Type-major fleet order: for each type run, every community's slice.
    order = np.concatenate([
        np.arange(c * B + a, c * B + b)
        for (_t, a, b) in ranges0 for c in range(n_comm)])
    community = order // B
    local_idx = order % B
    # ``community`` stays SHARD-LOCAL (0-based — the index the engine's
    # fold/segment arrays use); the global identity rides the seeds, the
    # env offsets, and the c<global>- name prefixes.
    return FleetSpec(
        n_communities=n_comm,
        homes_per_community=B,
        seeds=tuple(base_seed + (base + c) * stride for c in range(n_comm)),
        community=community.astype(np.int32),
        global_idx=order.astype(np.int32),
        local_idx=local_idx.astype(np.int32),
        env_offset=((base + community) * off_hours * dt).astype(np.int32),
    )


def build_fleet_batch(all_homes: list[dict], config: dict, horizon: int,
                      dt: int, sub_steps: int):
    """(HomeBatch, FleetSpec | None) for a community-major ``all_homes``
    list: the batch rows are the TYPE-MAJOR fleet order (``spec.global_idx``
    maps them back), so ``type_bucket_ranges`` sees C·B_type contiguous
    homes per type and the bucketed engine compiles ONE pattern per type
    regardless of C.  With ``fleet.communities == 1`` this is exactly
    :func:`build_home_batch`."""
    spec = fleet_spec_for(all_homes, config)
    if spec is None:
        return build_home_batch(all_homes, horizon, dt, sub_steps), None
    ordered = [all_homes[i] for i in spec.global_idx]
    return build_home_batch(ordered, horizon, dt, sub_steps), spec


class HomeBatch(NamedTuple):
    """Struct-of-arrays community, padded to the superset (pv_battery) shape.

    All arrays have leading dim n_homes.  Physical parameters keep the
    reference's units and meanings (dragg/mpc_calc.py:157-191,233-262):
    ``hvac_c`` already includes the ×1000 scale, ``hvac_p_c``/``p_h``/``wh_p``
    are per-sub-subhourly-step powers (total / s), ``wh_r`` includes ×1000,
    ``wh_c = tank_size * 4.2`` kJ/degC.
    """

    type_code: np.ndarray      # int, index into HOME_TYPES
    has_pv: np.ndarray         # float 0/1
    has_batt: np.ndarray       # float 0/1
    hvac_r: np.ndarray
    hvac_c: np.ndarray         # c * 1000
    hvac_p_c: np.ndarray       # p_c / s
    hvac_p_h: np.ndarray       # p_h / s
    temp_in_min: np.ndarray
    temp_in_max: np.ndarray
    temp_in_init: np.ndarray
    wh_r: np.ndarray           # r * 1000
    wh_c: np.ndarray           # tank_size * 4.2
    wh_p: np.ndarray           # p / s
    temp_wh_min: np.ndarray
    temp_wh_max: np.ndarray
    temp_wh_init: np.ndarray
    tank_size: np.ndarray
    draws_hourly: np.ndarray   # (n_homes, pad + n_hours) with (H//dt + 1) leading zeros
    batt_max_rate: np.ndarray
    batt_cap_min: np.ndarray   # capacity_lower * capacity
    batt_cap_max: np.ndarray   # capacity_upper * capacity
    batt_ch_eff: np.ndarray
    batt_disch_eff: np.ndarray
    e_batt_init_frac: np.ndarray  # fraction of capacity (t=0 init; dragg/mpc_calc.py:274)
    batt_capacity: np.ndarray
    pv_area: np.ndarray
    pv_eff: np.ndarray
    # Scenario types (ROADMAP item 4; zeros / identities for absent types
    # so the legacy batch math is untouched).
    is_ev: np.ndarray          # float 0/1
    ev_cap: np.ndarray         # kWh
    ev_rate: np.ndarray        # kW charger rate
    ev_ch_eff: np.ndarray      # charge efficiency (1.0 default)
    ev_init_frac: np.ndarray   # t=0 SOC fraction of ev_cap
    ev_target_kwh: np.ndarray  # departure-deadline energy, kWh
    ev_away_start: np.ndarray  # hour of day [0, 24)
    ev_away_end: np.ndarray    # hour of day (may exceed 24 → clipped window)
    ev_trip_kwh: np.ndarray    # SOC drained when the vehicle returns
    is_hp: np.ndarray          # float 0/1
    hp_cop_base: np.ndarray    # heating COP at 0 degC (1.0 default = resistive)
    hp_cop_slope: np.ndarray   # COP per degC (0.0 default)

    @property
    def n_homes(self) -> int:
        return int(self.type_code.shape[0])


def type_bucket_ranges(type_code) -> list[tuple[str, int, int]] | None:
    """Contiguous per-type runs of the batch, in community order:
    ``[(type_name, start, stop), ...]``.

    The population is materialized in type order (``create_homes``:
    pv_battery, pv_only, battery_only, base), so each home type occupies
    one contiguous slice and the type-bucketed engine can treat buckets
    as slices plus a static column map — no scatter.  Returns ``None``
    when some type appears in more than one run (a hand-built,
    interleaved batch): such a community is not bucketable by slicing.
    Empty types simply produce no range (never a zero-width bucket).
    """
    codes = np.asarray(type_code)
    if codes.size == 0:
        return None
    ranges: list[tuple[str, int, int]] = []
    seen: set[int] = set()
    start = 0
    for i in range(1, codes.size + 1):
        if i == codes.size or codes[i] != codes[start]:
            code = int(codes[start])
            if code in seen:
                return None  # type split across non-adjacent runs
            seen.add(code)
            ranges.append((HOME_TYPES[code], start, i))
            start = i
    return ranges


def slice_batch(batch: "HomeBatch", start: int, stop: int) -> "HomeBatch":
    """A HomeBatch view of homes ``[start:stop)`` (every per-home array
    sliced along the leading axis)."""
    return type(batch)(*[np.asarray(f)[start:stop] for f in batch])


def pad_batch(batch: "HomeBatch", multiple: int):
    """Pad every per-home array to a multiple of the shard count.

    Padding replicates the last home (edge padding) so the dummy problems
    remain well-posed (no zero tank sizes / RC constants); the returned
    mask is 0 for padded homes so aggregate reductions are unchanged.
    (Shared by the sharded engine's whole-batch padding and the
    type-bucketed engine's per-bucket padding.)
    """
    n = batch.n_homes
    n_pad = (-n) % multiple
    if n_pad == 0:
        return batch, np.ones(n)
    padded = type(batch)(*[
        np.pad(np.asarray(f), [(0, n_pad)] + [(0, 0)] * (np.asarray(f).ndim - 1),
               mode="edge")
        for f in batch
    ])
    mask = np.concatenate([np.ones(n), np.zeros(n_pad)])
    return padded, mask


def build_home_batch(all_homes: list[dict], horizon: int, dt: int, sub_steps: int) -> HomeBatch:
    """Pack home dicts into the padded superset batch.

    ``draws_hourly`` is prepended with ``horizon//dt + 1`` zero hours exactly
    as the reference's ``water_draws`` does (dragg/mpc_calc.py:194), so a
    window slice at hour ``t//dt`` of length ``horizon//dt + 1`` reproduces
    the reference draw schedule.
    """
    n = len(all_homes)
    s = float(max(1, sub_steps))
    pad = horizon // dt + 1

    def g(fn):
        return np.array([fn(h) for h in all_homes], dtype=np.float64)

    type_code = np.array([TYPE_CODES[h["type"]] for h in all_homes], dtype=np.int32)
    has_pv = np.array(["pv" in h["type"] for h in all_homes], dtype=np.float64)
    has_batt = np.array(["battery" in h["type"] for h in all_homes], dtype=np.float64)

    draw_len = max(len(h["wh"]["draw_sizes"]) for h in all_homes)
    draws = np.zeros((n, pad + draw_len), dtype=np.float64)
    for i, h in enumerate(all_homes):
        d = np.asarray(h["wh"]["draw_sizes"], dtype=np.float64)
        draws[i, pad : pad + len(d)] = d

    def batt(key, default=0.0):
        return np.array(
            [float(h["battery"][key]) if "battery" in h else default for h in all_homes],
            dtype=np.float64,
        )

    def ev(key, default=0.0):
        return np.array(
            [float(h["ev"][key]) if "ev" in h else default for h in all_homes],
            dtype=np.float64,
        )

    def hp(key, default=0.0):
        return np.array(
            [float(h["heat_pump"][key]) if "heat_pump" in h else default
             for h in all_homes],
            dtype=np.float64,
        )

    capacity = batt("capacity")
    return HomeBatch(
        type_code=type_code,
        has_pv=has_pv,
        has_batt=has_batt,
        hvac_r=g(lambda h: float(h["hvac"]["r"])),
        hvac_c=g(lambda h: float(h["hvac"]["c"]) * 1000.0),
        hvac_p_c=g(lambda h: float(h["hvac"]["p_c"]) / s),
        hvac_p_h=g(lambda h: float(h["hvac"]["p_h"]) / s),
        temp_in_min=g(lambda h: float(h["hvac"]["temp_in_min"])),
        temp_in_max=g(lambda h: float(h["hvac"]["temp_in_max"])),
        temp_in_init=g(lambda h: float(h["hvac"]["temp_in_init"])),
        wh_r=g(lambda h: float(h["wh"]["r"]) * 1000.0),
        wh_c=g(lambda h: float(h["wh"]["tank_size"]) * 4.2),
        wh_p=g(lambda h: float(h["wh"]["p"]) / s),
        temp_wh_min=g(lambda h: float(h["wh"]["temp_wh_min"])),
        temp_wh_max=g(lambda h: float(h["wh"]["temp_wh_max"])),
        temp_wh_init=g(lambda h: float(h["wh"]["temp_wh_init"])),
        tank_size=g(lambda h: float(h["wh"]["tank_size"])),
        draws_hourly=draws,
        batt_max_rate=batt("max_rate"),
        batt_cap_min=batt("capacity_lower") * capacity,
        batt_cap_max=batt("capacity_upper") * capacity,
        batt_ch_eff=batt("ch_eff", 1.0),
        batt_disch_eff=batt("disch_eff", 1.0),
        e_batt_init_frac=batt("e_batt_init"),
        batt_capacity=capacity,
        pv_area=np.array([float(h["pv"]["area"]) if "pv" in h else 0.0 for h in all_homes]),
        pv_eff=np.array([float(h["pv"]["eff"]) if "pv" in h else 0.0 for h in all_homes]),
        is_ev=np.array([1.0 if "ev" in h else 0.0 for h in all_homes]),
        ev_cap=ev("capacity"),
        ev_rate=ev("max_rate"),
        ev_ch_eff=ev("charge_eff", 1.0),
        ev_init_frac=ev("init_soc"),
        ev_target_kwh=ev("target_soc") * ev("capacity"),
        ev_away_start=ev("away_start"),
        ev_away_end=ev("away_end"),
        ev_trip_kwh=ev("trip_kwh"),
        is_hp=np.array([1.0 if "heat_pump" in h else 0.0 for h in all_homes]),
        hp_cop_base=hp("cop_base", 1.0),
        hp_cop_slope=hp("cop_slope", 0.0),
    )
