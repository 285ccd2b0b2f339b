"""The benchmark's inputs, made from ``--seed``: each home's parameters and
initial state, its hourly water draws, and the weather and price series.

Both sides get these arrays: the program as its home batch (see
``system.py``) and the plain reference as they are.  Nothing here imports
the program.  The homes follow the configuration's parameter ranges
(upstream dragg ``config.toml``: ``[home.hvac]``, ``[home.wh]``,
``[home.battery]``, ``[home.pv]``), drawn in bulk with numpy; each
community of a fleet is drawn from its own stream.
"""

from __future__ import annotations

import csv
from datetime import datetime

import numpy as np

# Home types in the order the program groups them (its type buckets run
# over contiguous rows of one type).
TYPE_ORDER = ("pv_battery", "pv_only", "battery_only", "base")
TAP_TEMP = 15.0  # degC, cold tap water (dragg/mpc_calc.py)
PROGRAM_SEED_MOD = 2**31 - 64  # the program takes non-negative int32 seeds


def type_counts(n: int, mix: dict) -> dict:
    """Homes of each type in one community: ``int(fraction · n)`` each,
    base takes the rest."""
    counts = {t: int(mix.get(t, 0.0) * n) for t in TYPE_ORDER if t != "base"}
    counts["base"] = n - sum(counts.values())
    return counts


def program_seed(seed: int) -> int:
    """The seed the program's own streams start from (its forecast noise),
    a non-negative int32 with room for one offset per community."""
    return int(seed) % PROGRAM_SEED_MOD


def load_weather(path: str, dt: int):
    """(oat, ghi, data_start) from an NSRDB csv: two rows of site metadata,
    a header, then half-hourly rows.  Each row is held ceil(dt/2) steps if
    its minute is 0, else floor(dt/2); temperature and GHI are truncated to
    whole numbers, as the reference reads them."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r][2:]
    col = {name: i for i, name in enumerate(rows[0])}
    body = np.array([[float(r[col[c]]) for c in
                      ("Year", "Month", "Day", "Hour", "Minute", "Temperature", "GHI")]
                     for r in rows[1:]])
    reps = np.where(body[:, 4] == 0, -(-dt // 2), dt // 2)
    oat = np.repeat(np.trunc(body[:, 5]), reps)
    ghi = np.repeat(np.trunc(body[:, 6]), reps)
    first = body[np.argmax(reps > 0)]
    return oat, ghi, datetime(*(int(v) for v in first[:4]))


def tou_series(n: int, data_start: datetime, dt: int, agg: dict) -> np.ndarray:
    """Time-of-use price a step: the shoulder price inside the shoulder
    hours, else the base price (the reference overwrites its peak tier)."""
    hours = (np.arange(n) // dt + data_start.hour) % 24
    tou = np.full(n, float(agg["base_price"]))
    if agg.get("tou_enabled", False):
        lo, hi = agg["tou"]["shoulder_times"]
        tou[(hours >= lo) & (hours < hi)] = float(agg["tou"]["shoulder_price"])
    return tou


def hourly_draw_profiles(path: str) -> np.ndarray:
    """(hours, profiles) litres drawn an hour, from a csv of minutely flows
    (a timestamp column, then one column per profile), summed by hour."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r][1:]
    hour = np.array([r[0][:13] for r in rows])
    vals = np.array([[float(v) for v in r[1:]] for r in rows])
    starts = np.flatnonzero(np.r_[True, hour[1:] != hour[:-1]])
    return np.add.reduceat(vals, starts, axis=0)


def _u(rng, lohi, n):
    return rng.uniform(float(lohi[0]), float(lohi[1]), n)


def _community(rng, n: int, mix: dict, home: dict, profiles: np.ndarray, n_hours: int) -> dict:
    """One community's homes, type-grouped in :data:`TYPE_ORDER`."""
    counts = type_counts(n, mix)
    code = np.concatenate([np.full(counts[t], i) for i, t in enumerate(TYPE_ORDER)])
    hv, wh, bt, pv = home["hvac"], home["wh"], home["battery"], home["pv"]
    sp, db = _u(rng, hv["temp_sp_dist"], n), _u(rng, hv["temp_deadband_dist"], n)
    wsp, wdb = _u(rng, wh["sp_dist"], n), _u(rng, wh["deadband_dist"], n)
    h = {
        "type_code": code,
        "hvac_r": _u(rng, hv["r_dist"], n),
        "hvac_c": _u(rng, hv["c_dist"], n) * 1000.0,   # kJ/degC
        "p_cool": _u(rng, hv["p_cool_dist"], n),        # kW
        "p_heat": _u(rng, hv["p_heat_dist"], n),
        "temp_in_min": sp - 0.5 * db,
        "temp_in_max": sp + 0.5 * db,
        "temp_in_init": sp - 0.5 * db + rng.uniform(0.25, 0.75, n) * db,
        "wh_r": _u(rng, wh["r_dist"], n) * 1000.0,
        "p_wh": _u(rng, wh["p_dist"], n),
        "temp_wh_min": wsp - 0.5 * wdb,
        "temp_wh_max": wsp + 0.5 * wdb,
        "temp_wh_init": wsp - 0.5 * wdb + rng.uniform(0.25, 0.75, n) * wdb,
        "tank_size": _u(rng, wh["size_dist"], n),
    }
    has_batt = np.isin(code, [0, 2]).astype(float)
    has_pv = np.isin(code, [0, 1]).astype(float)
    lower, upper = _u(rng, bt["lower_bound"], n), _u(rng, bt["upper_bound"], n)
    cap = _u(rng, bt["capacity"], n) * has_batt
    h.update(
        has_batt=has_batt, has_pv=has_pv,
        batt_max_rate=_u(rng, bt["max_rate"], n) * has_batt,
        batt_capacity=cap,
        batt_cap_min=lower * cap, batt_cap_max=upper * cap,
        batt_ch_eff=np.where(has_batt > 0, _u(rng, bt["charge_eff"], n), 1.0),
        batt_disch_eff=np.where(has_batt > 0, _u(rng, bt["discharge_eff"], n), 1.0),
        e_batt_init_frac=rng.uniform(bt["lower_bound"][1], bt["upper_bound"][0], n) * has_batt,
        pv_area=_u(rng, pv["area"], n) * has_pv,
        pv_eff=_u(rng, pv["efficiency"], n) * has_pv,
    )
    # Water draws: each home replays random days of one profile, each hour
    # scaled by its own noise, never more than its tank holds.
    n_prof_days = profiles.shape[0] // 24
    col = rng.integers(profiles.shape[1], size=n)
    days = rng.integers(n_prof_days, size=(n, -(-n_hours // 24)))
    hrs = (days[:, :, None] * 24 + np.arange(24)).reshape(n, -1)[:, :n_hours]
    noise = np.clip(1.0 + 0.2 * rng.standard_normal((n, n_hours)), 0.0, None)
    h["draws"] = np.minimum(profiles[hrs, col[:, None]] * noise, h["tank_size"][:, None])
    return h


def make_inputs(cfg_file: dict, traffic: dict, seed: int, root: str) -> dict:
    """Every input of one run: ``homes`` (per-home arrays over the fleet,
    type-major: each type's rows for community 0, then 1, …, as the
    program batches a fleet), with ``community`` and ``local_idx`` per
    row; ``oat``, ``ghi``, ``tou`` and ``data_start``; and the run's
    scalars.  The configuration's ``population_seed`` draws the homes;
    ``seed`` orders them inside each type and community, seeds the
    program's forecast noise, and (in ``compare.py``) draws the sample."""
    import os

    cfg = cfg_file["config"]
    dt = int(cfg["agg"]["subhourly_steps"])
    H = int(cfg["home"]["hems"]["prediction_horizon"]) * dt
    C = int(traffic.get("communities", 1))
    n = int(cfg_file["homes"])
    oat, ghi, data_start = load_weather(os.path.join(root, cfg_file["weather_file"]), dt)
    profiles = hourly_draw_profiles(os.path.join(root, cfg_file["waterdraw_file"]))
    # Hours of draws a home needs: the episode, its horizon and the fleet's
    # weather offsets never move the draws, which run on sim time.
    n_hours = int(traffic["episode_steps"]) // dt + H // dt + 2
    # One population a configuration (``population_seed``); the run's seed
    # orders each type's homes, so every seed gives the same work.
    pop = int(cfg_file["population_seed"])
    counts = type_counts(n, cfg_file["mix"])
    comms = []
    for c in range(C):
        h = _community(np.random.default_rng([pop, c]), n, cfg_file["mix"], cfg["home"],
                       profiles, n_hours)
        rng = np.random.default_rng([int(seed) % 2**63, c])
        perm, start = [], 0
        for t in TYPE_ORDER:
            perm.append(start + rng.permutation(counts[t]))
            start += counts[t]
        perm = np.concatenate(perm)
        comms.append({k: v[perm] for k, v in h.items()})
    order, start = [], 0
    for t in TYPE_ORDER:
        for c in range(C):
            order.append(c * n + start + np.arange(counts[t]))
        start += counts[t]
    order = np.concatenate(order)          # community-major index of each row
    homes = {k: np.concatenate([h[k] for h in comms])[order] for k in comms[0]}
    homes["community"] = order // n
    homes["local_idx"] = order % n
    homes["global_idx"] = order
    start_dt = datetime.strptime(cfg["simulation"]["start_datetime"], "%Y-%m-%d %H")
    start_index = int(round((start_dt - data_start).total_seconds() / 3600 * dt))
    return {
        "homes": homes, "n_per_community": n, "communities": C, "dt": dt, "H": H,
        "s": float(cfg["home"]["hems"]["sub_subhourly_steps"]),
        "discount": float(cfg["home"]["hems"]["discount_factor"]),
        "oat": oat, "ghi": ghi, "data_start": data_start, "start_index": start_index,
        "tou": tou_series(len(oat), data_start, dt, cfg["agg"]),
        "env_offset": homes["community"] * int(traffic.get("weather_offset_hours", 0)) * dt,
        "program_seed": program_seed(seed),
        "seed_stride": int(traffic.get("seed_stride", 1)),
    }
