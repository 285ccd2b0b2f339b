"""Weather / price timeseries ingestion, with numpy and the csv module.

Counterpart of ``dragg_tpu/data.py`` without pandas: the same NSRDB
ingest (two metadata rows, repeat-rows-to-dt grid, int cast of GHI/OAT),
the same TOU construction (the reference's overwritten peak price kept by
default, ``fix_tou_peak`` for the intended tiering) and the same seeded
synthetic generators, so both packages build identical series.

Water-draw profiles are a :class:`WaterdrawProfiles` (values plus minute
timestamps) in place of a DataFrame.  ERCOT settlement-point prices
(``agg.spp_enabled``) are read from a CSV (an ``.xlsx`` workbook must be
converted first: there is no Excel reader here) or synthesized.
"""

from __future__ import annotations

import csv
import logging
import os
from dataclasses import dataclass
from datetime import datetime, timedelta
from typing import NamedTuple

import numpy as np

log = logging.getLogger("dragg_tpu_torch.data")


def parse_dt(s: str) -> datetime:
    """Parse the reference's '%Y-%m-%d %H' datetime format."""
    return datetime.strptime(s, "%Y-%m-%d %H")


@dataclass
class EnvironmentData:
    """Full-span environmental series at dt steps/hour resolution:
    outdoor air temp (degC), GHI (W/m2) and TOU price ($/kWh), index 0 at
    ``data_start``."""

    oat: np.ndarray
    ghi: np.ndarray
    tou: np.ndarray
    data_start: datetime
    dt: int

    @property
    def n_steps(self) -> int:
        return len(self.oat)

    def start_index(self, start_dt: datetime) -> int:
        """Step index of ``start_dt`` in the series."""
        hours = (start_dt - self.data_start).total_seconds() / 3600
        return int(round(hours * self.dt))

    def check_coverage(self, start_dt: datetime, end_dt: datetime, horizon_hours: int) -> None:
        """Simulation window + prediction horizon must lie inside the data."""
        s = self.start_index(start_dt)
        if s < 0:
            raise ValueError("The start datetime must exist in the data provided.")
        e = self.start_index(end_dt) + horizon_hours * self.dt
        if e + 1 > self.n_steps:
            raise ValueError("The end datetime + the prediction horizon must exist in the data provided.")


class WaterdrawProfiles(NamedTuple):
    """Minutely water-draw flows: one column per profile."""

    values: np.ndarray    # (n_minutes, n_profiles) float64
    minutes: np.ndarray   # (n_minutes,) int64 minutes since the epoch


def load_nsrdb(path: str, dt: int) -> tuple[np.ndarray, np.ndarray, datetime]:
    """Ingest an NSRDB csv (two metadata rows, then Year/Month/Day/Hour/
    Minute/GHI/Temperature columns) and resample to ``dt`` steps/hour:
    each source row is repeated ceil(dt/2) times if Minute==0 else
    floor(dt/2), and GHI/OAT are truncated to int."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))[2:]
    head, body = rows[0], [r for r in rows[1:] if r]
    col = {name: i for i, name in enumerate(head)}

    def column(name):
        return np.array([float(r[col[name]]) for r in body])

    minute = column("Minute")
    reps = np.where(minute == 0, int(np.ceil(dt / 2)), int(np.floor(dt / 2)))
    oat = np.repeat(column("Temperature").astype(int), reps).astype(np.float64)
    ghi = np.repeat(column("GHI").astype(int), reps).astype(np.float64)
    first = next(r for r, k in zip(body, reps) if k > 0)
    data_start = datetime(*(int(float(first[col[c]]))
                            for c in ("Year", "Month", "Day", "Hour")), 0)
    return oat, ghi, data_start


def build_tou(
    n_steps: int,
    data_start: datetime,
    dt: int,
    base_price: float,
    tou_enabled: bool = True,
    shoulder_times: tuple[int, int] = (9, 21),
    shoulder_price: float = 0.09,
    peak_times: tuple[int, int] = (14, 18),
    peak_price: float = 0.13,
    fix_tou_peak: bool = False,
) -> np.ndarray:
    """TOU price series over the full span: shoulder_price inside
    [shoulder_times), else base_price (the reference's peak assignment is
    overwritten); ``fix_tou_peak=True`` applies the peak tier too."""
    hours = (np.arange(n_steps) // dt + data_start.hour) % 24
    tou = np.full(n_steps, float(base_price))
    if tou_enabled:
        sh = (hours >= shoulder_times[0]) & (hours < shoulder_times[1])
        tou[sh] = float(shoulder_price)
        if fix_tou_peak:
            pk = (hours >= peak_times[0]) & (hours < peak_times[1])
            tou[pk] = float(peak_price)
    return tou


def _spp_timestamp(date: str, hour_ending: str) -> datetime:
    """A Delivery Date (``MM/DD/YYYY`` as ERCOT writes it, or ISO
    ``YYYY-MM-DD``) and an Hour Ending (``1``..``24`` or ``01:00``..
    ``24:00``) → the hour-beginning timestamp."""
    date = date.strip()
    for fmt in ("%m/%d/%Y", "%Y-%m-%d"):
        try:
            day = datetime.strptime(date, fmt)
            break
        except ValueError:
            continue
    else:
        raise ValueError(f"SPP Delivery Date {date!r}: not MM/DD/YYYY or YYYY-MM-DD")
    return day + timedelta(hours=float(hour_ending.strip().replace(":00", "")) - 1)


def load_spp(path: str, load_zone: str, dt: int) -> tuple[np.ndarray, datetime]:
    """Ingest ERCOT DAM Settlement Point Prices from a CSV with the
    workbook's columns (Delivery Date / Hour Ending / Settlement Point /
    Settlement Point Price): rows of ``load_zone`` only, $/MWh → $/kWh,
    Hour Ending shifted to hour-beginning, sorted in time (file order kept
    among equal hours) with a repeated hour (DST) keeping its first row,
    interior gaps filled forward onto a contiguous hourly grid, and each
    hourly price repeated onto the dt-step grid.  Returns (prices at dt
    steps/hour, timestamp of index 0)."""
    if not path.endswith(".csv"):
        raise RuntimeError(
            f"{path}: only CSV settlement-point prices can be read here; "
            "convert the ERCOT .xlsx workbook to .csv with the same columns")
    with open(path, newline="") as f:
        rows = [r for r in csv.DictReader(f)
                if r.get("Settlement Point", "").strip() == load_zone]
    if not rows:
        raise ValueError(f"No SPP rows for load zone {load_zone!r} in {path}")
    stamps = [_spp_timestamp(r["Delivery Date"], r["Hour Ending"]) for r in rows]
    spp = np.array([float(r["Settlement Point Price"]) for r in rows]) / 1000.0
    order = sorted(range(len(stamps)), key=stamps.__getitem__)
    hours: dict[datetime, float] = {}
    for i in order:
        hours.setdefault(stamps[i], spp[i])
    first, last = min(hours), max(hours)
    n_hours = int((last - first).total_seconds() // 3600) + 1
    grid = np.empty(n_hours)
    for k in range(n_hours):
        grid[k] = hours.get(first + timedelta(hours=k), grid[k - 1] if k else np.nan)
    return np.repeat(grid, dt), first


def synth_spp(start: datetime, days: int, dt: int, seed: int = 0) -> np.ndarray:
    """Synthetic day-ahead price series ($/kWh) with a morning/evening
    double peak, for runs without ERCOT data."""
    rng = np.random.RandomState(seed ^ 0x599)
    n = days * 24 * dt
    hod = (np.arange(n) / dt + start.hour) % 24.0
    base = 0.03 + 0.02 * np.exp(-0.5 * ((hod - 8) / 2.0) ** 2) \
        + 0.035 * np.exp(-0.5 * ((hod - 18) / 2.5) ** 2)
    noise = np.abs(rng.randn(n)) * 0.004
    return base + noise


def _align_price_series(prices: np.ndarray, price_start: datetime,
                        data_start: datetime, n_steps: int, dt: int,
                        base_price: float) -> np.ndarray:
    """An independently indexed price series on the weather grid: steps
    before or after its span take its edge values; an empty series gives
    the base price throughout."""
    if len(prices) == 0:
        return np.full(n_steps, float(base_price))
    offset = int(round((data_start - price_start).total_seconds() / 3600 * dt))
    idx = np.clip(np.arange(n_steps) + offset, 0, len(prices) - 1)
    return np.asarray(prices, dtype=np.float64)[idx]


def bundled_data_dir() -> str | None:
    """The repo's first-party ``data/`` directory, or None when the bundled
    weather file is absent (callers then use the synthetic generators)."""
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data")
    if os.path.exists(os.path.join(d, "nsrdb.csv")):
        return d
    return None


def load_environment(config: dict, data_dir: str | None = None) -> EnvironmentData:
    """EnvironmentData from config: the NSRDB file if present, else synthetic
    weather covering the simulation year; TOU prices, or with
    ``agg.spp_enabled`` settlement-point prices (``$SPP_DATA_FILE``,
    default spp_data.csv in the data dir, else synthetic) aligned onto the
    weather grid.  ``data_dir=None`` resolves to the bundled ``data/``
    assets, ``data_dir=""`` forces the synthetic series."""
    dt = int(config["agg"]["subhourly_steps"])
    seed = int(config["simulation"]["random_seed"])
    if data_dir is None:
        data_dir = bundled_data_dir()
    elif data_dir == "":
        data_dir = None
    ts_file = None
    if data_dir is not None:
        ts_file = os.path.join(data_dir, os.environ.get("SOLAR_TEMPERATURE_DATA_FILE", "nsrdb.csv"))
    if ts_file is not None and os.path.exists(ts_file):
        oat, ghi, data_start = load_nsrdb(ts_file, dt)
    else:
        if ts_file is not None:
            log.warning(
                "Weather file %s not found — substituting SYNTHETIC weather. "
                'Set data_dir="" to silence this (explicit synthetic), or '
                "point DATA_DIR at the directory holding nsrdb.csv.", ts_file,
            )
        start = parse_dt(config["simulation"]["start_datetime"])
        year_start = datetime(start.year, 1, 1)
        oat, ghi, data_start = synth_weather(year_start, days=366, dt=dt, seed=seed)

    if bool(config["agg"].get("spp_enabled", False)):
        tou = _spp_series(config, data_dir, data_start, len(oat), dt, seed)
        return EnvironmentData(oat=oat, ghi=ghi, tou=tou, data_start=data_start, dt=dt)
    tou_cfg = config["agg"].get("tou", {})
    tou = build_tou(
        len(oat),
        data_start,
        dt,
        base_price=config["agg"]["base_price"],
        tou_enabled=bool(config["agg"].get("tou_enabled", False)),
        shoulder_times=tuple(tou_cfg.get("shoulder_times", (9, 21))),
        shoulder_price=float(tou_cfg.get("shoulder_price", 0.09)),
        peak_times=tuple(tou_cfg.get("peak_times", (14, 18))),
        peak_price=float(tou_cfg.get("peak_price", 0.13)),
        fix_tou_peak=bool(config.get("tpu", {}).get("fix_tou_peak", False)),
    )
    return EnvironmentData(oat=oat, ghi=ghi, tou=tou, data_start=data_start, dt=dt)


def _spp_series(config: dict, data_dir: str | None, data_start: datetime,
                n_steps: int, dt: int, seed: int) -> np.ndarray:
    """The settlement-point price series on the weather grid: from the
    data dir's SPP file when it exists, else synthetic."""
    spp_file = None
    if data_dir is not None:
        spp_file = os.path.join(data_dir, os.environ.get("SPP_DATA_FILE", "spp_data.csv"))
    if spp_file is not None and os.path.exists(spp_file):
        prices, price_start = load_spp(
            spp_file, config["simulation"].get("load_zone", "LZ_HOUSTON"), dt)
    else:
        if spp_file is not None:
            log.warning("SPP price file %s not found — substituting SYNTHETIC "
                        "day-ahead prices.", spp_file)
        prices = synth_spp(data_start, days=n_steps // (24 * dt) + 1, dt=dt, seed=seed)
        price_start = data_start
    return _align_price_series(prices, price_start, data_start, n_steps, dt,
                               base_price=float(config["agg"]["base_price"]))


def synth_weather(
    start: datetime, days: int, dt: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, datetime]:
    """Synthetic weather at dt steps/hour: seasonal + diurnal OAT and a
    clear-sky-like GHI, int-quantized like the NSRDB ingest.  Deterministic
    given ``seed``."""
    rng = np.random.RandomState(seed ^ 0x5EED)
    n = days * 24 * dt
    t_hours = np.arange(n) / dt
    doy = (t_hours / 24.0 + (start.timetuple().tm_yday - 1)) % 365.25
    hod = (t_hours + start.hour) % 24.0
    seasonal = 15.0 - 12.0 * np.cos(2 * np.pi * (doy - 15) / 365.25)
    diurnal = 6.0 * np.sin(2 * np.pi * (hod - 9) / 24.0)
    noise = rng.randn(n) * 1.5
    # Smooth the noise so consecutive steps are correlated like real weather.
    kernel = np.exp(-0.5 * (np.arange(-12, 13) / 4.0) ** 2)
    kernel /= kernel.sum()
    noise = np.convolve(noise, kernel, mode="same")
    oat = np.round(seasonal + diurnal + noise).astype(int).astype(np.float64)
    solar_elev = np.sin(np.pi * np.clip((hod - 6.0) / 12.0, 0.0, 1.0))
    season_scale = 0.65 + 0.35 * np.sin(2 * np.pi * (doy - 80) / 365.25)
    cloud = 1.0 - 0.3 * np.abs(np.sin(0.37 * t_hours + rng.rand() * 6.28))
    ghi = np.round(950.0 * solar_elev * season_scale * cloud).astype(int)
    ghi = np.clip(ghi, 0, None).astype(np.float64)
    return oat, ghi, start


def synth_waterdraw_profiles(
    n_profiles: int = 10, days: int = 7, seed: int = 0
) -> WaterdrawProfiles:
    """Synthetic minutely water-draw flow profiles starting 2020-01-01:
    draw events cluster at morning and evening hours, ~150-250 L/day."""
    rng = np.random.RandomState(seed ^ 0xD3A3)
    n_min = days * 24 * 60
    t0 = np.datetime64("2020-01-01T00:00", "m").astype(np.int64)
    minute_of_day = np.arange(n_min) % (24 * 60)
    density = (
        0.2
        + 1.2 * np.exp(-0.5 * ((minute_of_day - 7 * 60) / 60.0) ** 2)
        + 1.0 * np.exp(-0.5 * ((minute_of_day - 19 * 60) / 90.0) ** 2)
    )
    density /= density.sum() / (24 * 60)
    cols = []
    for _ in range(n_profiles):
        flows = np.zeros(n_min)
        n_events = rng.poisson(8 * days)
        starts = rng.choice(n_min, size=n_events, p=density / density.sum())
        for s in starts:
            dur = rng.randint(1, 12)
            rate = rng.uniform(2.0, 8.0)
            flows[s : s + dur] += rate
        cols.append(flows)
    return WaterdrawProfiles(values=np.stack(cols, axis=1),
                             minutes=t0 + np.arange(n_min, dtype=np.int64))


def hourly_sums(values: np.ndarray, minutes: np.ndarray) -> np.ndarray:
    """Sum minutely rows into calendar hours, from the first row's hour to
    the last's (empty hours sum to 0): pandas' ``resample("h").sum()``,
    including its Kahan-compensated summation in row order, so the sums
    agree to the last bit."""
    hour = minutes // 60
    hour = hour - hour[0]
    n_hours = int(hour[-1]) + 1
    # Rank of each row inside its hour (rows are in time order).
    starts = np.searchsorted(hour, np.arange(n_hours))
    rank = np.arange(len(hour)) - starts[hour]
    dense = np.zeros((n_hours, int(rank.max()) + 1, values.shape[1]))
    present = np.zeros(dense.shape[:2], dtype=bool)
    dense[hour, rank] = values
    present[hour, rank] = True
    total = np.zeros((n_hours, values.shape[1]))
    comp = np.zeros_like(total)
    for j in range(dense.shape[1]):
        keep = present[:, j, None]
        y = dense[:, j] - comp
        t = total + y
        comp = np.where(keep, (t - total) - y, comp)
        total = np.where(keep, t, total)
    return total


def waterdraw_path(config: dict, data_dir: str | None) -> str | None:
    """The water-draw csv path from a data dir + ``home.wh.waterdraw_file``;
    ``data_dir=None`` resolves to the bundled assets, and None comes back
    (synthetic draws) only when those are absent too (or ``data_dir=""``)."""
    if data_dir is None:
        data_dir = bundled_data_dir()
    elif data_dir == "":
        data_dir = None
    if data_dir is None:
        return None
    fname = config["home"]["wh"].get("waterdraw_file", "waterdraw_profiles.csv")
    return os.path.join(data_dir, fname)


def load_waterdraw_profiles(path: str | None, seed: int = 0) -> WaterdrawProfiles:
    """Load the minutely water-draw profile csv, or synthesize one."""
    if path is not None and os.path.exists(path):
        with open(path, newline="") as f:
            rows = [r for r in csv.reader(f) if r][1:]
        stamps = np.array([r[0] for r in rows], dtype="datetime64[m]")
        values = np.array([[float(v) for v in r[1:]] for r in rows])
        return WaterdrawProfiles(values=values, minutes=stamps.astype(np.int64))
    if path is not None:
        log.warning(
            "Water-draw profile file %s not found — substituting SYNTHETIC "
            "draw profiles.", path,
        )
    return synth_waterdraw_profiles(seed=seed)
