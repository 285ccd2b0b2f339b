"""The port's ERCOT settlement-point prices (dragg_tpu_torch/data.py, the
csv module in place of pandas) against the JAX package's, on the same
CSV files: every behaviour tests/test_spp.py pins (the zone filter,
$/MWh → $/kWh, Hour Ending → hour beginning, the repeated-hour dedup, the
gap fill, the sub-hourly repeat, the missing zone raising), the
synthetic series and the environment's SPP branch, all bit for bit."""

import csv
from datetime import datetime

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu import data as jd
from dragg_tpu_torch import data as td
from dragg_tpu_torch.config import default_config

COLUMNS = ["Delivery Date", "Hour Ending", "Repeated Hour Flag",
           "Settlement Point", "Settlement Point Price"]


def _ercot_csv(tmp_path, rows, name="spp_data.csv"):
    path = str(tmp_path / name)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(COLUMNS)
        w.writerows(rows)
    return path


def _both(path, zone="LZ_HOUSTON", dt=1):
    pj, sj = jd.load_spp(path, zone, dt)
    pt, st = td.load_spp(path, zone, dt)
    assert st == sj
    np.testing.assert_array_equal(pt, np.asarray(pj))
    assert pt.dtype == np.float64
    return pt, st


@pytest.mark.parametrize("rows,dt,want", [
    # Zone filter and $/MWh → $/kWh; "HH:00" hour endings.
    ([["01/01/2015", "01:00", "N", "LZ_HOUSTON", 25.0],
      ["01/01/2015", "02:00", "N", "LZ_HOUSTON", 30.0],
      ["01/01/2015", "01:00", "N", "LZ_WEST", 99.0],
      ["01/01/2015", "03:00", "N", "LZ_HOUSTON", 45.0]], 1, [0.025, 0.030, 0.045]),
    # A missing hour is filled forward; dt = 2 repeats each hour.
    ([["01/01/2015", "1", "N", "LZ_HOUSTON", 10.0],
      ["01/01/2015", "3", "N", "LZ_HOUSTON", 30.0]], 2,
     [0.01, 0.01, 0.01, 0.01, 0.03, 0.03]),
    # The DST repeated hour keeps its first row.
    ([["11/01/2015", "1", "N", "LZ_HOUSTON", 10.0],
      ["11/01/2015", "1", "Y", "LZ_HOUSTON", 20.0]], 1, [0.01]),
    # Rows out of order, across midnight (hour ending 24 → 23:00), with
    # a fractional price.
    ([["01/02/2015", "2", "N", "LZ_HOUSTON", 17.31],
      ["01/01/2015", "24", "N", "LZ_HOUSTON", 21.5],
      ["01/02/2015", "1", "N", "LZ_HOUSTON", 19.07]], 4, None),
], ids=["zone-and-units", "gap-fill-subhourly", "repeated-hour", "unsorted-midnight"])
def test_load_spp_matches_jax(tmp_path, rows, dt, want):
    prices, start = _both(_ercot_csv(tmp_path, rows), dt=dt)
    if want is not None:
        np.testing.assert_allclose(prices, want)
    assert start.minute == 0


def test_load_spp_missing_zone_raises_as_jax(tmp_path):
    path = _ercot_csv(tmp_path, [["01/01/2015", "1", "N", "LZ_WEST", 10.0]])
    with pytest.raises(ValueError, match="LZ_HOUSTON") as ej:
        jd.load_spp(path, "LZ_HOUSTON", 1)
    with pytest.raises(ValueError, match="LZ_HOUSTON") as et:
        td.load_spp(path, "LZ_HOUSTON", 1)
    assert str(et.value) == str(ej.value)


def test_xlsx_needs_conversion(tmp_path):
    path = str(tmp_path / "spp.xlsx")
    open(path, "wb").close()
    with pytest.raises(RuntimeError, match="convert"):
        td.load_spp(path, "LZ_HOUSTON", 1)


@pytest.mark.parametrize("start,days,dt,seed", [
    (datetime(2015, 1, 1), 2, 1, 5), (datetime(2015, 6, 3, 7), 3, 4, 12)])
def test_synth_spp_and_alignment_bit_equal(start, days, dt, seed):
    a = td.synth_spp(start, days, dt, seed)
    np.testing.assert_array_equal(a, jd.synth_spp(start, days, dt, seed))
    for price_start in (start, datetime(2015, 1, 1, 2), datetime(2014, 12, 31, 20)):
        np.testing.assert_array_equal(
            td._align_price_series(a, price_start, start, 100, dt, 0.07),
            jd._align_price_series(a, price_start, start, 100, dt, 0.07))
    np.testing.assert_array_equal(
        td._align_price_series(np.array([]), start, start, 3, dt, 0.07),
        jd._align_price_series(np.array([]), start, start, 3, dt, 0.07))


@pytest.mark.parametrize("source", ["synthetic", "csv"])
def test_environment_spp_branch_bit_equal(tmp_path, source):
    """``load_environment`` with ``agg.spp_enabled``: the synthetic prices
    (no file) or the data dir's spp_data.csv, on the weather grid."""
    cfg = default_config()
    cfg["agg"]["spp_enabled"] = True
    cfg["agg"]["subhourly_steps"] = 2
    data_dir = ""
    if source == "csv":
        rows = [[f"01/{d + 1:02d}/2015", str(h), "N", "LZ_HOUSTON", 20.0 + h + 0.37 * d]
                for d in range(3) for h in range(1, 25)]
        rows.append(["01/02/2015", "5", "N", "LZ_NORTH", 99.0])
        _ercot_csv(tmp_path, rows)
        data_dir = str(tmp_path)
    ej = jd.load_environment(cfg, data_dir=data_dir)
    et = td.load_environment(cfg, data_dir=data_dir)
    for f in ("oat", "ghi", "tou"):
        np.testing.assert_array_equal(getattr(et, f), getattr(ej, f), err_msg=f)
    assert et.data_start == ej.data_start
    if source == "csv":
        assert et.tou[0] == pytest.approx(0.021)
