"""Data ingestion and home synthesis of the PyTorch port
(dragg_tpu_torch/data.py, homes.py — numpy and the csv module, no pandas)
against the JAX package's pandas versions: the environment series, the
water-draw profiles and every HomeBatch field must be identical, for the
default config and a 50-home legacy mix, from the bundled data files and
from the synthetic generators."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu import data as jd
from dragg_tpu import homes as jh
from dragg_tpu_torch import data as td
from dragg_tpu_torch import homes as th
from dragg_tpu_torch.config import default_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mix50():
    cfg = default_config()
    cfg["community"].update(total_number_homes=50, homes_pv=20, homes_battery=5,
                            homes_pv_battery=5)
    return cfg


@pytest.mark.parametrize("synthetic", [False, True])
def test_environment_series_equal(synthetic):
    cfg = default_config()
    dd = "" if synthetic else None
    ej, et = jd.load_environment(cfg, data_dir=dd), td.load_environment(cfg, data_dir=dd)
    for f in ("oat", "ghi", "tou"):
        np.testing.assert_array_equal(getattr(et, f), getattr(ej, f))
    assert (et.data_start, et.dt) == (ej.data_start, ej.dt)
    cfg["tpu"]["fix_tou_peak"] = True
    np.testing.assert_array_equal(td.load_environment(cfg).tou,
                                  jd.load_environment(cfg).tou)


@pytest.mark.parametrize("synthetic", [False, True])
@pytest.mark.parametrize("mix", ["default", "legacy50"])
def test_home_batches_equal(synthetic, mix):
    cfg = default_config() if mix == "default" else _mix50()
    seed = int(cfg["simulation"]["random_seed"])
    path = None if synthetic else jd.waterdraw_path(cfg, None)
    wj, wt = jd.load_waterdraw_profiles(path, seed=seed), td.load_waterdraw_profiles(path, seed=seed)
    np.testing.assert_array_equal(wt.values, wj.to_numpy())
    np.testing.assert_array_equal(
        wt.minutes, wj.index.values.astype("datetime64[m]").astype(np.int64))
    hj, ht = jh.create_homes(cfg, 72, 1, wj), th.create_homes(cfg, 72, 1, wt)
    assert ht == hj
    H = int(cfg["home"]["hems"]["prediction_horizon"])
    bj, bt = jh.build_home_batch(hj, H, 1, 6), th.build_home_batch(ht, H, 1, 6)
    assert bt._fields == bj._fields
    for f in bj._fields:
        np.testing.assert_array_equal(getattr(bt, f), getattr(bj, f), err_msg=f)
    assert th.type_bucket_ranges(bt.type_code) == jh.type_bucket_ranges(bj.type_code)
    (pt, mt), (pj, mj) = th.pad_batch(th.slice_batch(bt, 3, 16), 8), \
        jh.pad_batch(jh.slice_batch(bj, 3, 16), 8)
    np.testing.assert_array_equal(mt, mj)
    for f in bj._fields:
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f), err_msg=f)


def test_hourly_sums_match_pandas_with_gaps():
    """resample("h").sum() (Kahan-compensated, empty hours 0) on minutes
    with gaps and a non-aligned start."""
    import pandas as pd

    rng = np.random.default_rng(0)
    minutes = np.sort(rng.choice(np.arange(1_000, 1_000 + 600), 400, replace=False))
    values = rng.standard_normal((400, 3)) * 10.0 ** rng.integers(-3, 3, (400, 3))
    idx = pd.to_datetime(minutes.astype("datetime64[m]"))
    ref = pd.DataFrame(values, index=idx).resample("h").sum().to_numpy()
    np.testing.assert_array_equal(td.hourly_sums(values, minutes), ref)


def test_port_data_and_homes_import_no_pandas():
    for mod in ("data.py", "homes.py"):
        tree = ast.parse(open(os.path.join(REPO, "dragg_tpu_torch", mod)).read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert not any(str(n).split(".")[0] == "pandas" for n in names), mod
    code = ("import sys, dragg_tpu_torch.homes, dragg_tpu_torch.data; "
            "print('pandas' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
