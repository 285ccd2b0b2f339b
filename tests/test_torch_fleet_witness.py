"""dragg_tpu_torch.fleet_witness on the CPU at a small size: the replica
engine's copies of a community equal its run alone bit for bit (the
CPU's sums do not depend on where a row lies), and ``compare_homes``
finds first flips and bounds as its docstring says."""

import numpy as np
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu_torch.aggregator import Aggregator
from dragg_tpu_torch.config import pack_fleet_config
from dragg_tpu_torch.fleet_witness import (DUTY, SERIES, compare_homes, engine_series,
                                           replica_engine)


def test_replica_copies_equal_the_run_alone(tmp_path):
    cfg = pack_fleet_config(20, 4, 3, 1, ipm_tail_frac=0.0, bucketed="true")
    cfg["fleet"]["community_base"] = 1
    agg = Aggregator(cfg, outputs_dir=str(tmp_path), device="cpu")
    agg.get_homes()
    agg._build_engine()
    ref, _ = engine_series(agg.engine, 3)
    rep, _ = engine_series(replica_engine(agg, 3), 3)
    assert rep["cost"].shape == (3, 60)
    for c in range(3):
        for key, want in ref.items():
            np.testing.assert_array_equal(rep[key][:, c * 20:(c + 1) * 20], want, err_msg=key)
    battery = np.array(["battery" in h["type"] for h in agg.all_homes])
    storage = battery | np.array([h["type"] == "ev" for h in agg.all_homes])
    assert battery.any() and (storage & ~battery).any() and not storage.all()
    stats = compare_homes(ref, {k: v[:, 40:] for k, v in rep.items()}, 6.0, battery, storage)
    assert stats["solved_flag_agreement"] == 1.0 and stats["compared_share"] == 1.0
    assert not any(stats["max_abs_differences_before_flip"].values())


def test_compare_homes_first_flips_and_bounds():
    steps, homes = 4, 3
    ref = {k: np.zeros((steps, homes)) for k in ("correct_solve", *DUTY, *SERIES)}
    ref["correct_solve"][:] = 1.0
    cmp = {k: v.copy() for k, v in ref.items()}
    cmp["correct_solve"][2, 0] = 0.0         # home 0: a solved flag differs at step 2
    cmp["wh_heat_on"][1, 1] = 1.0 / 6.0      # home 1: one duty count apart at step 1
    cmp["cost"][0, 2] = 0.1                  # home 2 (no storage): beyond its bound
    cmp["cost"][3, 0] = 5.0                  # home 0 after its first flip: not compared
    storage = np.array([True, False, False])
    stats = compare_homes(ref, cmp, 6.0, storage, storage,
                          {"cost": (1e-2, 2e-3), "cost (storage homes)": (0.0, 0.4)})
    assert stats["homes_first_flip_solved"] == 1 and stats["homes_first_flip_rounding"] == 1
    assert stats["compared_share"] == (2 + 1 + 4) / 12
    assert stats["max_abs_differences_before_flip"]["cost (storage homes)"] == 0.0
    assert stats["max_abs_differences_before_flip"]["cost"] == 0.1
    assert stats["violations"] == ["home 2: cost differs by 0.1 before its first flip"]
    assert stats["solved_flag_agreement"] == 11 / 12
