"""The sharded run's checkpoint and resume as two gloo ranks on the CPU,
each rank on its own outputs directory (ranks that share no disk), with
tests/test_torch_distributed_run.py's launcher; the counterpart of
tests/test_distributed.py's resume test and tests/test_checkpoint.py's
world-size check.

* A run stopped after its first day leaves, on each rank's disk, only
  that rank's ``state.proc0000r-of-00002.npz``; rank 1 holds no
  ``progress.json``.  Resumed on both ranks, it is bit-equal to the
  uninterrupted two-rank run.
* A torn shard (another timestep inside) or a missing one on rank 1
  sends both ranks back to t = 0.
* A checkpoint of two ranks, resumed by a world of one, starts afresh.
"""

import json
import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from tests.test_torch_checkpoint import _assert_bit_equal  # noqa: E402
from tests.test_torch_distributed_run import day_config, find_files, run_rank_script  # noqa: E402


def _config(resume: bool = False) -> dict:
    cfg = day_config(n_homes=5)
    cfg["simulation"]["end_datetime"] = "2015-01-03 00"
    cfg["simulation"]["resume"] = resume
    cfg["home"]["hems"]["prediction_horizon"] = 2
    return cfg


def _results(d) -> dict:
    (path,) = find_files(d, "results.json")
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("full")
    dirs = [tmp / f"rank{r}" for r in range(2)]
    run_rank_script(tmp, _config(), dirs)
    return _results(dirs[0])


def _stopped(tmp_path) -> list:
    dirs = [tmp_path / f"rank{r}" for r in range(2)]
    done = run_rank_script(tmp_path, _config(), dirs, stop=1)
    assert [d["timestep"] for d in done] == [24, 24]
    return dirs


def test_resume_bit_exact_on_separate_disks(tmp_path, full):
    dirs = _stopped(tmp_path)
    shards = [find_files(d, f"state.proc0000{r}-of-00002.npz") for r, d in enumerate(dirs)]
    assert all(len(s) == 1 for s in shards)
    assert not find_files(dirs[0], "state.proc00001-of-00002.npz")
    assert not find_files(dirs[1], "state.proc00000-of-00002.npz")
    assert find_files(dirs[0], "progress.json") and not find_files(dirs[1], "progress.json")
    with np.load(shards[1][0]) as data:
        assert int(data["__timestep__"]) == 24
    done = run_rank_script(tmp_path, _config(resume=True), dirs)
    assert all(d["resumed_from"].endswith("ckpt_t00000024") for d in done)
    _assert_bit_equal(_results(dirs[0]), full)
    assert not find_files(dirs[1], "results.json")


@pytest.mark.parametrize("fault", ["torn", "missing"])
def test_bad_shard_on_one_rank_restarts_every_rank(tmp_path, full, fault):
    dirs = _stopped(tmp_path)
    (shard,) = find_files(dirs[1], "state.proc00001-of-00002.npz")
    if fault == "missing":
        os.remove(shard)
    else:
        with np.load(shard) as data:
            arrays = dict(data)
        arrays["__timestep__"] = np.asarray(0, np.int64)
        with open(shard, "wb") as f:
            np.savez_compressed(f, **arrays)
    done = run_rank_script(tmp_path, _config(resume=True), dirs)
    assert [d["resumed_from"] for d in done] == [None, None]
    _assert_bit_equal(_results(dirs[0]), full)


def test_checkpoint_of_another_world_size_starts_afresh(tmp_path):
    dirs = _stopped(tmp_path)
    (done,) = run_rank_script(tmp_path, _config(resume=True), dirs[:1])
    assert done["size"] == 1 and done["resumed_from"] is None
    assert done["timestep"] == 48
    assert len(_results(dirs[0])["Summary"]["p_grid_aggregate"]) == 48
