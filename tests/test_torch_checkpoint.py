"""Checkpoint, resume and the two-slot host pipeline of the port
(dragg_tpu_torch/checkpoint.py and aggregator.py, on the CPU).

The community is tests/test_checkpoint.py's: 4 homes, 2 days in daily
chunks, a 2 h horizon.  Within the port a run stopped after its first
chunk and resumed gives every per-home series and the aggregate bit for
bit as the uninterrupted run, for the interior point and for ReLU-QP, and
the pipeline on and off give the same bits.  Against the JAX package: its
resumed run within 1e-4 absolute (tests/test_torch_aggregator.py's
tolerance for two float32 solvers), and the same checkpoint layout.
"""

import json
import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu.aggregator import Aggregator as JaxAggregator
from dragg_tpu_torch.aggregator import Aggregator, _HostSlot
from dragg_tpu_torch.checkpoint import host_snapshot, load_pytree, save_pytree, tree_leaves
from dragg_tpu_torch.config import default_config


def _cfg(solver="ipm", **sim):
    cfg = default_config()
    cfg["community"].update(total_number_homes=4, homes_pv=1, homes_battery=1,
                            homes_pv_battery=1)
    cfg["simulation"].update(start_datetime="2015-01-01 00", end_datetime="2015-01-03 00",
                             checkpoint_interval="daily", **sim)
    cfg["home"]["hems"]["prediction_horizon"] = 2
    cfg["home"]["hems"]["solver"] = solver
    cfg["tpu"]["sharded"] = False  # one device: the JAX engine's state unpadded
    return cfg


def _results(agg) -> dict:
    with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
        return json.load(f)


def _series(results: dict) -> dict:
    return {name: {k: v for k, v in d.items() if isinstance(v, list)}
            for name, d in results.items() if name != "Summary"}


def _run(cls, outputs_dir, cfg, stop=None, **kw):
    agg = cls(cfg, outputs_dir=str(outputs_dir), **kw)
    agg.stop_after_chunks = stop
    agg.run()
    return agg


def _ckpt_dir(agg) -> str:
    root = os.path.join(agg.run_dir, "baseline", "checkpoint")
    with open(os.path.join(root, "LATEST")) as f:
        return os.path.join(root, f.read().strip())


def _assert_bit_equal(got: dict, want: dict) -> None:
    gs, ws = _series(got), _series(want)
    assert set(gs) == set(ws)
    for name in ws:
        assert set(gs[name]) == set(ws[name]), name
        for key in ws[name]:
            np.testing.assert_array_equal(np.asarray(gs[name][key]), np.asarray(ws[name][key]),
                                          err_msg=f"{name}.{key}")
    for key in ("p_grid_aggregate", "p_grid_setpoint", "solver_iterations"):
        np.testing.assert_array_equal(np.asarray(got["Summary"][key]),
                                      np.asarray(want["Summary"][key]), err_msg=key)


def _solver_runs(solver, tmp_path_factory) -> dict:
    """The uninterrupted run (pipeline on, the default) and, in another
    outputs directory, the run stopped after one chunk, the layout of its
    checkpoint and the resumed run.  The interior point also runs with the
    pipeline off."""
    root = tmp_path_factory.mktemp(solver)
    out = {"solver": solver, "full": _run(Aggregator, root / "full", _cfg(solver),
                                          device="cpu")}
    if solver == "ipm":
        cfg = _cfg(solver)
        cfg["fleet"]["pipeline"] = False
        out["off"] = _run(Aggregator, root / "off", cfg, device="cpu")
    out["part"] = _run(Aggregator, root / "resumed", _cfg(solver), stop=1, device="cpu")
    out["part_results"] = _results(out["part"])
    out["layout"] = _layout(_ckpt_dir(out["part"]))
    out["resumed"] = _run(Aggregator, root / "resumed", _cfg(solver, resume=True),
                          device="cpu")
    return out


@pytest.fixture(scope="module")
def ipm_runs(tmp_path_factory):
    return _solver_runs("ipm", tmp_path_factory)


@pytest.fixture(scope="module")
def reluqp_runs(tmp_path_factory):
    return _solver_runs("reluqp", tmp_path_factory)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's run stopped after one chunk (with its checkpoint's
    layout) and resumed."""
    root = tmp_path_factory.mktemp("jax")
    part = _run(JaxAggregator, root, _cfg(), stop=1)
    layout = _layout(_ckpt_dir(part))
    resumed = _run(JaxAggregator, root, _cfg(resume=True))
    return layout, resumed


def _layout(d: str) -> dict:
    with np.load(os.path.join(d, "state.npz")) as data:
        keys = sorted(data.files, key=lambda k: int(k.rsplit("_", 1)[1]))
        leaves = [(k, data[k].shape, data[k].dtype) for k in keys]
    with open(os.path.join(d, "progress.json")) as f:
        progress = json.load(f)
    return {"files": sorted(os.listdir(d)), "leaves": leaves, "progress": progress,
            "name": os.path.basename(d)}


# --------------------------------------------------------------- pytrees
def test_pytree_roundtrip(tmp_path):
    """A bucketed engine's state, a tuple of CommunityStates, comes back
    leaf for leaf with the template's structure, dtypes and device."""
    cfg = _cfg()
    cfg["community"].update(total_number_homes=40, homes_pv=16, homes_battery=4,
                            homes_pv_battery=4)
    agg = Aggregator(cfg, outputs_dir=str(tmp_path / "out"), device="cpu")
    agg.get_homes()
    agg._build_engine()
    eng = agg.engine
    assert eng.bucketed
    template = eng.init_state()
    state, _ = eng.run_chunk(template, 0, np.zeros((2, eng.params.horizon), np.float32))
    save_pytree(str(tmp_path / "state.npz"), state)
    loaded = load_pytree(str(tmp_path / "state.npz"), template)
    assert type(loaded) is tuple and len(loaded) == len(state)
    assert [type(s) for s in loaded] == [type(s) for s in state]
    for a, b in zip(tree_leaves(loaded), tree_leaves(state)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_pytree_shape_mismatch_raises(tmp_path):
    tree = (torch.zeros(3), (torch.ones(2, 2), torch.arange(4)))
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree)
    with pytest.raises(ValueError, match="shape"):
        load_pytree(path, (torch.zeros(4), (torch.ones(2, 2), torch.arange(4))))
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(path, (torch.zeros(3), (torch.ones(2, 2),)))


# ---------------------------------------------------------------- resume
@pytest.mark.parametrize("solver", ["ipm", "reluqp"])
def test_resume_bit_exact(request, solver):
    runs = request.getfixturevalue(f"{solver}_runs")
    part = runs["part"]
    assert part.timestep == 24 < part.num_timesteps
    assert "state.npz" in runs["layout"]["files"]
    name = next(n for n in runs["part_results"] if n != "Summary")
    assert len(runs["part_results"][name]["p_grid_opt"]) == 24
    resumed = runs["resumed"]
    assert resumed.resumed_from is not None and resumed.resumed_from.endswith("ckpt_t00000024")
    _assert_bit_equal(_results(resumed), _results(runs["full"]))
    assert resumed.check_baseline_vals() == []


def test_pipeline_on_off_bit_equal(ipm_runs):
    runs = ipm_runs
    _assert_bit_equal(_results(runs["off"]), _results(runs["full"]))
    on = _results(runs["full"])["Summary"]["phase_times"]
    off = _results(runs["off"])["Summary"]["phase_times"]
    assert set(on) == set(off) == {"device_chunks", "collect", "overlap_hidden_s",
                                   "state_snapshot"}
    assert off["overlap_hidden_s"] == 0.0


@pytest.mark.parametrize("solver", ["ipm", "reluqp"])
def test_completed_run_clears_checkpoint(request, solver):
    runs = request.getfixturevalue(f"{solver}_runs")
    for key in ("full", "resumed"):
        agg = runs[key]
        assert agg.timestep == agg.num_timesteps
        assert not os.path.isdir(os.path.join(agg.run_dir, "baseline", "checkpoint")), key


def test_mismatched_config_starts_fresh(tmp_path):
    """A checkpoint written with a zero-width warm carry (the interior
    point's default) is ignored by a resume with ``ipm_warm_start``, whose
    carry is as wide as the QP: the run starts afresh."""
    part = _run(Aggregator, tmp_path, _cfg(), stop=1, device="cpu")
    assert part.timestep == 24
    cfg = _cfg(resume=True)
    cfg["tpu"]["ipm_warm_start"] = True
    res = _run(Aggregator, tmp_path, cfg, stop=1, device="cpu")
    assert res.resumed_from is None
    assert res.timestep == 24
    assert res._run_shape()["warm_cols"] != part._run_shape()["warm_cols"]


def test_snapshot_survives_the_next_chunk(tmp_path):
    """The host slot holds the state after chunk N once chunk N+1 has run
    from it, and no engine step wrote that state in place."""
    cfg = _cfg()
    cfg["community"].update(total_number_homes=40, homes_pv=16, homes_battery=4,
                            homes_pv_battery=4)
    agg = Aggregator(cfg, outputs_dir=str(tmp_path), device="cpu")
    agg.get_homes()
    agg._build_engine()
    eng = agg.engine
    rps = np.zeros((2, eng.params.horizon), np.float32)
    state1, outs1 = eng.run_chunk(eng.init_state(), 0, rps)
    want = host_snapshot((outs1, state1))
    slot = _HostSlot(torch.device("cpu"))
    slot.stage(outs1, state1)
    eng.run_chunk(state1, 2, rps)
    got = slot.wait()
    for g, w, live in zip(tree_leaves(got), tree_leaves(want),
                          tree_leaves((outs1, state1))):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(live.numpy(), w)


# ------------------------------------------------------- the JAX package
def test_resumed_run_matches_jax(ipm_runs, jax_runs):
    got, want = _results(ipm_runs["resumed"]), _results(jax_runs[1])
    assert jax_runs[1].resumed_from is not None
    gs, ws = _series(got), _series(want)
    assert list(gs) == list(ws)
    for name in ws:
        assert list(gs[name]) == list(ws[name]), name
        for key, v in ws[name].items():
            np.testing.assert_allclose(gs[name][key], v, rtol=0, atol=1e-4,
                                       err_msg=f"{name}.{key}")
        assert gs[name]["correct_solve"] == ws[name]["correct_solve"]
    for key in ("p_grid_aggregate", "p_grid_setpoint"):
        np.testing.assert_allclose(got["Summary"][key], want["Summary"][key], rtol=0,
                                   atol=1e-4, err_msg=key)


def test_checkpoint_layout_matches_jax(ipm_runs, jax_runs):
    """The same files, the same leaves in the same order with the same
    shapes, and the same progress.json and run_shape keys; run_shape's
    values are equal too.  The PRNG key leaf is int64 here (torch has no
    uint32 arithmetic, see rng.py) where the JAX package stores uint32."""
    got, want = ipm_runs["layout"], jax_runs[0]
    assert got["name"] == want["name"] == "ckpt_t00000024"
    assert got["files"] == want["files"] == ["collected.json", "progress.json", "state.npz"]
    assert [(k, s) for k, s, _ in got["leaves"]] == [(k, s) for k, s, _ in want["leaves"]]
    key_leaf = len(got["leaves"]) - 1  # CommunityState.key, the last field
    for i, ((k, _, dt_got), (_, _, dt_want)) in enumerate(zip(got["leaves"], want["leaves"])):
        if i == key_leaf:
            assert (dt_got, dt_want) == (np.int64, np.uint32)
        else:
            assert dt_got == dt_want, k
    assert set(got["progress"]) == set(want["progress"])
    # Values that cannot differ in this slice: one community, no event
    # timeline, no fleet RL, one process.
    assert got["progress"]["run_shape"] == want["progress"]["run_shape"]
    for key in ("events", "rl_fleet"):
        assert got["progress"]["run_shape"][key] is None
    assert got["progress"]["run_shape"]["process_count"] == 1
    for key in ("timestep", "solve_iters"):
        assert got["progress"][key] == want["progress"][key], key
    for key in ("tracked_loads", "max_load", "min_load", "baseline_agg_load_list"):
        np.testing.assert_allclose(got["progress"][key], want["progress"][key], rtol=0,
                                   atol=1e-4, err_msg=key)
