"""The port's fleet axis (dragg_tpu_torch/homes.py FleetSpec and the
engine's fleet rows) against the JAX package:

* ``fleet_spec_for``, ``create_fleet_homes`` and ``build_fleet_batch``:
  equal arrays, also with a community base and weather offsets;
* a 3-community fleet engine against the JAX fleet engine, weather
  offsets on and per-community (C, H) reward prices, each step from the
  JAX engine's state: solved flags equal and every series within
  test_torch_engine.py's 1e-4 (the legacy four-type mix: no home at the
  edge of feasibility, unlike tests/test_torch_scenario_runs.py);
* the fleet accessors (real_home_cols, real_home_pairs,
  community_fold_arrays) equal to the JAX engine's;
* inside the port, each community of a 2-community fleet against its
  standalone run in tests/test_fleet.py's tolerance class
  (``_assert_community_match``), and an unbucketed fleet against its
  standalone communities bit for bit.
"""

import copy
import os
import tempfile

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu import data as jd
from dragg_tpu import engine as je
from dragg_tpu import homes as jh
from dragg_tpu_torch import engine as te
from dragg_tpu_torch import homes as th
from dragg_tpu_torch.config import default_config
from dragg_tpu_torch.data import load_waterdraw_profiles
from dragg_tpu_torch.interop import engine_state_from_numpy
from test_fleet import _assert_community_match


def _fleet_cfg(n=8, communities=3, weather_off=24, base=0, bucketed="true"):
    cfg = default_config()
    cfg["community"].update(total_number_homes=n, homes_pv=2, homes_battery=2,
                            homes_pv_battery=2)
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["fleet"].update(communities=communities, seed_stride=5,
                        weather_offset_hours=weather_off, community_base=base)
    cfg["tpu"].update(bucketed=bucketed, ipm_tail_frac=0.0)
    return cfg


def _homes(cfg):
    wd = jd.load_waterdraw_profiles(jd.waterdraw_path(cfg, None), seed=12)
    return jh.create_fleet_homes(cfg, 48, 1, wd)


@pytest.mark.parametrize("communities,off,base", [(3, 2, 0), (2, 24, 3), (1, 24, 2)])
def test_fleet_spec_and_batch_match_jax(communities, off, base):
    cfg = _fleet_cfg(communities=communities, weather_off=off, base=base)
    homes = _homes(cfg)
    homes_t = th.create_fleet_homes(
        cfg, 48, 1, load_waterdraw_profiles(jd.waterdraw_path(cfg, None), seed=12))
    assert homes_t == homes
    spec_j, spec_t = jh.fleet_spec_for(homes, cfg), th.fleet_spec_for(homes, cfg)
    for f in spec_j._fields:
        a, b = getattr(spec_j, f), getattr(spec_t, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f)
            assert b.dtype == a.dtype, f
        else:
            assert b == a, f
    (bj, fj), (bt, ft) = (jh.build_fleet_batch(homes, cfg, 4, 1, 6),
                          th.build_fleet_batch(homes, cfg, 4, 1, 6))
    for f in bj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(bt, f)), np.asarray(getattr(bj, f)),
                                      err_msg=f)
    assert (ft is None) == (fj is None)


def _engines(cfg):
    env = jd.load_environment(cfg)
    homes = _homes(cfg)
    batch, fleet = jh.build_fleet_batch(homes, cfg, 4, 1, 6)
    return (je.make_engine(batch, env, cfg, 0, fleet=fleet),
            te.make_engine(batch, env, cfg, 0, device="cpu", fleet=fleet), env)


def test_fleet_engine_matches_jax():
    """3 communities × 8 homes, 24 h weather offsets, 4 steps with a
    different reward-price row per community, each from the JAX state."""
    ej, et, _ = _engines(_fleet_cfg())
    assert et.n_communities == ej.n_communities == 3 and et._per_home_env
    np.testing.assert_array_equal(et.real_home_cols, ej.real_home_cols)
    np.testing.assert_array_equal(et.real_home_pairs, ej.real_home_pairs)
    for a, b in zip(et.community_fold_arrays(), ej.community_fold_arrays()):
        np.testing.assert_array_equal(a, b)
    rps = np.random.default_rng(5).uniform(-0.02, 0.02, (4, 3, 4)).astype(np.float32)
    state = ej.init_state()
    for t in range(4):
        nxt, oj = ej.run_chunk(state, t, rps[t:t + 1])
        _, ot = et.run_chunk(engine_state_from_numpy(state, "cpu"), t, rps[t:t + 1])
        for f in te.StepOutputs._fields:
            if f in te.OBS_FIELDS:
                continue  # the observatory's leaves: tests/test_torch_observatory*.py
            a, b = np.asarray(getattr(oj, f)), getattr(ot, f).numpy()
            if f in ("correct_solve", "admm_iters", "waterdraws", "hvac_cool_on"):
                np.testing.assert_array_equal(b, a, err_msg=f"t={t} {f}")
            elif f not in ("r_prim_max", "r_dual_max"):
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=f"t={t} {f}")
        state = nxt
    assert float(np.asarray(oj.correct_solve).mean()) > 0.5


def _port_run(cfg, env, steps=3, rps=None):
    homes = th.create_fleet_homes(
        cfg, 48, 1, load_waterdraw_profiles(jd.waterdraw_path(cfg, None), seed=12))
    batch, fleet = th.build_fleet_batch(homes, cfg, 4, 1, 6)
    eng = te.make_engine(batch, env, cfg, 0, device="cpu", fleet=fleet)
    if rps is None:
        rps = np.zeros((steps, 4), np.float32)
    _, out = eng.run_chunk(eng.init_state(), 0, rps)
    return eng, {f: getattr(out, f).numpy() for f in out._fields}


@pytest.mark.parametrize("bucketed", ["true", "false"])
def test_fleet_matches_standalone_communities(bucketed):
    """Community c of a 2-community fleet (its own seed, its weather 24 h
    on) against the standalone run of the same community (community_base
    c): bucketed, tests/test_fleet.py's tolerance class; unbucketed (the
    same batch shapes), bit for bit.  The fleet's community-0 price row is
    the standalone run's price."""
    cfg = _fleet_cfg(n=8, communities=2, bucketed=bucketed)
    env = jd.load_environment(cfg)
    rps = np.random.default_rng(2).uniform(-0.02, 0.02, (3, 2, 4)).astype(np.float32)
    eng, out = _port_run(cfg, env, rps=rps)
    B = eng.fleet.homes_per_community
    cols = eng.real_home_cols
    agg = np.zeros(3)
    for c in range(2):
        cfg_c = copy.deepcopy(cfg)
        cfg_c["fleet"].update(communities=1, community_base=c)
        eng_c, solo = _port_run(cfg_c, env, rps=rps[:, c])
        assert eng_c.n_communities == 1 and (eng_c.fleet is None) == (c == 0)
        # Per-home series and aggregates; the observatory's per-bucket
        # leaves are held in tests/test_torch_observatory*.py.
        fl = {f: a[:, cols[c * B:(c + 1) * B]] if a.ndim == 2 else a for f, a in out.items()
              if f not in te.OBS_FIELDS}
        so = {f: a[:, eng_c.real_home_cols] if a.ndim == 2 else a for f, a in solo.items()
              if f not in te.OBS_FIELDS}
        if bucketed == "true":
            _assert_community_match(fl, so, eng.params.s)
        else:
            for f, a in so.items():
                if a.ndim == 2:
                    np.testing.assert_array_equal(fl[f], a, err_msg=f)
        agg += so["agg_load"]
    np.testing.assert_allclose(out["agg_load"], agg, rtol=1e-3, atol=1e-2)


def test_fleet_state_roundtrip_and_price_shapes():
    """The fleet state through the port's checkpoint files and back gives
    the same next chunk bit for bit; an (H,) price equals the same row
    for every community."""
    from dragg_tpu_torch.checkpoint import load_pytree, save_pytree

    cfg = _fleet_cfg(n=8, communities=2, weather_off=0)
    env = jd.load_environment(cfg)
    eng, _ = _port_run(cfg, env, steps=1)
    assert not eng._per_home_env
    rps = np.full((2, 4), 0.01, np.float32)
    state, _ = eng.run_chunk(eng.init_state(), 0, rps)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(os.path.join(d, "state.npz"), state)
        restored = load_pytree(os.path.join(d, "state.npz"), eng.init_state())
    _, o1 = eng.run_chunk(state, 2, rps)
    _, o2 = eng.run_chunk(restored, 2, rps)
    _, o3 = eng.run_chunk(state, 2, np.broadcast_to(rps[:, None], (2, 2, 4)).copy())
    for f in te.StepOutputs._fields:
        assert torch.equal(getattr(o1, f), getattr(o2, f)), f
        assert torch.equal(getattr(o1, f), getattr(o3, f)), f
