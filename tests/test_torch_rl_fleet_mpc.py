"""The fleet's ``rl.fleet.gradient = "mpc"`` (dragg_tpu_torch/rl/fleet.py
``mpc_response``: forward-mode AD through ``Engine._step``) against the
JAX package's ``jax.jvp`` through its engine step, on the CPU.

* The tangent: 2 communities × 4 homes, H = 4, a reward-price row per
  community and the window tangent of ``_rp_matrix``, 4 steps each from
  the JAX engine's state, on the plain routes (the interior point with
  ``tpu.band_kernel = "xla"``, ReLU-QP on the lax route): each
  community's relaxed response (step-1 ``forecast_p_grid`` summed) within
  1e-4, and its derivative ``dagg`` within TANGENT_RTOL[solver] of the
  step's largest |dagg| (plus 1e-6).  Both packages run the same
  iterations; the tangent is that of the last iterate, and it carries the
  iterates' float32 differences, amplified where the solve is
  ill-conditioned.  The interior point's is the worse: its iterate
  follows the central path of an LP whose solution is piecewise constant
  in the price.  Over 4 price seeds × 8 steps at the default tolerances
  the largest error seen was 2.7 % (interior point) and 0.35 % (ReLU-QP)
  of the step's largest |dagg|; 5 % and 1 % are held.
* A whole rl_agg run (the shared linear agent, ReLU-QP on the lax route,
  6 hourly steps): prices within 1e-6 and θ_μ within 1e-5 of its largest
  magnitude against the JAX package's run (2.5e-7 is seen), and θ_μ
  apart from the score gradient's by more than 1e-4 of it (7.9e-4 is
  seen: the mpc term enters from the second step).
* The kernel-route rule (``check_mpc_route``): a ValueError naming
  ``rl.fleet.gradient`` and the kernel key for ``band_kernel = "auto"`` on
  a CUDA device, ``"pallas"`` on any device, and ``iter_kernel =
  "pallas"`` under ReLU-QP; none on the plain routes or under "score";
  the Aggregator raises it at construction.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu import data as jd
from dragg_tpu import engine as je
from dragg_tpu import homes as jh
from dragg_tpu.aggregator import Aggregator as JaxAggregator
from dragg_tpu_torch import engine as te
from dragg_tpu_torch.aggregator import Aggregator
from dragg_tpu_torch.config import default_config
from dragg_tpu_torch.interop import engine_state_from_numpy
from dragg_tpu_torch.rl import fleet as tfleet

C, H = 2, 4
TANGENT_RTOL = {"ipm": 5e-2, "reluqp": 1e-2}
TANGENT_ATOL = 1e-6


def _config(solver="ipm", **rl_fleet):
    cfg = default_config()
    cfg["community"].update(total_number_homes=4, homes_pv=1, homes_battery=1,
                            homes_pv_battery=1)
    cfg["home"]["hems"]["prediction_horizon"] = H
    cfg["home"]["hems"]["solver"] = solver
    cfg["fleet"].update(communities=C, seed_stride=5)
    cfg["tpu"].update(sharded=False, band_kernel="xla")
    cfg["rl"]["fleet"].update(gradient="mpc", **rl_fleet)
    return cfg


@pytest.mark.parametrize("solver", ["ipm", "reluqp"])
def test_mpc_tangent_matches_jax_jvp(solver):
    cfg = _config(solver)
    env = jd.load_environment(cfg)
    homes = jh.create_fleet_homes(cfg, 48, 1, jd.load_waterdraw_profiles(
        jd.waterdraw_path(cfg, None), seed=12))
    batch, fleet = jh.build_fleet_batch(homes, cfg, H, 1, 6)
    ej = je.make_engine(batch, env, cfg, 0, fleet=fleet)
    et = te.make_engine(batch, env, cfg, 0, device="cpu", fleet=fleet)
    comm, mask = ej.community_fold_arrays()
    fold = tfleet.CommunityFold.of(et)
    rps = np.random.default_rng(3).uniform(-0.02, 0.02, (4, C)).astype(np.float32)
    state = ej.init_state()
    live = 0
    for t in range(4):
        rp_mat, tangent = tfleet._rp_matrix(torch.from_numpy(rps[t]), H, 1, 1)

        def f(rp, state=state, t=t):
            cs, _, outs = ej._step_fn(ej._consts(), state, jnp.asarray(t), rp,
                                      jnp.asarray(True), ej.init_factor())
            return jax.ops.segment_sum(outs.forecast_p_grid * mask, comm, num_segments=C), cs

        fore_j, dagg_j, nxt = jax.jvp(f, (jnp.asarray(rp_mat.numpy()),),
                                      (jnp.asarray(tangent.numpy()),), has_aux=True)
        fore_t, dagg_t, _ = tfleet.mpc_response(
            et, engine_state_from_numpy(state, "cpu"), t, rp_mat, tangent, True,
            et.init_factor(), fold)
        fore_j, dagg_j = np.asarray(fore_j), np.asarray(dagg_j)
        np.testing.assert_allclose(fore_t.numpy(), fore_j, rtol=0, atol=1e-4, err_msg=str(t))
        bound = TANGENT_RTOL[solver] * np.max(np.abs(dagg_j)) + TANGENT_ATOL
        err = np.max(np.abs(dagg_t.numpy() - dagg_j))
        assert err <= bound, (t, dagg_t.numpy(), dagg_j, err, bound)
        live += np.any(dagg_j != 0)
        state = nxt
    assert live == 4


def _run(cls, out, cfg, **kw):
    agg = cls(config=cfg, outputs_dir=str(out), **kw)
    agg.run()
    with open(os.path.join(agg.run_dir, "rl_agg", "results.json")) as f:
        return agg, json.load(f)["Summary"]


def test_mpc_run_matches_jax_and_moves_the_policy(tmp_path):
    cfg = _config("reluqp")
    cfg["simulation"].update(end_datetime="2015-01-01 06", run_rbo_mpc=False,
                             run_rl_agg=True, checkpoint_interval="daily")
    ja, sj = _run(JaxAggregator, tmp_path / "jax", copy.deepcopy(cfg))
    ta, st = _run(Aggregator, tmp_path / "torch", copy.deepcopy(cfg), device="cpu")
    assert st["fleet_rl"]["gradient"] == "mpc"
    np.testing.assert_allclose(st["fleet_rl"]["RP_by_community"],
                               sj["fleet_rl"]["RP_by_community"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(st["p_grid_aggregate"], sj["p_grid_aggregate"], rtol=0,
                               atol=1e-4)
    want = np.asarray(ja.agent.carry.theta_mu)
    got = ta.agent.carry.theta_mu.numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
    cfg["rl"]["fleet"]["gradient"] = "score"
    ts, _ = _run(Aggregator, tmp_path / "score", cfg, device="cpu")
    score = ts.agent.carry.theta_mu.numpy()
    assert np.max(np.abs(got - score)) > 1e-4 * np.max(np.abs(want))


@pytest.mark.parametrize("solver,tpu,device,key", [
    ("ipm", {"band_kernel": "auto"}, "cuda", "tpu.band_kernel"),
    ("ipm", {"band_kernel": "pallas"}, "cuda", "tpu.band_kernel"),
    ("ipm", {"band_kernel": "pallas"}, "cpu", "tpu.band_kernel"),
    ("ipm", {"band_kernel": "pallas", "band_fused": True}, "cpu", "tpu.band_kernel"),
    ("reluqp", {"iter_kernel": "pallas"}, "cuda", "tpu.iter_kernel"),
    ("reluqp", {"iter_kernel": "pallas"}, "cpu", "tpu.iter_kernel"),
    ("ipm", {"band_kernel": "auto"}, "cpu", None),
    ("ipm", {"band_kernel": "xla"}, "cuda", None),
    ("reluqp", {"iter_kernel": "lax"}, "cuda", None),
    ("reluqp", {"iter_kernel": "auto", "band_kernel": "auto"}, "cuda", None),
])
def test_mpc_kernel_route_rule(solver, tpu, device, key):
    cfg = _config(solver)
    cfg["tpu"].update(tpu)
    if key is None:
        tfleet.check_mpc_route(cfg, device)
        return
    with pytest.raises(ValueError, match=rf"rl\.fleet\.gradient.*{key}"):
        tfleet.check_mpc_route(cfg, device)
    cfg["rl"]["fleet"]["gradient"] = "score"
    tfleet.check_mpc_route(cfg, device)  # the score gradient runs every route


def test_aggregator_raises_the_route_error_before_any_run(tmp_path):
    cfg = _config()
    cfg["tpu"]["band_kernel"] = "pallas"
    cfg["simulation"]["run_rl_agg"] = True
    with pytest.raises(ValueError, match="tpu.band_kernel"):
        Aggregator(config=cfg, outputs_dir=str(tmp_path), device="cpu")
    # The simplified case differentiates its linear model exactly.
    cfg["simulation"].update(run_rl_agg=False, run_rl_simplified=True)
    Aggregator(config=cfg, outputs_dir=str(tmp_path), device="cpu")
