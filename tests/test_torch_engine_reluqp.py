"""The port's engine under ``hems.solver = "reluqp"`` (dragg_tpu_torch/engine.py
on the CPU) against ``dragg_tpu.engine.Engine``: an 8-home mixed community
at a 4 h horizon, bucketed and not, six steps through ``run_chunk`` with
``admm_refactor_every = 4``, so the rho bank is rebuilt at t = 0 and again
at t = 4.  The port runs both check-window routes ("lax", the einsum
chain, and "pallas", the fused window's plain version on the CPU)
against the JAX engine's default ("auto" = lax) run.

Assertions: the flip-aware set of tests/test_reluqp.py:333-403, copied
below, with its tolerances — solved flags equal; applied duty counts
differ by at most one count, on at most 2 % of home-steps, and match
exactly on at least 95 %; aggregate cost and load within rtol 1e-2 /
atol 5e-3; on non-flip home-steps cost within rtol 1e-2 / atol 2e-3,
temperatures within 1e-2 degC, battery series within 5e-3; flip
home-steps within one count's worth (cost < 0.5, temperatures < 1 degC).
A first-order iterate at eps 1e-4 is pinned only to O(eps), and the two
packages stop at different points inside that ball.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu import data as jd
from dragg_tpu import engine as je
from dragg_tpu import homes as jh
from dragg_tpu_torch import engine as te
from dragg_tpu_torch.config import default_config

N_STEPS, K = 6, 4


def _config(bucketed="auto", **tpu):
    cfg = default_config()
    cfg["community"].update(total_number_homes=8, homes_pv=2, homes_battery=2,
                            homes_pv_battery=2)
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["home"]["hems"]["solver"] = "reluqp"
    cfg["tpu"].update(bucketed=bucketed, admm_refactor_every=K, **tpu)
    return cfg


def _inputs(cfg):
    env = jd.load_environment(cfg)
    wd = jd.load_waterdraw_profiles(jd.waterdraw_path(cfg, None), seed=12)
    batch = jh.build_home_batch(jh.create_homes(cfg, 24, 1, wd), 4, 1, 6)
    start = env.start_index(jd.parse_dt(cfg["simulation"]["start_datetime"]))
    return batch, env, start


@pytest.fixture(scope="module", params=["true", "false"])
def jax_run(request):
    cfg = _config(request.param)
    batch, env, start = _inputs(cfg)
    ej = je.make_engine(batch, env, cfg, start)
    assert ej.params.solver == "reluqp" and ej.bucketed == (request.param == "true")
    _, out = ej.run_chunk(ej.init_state(), 0, np.zeros((N_STEPS, 4), np.float32))
    return request.param, out, float(ej.params.s)


def _assert_outputs_match_flip_aware(out_ref, out_cmp, s):
    """tests/test_reluqp.py's assertion set (see the module docstring)."""
    ref = {f: np.asarray(getattr(out_ref, f)) for f in out_cmp._fields}
    cmp = {f: getattr(out_cmp, f).numpy() for f in out_cmp._fields}

    np.testing.assert_array_equal(cmp["correct_solve"], ref["correct_solve"])

    flip = np.zeros(ref["cost"].shape, bool)
    exact = total = 0
    for key in ("hvac_cool_on", "hvac_heat_on", "wh_heat_on"):
        dc = np.abs(cmp[key] * s - ref[key] * s)
        assert np.max(dc) <= 1 + 1e-3, key
        flip |= dc > 1e-3
        exact += int(np.sum(dc < 1e-3))
        total += dc.size
    assert exact / total >= 0.95, f"only {exact}/{total} actions match"
    assert flip.mean() <= 0.02, f"{flip.sum()} flip home-steps (> 2 %)"

    np.testing.assert_allclose(cmp["agg_cost"], ref["agg_cost"], rtol=1e-2, atol=5e-3)
    np.testing.assert_allclose(cmp["agg_load"], ref["agg_load"], rtol=1e-2, atol=5e-3)

    nf = ~flip
    np.testing.assert_allclose(cmp["cost"][nf], ref["cost"][nf], rtol=1e-2, atol=2e-3)
    np.testing.assert_allclose(cmp["temp_in"][nf], ref["temp_in"][nf], atol=1e-2)
    np.testing.assert_allclose(cmp["temp_wh"][nf], ref["temp_wh"][nf], atol=1e-2)
    np.testing.assert_allclose(cmp["e_batt"][nf], ref["e_batt"][nf], atol=5e-3)
    np.testing.assert_allclose(cmp["p_batt_ch"][nf], ref["p_batt_ch"][nf], atol=5e-3)
    np.testing.assert_allclose(cmp["p_batt_disch"][nf], ref["p_batt_disch"][nf],
                               atol=5e-3)
    if flip.any():
        assert np.max(np.abs(cmp["cost"][flip] - ref["cost"][flip])) < 0.5
        assert np.max(np.abs(cmp["temp_in"][flip] - ref["temp_in"][flip])) < 1.0
        assert np.max(np.abs(cmp["temp_wh"][flip] - ref["temp_wh"][flip])) < 1.0


@pytest.mark.parametrize("iter_kernel", ["lax", "pallas"])
def test_engine_matches_jax_across_a_bank_refresh(jax_run, iter_kernel):
    bucketed, out_j, s = jax_run
    cfg = _config(bucketed, iter_kernel=iter_kernel)
    batch, env, start = _inputs(cfg)
    et = te.make_engine(batch, env, cfg, start, device="cpu")
    assert et.iter_kernel == iter_kernel
    _, out_t = et.run_chunk(et.init_state(), 0, np.zeros((N_STEPS, 4), np.float32))
    assert set(te.StepOutputs._fields) == set(je.StepOutputs._fields)
    _assert_outputs_match_flip_aware(out_j, out_t, s)
    np.testing.assert_array_equal(out_t.bank_fallback_count.numpy(),
                                  np.asarray(out_j.bank_fallback_count))
    assert float(out_t.correct_solve.float().mean()) > 0.5


@pytest.mark.parametrize("t0,want", [
    (0, [True, False, False, False, True, False]),
    (2, [True, False, True, False, False, False]),
])
def test_run_chunk_refresh_cadence(monkeypatch, t0, want):
    """The bank refreshes on a chunk's first step and on every sim step t
    with t % admm_refactor_every == 0 (dragg_tpu/engine.py _chunk); a
    single ``step`` always refreshes."""
    cfg = _config("false")
    batch, env, start = _inputs(cfg)
    et = te.make_engine(batch, env, cfg, start, device="cpu")
    seen = []
    solve = te.reluqp_solve_qp_cached

    def spy(*args, **kwargs):
        seen.append(bool(args[7]))
        return solve(*args, **kwargs)

    monkeypatch.setattr(te, "reluqp_solve_qp_cached", spy)
    state, _ = et.run_chunk(et.init_state(), t0, np.zeros((N_STEPS, 4), np.float32))
    assert seen == want
    seen.clear()
    et.step(state, t0 + N_STEPS, np.zeros(4, np.float32))
    assert seen == [True]


def test_iter_kernel_resolution():
    batch, env, start = _inputs(_config())
    assert te.make_engine(batch, env, _config(), start, device="cpu").iter_kernel == "lax"
    cfg = _config(iter_kernel="pallas")
    assert te.make_engine(batch, env, cfg, start, device="cpu").iter_kernel == "pallas"
    assert te.engine_params(cfg, 0).iter_kernel == "pallas"
    with pytest.raises(ValueError, match="precision"):
        te.engine_params(_config(iter_kernel="pallas", precision="bf16x3"), 0)
    with pytest.raises(ValueError, match="iter_kernel"):
        te.engine_params(_config(iter_kernel="triton"), 0)


def test_engine_params_read_as_jax():
    cfg = _config(reluqp_bank=7, reluqp_iters=500, admm_patience=3)
    pt, pj = te.engine_params(cfg, 0), je.engine_params(cfg, 0)
    for f in ("solver", "admm_eps", "admm_sigma", "admm_alpha", "admm_patience",
              "admm_refactor_every", "reluqp_rho", "reluqp_rho_factor", "reluqp_bank",
              "reluqp_iters", "reluqp_tail_iters", "precision", "iter_kernel"):
        assert getattr(pt, f) == getattr(pj, f), f


def test_admm_still_raises():
    """Once a raise: the ADMM now builds the JAX engine's parameters."""
    cfg = _config()
    cfg["home"]["hems"]["solver"] = "admm"
    pt, pj = te.engine_params(cfg, 0), je.engine_params(cfg, 0)
    assert pt.solver == pj.solver == "admm"
    for f in ("admm_iters", "admm_eps", "admm_patience", "admm_refactor_every",
              "admm_rho_update_every", "admm_refine", "admm_solve_backend", "precision"):
        assert getattr(pt, f) == getattr(pj, f), f
