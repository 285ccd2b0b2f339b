"""The port's linear RL agent (dragg_tpu_torch/rl/{basis,core,env,agent}.py)
against the JAX package's, on the CPU, inputs made from a numpy seed.

* The bases within 1e-6.
* ``init_carry`` equal to the JAX package's, key and θ_q bit for bit.
* 40 ``train_step``s from one carry carried across (the JAX package's
  fresh carry), fed the same observations, so the ridge refit fires
  (from step 34, ``(t - 1) > batch_size``): the key stream, the replay
  indices, ``i`` and ``t`` equal; θ_μ, θ_q and ``next_action`` within
  1e-4 of the largest magnitude of their JAX values (``jnp.linalg.solve``
  and ``torch.linalg.solve`` on the 71 × 71 float32 Gram matrix do not
  agree to the bit; ~1e-6 is seen).  The observations lie in the ranges an
  rl_agg run feeds the agent (normalized errors within ±0.3, action
  changes within the ±0.02 action space); far outside them (uniform in
  ±1) the reference's policy update runs away in both packages alike, and
  the 32-sample ridge on such features is too ill-conditioned for any two
  float32 solvers to agree.
* The environment's observation and setpoint tracker, and the host agent
  API (``train``, ``get_policy_action``, ``load_from_previous``).
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu.rl import basis as jbasis
from dragg_tpu.rl import core as jcore
from dragg_tpu.rl import env as jenv
from dragg_tpu.rl.agent import UtilityAgent as JaxUtilityAgent
from dragg_tpu_torch import interop, rng
from dragg_tpu_torch.checkpoint import tree_leaves
from dragg_tpu_torch.config import default_config
from dragg_tpu_torch.rl import basis as tbasis
from dragg_tpu_torch.rl import core as tcore
from dragg_tpu_torch.rl import env as tenv
from dragg_tpu_torch.rl.agent import UtilityAgent

STEPS = 40
TOL = 1e-4


def _config(agent="linear"):
    cfg = default_config()
    cfg["rl"]["parameters"]["agent"] = agent
    return cfg


def _observations(seed: int, n: int) -> np.ndarray:
    """(n, 5) float32 rows: forecast error, trend, time of day (hourly),
    change in action, reward (≤ 0)."""
    rs = np.random.RandomState(seed)
    o = np.zeros((n, 5), np.float32)
    o[:, 0] = rs.uniform(-0.3, 0.3, n)
    o[:, 1] = rs.uniform(-0.1, 0.1, n)
    o[:, 2] = (np.arange(n) % 24) / 24
    o[:, 3] = rs.uniform(-0.04, 0.04, n)
    o[:, 4] = -rs.uniform(0.0, 0.3, n) ** 2
    return o


def _jobs(row):
    return jcore.RLObservation(*(jnp.float32(v) for v in row))


def _tobs(row):
    return tcore.RLObservation(*(torch.tensor(v) for v in row))


def _to_numpy(carry) -> dict:
    return jax.tree.map(np.asarray, carry)._asdict()


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want), initial=0.0)
                 / max(np.max(np.abs(want), initial=0.0), 1e-30))


def test_bases_match():
    x = np.random.RandomState(0).uniform(-2.0, 2.0, (64, 5)).astype(np.float32)
    x[:, 2] = np.abs(x[:, 2]) / 2
    js = np.asarray(jax.vmap(jbasis.state_basis)(*(x[:, k] for k in range(3))))
    jsa = np.asarray(jax.vmap(jbasis.state_action_basis)(*(x[:, k] for k in range(5))))
    ts = tbasis.state_basis(*(torch.from_numpy(x[:, k]) for k in range(3))).numpy()
    tsa = tbasis.state_action_basis(*(torch.from_numpy(x[:, k]) for k in range(5))).numpy()
    assert ts.shape == (64, tbasis.STATE_DIM) and tsa.shape == (64, tbasis.STATE_ACTION_DIM)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tsa, jsa, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("twin_q", [True, False])
def test_init_carry_is_jaxs(twin_q):
    cfg = _config()
    cfg["rl"]["parameters"]["twin_q"] = twin_q
    jp, tp = jcore.params_from_config(cfg), tcore.params_from_config(cfg)
    assert tuple(tp) == tuple(jp)
    want = interop.agent_carry_from_numpy(_to_numpy(jcore.init_carry(jp, 12)), "cpu")
    got = tcore.init_carry(tp, 12, "cpu")
    for name, a, b in zip(tcore.AgentCarry._fields, tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _replay_indices(carry_before: tcore.AgentCarry, batch: int) -> np.ndarray:
    """The replay indices the step from ``carry_before`` draws, from its key
    (the JAX package's _ridge_update: split(key, 3)[2] → split → randint)."""
    k_ridge = rng.split(carry_before.key, 3)[2]
    kidx = rng.split(k_ridge, 2)[0]
    valid = min(int(carry_before.t), tcore.MEMORY_CAP)
    return rng.randint(kidx, batch, 0, max(valid, 1)).numpy()


def test_train_steps_match_jax():
    cfg = _config()
    jp, tp = jcore.params_from_config(cfg), tcore.params_from_config(cfg)
    jc = jcore.init_carry(jp, 12)
    tc = interop.agent_carry_from_numpy(_to_numpy(jc), "cpu")
    step = jax.jit(lambda c, o: jcore.train_step(c, o, jp))
    obs = _observations(1, STEPS)
    fired = 0
    for k in range(STEPS):
        # The replay indices JAX draws at this step, from its own key.
        jkey = jc.key
        k_ridge = jax.random.split(jkey, 3)[2]
        kidx = jax.random.split(k_ridge)[0]
        jidx = np.asarray(jax.random.randint(kidx, (jp.batch_size,), 0,
                                             jnp.maximum(jnp.minimum(jc.t, 2048), 1)))
        np.testing.assert_array_equal(_replay_indices(tc, tp.batch_size), jidx)
        theta_q_before = np.asarray(jc.theta_q)
        jc, jr = step(jc, _jobs(obs[k]))
        tc, tr = tcore.train_step(tc, _tobs(obs[k]), tp)
        want = interop.agent_carry_from_numpy(_to_numpy(jc), "cpu")
        for name in ("key", "i", "t"):
            assert torch.equal(getattr(tc, name), getattr(want, name)), (k, name)
        for name in ("theta_mu", "theta_q", "next_action", "z_theta_mu", "avg_reward",
                     "mem_s", "mem_a", "mem_r", "mem_s1"):
            assert _rel(getattr(tc, name), getattr(want, name)) <= TOL, (k, name)
        for name in tcore.StepRecord._fields:
            assert _rel(getattr(tr, name), getattr(jr, name)) <= TOL, (k, name)
        fired += not np.array_equal(np.asarray(jc.theta_q), theta_q_before)
    # The ridge refit fires from step 34 (post-increment t - 1 > 32) on.
    assert fired == STEPS - 33


def test_env_observe_and_tracker_match_jax():
    rs = np.random.RandomState(2)
    vals = rs.uniform(5.0, 50.0, 6).astype(np.float32)
    je = jenv.init_env_carry(7, 5, 60.0)
    te = tenv.init_env_carry(7, 5, 60.0, "cpu")
    np.testing.assert_array_equal(te.tracker.tracked.numpy(), np.asarray(je.tracker.tracked))
    for t, v in enumerate(vals):
        jt, jsp = jenv.tracker_step(je.tracker, jnp.float32(v), t)
        tt, tsp = tenv.tracker_step(te.tracker, torch.tensor(v), t)
        np.testing.assert_allclose(tt.tracked.numpy(), np.asarray(jt.tracked), rtol=0, atol=0)
        np.testing.assert_allclose(float(tsp), float(jsp), rtol=1e-6)
        je = je._replace(agg_load=jnp.float32(v), setpoint=jsp, tracker=jt,
                         action=jnp.float32(0.01 * t))
        te = te._replace(agg_load=torch.tensor(v), setpoint=tsp, tracker=tt,
                         action=torch.tensor(np.float32(0.01 * t)))
        for dt in (1, 4):
            jo, to = jenv.observe(je, t * 5, dt, 60.0), tenv.observe(te, t * 5, dt, 60.0)
            for name in tcore.RLObservation._fields:
                np.testing.assert_allclose(float(getattr(to, name)), float(getattr(jo, name)),
                                           rtol=1e-6, atol=1e-7, err_msg=name)
    jl, jc = jenv.simplified_response(jnp.float32(9.0), jnp.float32(0.02), jnp.float32(8.0), 0.3)
    tl, tc = tenv.simplified_response(torch.tensor(9.0), torch.tensor(0.02), torch.tensor(8.0),
                                      0.3)
    assert (float(tl), float(tc)) == (float(jl), float(jc))


def _env_ns(t):
    return SimpleNamespace(agg_load=12.0 + t, forecast_load=11.5 + t, prev_forecast_load=11.0,
                           agg_setpoint=12.5, timestep=t, dt=1, norm=40.0,
                           prev_action=0.0, action=0.01)


def test_host_agent_api_matches_jax(tmp_path):
    cfg = _config()
    ja, ta = JaxUtilityAgent(cfg), UtilityAgent(cfg, device="cpu")
    for t in range(5):
        e = _env_ns(t)
        assert ta.calc_state(e) == pytest.approx(ja.calc_state(e), rel=1e-6, abs=1e-7)
        assert ta.train(e) == pytest.approx(ja.train(e), rel=1e-5, abs=1e-7)
    state = ja.calc_state(_env_ns(5))
    assert ta.get_policy_action(state) == pytest.approx(ja.get_policy_action(state), rel=1e-5)
    assert torch.equal(ta.carry.key, torch.from_numpy(np.asarray(ja.carry.key).astype(np.int64)))
    assert set(ta.rl_data) == set(ja.rl_data) and ta.rl_data["parameters"] == ja.rl_data[
        "parameters"]
    ta.write_rl_data(str(tmp_path))
    fresh = UtilityAgent(cfg, device="cpu")
    fresh.load_from_previous(str(tmp_path / "utility_agent-results.json"))
    with open(tmp_path / "utility_agent-results.json") as f:
        data = json.load(f)
    np.testing.assert_array_equal(fresh.carry.theta_mu.numpy(),
                                  np.float32(data["theta_mu"][-1]))
    assert fresh.carry.theta_q.shape == (tbasis.STATE_ACTION_DIM, 2)
    with pytest.raises(ValueError, match="linear agent"):
        UtilityAgent(_config("ddpg"), device="cpu").load_from_previous(
            str(tmp_path / "utility_agent-results.json"))
    with pytest.raises(ValueError, match="Unknown rl.parameters.agent"):
        UtilityAgent(_config("sarsa"), device="cpu")
