"""The port's fleet RL cores (dragg_tpu_torch/rl/fleet.py) against the JAX
package's dragg_tpu/rl/fleet.py on the CPU, inputs made from a numpy seed.

* ``fleet_params_from_config``: the same FleetParams and the same
  ValueError messages.
* ``community_noise_keys`` and ``_learner_key`` bit for bit; community 0
  of a C = 2 stream is the C = 1 stream, community 1 the stream of a run
  alone at ``random_seed + seed_stride``.
* ``event_feature_table`` equal, and ``traced_event_features`` within
  1e-6, on a timeline with all three event kinds (tariff shock, DR call,
  outage), its windows clamped at the series' end included.
* ``fleet_linear_step`` (score and mpc gradient) and ``fleet_ddpg_step``
  over 40 steps of C = 2 from carries converted by ``interop``, fed the
  same observations (the ranges an rl_agg run feeds the agent, as
  tests/test_torch_rl_core.py): keys, ``i`` and ``t`` equal, actions, θ
  and the records within 1e-4 of the largest magnitude of their JAX
  values.  With C = 2 the shared replay holds t·C transitions before
  step t (0-based), so the ridge refit (t·C > 32: from t = 17) and the
  DDPG updates (t·C ≥ 32: from t = 16) fire inside the 40 steps.
* The per-community mode (C single cores stacked on a leading axis, run
  community by community) against the JAX package's vmapped cores, both
  agents, the same 40 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu.rl import core as jcore
from dragg_tpu.rl import fleet as jfleet
from dragg_tpu.rl import neural as jneural
from dragg_tpu.scenarios.timeline import build_timeline as jbuild_timeline
from dragg_tpu_torch import interop
from dragg_tpu_torch.checkpoint import tree_flatten, tree_leaves
from dragg_tpu_torch.config import default_config
from dragg_tpu_torch.rl import core as tcore
from dragg_tpu_torch.rl import fleet as tfleet
from dragg_tpu_torch.rl import neural as tneural
from dragg_tpu_torch.scenarios.timeline import build_timeline as tbuild_timeline

C = 2
STEPS = 40
TOL = 1e-4

EVENTS = [
    dict(kind="tariff_shock", start_hour=3, duration_hours=3, repeat_hours=12,
         price_delta=0.05, communities=[1]),
    dict(kind="dr", start_hour=2, duration_hours=2, p_cap_kw=2.0,
         comfort_relax_degc=1.5),
    dict(kind="outage", start_hour=9, duration_hours=2, comfort_relax_degc=2.0,
         communities=[0]),
]


def _config(agent="linear", **fleet):
    cfg = default_config()
    cfg["rl"]["parameters"]["agent"] = agent
    cfg["fleet"].update(communities=C, seed_stride=5)
    cfg["rl"]["fleet"].update(fleet)
    return cfg


def _observations(seed: int, n: int) -> np.ndarray:
    """(n, C, 10) float32: the five observation fields (forecast error,
    trend, time of day, change in action, reward ≤ 0), four event
    features (zero in a third of the steps) and d(reward)/d(action)."""
    rs = np.random.RandomState(seed)
    o = np.zeros((n, C, 10), np.float32)
    o[..., 0] = rs.uniform(-0.3, 0.3, (n, C))
    o[..., 1] = rs.uniform(-0.1, 0.1, (n, C))
    o[..., 2] = ((np.arange(n) % 24) / 24)[:, None]
    o[..., 3] = rs.uniform(-0.04, 0.04, (n, C))
    o[..., 4] = -rs.uniform(0.0, 0.3, (n, C)) ** 2
    o[..., 5:9] = rs.uniform(0.0, 1.0, (n, C, 4)) * (np.arange(n) % 3 != 0)[:, None, None]
    o[..., 9] = rs.uniform(-0.5, 0.5, (n, C))
    return o


def _jfobs(row):
    return jfleet.FleetObservation(
        obs=jcore.RLObservation(*(jnp.asarray(row[:, k]) for k in range(5))),
        events=jnp.asarray(row[:, 5:9]), drda=jnp.asarray(row[:, 9]))


def _tfobs(row):
    row = torch.from_numpy(row)
    return tfleet.FleetObservation(
        obs=tcore.RLObservation(*(row[:, k] for k in range(5))),
        events=row[:, 5:9], drda=row[:, 9])


def _np(tree) -> dict:
    return jax.tree.map(np.asarray, tree)._asdict()


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want), initial=0.0)
                 / max(np.max(np.abs(want), initial=0.0), 1e-30))


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("fleet", [
    {}, {"learner_batch": 64}, {"policy": "per_community"}, {"gradient": "mpc"},
    {"mpc_weight": 0.5, "event_features": False},
    {"policy": "bogus"}, {"gradient": "exact"},
    {"policy": "per_community", "gradient": "mpc"},
])
def test_fleet_params_match_jax(fleet):
    cfg = _config(**fleet)
    try:
        want = jfleet.fleet_params_from_config(cfg, 4)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfleet.fleet_params_from_config(cfg, 4)
        assert str(got.value) == str(e)
        return
    assert tuple(tfleet.fleet_params_from_config(cfg, 4)) == tuple(want)


# ---------------------------------------------------------------- streams
def test_noise_and_learner_keys_are_jaxs():
    cfg = _config()
    cfg["fleet"]["seed_stride"] = 7
    base = int(cfg["simulation"]["random_seed"])
    np.testing.assert_array_equal(tfleet.community_seeds(cfg, 2), [base, base + 7])
    k2 = tfleet.community_noise_keys(cfg, 2, "cpu")
    np.testing.assert_array_equal(k2.numpy(), np.asarray(jfleet.community_noise_keys(cfg, 2)))
    np.testing.assert_array_equal(tfleet._learner_key(cfg, "cpu").numpy(),
                                  np.asarray(jfleet._learner_key(cfg)))
    # Community 0 of a C = 2 stream is the C = 1 stream; community 1 the
    # stream of a run alone at base + stride.
    assert torch.equal(k2[0], tfleet.community_noise_keys(cfg, 1, "cpu")[0])
    cfg["simulation"]["random_seed"] = base + 7
    assert torch.equal(k2[1], tfleet.community_noise_keys(cfg, 1, "cpu")[0])


# --------------------------------------------------------- event features
def test_event_features_match_jax():
    t_env, max_rp, H = 30, 0.02, 4
    jtl = jbuild_timeline(EVENTS, C, t_env, 1, 0)
    ttl = tbuild_timeline(EVENTS, C, t_env, 1, 0)
    want = jfleet.event_feature_table(jtl, 0, 28, 2, max_rp)
    got = tfleet.event_feature_table(ttl, 0, 28, 2, max_rp)
    np.testing.assert_array_equal(got, want)
    for f in range(4):  # every feature is live somewhere
        assert np.any(want[:, :, f] != 0), f
    evt = {"price": jtl.price, "cap": jtl.cap, "relax": jtl.relax}
    jevt = {k: jnp.asarray(v) for k, v in evt.items()}
    tevt = {k: torch.from_numpy(np.asarray(v)) for k, v in evt.items()}
    seen = np.zeros(4, bool)
    for start in range(t_env):  # the last windows are clamped to fit
        w = np.asarray(jax.jit(lambda e, s: jfleet.traced_event_features(
            e, s, C, H, max_rp))(jevt, start))
        g = tfleet.traced_event_features(tevt, start, C, H, max_rp).numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=str(start))
        seen |= np.any(w != 0, axis=0)
    assert seen.all()
    # Absent families give exact zeros.
    g = tfleet.traced_event_features({"price": tevt["price"]}, 3, C, H, max_rp).numpy()
    assert np.all(g[:, 1:] == 0) and np.any(g[:, 0] != 0)


# ------------------------------------------------------------ shared cores
def _run_pair(jinit, tinit, jstep, tstep, obs, check):
    jc, tc = jinit, tinit
    jstep = jax.jit(jstep)
    for k in range(STEPS):
        jc, jr = jstep(jc, _jfobs(obs[k]))
        tc, tr = tstep(tc, _tfobs(obs[k]))
        check(k, jc, tc)
        for name in tcore.StepRecord._fields:
            assert _rel(getattr(tr, name), getattr(jr, name)) <= TOL, (k, name)
    return jc, tc


@pytest.mark.parametrize("gradient", ["score", "mpc"])
def test_fleet_linear_step_matches_jax(gradient):
    cfg = _config(gradient=gradient)
    jp, tp = jcore.params_from_config(cfg), tcore.params_from_config(cfg)
    jfp, tfp = jfleet.fleet_params_from_config(cfg, C), tfleet.fleet_params_from_config(cfg, C)
    jc = jfleet.init_fleet_linear(jp, jfp, cfg)
    tc = tfleet.init_fleet_linear(tp, tfp, cfg, "cpu")
    want0 = interop.fleet_linear_carry_from_numpy(_np(jc), "cpu")
    for name, a, b in zip(tfleet.FleetLinearCarry._fields, tree_leaves(tc), tree_leaves(want0)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    fired = []

    def check(k, jc, tc):
        want = interop.fleet_linear_carry_from_numpy(_np(jc), "cpu")
        for name in ("key", "comm_keys", "i", "t"):
            assert torch.equal(getattr(tc, name), getattr(want, name)), (k, name)
        for name in ("theta_mu", "theta_q", "next_action", "z_theta_mu", "avg_reward",
                     "cum_reward", "mem_s", "mem_a", "mem_r", "mem_s1"):
            assert _rel(getattr(tc, name), getattr(want, name)) <= TOL, (k, name)
        fired.append(np.asarray(jc.theta_q).copy())

    _run_pair(jc, tc, lambda c, o: jfleet.fleet_linear_step(c, o, jp, jfp),
              lambda c, o: tfleet.fleet_linear_step(c, o, tp, tfp),
              _observations(1, STEPS), check)
    # The refit blends a column once the shared replay holds more than
    # learner_batch transitions: t·C > 32 from step t = 17 on.
    moved = [k for k in range(1, STEPS) if not np.array_equal(fired[k], fired[k - 1])]
    assert moved == list(range(17, STEPS))


def _groups(carry) -> list[list[torch.Tensor]]:
    """A DDPG carry's array leaves grouped by network (weights, each Adam
    moment), every other leaf alone."""
    out = []
    for name in carry._fields:
        v = getattr(carry, name)
        if isinstance(v, dict):
            out.append(list(v.values()))
        elif isinstance(v, tneural.AdamState):
            out += [list(v.mu.values()), list(v.nu.values())]
        elif v.is_floating_point() and v.ndim:
            out.append([v])
    return out


def _check_ddpg(k, got, want):
    for name in ("key", "t"):
        assert torch.equal(getattr(got, name), getattr(want, name)), (k, name)
    for i, (g, w) in enumerate(zip(_groups(got), _groups(want))):
        scale = max(float(b.abs().max()) for b in w)
        err = max(float((a - b).abs().max()) for a, b in zip(g, w))
        assert err <= TOL * max(scale, 1e-30), (k, i, err, scale)


@pytest.mark.parametrize("gradient", ["score", "mpc"])
def test_fleet_ddpg_step_matches_jax(gradient):
    cfg = _config("ddpg", gradient=gradient)
    jp, tp = jneural.params_from_config(cfg), tneural.params_from_config(cfg)
    jfp, tfp = jfleet.fleet_params_from_config(cfg, C), tfleet.fleet_params_from_config(cfg, C)
    jc = jfleet.init_fleet_ddpg(jp, jfp, cfg)
    tc = tfleet.init_fleet_ddpg(tp, tfp, cfg, "cpu")
    want0 = interop.fleet_ddpg_carry_from_numpy(_np(jc), "cpu")
    gl, wl = tree_leaves(tc), tree_leaves(want0)
    assert len(gl) == len(wl) == len(jax.tree_util.tree_leaves(jc))
    for a, b in zip(gl, wl):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert tc.actor["l0.weight"].shape == (tp.hidden, tfleet.FLEET_STATE_SCALARS)
    actor = []

    def check(k, jc, tc):
        assert torch.equal(tc.comm_keys, torch.from_numpy(np.array(jc.comm_keys)).long())
        _check_ddpg(k, tc, interop.fleet_ddpg_carry_from_numpy(_np(jc), "cpu"))
        actor.append(tc.actor["l0.weight"].clone())

    _run_pair(jc, tc, lambda c, o: jfleet.fleet_ddpg_step(c, o, jp, jfp),
              lambda c, o: tfleet.fleet_ddpg_step(c, o, tp, tfp),
              _observations(3, STEPS), check)
    # Frozen while the shared replay holds fewer than 32 transitions
    # (t·C < 32), then the actor moves every policy_delay steps.
    moved = [k for k in range(1, STEPS) if not torch.equal(actor[k], actor[k - 1])]
    assert moved[0] == 16 and moved == list(range(16, STEPS, tp.policy_delay))


# ------------------------------------------------------- per-community mode
@pytest.mark.parametrize("agent", ["linear", "ddpg"])
def test_per_community_mode_matches_jax(agent):
    cfg = _config(agent, policy="per_community")
    jagent = jfleet.FleetAgent(cfg, C)
    tagent = tfleet.FleetAgent(cfg, C, device="cpu")
    convert = (interop.agent_carry_from_numpy if agent == "linear"
               else interop.ddpg_carry_from_numpy)
    want0 = convert(_np(jagent.carry), "cpu")
    gl, wl = tree_leaves(tagent.carry), tree_leaves(want0)
    assert len(gl) == len(wl) and all(a.shape[0] == C for a in gl)
    for a, b in zip(gl, wl):
        assert a.dtype == b.dtype and torch.equal(a, b)

    def check(k, jc, tc):
        want = convert(_np(jc), "cpu")
        assert torch.equal(tc.key, want.key) and torch.equal(tc.t, want.t), k
        if agent == "ddpg":
            _check_ddpg(k, tc, want)
            return
        for name in ("theta_mu", "theta_q", "next_action", "z_theta_mu"):
            assert _rel(getattr(tc, name), getattr(want, name)) <= TOL, (k, name)

    jc, tc = _run_pair(jagent.carry, tagent.carry, jagent.scan_step, tagent.scan_step,
                       _observations(5, STEPS), check)
    # The communities learn apart.
    assert not torch.equal(tree_flatten(tc)[0][0][0], tree_flatten(tc)[0][0][1])
