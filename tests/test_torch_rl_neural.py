"""The port's DDPG twin-Q agent (dragg_tpu_torch/rl/neural.py) against the
JAX package's flax core, on the CPU, inputs made from a numpy seed.

* ``init_carry`` equals flax's initialization bit for bit (flax's
  per-layer keys and lecun-normal kernels, transposed into ``nn.Linear``'s
  layout), and its leaves flatten in the JAX carry's order.
* 40 ``train_step``s from one carry carried across: the key and ``t``
  equal; every weight, target weight and Adam moment within 1e-5 of the
  largest magnitude in the JAX values of its network (of its moment of
  its network: the output bias's moments are sums of residuals that
  nearly cancel), the replay buffers within 1e-5 of their largest
  magnitude, and each
  scalar series over the 40 steps (the next action and every step
  record) within 1e-5 of its largest magnitude over the run
  (``torch.autograd`` against ``jax.grad``, the float32 sums in another
  order: ~1e-6 is seen; the scalars pass near zero as differences, the
  action as the action space's bound plus the scaled tanh, the TD target
  as reward plus Q).
* The gated Adam freeze: before step 32 (``t < batch_size``) no weight and
  no Adam state moves, bit for bit; from step 32 the critics move every
  step and the actor and the targets every second step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu.rl import core as jcore
from dragg_tpu.rl import neural as jneural
from dragg_tpu_torch import interop
from dragg_tpu_torch.checkpoint import tree_leaves
from dragg_tpu_torch.config import default_config
from dragg_tpu_torch.rl import core as tcore
from dragg_tpu_torch.rl import neural as tneural

STEPS = 40
TOL = 1e-5
NETS = ("actor", "critic1", "critic2", "t_actor", "t_critic1", "t_critic2")


def _config():
    cfg = default_config()
    cfg["rl"]["parameters"]["agent"] = "ddpg"
    return cfg


def _observations(seed: int, n: int) -> np.ndarray:
    """(n, 5) float32 rows in the ranges an rl_agg run feeds the agent."""
    rs = np.random.RandomState(seed)
    o = np.zeros((n, 5), np.float32)
    o[:, 0] = rs.uniform(-0.3, 0.3, n)
    o[:, 1] = rs.uniform(-0.1, 0.1, n)
    o[:, 2] = (np.arange(n) % 24) / 24
    o[:, 3] = rs.uniform(-0.04, 0.04, n)
    o[:, 4] = -rs.uniform(0.0, 0.3, n) ** 2
    return o


def _port(carry) -> tneural.DDPGCarry:
    return interop.ddpg_carry_from_numpy(jax.tree.map(np.asarray, carry)._asdict(), "cpu")


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want), initial=0.0)
                 / max(np.max(np.abs(want), initial=0.0), 1e-30))



def test_init_carry_is_flaxs():
    cfg = _config()
    jp, tp = jneural.params_from_config(cfg), tneural.params_from_config(cfg)
    assert tuple(tp) == tuple(jp)
    jc = jneural.init_carry(jp, 12)
    got, want = tneural.init_carry(tp, 12, "cpu"), _port(jc)
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl) == len(jax.tree_util.tree_leaves(jc))
    for a, b in zip(gl, wl):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # The port's leaves in the JAX carry's flatten order: flax kernels
    # (in, out) are the transposes of nn.Linear's (out, in) weights.
    for a, b in zip(gl, jax.tree_util.tree_leaves(jc)):
        assert tuple(a.shape) in (b.shape, b.shape[::-1])
    assert got.actor["l0.weight"].shape == (tp.hidden, tneural.STATE_DIM)


def _groups(carry: tneural.DDPGCarry) -> list[list[torch.Tensor]]:
    """The carry's array leaves grouped by network: each network's weights,
    each Adam moment of each network, and every other leaf alone."""
    out = []
    for name in tneural.DDPGCarry._fields:
        v = getattr(carry, name)
        if isinstance(v, dict):
            out.append(list(v.values()))
        elif isinstance(v, tneural.AdamState):
            out += [list(v.mu.values()), list(v.nu.values())]
        elif v.shape:
            out.append([v])
    return out


def test_train_steps_match_jax_and_freeze():
    cfg = _config()
    jp, tp = jneural.params_from_config(cfg), tneural.params_from_config(cfg)
    jc = jneural.init_carry(jp, 12)
    tc = _port(jc)
    init = tc
    step = jax.jit(lambda c, o: jneural.train_step(c, o, jp))
    obs = _observations(3, STEPS)
    series = {"got": [], "want": []}
    for k in range(STEPS):
        prev = tc
        jc, jr = step(jc, jcore.RLObservation(*(jnp.float32(v) for v in obs[k])))
        tc, tr = tneural.train_step(tc, tcore.RLObservation(*(torch.tensor(v) for v in obs[k])),
                                    tp)
        want = _port(jc)
        assert torch.equal(tc.key, want.key) and torch.equal(tc.t, want.t), k
        for i, (got, ref) in enumerate(zip(_groups(tc), _groups(want))):
            scale = max(float(b.abs().max()) for b in ref)
            err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            assert err <= TOL * scale, (k, i, err, scale)
        series["got"].append([float(tc.next_action), *map(float, tr)])
        series["want"].append([float(jc.next_action), *map(float, jr)])
        frozen = lambda c: tree_leaves(tuple(getattr(c, n) for n in NETS)  # noqa: E731
                                       + (c.opt_actor, c.opt_critic1, c.opt_critic2))
        moved = [not torch.equal(a, b) for a, b in zip(frozen(tc), frozen(prev))]
        if k < tp.batch_size:
            # t < batch_size: the gated Adam leaves everything as it started.
            assert not any(moved), k
            assert all(torch.equal(a, b) for a, b in zip(frozen(tc), frozen(init))), k
        else:
            assert not torch.equal(tc.critic1["l2.weight"], prev.critic1["l2.weight"]), k
            assert int(tc.opt_critic1.count) == k - tp.batch_size + 1
            actor_moved = not torch.equal(tc.actor["l0.weight"], prev.actor["l0.weight"])
            target_moved = not torch.equal(tc.t_actor["l0.weight"], prev.t_actor["l0.weight"])
            assert actor_moved == target_moved == (k % tp.policy_delay == 0), k
    got, want = np.asarray(series["got"]), np.asarray(series["want"])
    for j, name in enumerate(("next_action", *tcore.StepRecord._fields)):
        assert _rel(got[:, j], want[:, j]) <= TOL, name
    # The actor's parameter norm is constant while frozen, then changes.
    actor_norms = got[:, 1 + tcore.StepRecord._fields.index("theta_mu")]
    assert len(set(actor_norms[:tp.batch_size])) == 1
    assert actor_norms[-1] != actor_norms[tp.batch_size - 1]
