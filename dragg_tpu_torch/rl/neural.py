"""The DDPG twin-Q agent (counterpart of ``dragg_tpu/rl/neural.py``).

The same step contract as the linear core (:mod:`dragg_tpu_torch.rl.core`):
the 4-scalar observation, a replay buffer, a batch critic fit and a policy
step, with MLPs trained by Adam in place of the hand-built bases fit by
ridge regression, and TD3's twin critics with a min target, target
networks moved by Polyak averaging and a delayed actor.

The networks are ``nn.Module`` MLPs run functionally
(``torch.func.functional_call``) on weights held in the carry as dicts
keyed by the module's parameter names, so the carry, Adam's moments
included, is the whole state: gradients come from ``torch.autograd.grad``
and no optimizer object lives outside it.  Adam is written out as the JAX
package writes it (bias correction with a float32 count), not taken from
``torch.optim``.  The weights start as flax's ``Dense`` start them
(lecun-normal kernels, zero biases, flax's per-layer keys), transposed
into ``nn.Linear``'s (out, in) layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.func import functional_call

from dragg_tpu_torch import rng
from dragg_tpu_torch.rl.core import RLObservation, StepRecord, memorize, obs_to_state

MEMORY_CAP = 2048  # replay capacity, as the linear core's
STATE_DIM = 4
ACTION_DIM = 1
F32 = torch.float32


class DDPGParams(NamedTuple):
    """Static hyperparameters (``tpu.ddpg_*`` for the learning rates, τ,
    the actor delay and the width; the rest from [rl.parameters])."""

    sigma: float        # exploration noise std (the reference's epsilon)
    beta: float         # discount
    batch_size: int
    actor_lr: float
    critic_lr: float
    tau: float          # Polyak target-update rate
    policy_delay: int   # actor / target update cadence in steps (TD3)
    action_low: float
    action_high: float
    hidden: int         # MLP width


class MLP(nn.Module):
    """Two tanh hidden layers and a linear output; a tanh head for the
    actor.  The layers are flax's ``Dense_0..2``."""

    def __init__(self, n_in: int, hidden: int, out: int, tanh_out: bool = False):
        super().__init__()
        self.l0 = nn.Linear(n_in, hidden)
        self.l1 = nn.Linear(hidden, hidden)
        self.l2 = nn.Linear(hidden, out)
        self.tanh_out = tanh_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.tanh(self.l0(x))
        x = torch.tanh(self.l1(x))
        x = self.l2(x)
        return torch.tanh(x) if self.tanh_out else x


class AdamState(NamedTuple):
    """Adam's moments, keyed as the weights, and its int32 step count."""

    mu: dict
    nu: dict
    count: torch.Tensor


class DDPGCarry(NamedTuple):
    """The agent's state between steps."""

    actor: dict
    critic1: dict
    critic2: dict
    t_actor: dict       # target networks
    t_critic1: dict
    t_critic2: dict
    opt_actor: AdamState
    opt_critic1: AdamState
    opt_critic2: AdamState
    state: torch.Tensor        # (4,)
    next_action: torch.Tensor  # ()
    avg_reward: torch.Tensor
    cum_reward: torch.Tensor
    t: torch.Tensor            # () int32
    mem_s: torch.Tensor        # (CAP, 4)
    mem_a: torch.Tensor        # (CAP,)
    mem_r: torch.Tensor        # (CAP,)
    mem_s1: torch.Tensor       # (CAP, 4)
    key: torch.Tensor


_NETS: dict = {}


def _nets(hidden: int, state_dim: int = STATE_DIM) -> tuple[MLP, MLP]:
    """The (actor, critic) modules of width ``hidden`` over ``state_dim``
    state scalars (4; the fleet's 4 + 4 with its event features) on the
    meta device: only their structure is used, the weights come from the
    carry (``functional_call`` swaps them in for the length of one call,
    so a module serves one call at a time)."""
    if (hidden, state_dim) not in _NETS:
        with torch.device("meta"):
            _NETS[hidden, state_dim] = (
                MLP(state_dim, hidden, ACTION_DIM, tanh_out=True),
                MLP(state_dim + ACTION_DIM, hidden, 1))
    return _NETS[hidden, state_dim]


def _init_net(key: torch.Tensor, n_in: int, hidden: int, out: int) -> dict:
    """flax ``init`` of the three-Dense MLP from ``key``, as ``nn.Linear``
    weights: kernel_i = lecun_normal(fold_in(key, hash("Dense_i", 1))),
    transposed; zero biases."""
    w = {}
    for i, (fi, fo) in enumerate(((n_in, hidden), (hidden, hidden), (hidden, out))):
        kernel = rng.lecun_normal(rng.flax_param_key(key, f"Dense_{i}"), fi, fo)
        # Bias before weight: the sorted key order, which is the order of
        # flax's leaves (bias, kernel) and of a checkpoint's.
        w[f"l{i}.bias"] = torch.zeros(fo, dtype=F32, device=key.device)
        w[f"l{i}.weight"] = kernel.T.contiguous()
    return w


def _tree(fn, *trees: dict) -> dict:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def _adam_init(params: dict) -> AdamState:
    return AdamState(mu=_tree(torch.zeros_like, params), nu=_tree(torch.zeros_like, params),
                     count=torch.zeros((), dtype=torch.int32,
                                       device=next(iter(params.values())).device))


def _adam_update(grads: dict, st: AdamState, params: dict, lr: float,
                 b1=0.9, b2=0.999, eps=1e-8):
    """Adam as ``dragg_tpu/rl/neural.py:_adam_update``: the bias correction
    1 - b**c with ``c`` the float32 step count."""
    count = st.count + 1
    mu = _tree(lambda m, g: b1 * m + (1 - b1) * g, st.mu, grads)
    nu = _tree(lambda v, g: b2 * v + (1 - b2) * g * g, st.nu, grads)
    c = count.to(F32)
    c1 = 1 - torch.pow(torch.full((), b1, dtype=F32, device=c.device), c)
    c2 = 1 - torch.pow(torch.full((), b2, dtype=F32, device=c.device), c)
    new = _tree(lambda p, m, v: p - lr * (m / c1) / (torch.sqrt(v / c2) + eps),
                params, mu, nu)
    return new, AdamState(mu=mu, nu=nu, count=count)


def gated_adam(gate: torch.Tensor, new_pair, old_params: dict, old_opt: AdamState):
    """(params, Adam state) updated where ``gate > 0``, else unchanged.
    Zero gradients would not freeze Adam (its momentum keeps moving the
    weights and the count skews the bias correction), so the whole update
    is switched."""
    new_params, new_opt = new_pair
    on = gate > 0
    pick = lambda a, b: _tree(lambda x, y: torch.where(on, x, y), a, b)  # noqa: E731
    return pick(new_params, old_params), AdamState(
        mu=pick(new_opt.mu, old_opt.mu), nu=pick(new_opt.nu, old_opt.nu),
        count=torch.where(on, new_opt.count, old_opt.count))


def _scale_action(raw: torch.Tensor, params: DDPGParams) -> torch.Tensor:
    """tanh output in [-1, 1] → the action space."""
    lo, hi = params.action_low, params.action_high
    return lo + (raw + 1.0) * 0.5 * (hi - lo)


def _mu(actor: dict, s: torch.Tensor, params: DDPGParams) -> torch.Tensor:
    a_net, _ = _nets(params.hidden, s.shape[-1])
    return _scale_action(functional_call(a_net, actor, (s,))[..., 0], params)


def _q(critic: dict, s: torch.Tensor, a: torch.Tensor, params: DDPGParams) -> torch.Tensor:
    _, c_net = _nets(params.hidden, s.shape[-1])
    return functional_call(c_net, critic, (torch.cat([s, a[..., None]], dim=-1),))[..., 0]


def _grad(loss_fn, params: dict) -> dict:
    """d loss / d params, the weights detached from everything else."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        grads = torch.autograd.grad(loss_fn(leaves), list(leaves.values()))
    return dict(zip(leaves, grads))


def init_carry(params: DDPGParams, seed: int, device) -> DDPGCarry:
    """A fresh agent on ``device``, the JAX package's weights: key
    PRNGKey(seed ^ 0xDD96) split into four (carry, actor, critic 1,
    critic 2)."""
    key, ka, k1, k2 = rng.split(rng.prng_key(seed ^ 0xDD96, device=device), 4)
    h = params.hidden
    actor = _init_net(ka, STATE_DIM, h, ACTION_DIM)
    critic1 = _init_net(k1, STATE_DIM + ACTION_DIM, h, 1)
    critic2 = _init_net(k2, STATE_DIM + ACTION_DIM, h, 1)
    z = lambda *shape: torch.zeros(shape, dtype=F32, device=device)  # noqa: E731
    return DDPGCarry(
        actor=actor, critic1=critic1, critic2=critic2,
        t_actor=_tree(torch.clone, actor), t_critic1=_tree(torch.clone, critic1),
        t_critic2=_tree(torch.clone, critic2),
        opt_actor=_adam_init(actor), opt_critic1=_adam_init(critic1),
        opt_critic2=_adam_init(critic2),
        state=z(STATE_DIM), next_action=z(), avg_reward=z(), cum_reward=z(),
        t=torch.zeros((), dtype=torch.int32, device=device),
        mem_s=z(MEMORY_CAP, STATE_DIM), mem_a=z(MEMORY_CAP), mem_r=z(MEMORY_CAP),
        mem_s1=z(MEMORY_CAP, STATE_DIM), key=key,
    )


def _polyak(target: dict, online: dict, tau: torch.Tensor) -> dict:
    return _tree(lambda t, o: (1 - tau) * t + tau * o, target, online)


def param_norm(p: dict) -> torch.Tensor:
    """√(Σ w²) over every weight of a network."""
    return torch.sqrt(sum(torch.sum(x * x) for x in p.values()))


def train_step(carry: DDPGCarry, obs: RLObservation, params: DDPGParams):
    """One DDPG step, the linear core's contract: observe → memorize →
    critic, actor and target updates → the next exploratory action.
    Returns (carry, StepRecord); the record's ``theta_q`` / ``theta_mu``
    hold the critic's and the actor's parameter norms."""
    next_state = obs_to_state(obs)
    first = carry.t == 0
    state = torch.where(first, next_state, carry.state)
    action = carry.next_action
    r = obs.reward.to(F32)

    key, k_next, k_idx = rng.split(carry.key, 3)
    mem_s, mem_a, mem_r, mem_s1 = memorize(carry, first, state, action, r, next_state)
    valid = torch.clamp(carry.t, max=MEMORY_CAP)

    B = params.batch_size
    idx = rng.randint(k_idx, B, 0, torch.clamp(valid, min=1))
    bs, ba, br, bs1 = mem_s[idx], mem_a[idx], mem_r[idx], mem_s1[idx]

    # Critic update: y = r + β·min_i Q_ti(s', μ_t(s')).
    a1 = _mu(carry.t_actor, bs1, params)
    y = br + params.beta * torch.minimum(_q(carry.t_critic1, bs1, a1, params),
                                         _q(carry.t_critic2, bs1, a1, params))

    def critic_loss(cp):
        return torch.mean((_q(cp, bs, ba, params) - y) ** 2)

    do_update = (carry.t >= B).to(F32)  # len(memory) > batch gate
    g1 = _grad(critic_loss, carry.critic1)
    g2 = _grad(critic_loss, carry.critic2)
    critic1, opt_c1 = gated_adam(
        do_update, _adam_update(g1, carry.opt_critic1, carry.critic1, params.critic_lr),
        carry.critic1, carry.opt_critic1)
    critic2, opt_c2 = gated_adam(
        do_update, _adam_update(g2, carry.opt_critic2, carry.critic2, params.critic_lr),
        carry.critic2, carry.opt_critic2)

    # Delayed actor update: maximize Q1(s, μ(s)).
    def actor_loss(ap):
        return -torch.mean(_q(critic1, bs, _mu(ap, bs, params), params))

    delay = max(1, params.policy_delay)
    do_actor = do_update * (torch.remainder(carry.t, delay) == 0).to(F32)
    ga = _grad(actor_loss, carry.actor)
    actor, opt_a = gated_adam(
        do_actor, _adam_update(ga, carry.opt_actor, carry.actor, params.actor_lr),
        carry.actor, carry.opt_actor)

    # Polyak target updates, on the actor's cadence.
    tau = params.tau * do_actor
    t_actor = _polyak(carry.t_actor, actor, tau)
    t_critic1 = _polyak(carry.t_critic1, critic1, tau)
    t_critic2 = _polyak(carry.t_critic2, critic2, tau)

    # The next exploratory action.
    mu_next = _mu(actor, next_state, params)
    noise = params.sigma * rng.normal(k_next, 1)[0]
    next_action = torch.clamp(mu_next + noise, params.action_low, params.action_high)

    q_pred = _q(carry.critic1, state[None, :], action[None], params)[0]
    q_obs = r + params.beta * q_pred  # one-step TD pair for the telemetry
    cum_reward = carry.cum_reward + r
    avg_reward = carry.avg_reward + (r - carry.avg_reward) / (carry.t.to(F32) + 1.0)

    new_carry = DDPGCarry(
        actor=actor, critic1=critic1, critic2=critic2,
        t_actor=t_actor, t_critic1=t_critic1, t_critic2=t_critic2,
        opt_actor=opt_a, opt_critic1=opt_c1, opt_critic2=opt_c2,
        state=next_state, next_action=next_action,
        avg_reward=avg_reward, cum_reward=cum_reward, t=carry.t + 1,
        mem_s=mem_s, mem_a=mem_a, mem_r=mem_r, mem_s1=mem_s1, key=key)
    record = StepRecord(
        theta_q=param_norm(critic1), theta_mu=param_norm(actor), q_obs=q_obs,
        q_pred=q_pred, action=action, average_reward=avg_reward,
        cumulative_reward=cum_reward, reward=r, mu=mu_next)
    return new_carry, record


def params_from_config(config: dict) -> DDPGParams:
    """[rl.parameters] and the ``tpu.ddpg_*`` knobs → DDPGParams."""
    p = config["rl"]["parameters"]
    space = config["rl"]["utility"]["action_space"]
    tpu = config.get("tpu", {})
    return DDPGParams(
        sigma=float(p["epsilon"]),
        beta=float(p["beta"]),
        batch_size=int(p["batch_size"]),
        actor_lr=float(tpu.get("ddpg_actor_lr", 1e-3)),
        critic_lr=float(tpu.get("ddpg_critic_lr", 1e-3)),
        tau=float(tpu.get("ddpg_tau", 0.01)),
        policy_delay=int(tpu.get("ddpg_policy_delay", 2)),
        action_low=float(space[0]),
        action_high=float(space[1]),
        hidden=int(tpu.get("ddpg_hidden", 64)),
    )
