"""The fleet form of the RL cases (counterpart of ``dragg_tpu/rl/fleet.py``).

With ``fleet.communities = C > 1`` the engine already solves C
independent communities in one batch; here the environment carry gains a
leading community axis, each community's aggregates come from the
engine's merged outputs (``Engine.community_fold_arrays``), and one step
of the loop trains the reward-price policy on all C rollout streams.

Two policy layouts (``[rl.fleet] policy``):

* ``"shared"``: C actors (each with its own exploration stream from its
  community's seed) feed one replay buffer, and one learner update a
  step trains one actor-critic, the linear core or DDPG.  Its state
  carries four event features per community (price shock, DR cap,
  outage, comfort relief over the upcoming window), so one policy learns
  across different event schedules.
* ``"per_community"``: C independent single-community cores
  (:mod:`~dragg_tpu_torch.rl.core`, :mod:`~dragg_tpu_torch.rl.neural`),
  their carries stacked along a leading community axis and stepped one
  community after the other (C × the single core's launches a step).

``[rl.fleet] gradient = "mpc"`` adds a deterministic actor term through
the community's response: d(relaxed load)/d(action) by forward-mode
differentiation (``torch.autograd.forward_ad``) through the engine step.
It runs on the plain routes only: the CUDA band and window kernels have
no tangent (:func:`check_mpc_route`).
"""

from __future__ import annotations

import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from dragg_tpu_torch import rng
from dragg_tpu_torch.checkpoint import host_snapshot, to_host, tree_flatten, tree_map, tree_unflatten
from dragg_tpu_torch.device import resolve_device
from dragg_tpu_torch.engine import StepOutputs
from dragg_tpu_torch.rl import core, neural
from dragg_tpu_torch.rl.agent import RLAgent, new_rl_data
from dragg_tpu_torch.rl.basis import STATE_ACTION_DIM, STATE_DIM, state_action_basis, state_basis
from dragg_tpu_torch.rl.core import MEMORY_CAP, RLObservation, StepRecord, obs_to_state
from dragg_tpu_torch.rl.env import (
    EnvCarry,
    init_fleet_env_carry,
    init_tracker,
    observe,
    simplified_response,
    tracker_step,
)

F32 = torch.float32

# Event features appended to the shared policy's state, per community:
# [price-shock intensity, DR-cap activity fraction, outage fraction,
#  comfort-relief intensity].  Event-free runs see exact zeros.
N_EVENT_FEATURES = 4
FLEET_STATE_SCALARS = 4 + N_EVENT_FEATURES        # replay state width
FLEET_STATE_DIM = STATE_DIM + N_EVENT_FEATURES    # φ(s) width
FLEET_SA_DIM = STATE_ACTION_DIM + N_EVENT_FEATURES  # φ(s, a) width

# Stream constants folded into the community seeds, so exploration and
# the learner's draws are apart from the forecast noise drawn from the
# same seeds.
_NOISE_STREAM = 0x52F7
_LEARNER_STREAM = 0x1EA5


class FleetParams(NamedTuple):
    """The ``[rl.fleet]`` settings."""

    policy: str          # "shared" | "per_community"
    learner_batch: int   # shared learner minibatch (resolved, > 0)
    gradient: str        # "score" | "mpc"
    mpc_weight: float
    event_features: bool
    n_communities: int


def fleet_params_from_config(config: dict, n_communities: int) -> FleetParams:
    """The ``[rl.fleet]`` table, resolved and checked."""
    f = config.get("rl", {}).get("fleet", {}) or {}
    policy = str(f.get("policy", "shared"))
    if policy not in ("shared", "per_community"):
        raise ValueError(
            f"rl.fleet.policy must be 'shared' or 'per_community', "
            f"got {policy!r}")
    gradient = str(f.get("gradient", "score"))
    if gradient not in ("score", "mpc"):
        raise ValueError(
            f"rl.fleet.gradient must be 'score' or 'mpc', got {gradient!r}")
    if gradient == "mpc" and policy != "shared":
        raise ValueError(
            "rl.fleet.gradient = 'mpc' requires rl.fleet.policy = 'shared' "
            "(the deterministic actor term updates the one shared policy)")
    lb = int(f.get("learner_batch", 0) or 0)
    if lb <= 0:
        lb = int(config["rl"]["parameters"]["batch_size"])
    return FleetParams(
        policy=policy,
        learner_batch=lb,
        gradient=gradient,
        mpc_weight=float(f.get("mpc_weight", 0.25)),
        event_features=bool(f.get("event_features", True)),
        n_communities=int(n_communities),
    )


def check_mpc_route(config: dict, device_type: str) -> None:
    """Raise ``ValueError`` when ``rl.fleet.gradient = "mpc"`` would
    differentiate through a CUDA kernel, which has no tangent: the
    interior point's band kernels (``tpu.band_kernel = "pallas"``, or
    ``"auto"`` on a CUDA device) or ReLU-QP's window kernel
    (``tpu.iter_kernel = "pallas"``).  The plain routes (``band_kernel =
    "xla"``, ``"auto"`` on the CPU; ``iter_kernel = "lax"``/``"auto"``)
    pass.  A pure function of the config and the device type."""
    from dragg_tpu_torch.config import resolve_solver_family

    if str(config.get("rl", {}).get("fleet", {}).get("gradient", "score")) != "mpc":
        return
    tpu = config.get("tpu", {})
    if resolve_solver_family(config) == "reluqp":
        if str(tpu.get("iter_kernel", "auto")) == "pallas":
            raise ValueError(
                "rl.fleet.gradient = 'mpc' differentiates the plain routes only: "
                "tpu.iter_kernel = 'pallas' runs the CUDA window kernel, which has "
                "no tangent; set tpu.iter_kernel = 'lax'")
        return
    kern = str(tpu.get("band_kernel", "auto"))
    if kern == "pallas" or (kern == "auto" and device_type == "cuda"):
        raise ValueError(
            f"rl.fleet.gradient = 'mpc' differentiates the plain routes only: "
            f"tpu.band_kernel = {kern!r} runs the CUDA band kernels on a "
            f"{device_type} device, which have no tangent; set tpu.band_kernel = 'xla'")


class FleetObservation(NamedTuple):
    """One fleet step's observation: the 4-scalar observation with (C,)
    leaves, the (C, N_EVENT_FEATURES) event features, and (mpc gradient)
    d(reward)/d(action) for the action whose reward ``obs.reward`` is."""

    obs: RLObservation
    events: torch.Tensor  # (C, N_EVENT_FEATURES)
    drda: torch.Tensor    # (C,)


# --------------------------------------------------------------------------
# Per-community random streams
# --------------------------------------------------------------------------

def community_seeds(config: dict, n_communities: int) -> np.ndarray:
    """``random_seed + c · seed_stride``: the fleet population's own seeds,
    so community c of a fleet and a run alone at that seed share one."""
    from dragg_tpu_torch.homes import fleet_config

    _c, stride, _off = fleet_config(config)
    base = int(config["simulation"]["random_seed"])
    return base + stride * np.arange(n_communities)


def community_noise_keys(config: dict, n_communities: int, device=None) -> torch.Tensor:
    """(C, 2) exploration keys: each community seed's key folded with the
    noise stream constant."""
    return torch.stack([rng.fold_in(rng.prng_key(int(s), device), _NOISE_STREAM)
                        for s in community_seeds(config, n_communities)])


def _learner_key(config: dict, device=None) -> torch.Tensor:
    base = int(config["simulation"]["random_seed"])
    return rng.fold_in(rng.prng_key(base, device), _LEARNER_STREAM)


# --------------------------------------------------------------------------
# Feature maps with the event features on the basis tail
# --------------------------------------------------------------------------

def _phi_s_fleet(sv: torch.Tensor) -> torch.Tensor:
    """φ(s) of the (…, 4 + F) fleet state: the 23-wide basis of the first
    three scalars, the raw event features appended."""
    return torch.cat([state_basis(sv[..., 0], sv[..., 1], sv[..., 2]), sv[..., 4:]], dim=-1)


def _phi_sa_fleet(sv: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.cat([state_action_basis(sv[..., 0], sv[..., 1], sv[..., 2], sv[..., 3], a),
                      sv[..., 4:]], dim=-1)


def _fleet_state(fobs: FleetObservation) -> torch.Tensor:
    """(C, 4 + F): the observation scalars and the event features."""
    return torch.cat([obs_to_state(fobs.obs), fobs.events.to(F32)], dim=-1)


def _memorize(carry, first, state, action, r, next_state):
    """The shared replay after storing the C transitions of this step:
    fleet step k owns slots (k-1)·C … k·C-1 mod CAP, and the t = 0
    self-loops are dropped, so the valid prefix stays dense.  Returns
    (mem_s, mem_a, mem_r, mem_s1, valid)."""
    C = state.shape[0]
    base = torch.clamp(carry.t - 1, min=0).long() * C
    slots = torch.remainder(base + torch.arange(C, device=state.device), MEMORY_CAP)

    def put(mem, new):
        return mem.index_copy(0, slots, torch.where(first, mem[slots], new))

    valid = torch.clamp(carry.t.long() * C, max=MEMORY_CAP)
    return (put(carry.mem_s, state), put(carry.mem_a, action), put(carry.mem_r, r),
            put(carry.mem_s1, next_state), valid)


def _split_streams(carry):
    """(new community keys, this step's community keys): each community
    key split in two."""
    splits = rng.split(carry.comm_keys, 2)   # (C, 2, 2)
    return splits[:, 0], splits[:, 1]


# --------------------------------------------------------------------------
# Shared linear core: C actors, one learner, one policy
# --------------------------------------------------------------------------

class FleetLinearCarry(NamedTuple):
    """The shared linear actor-critic: one θ pair, C rollout streams and
    one replay holding C transitions a step."""

    theta_mu: torch.Tensor     # (FLEET_STATE_DIM,)
    theta_q: torch.Tensor      # (FLEET_SA_DIM, n_q)
    z_theta_mu: torch.Tensor   # (C, FLEET_STATE_DIM) per-community traces
    state: torch.Tensor        # (C, 4 + F)
    next_action: torch.Tensor  # (C,)
    avg_reward: torch.Tensor   # ()
    cum_reward: torch.Tensor   # ()
    i: torch.Tensor            # () int32 twin-Q index
    t: torch.Tensor            # () int32 fleet steps taken
    mem_s: torch.Tensor        # (CAP, 4 + F) shared replay
    mem_a: torch.Tensor        # (CAP,)
    mem_r: torch.Tensor        # (CAP,)
    mem_s1: torch.Tensor       # (CAP, 4 + F)
    comm_keys: torch.Tensor    # (C, 2) per-community exploration streams
    key: torch.Tensor          # (2,) the learner's stream


def init_fleet_linear(params: core.AgentParams, fparams: FleetParams, config: dict,
                      device) -> FleetLinearCarry:
    C = fparams.n_communities
    key, kq = rng.split(_learner_key(config, device), 2)
    z = lambda *shape: torch.zeros(shape, dtype=F32, device=device)  # noqa: E731
    return FleetLinearCarry(
        theta_mu=z(FLEET_STATE_DIM),
        theta_q=0.3 * rng.normal(kq, FLEET_SA_DIM * params.n_q).reshape(
            FLEET_SA_DIM, params.n_q),
        z_theta_mu=z(C, FLEET_STATE_DIM),
        state=z(C, FLEET_STATE_SCALARS),
        next_action=z(C),
        avg_reward=z(),
        cum_reward=z(),
        i=torch.zeros((), dtype=torch.int32, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device),
        mem_s=z(MEMORY_CAP, FLEET_STATE_SCALARS),
        mem_a=z(MEMORY_CAP),
        mem_r=z(MEMORY_CAP),
        mem_s1=z(MEMORY_CAP, FLEET_STATE_SCALARS),
        comm_keys=community_noise_keys(config, C, device),
        key=key,
    )


def fleet_linear_step(carry: FleetLinearCarry, fobs: FleetObservation,
                      params: core.AgentParams, fparams: FleetParams):
    """One fleet step of the shared linear core: the single core's actor
    math for every community at once, one ridge refit of the critic from
    the shared replay, and the per-community eligibility-trace gradients
    averaged into the one θ_μ.  Returns (carry, StepRecord)."""
    next_state = _fleet_state(fobs)                     # (C, D)
    first = carry.t == 0
    state = torch.where(first, next_state, carry.state)
    action = carry.next_action                          # (C,)
    r = fobs.obs.reward.to(F32)                         # (C,)

    comm_keys, k_next = _split_streams(carry)
    key, k_idx, k_act = rng.split(carry.key, 3)
    mem_s, mem_a, mem_r, mem_s1, valid = _memorize(carry, first, state, action, r, next_state)

    # Twin-Q index flip before the TD pair (core.train_step's order).
    i = torch.remainder(carry.i + 1, params.n_q).to(torch.int32)
    phi_k = _phi_sa_fleet(state, action)                 # (C, SA)
    mu_next = _phi_s_fleet(next_state) @ carry.theta_mu  # (C,)
    next_action = mu_next + params.sigma * rng.normal(k_next, 1)[..., 0]
    phi_k1 = _phi_sa_fleet(next_state, next_action)
    col = core._column(carry.theta_q, i)
    q_pred = phi_k @ col
    q_obs = r + params.beta * (phi_k1 @ col)

    # The learner: one ridge refit from the shared replay.
    B = fparams.learner_batch
    idx = rng.randint(k_idx, B, 0, torch.clamp(valid, min=1))
    s_b, a_b, r_b, s1_b = mem_s[idx], mem_a[idx], mem_r[idx], mem_s1[idx]
    mu1 = _phi_s_fleet(s1_b) @ carry.theta_mu
    a1 = mu1 + params.sigma * rng.normal(rng.split(k_act, B), 1)[..., 0]
    q1 = torch.amin(_phi_sa_fleet(s1_b, a1) @ carry.theta_q, dim=1)
    y = r_b + params.beta * q1
    phi = _phi_sa_fleet(s_b, a_b)
    phi_c = phi - phi.mean(dim=0)
    y_c = y - y.mean()
    gram = phi_c.T @ phi_c + params.ridge_alpha * torch.eye(
        FLEET_SA_DIM, dtype=F32, device=phi.device)
    theta_r = torch.linalg.solve_ex(gram, phi_c.T @ y_c)[0]
    blended = params.alpha_q * theta_r + (1.0 - params.alpha_q) * col
    new_col = torch.where(valid > B, blended, col)
    cols = torch.arange(params.n_q, device=col.device) == i
    theta_q = torch.where(cols, new_col[:, None], carry.theta_q)

    # The shared policy: per-community traces, the averaged gradient.
    x_k = _phi_s_fleet(state)                            # (C, SD)
    delta = torch.clamp(q_obs - q_pred, -1.0, 1.0)       # (C,)
    avg_reward = carry.avg_reward + params.alpha_r * torch.mean(delta)
    cum_reward = carry.cum_reward + torch.mean(r)
    mu = torch.clamp(x_k @ carry.theta_mu, params.action_low, params.action_high)
    grad_pi_mu = (action - mu)[:, None] / params.sigma * x_k
    z = params.lam_theta * carry.z_theta_mu + grad_pi_mu
    g = torch.mean(delta[:, None] * z, dim=0)
    if fparams.gradient == "mpc":
        # The deterministic actor term through the relaxed MPC response:
        # dR/dθ ≈ E_c[dr/da · φ(s)], clipped as the TD error is.
        drda = torch.clamp(fobs.drda.to(F32), -1.0, 1.0)
        g = g + fparams.mpc_weight * torch.mean(drda[:, None] * x_k, dim=0)
    theta_mu = carry.theta_mu + params.alpha_mu * g

    new_carry = FleetLinearCarry(
        theta_mu=theta_mu, theta_q=theta_q, z_theta_mu=z, state=next_state,
        next_action=next_action, avg_reward=avg_reward, cum_reward=cum_reward,
        i=i, t=carry.t + 1, mem_s=mem_s, mem_a=mem_a, mem_r=mem_r, mem_s1=mem_s1,
        comm_keys=comm_keys, key=key)
    record = StepRecord(
        theta_q=core._column(theta_q, i), theta_mu=theta_mu, q_obs=q_obs, q_pred=q_pred,
        action=action, average_reward=avg_reward, cumulative_reward=cum_reward,
        reward=r, mu=mu)
    return new_carry, record


# --------------------------------------------------------------------------
# Shared DDPG core: one policy, C rollout streams
# --------------------------------------------------------------------------

class FleetDDPGCarry(NamedTuple):
    """:class:`~dragg_tpu_torch.rl.neural.DDPGCarry` with the rollout
    leaves over C, one shared replay and networks over the (4 + F)-scalar
    fleet state."""

    actor: dict
    critic1: dict
    critic2: dict
    t_actor: dict
    t_critic1: dict
    t_critic2: dict
    opt_actor: neural.AdamState
    opt_critic1: neural.AdamState
    opt_critic2: neural.AdamState
    state: torch.Tensor        # (C, 4 + F)
    next_action: torch.Tensor  # (C,)
    avg_reward: torch.Tensor
    cum_reward: torch.Tensor
    t: torch.Tensor
    mem_s: torch.Tensor        # (CAP, 4 + F)
    mem_a: torch.Tensor
    mem_r: torch.Tensor
    mem_s1: torch.Tensor
    comm_keys: torch.Tensor    # (C, 2)
    key: torch.Tensor          # (2,)


def init_fleet_ddpg(params: neural.DDPGParams, fparams: FleetParams, config: dict,
                    device) -> FleetDDPGCarry:
    """Fresh shared DDPG networks, flax's init at the fleet state's width
    (an 8-input actor, 9-input critics)."""
    C, D, h = fparams.n_communities, FLEET_STATE_SCALARS, params.hidden
    key, ka, k1, k2 = rng.split(_learner_key(config, device), 4)
    actor = neural._init_net(ka, D, h, neural.ACTION_DIM)
    critic1 = neural._init_net(k1, D + neural.ACTION_DIM, h, 1)
    critic2 = neural._init_net(k2, D + neural.ACTION_DIM, h, 1)
    z = lambda *shape: torch.zeros(shape, dtype=F32, device=device)  # noqa: E731
    clone = lambda net: neural._tree(torch.clone, net)  # noqa: E731
    return FleetDDPGCarry(
        actor=actor, critic1=critic1, critic2=critic2,
        t_actor=clone(actor), t_critic1=clone(critic1), t_critic2=clone(critic2),
        opt_actor=neural._adam_init(actor), opt_critic1=neural._adam_init(critic1),
        opt_critic2=neural._adam_init(critic2),
        state=z(C, D), next_action=z(C), avg_reward=z(), cum_reward=z(),
        t=torch.zeros((), dtype=torch.int32, device=device),
        mem_s=z(MEMORY_CAP, D), mem_a=z(MEMORY_CAP), mem_r=z(MEMORY_CAP),
        mem_s1=z(MEMORY_CAP, D),
        comm_keys=community_noise_keys(config, C, device), key=key,
    )


def fleet_ddpg_step(carry: FleetDDPGCarry, fobs: FleetObservation,
                    params: neural.DDPGParams, fparams: FleetParams):
    """One fleet step of the shared DDPG core: C rollouts feed the shared
    replay; the critic, actor and target updates are
    ``neural.train_step``'s, gated and delayed on the fleet step count.
    Returns (carry, StepRecord)."""
    next_state = _fleet_state(fobs)
    first = carry.t == 0
    state = torch.where(first, next_state, carry.state)
    action = carry.next_action
    r = fobs.obs.reward.to(F32)

    comm_keys, k_next = _split_streams(carry)
    key, k_idx = rng.split(carry.key, 2)
    mem_s, mem_a, mem_r, mem_s1, valid = _memorize(carry, first, state, action, r, next_state)

    B = fparams.learner_batch
    idx = rng.randint(k_idx, B, 0, torch.clamp(valid, min=1))
    bs, ba, br, bs1 = mem_s[idx], mem_a[idx], mem_r[idx], mem_s1[idx]

    a1 = neural._mu(carry.t_actor, bs1, params)
    y = br + params.beta * torch.minimum(neural._q(carry.t_critic1, bs1, a1, params),
                                         neural._q(carry.t_critic2, bs1, a1, params))

    def critic_loss(cp):
        return torch.mean((neural._q(cp, bs, ba, params) - y) ** 2)

    do_update = (valid >= B).to(F32)
    g1 = neural._grad(critic_loss, carry.critic1)
    g2 = neural._grad(critic_loss, carry.critic2)
    critic1, opt_c1 = neural.gated_adam(
        do_update, neural._adam_update(g1, carry.opt_critic1, carry.critic1, params.critic_lr),
        carry.critic1, carry.opt_critic1)
    critic2, opt_c2 = neural.gated_adam(
        do_update, neural._adam_update(g2, carry.opt_critic2, carry.critic2, params.critic_lr),
        carry.critic2, carry.opt_critic2)

    drda = torch.clamp(fobs.drda.to(F32), -1.0, 1.0).detach()

    def actor_loss(ap):
        loss = -torch.mean(neural._q(critic1, bs, neural._mu(ap, bs, params), params))
        if fparams.gradient == "mpc":
            # The deterministic env-gradient term on this step's rollout
            # states: ascend dr/da · μ(s).
            loss = loss - fparams.mpc_weight * torch.mean(drda * neural._mu(ap, state, params))
        return loss

    delay = max(1, params.policy_delay)
    do_actor = do_update * (torch.remainder(carry.t, delay) == 0).to(F32)
    ga = neural._grad(actor_loss, carry.actor)
    actor, opt_a = neural.gated_adam(
        do_actor, neural._adam_update(ga, carry.opt_actor, carry.actor, params.actor_lr),
        carry.actor, carry.opt_actor)

    tau = params.tau * do_actor
    t_actor = neural._polyak(carry.t_actor, actor, tau)
    t_critic1 = neural._polyak(carry.t_critic1, critic1, tau)
    t_critic2 = neural._polyak(carry.t_critic2, critic2, tau)

    mu_next = neural._mu(actor, next_state, params)      # (C,)
    noise = params.sigma * rng.normal(k_next, 1)[..., 0]
    next_action = torch.clamp(mu_next + noise, params.action_low, params.action_high)

    q_pred = neural._q(carry.critic1, state, action, params)  # (C,)
    q_obs = r + params.beta * q_pred
    cum_reward = carry.cum_reward + torch.mean(r)
    avg_reward = carry.avg_reward + (torch.mean(r) - carry.avg_reward) / (
        carry.t.to(F32) + 1.0)

    new_carry = FleetDDPGCarry(
        actor=actor, critic1=critic1, critic2=critic2,
        t_actor=t_actor, t_critic1=t_critic1, t_critic2=t_critic2,
        opt_actor=opt_a, opt_critic1=opt_c1, opt_critic2=opt_c2,
        state=next_state, next_action=next_action,
        avg_reward=avg_reward, cum_reward=cum_reward, t=carry.t + 1,
        mem_s=mem_s, mem_a=mem_a, mem_r=mem_r, mem_s1=mem_s1,
        comm_keys=comm_keys, key=key)
    record = StepRecord(
        theta_q=neural.param_norm(critic1), theta_mu=neural.param_norm(actor),
        q_obs=q_obs, q_pred=q_pred, action=action, average_reward=avg_reward,
        cumulative_reward=cum_reward, reward=r, mu=mu_next)
    return new_carry, record


# --------------------------------------------------------------------------
# Per-community mode: the single-community cores, one per community
# --------------------------------------------------------------------------

def _stack(trees: list):
    """Trees of one structure → one tree, each leaf stacked on a new
    leading axis."""
    flat = [tree_flatten(t) for t in trees]
    structure = flat[0][1]
    return tree_unflatten(structure, [torch.stack(leaves) for leaves in
                                      zip(*(f[0] for f in flat))])


def init_fleet_per_community(kind: str, params, config: dict, n_communities: int, device):
    """C independent agent carries stacked along a leading community axis,
    each seeded with its community's seed (:func:`community_seeds`)."""
    init = core.init_carry if kind == "linear" else neural.init_carry
    return _stack([init(params, int(s), device)
                   for s in community_seeds(config, n_communities)])


def _per_community_step(step, carry, fobs: FleetObservation, params, _fparams):
    """Each community's single core on its slice of the stacked carry,
    community after community (the JAX package maps the cores over the
    community axis in one program)."""
    C = fobs.obs.reward.shape[0]
    out = [step(tree_map(lambda a, c=c: a[c], carry),
                RLObservation(*(f[c] for f in fobs.obs)), params) for c in range(C)]
    return _stack([o[0] for o in out]), _stack([o[1] for o in out])


# --------------------------------------------------------------------------
# Scenario event features
# --------------------------------------------------------------------------

def traced_event_features(evt: dict, start: int, C: int, window: int,
                          max_rp: float) -> torch.Tensor:
    """(C, N_EVENT_FEATURES) per-community event intensities over the
    next ``window`` steps from the engine's device event series
    (``Engine._evt``, the families the schedule uses; absent families
    give exact zeros).  ``start`` is the environment index of the
    current step; the window is clamped to fit, as a dynamic slice."""
    dev = next(iter(evt.values())).device
    z = torch.zeros((C,), dtype=F32, device=dev)

    def win(name):
        s = evt[name]                                   # (C, T)
        a = min(max(start, 0), s.shape[1] - window)
        return s[:, a:a + window]

    if "price" in evt:
        price = torch.clamp(torch.mean(win("price"), dim=1)
                            / float(np.float32(max(max_rp, 1e-6))), -3.0, 3.0)
    else:
        price = z
    if "cap" in evt:
        cw = win("cap")
        cap_active = torch.mean((torch.isfinite(cw) & (cw > 0)).to(F32), dim=1)
        outage = torch.mean((cw == 0).to(F32), dim=1)
    else:
        cap_active, outage = z, z
    relax = (torch.clamp(torch.mean(win("relax"), dim=1) / 2.0, 0.0, 3.0)
             if "relax" in evt else z)
    return torch.stack([price, cap_active, outage, relax], dim=1)


def event_feature_table(timeline, start_index: int, num_timesteps: int,
                        window: int, max_rp: float) -> np.ndarray:
    """(T, C, F) host feature table for the simplified fleet case: the
    features of :func:`traced_event_features`, windowed per step."""
    C = timeline.n_communities
    feats = np.zeros((num_timesteps, C, N_EVENT_FEATURES), np.float32)
    price = np.asarray(timeline.price)
    cap = np.asarray(timeline.cap)
    relax = np.asarray(timeline.relax)
    T_env = price.shape[1]
    for t in range(num_timesteps):
        a = min(start_index + t, T_env - 1)
        b = min(a + window, T_env)
        pw, cw, rw = price[:, a:b], cap[:, a:b], relax[:, a:b]
        feats[t, :, 0] = np.clip(pw.mean(axis=1) / max(max_rp, 1e-6), -3, 3)
        feats[t, :, 1] = (np.isfinite(cw) & (cw > 0)).mean(axis=1)
        feats[t, :, 2] = (cw == 0).mean(axis=1)
        feats[t, :, 3] = np.clip(rw.mean(axis=1) / 2.0, 0, 3)
    return feats


# --------------------------------------------------------------------------
# The host-facing fleet agent
# --------------------------------------------------------------------------

class FleetAgent(RLAgent):
    """The fleet's price-signal agent: one of the four (core × policy
    layout) carries above.  Its rl_data scalar series hold the fleet mean
    a step; ``action_by_community`` holds every community's action."""

    name = "utility"

    def __init__(self, config: dict, n_communities: int, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.kind = str(config["rl"]["parameters"].get("agent", "linear"))
        self.fparams = fleet_params_from_config(config, n_communities)
        if self.kind == "ddpg":
            self.params = neural.params_from_config(config)
        elif self.kind == "linear":
            self.params = core.params_from_config(config)
        else:
            raise ValueError(f"Unknown rl.parameters.agent {self.kind!r} (linear | ddpg)")
        if self.fparams.policy == "shared":
            init, self._core = ((init_fleet_linear, fleet_linear_step) if self.kind == "linear"
                                else (init_fleet_ddpg, fleet_ddpg_step))
            self.carry = init(self.params, self.fparams, config, self.device)
        else:
            self.carry = init_fleet_per_community(self.kind, self.params, config,
                                                  n_communities, self.device)
            base = core.train_step if self.kind == "linear" else neural.train_step
            self._core = lambda c, o, p, f: _per_community_step(base, c, o, p, f)  # noqa: E731
        self.rl_data = new_rl_data(
            self.params.beta, self.params.batch_size, self.params.sigma,
            {"agent": self.kind,
             "fleet": {"communities": n_communities,
                       "policy": self.fparams.policy,
                       "learner_batch": self.fparams.learner_batch,
                       "gradient": self.fparams.gradient,
                       "event_features": self.fparams.event_features}})
        self.rl_data["action_by_community"] = []

    def scan_step(self, carry, fobs: FleetObservation):
        return self._core(carry, fobs, self.params, self.fparams)

    def record_chunk(self, recs: StepRecord) -> None:
        """Fold a chunk of stacked fleet StepRecords (steps first) into
        rl_data: scalar keys take the fleet mean a step; θ rows are the
        shared vectors, or the community mean in per-community mode;
        per-community actions are kept whole."""
        host = StepRecord(*(to_host(f) for f in recs))
        T = host.action.shape[0]
        self.rl_data["action_by_community"].extend(
            [[float(v) for v in row] for row in host.action.reshape(T, -1)])
        shared = self.fparams.policy == "shared"

        def theta_rows(a):
            if not shared:
                a = a.mean(axis=1)     # the community axis
            if a.ndim == 1:            # DDPG parameter norms
                return [[float(v)] for v in a]
            return [list(map(float, row)) for row in a]

        self.rl_data["theta_q"].extend(theta_rows(host.theta_q))
        self.rl_data["theta_mu"].extend(theta_rows(host.theta_mu))
        for name in ("q_obs", "q_pred", "action", "average_reward", "cumulative_reward",
                     "reward", "mu"):
            a = np.asarray(getattr(host, name)).reshape(T, -1).mean(axis=1)
            self.rl_data[name].extend(float(v) for v in a)


# --------------------------------------------------------------------------
# The fleet environment carry and one rl_agg step
# --------------------------------------------------------------------------

class FleetEnvCarry(NamedTuple):
    """The (C,)-leaved environment carry and the mpc gradient's channel."""

    env: EnvCarry          # every leaf (C, ...)
    drda: torch.Tensor     # (C,) d r_t / d a_{t-1} (zeros under "score")


def _rp_matrix(rp_c: torch.Tensor, H: int, rp_len: int, dt: int):
    """(C, H) per-community price windows and their tangent d rp / d a
    (the window indicator): the runner's announcement for each community."""
    C = rp_c.shape[0]
    if rp_len <= dt or rp_len >= H:
        return (rp_c[:, None].expand(C, H).contiguous(),
                torch.ones((C, H), dtype=F32, device=rp_c.device))
    win = (torch.arange(H, device=rp_c.device) < rp_len).to(F32)[None, :]
    return rp_c[:, None] * win, win.expand(C, H).contiguous()


class CommunityFold(NamedTuple):
    """Per-community sums of a merged per-home series: ``weights`` is
    (C, n), each row its community's check mask and zero elsewhere.  A
    row sum is deterministic on the card, unlike an atomic scatter."""

    weights: torch.Tensor

    @classmethod
    def of(cls, engine) -> "CommunityFold":
        comm, mask = engine.community_fold_arrays()
        C = engine.n_communities
        w = (comm[None, :] == np.arange(C)[:, None]) * mask[None, :]
        return cls(torch.as_tensor(w, dtype=F32, device=engine.device))

    def __call__(self, vec: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.weights * vec[None, :], dim=1)


def mpc_response(engine, cstate, t: int, rp_mat, tangent, refresh: bool, factor,
                 fold: CommunityFold):
    """One engine step under the (C, H) prices ``rp_mat`` with the
    forward-mode derivative of each community's relaxed response: the
    plan's step-1 grid power (``forecast_p_grid``) summed per community,
    differentiated along ``tangent``.  Communities couple only through
    their own price rows, so one pass gives every community's own
    d(load)/d(action).  The applied step-0 aggregate is pinned to integer
    duty counts, whose tangent is zero almost everywhere, so the relaxed
    plan is what is differentiated.  Returns (fore_c, dagg, (state,
    solver carry, outputs)), all without tangents."""
    with fwAD.dual_level():
        cs, fc, outs = engine._step(cstate, t, fwAD.make_dual(rp_mat, tangent), refresh, factor)
        fore_c, dagg = fwAD.unpack_dual(fold(outs.forecast_p_grid))
        primal = lambda a: (fwAD.unpack_dual(a).primal  # noqa: E731
                            if isinstance(a, torch.Tensor) else a)
        cs, fc, outs = tree_map(primal, (cs, fc, outs))
    if dagg is None:  # no solved home: nothing depends on the price
        dagg = torch.zeros_like(fore_c)
    return fore_c, dagg, (cs, fc, outs)


def _fleet_step(engine, agent: FleetAgent, norms, settings: dict, fold: CommunityFold,
                carry, factor, t: int, t0: int):
    """One fleet RL + community-MPC timestep, in the single runner's order:
    the C agents observe and the policy acts, the engine solves every
    community under its own price row, the per-community aggregates fold
    back into the environment carry."""
    cstate, acarry, fenv = carry
    env = fenv.env
    p = engine.params
    C, H, dt = agent.fparams.n_communities, p.horizon, p.dt
    max_rp = settings["max_rp"]
    obs = observe(env, t, dt, norms)
    if agent.fparams.event_features and engine._evt:
        ev = traced_event_features(engine._evt, p.start_index + t, C, H, max_rp)
    else:
        ev = torch.zeros((C, N_EVENT_FEATURES), dtype=F32, device=norms.device)
    acarry, rec = agent.scan_step(acarry, FleetObservation(obs=obs, events=ev, drda=fenv.drda))
    ap = agent.params
    rp_c = torch.clamp(torch.clamp(acarry.next_action, ap.action_low, ap.action_high),
                       -max_rp, max_rp)
    rp_mat, tangent = _rp_matrix(rp_c, H, settings["action_horizon"] * dt, dt)
    refresh = t == t0 or t % max(1, p.admm_refactor_every) == 0
    mpc = agent.fparams.gradient == "mpc"
    if mpc:
        fore_c, dagg, (cstate, factor, outs) = mpc_response(
            engine, cstate, t, rp_mat, tangent, refresh, factor, fold)
    else:
        cstate, factor, outs = engine._step(cstate, t, rp_mat, refresh, factor)
        fore_c = fold(outs.forecast_p_grid)
    agg_c = fold(outs.p_grid)
    tracker, sp = tracker_step(env.tracker, agg_c, t + 1)
    new_env = EnvCarry(agg_load=agg_c, forecast_load=fore_c,
                       prev_forecast_load=env.forecast_load, setpoint=sp,
                       prev_action=env.action, action=rp_c, tracker=tracker)
    # dr_{t+1}/da_t for the next step's actor term, r = -((agg - sp)/norm)²,
    # the setpoint's own dependence on agg dropped (clipped at use).
    drda = (-2.0 * ((agg_c - sp) / norms) * dagg / norms if mpc
            else torch.zeros_like(agg_c))
    return ((cstate, acarry, FleetEnvCarry(new_env, drda)), factor,
            (outs, rec, rp_c, env.setpoint))


def _stack_rows(rows: list, kind):
    return kind(*(torch.stack(leaves) for leaves in zip(*rows)))


def run_fleet_chunk(engine, agent: FleetAgent, settings: dict, norms, fold: CommunityFold,
                    carry, t0: int, n_steps: int):
    """``n_steps`` fleet steps from sim step ``t0``: (carry after them,
    (StepOutputs, StepRecord, (n, C) prices, (n, C) setpoints) stacked
    along time, on the device).  The solver carry is chunk-local."""
    factor = engine.init_factor()
    outs, recs, rps, sps = [], [], [], []
    for t in range(t0, t0 + n_steps):
        carry, factor, (o, r, rp, sp) = _fleet_step(engine, agent, norms, settings, fold,
                                                    carry, factor, t, t0)
        outs.append(o)
        recs.append(r)
        rps.append(rp)
        sps.append(sp)
    return carry, (_stack_rows(outs, StepOutputs), _stack_rows(recs, StepRecord),
                   torch.stack(rps), torch.stack(sps))


# --------------------------------------------------------------------------
# Run modes
# --------------------------------------------------------------------------

def run_rl_agg_fleet(agg) -> None:
    """The RL price-signal aggregator over a C-community MPC fleet: the
    single runner's chunk and checkpoint loop with batched carries and a
    reward price per community."""
    from dragg_tpu_torch.rl.runner import _rl_settings

    config = agg.config
    agg.case = "rl_agg"
    C = agg.n_communities
    check_mpc_route(config, agg.device.type)
    if agg.all_homes is None:
        agg.get_homes()
    if agg.engine is None:
        agg._build_engine()
    agg.reset_collected_data()
    agg.all_rps = np.zeros(agg.num_timesteps)
    agg.all_sps = np.zeros(agg.num_timesteps)
    agg.fleet_rps = np.zeros((agg.num_timesteps, C))
    agg.fleet_sps = np.zeros((agg.num_timesteps, C))

    settings = _rl_settings(config)
    norms_np = agg._max_possible_load_per_community()
    norms = torch.as_tensor(norms_np, dtype=F32, device=agg.device)
    agent = FleetAgent(config, C, device=agg.device)
    B = len(agg.all_homes) // C
    env0 = FleetEnvCarry(env=init_fleet_env_carry(B, settings["prev_n"], norms_np, agg.device),
                         drda=torch.zeros((C,), dtype=F32, device=agg.device))
    fold = CommunityFold.of(agg.engine)
    agg.checkpoint_interval = agg._checkpoint_steps()
    if agg.run_dir is None:
        agg.set_run_dir()
    agg.log.logger.info(
        f"Performing FLEET RL AGG run: {C} communities × {B} homes, "
        f"policy={agent.fparams.policy}/{agent.kind}, gradient={agent.fparams.gradient}")
    agg.start_time = time.time()
    case_dir = os.path.join(agg.run_dir, agg.case)
    carry, t = agg.try_resume((agg.engine.init_state(), agent.carry, env0))
    if agg.resumed_from is not None:
        rl_file = os.path.join(agg.resumed_from, "rl_data.json")
        if os.path.isfile(rl_file):
            with open(rl_file) as f:
                agent.rl_data = json.load(f)
        fleet_file = os.path.join(agg.resumed_from, "fleet_rl.json")
        if os.path.isfile(fleet_file):
            with open(fleet_file) as f:
                fr = json.load(f)
            agg.fleet_rps = np.asarray(fr["rps"], dtype=np.float64)
            agg.fleet_sps = np.asarray(fr["sps"], dtype=np.float64)
    chunks = 0
    while t < agg.num_timesteps:
        n_steps = min(agg.checkpoint_interval, agg.num_timesteps - t)
        # The community state at the chunk's start, for a forensic dump.
        agg._chunk_state0 = host_snapshot(carry[0]) if agg._forensics_on else None
        d0 = time.perf_counter()
        carry, stacked = run_fleet_chunk(agg.engine, agent, settings, norms, fold, carry,
                                         t, n_steps)
        outs, recs, rps, sps = host_snapshot(stacked)
        agg._phase_times["device_chunks"] += time.perf_counter() - d0
        c0 = time.perf_counter()
        # The chunk's prices first: a forensic dump of it records them.
        agg.fleet_rps[t:t + n_steps] = rps
        agg.fleet_sps[t:t + n_steps] = sps
        agg.all_rps[t:t + n_steps] = rps.mean(axis=1)
        agg.all_sps[t:t + n_steps] = sps.mean(axis=1)
        agg._collect_chunk(outs, track_setpoints=False)
        agent.record_chunk(recs)
        agg._phase_times["collect"] += time.perf_counter() - c0
        t += n_steps
        chunks += 1
        if t < agg.num_timesteps:
            _set_fleet_summary(agg, agent)
            agg.write_outputs()
            agg.save_checkpoint(carry, extra_json={
                "rl_data.json": agent.rl_data,
                "fleet_rl.json": {"rps": agg.fleet_rps.tolist(),
                                  "sps": agg.fleet_sps.tolist()}})
            if agg.stop_after_chunks is not None and chunks >= agg.stop_after_chunks:
                agg.log.logger.info(f"Stopping early after {chunks} chunks.")
                break
    agent.carry = carry[1]
    agg.agent = agent
    agg.fleet_env = carry[2]  # the environment carry after the last step (drda)
    if t < agg.num_timesteps:
        return
    agg.check_baseline_vals()
    _set_fleet_summary(agg, agent)
    agg.write_outputs()
    agent.write_rl_data(case_dir)
    agg.clear_checkpoint()


def _set_fleet_summary(agg, agent: FleetAgent) -> None:
    """The Summary's ``fleet_rl`` block: the fleet settings, the mean
    |price| per community, and the (C, T) price and setpoint matrices up
    to 200,000 entries."""
    block = {
        "communities": agent.fparams.n_communities,
        "policy": agent.fparams.policy,
        "agent": agent.kind,
        "learner_batch": agent.fparams.learner_batch,
        "gradient": agent.fparams.gradient,
        "event_features": agent.fparams.event_features,
        "mean_abs_rp_by_community":
            [round(float(v), 6) for v in np.abs(agg.fleet_rps).mean(axis=0)],
    }
    if agg.fleet_rps.size <= 200_000:
        block["RP_by_community"] = agg.fleet_rps.T.tolist()
        block["setpoint_by_community"] = agg.fleet_sps.T.tolist()
    agg.extra_summary["fleet_rl"] = block


def run_rl_simplified_fleet(agg) -> None:
    """The fleet's agents against C simplified linear communities, step by
    step on the agent's device.  Event timelines reach the observation
    through a host feature table; under ``gradient = "mpc"`` the response
    derivative is exact (the model is linear)."""
    from dragg_tpu_torch.rl.runner import _rl_settings

    config = agg.config
    agg.case = "simplified"
    C = agg.n_communities
    settings = _rl_settings(config)
    c_rate = float(config["agg"].get("simplified", {}).get("response_rate", 0.3))
    n_homes = int(config["community"]["total_number_homes"])
    house_p_avg = float(config["community"].get("house_p_avg", 1.2))
    norm = max(1.0, house_p_avg * n_homes * 2.5)
    dt = agg.dt
    max_rp = settings["max_rp"]
    dev = agg.device

    agent = FleetAgent(config, C, device=dev)
    tr = init_tracker(settings["prev_n"], house_p_avg * n_homes * 2.5, dev)
    sp0 = float(np.mean(to_host(tr.tracked)))
    rep = lambda v: torch.full((C,), v, dtype=F32, device=dev)  # noqa: E731
    env = EnvCarry(agg_load=rep(1.1 * sp0), forecast_load=rep(1.1 * sp0),
                   prev_forecast_load=rep(1.1 * sp0), setpoint=rep(sp0),
                   prev_action=rep(0.0), action=rep(0.0),
                   tracker=type(tr)(tr.tracked.expand(C, -1).contiguous()))
    drda = rep(0.0)

    # Event features: the resolved timeline as a host (T, C, F) table,
    # windowed by one hour (the simplified case's announcement).
    feats = np.zeros((agg.num_timesteps, C, N_EVENT_FEATURES), np.float32)
    if agent.fparams.event_features:
        from dragg_tpu_torch.scenarios import timeline_for

        tl = timeline_for(config, C, agg.start_index + agg.num_timesteps + dt, dt,
                          agg.start_index)
        if tl is not None:
            feats = event_feature_table(tl, agg.start_index, agg.num_timesteps, dt, max_rp)
    feats = torch.as_tensor(feats, device=dev)
    use_mpc = agent.fparams.gradient == "mpc"

    agg.log.logger.info(
        f"Performing FLEET RL simplified run: {C} communities, "
        f"policy={agent.fparams.policy}/{agent.kind}")
    agg.start_time = time.time()
    acarry = agent.carry
    ap = agent.params
    rows = []
    for t in range(agg.num_timesteps):
        obs = observe(env, t, dt, norm)
        acarry, rec = agent.scan_step(acarry, FleetObservation(obs=obs, events=feats[t],
                                                               drda=drda))
        rp = torch.clamp(torch.clamp(acarry.next_action, ap.action_low, ap.action_high),
                         -max_rp, max_rp)
        load, cost = simplified_response(env.agg_load, rp, env.setpoint, c_rate)
        tracker, sp = tracker_step(env.tracker, load, t + 1)
        if use_mpc:
            # Exact response derivative: d load / d rp = -c·(sp - load).
            dload = -c_rate * (env.setpoint - env.agg_load)
            drda = -2.0 * ((load - sp) / norm) * dload / norm
        rows.append((rec, load, cost, rp, env.setpoint))
        env = EnvCarry(agg_load=load, forecast_load=load, prev_forecast_load=env.agg_load,
                       setpoint=sp, prev_action=env.action, action=rp, tracker=tracker)
    agent.carry = acarry
    agent.record_chunk(_stack_rows([r[0] for r in rows], StepRecord))
    loads, costs, rps, sps = (to_host(torch.stack([r[k] for r in rows])) for k in range(1, 5))

    # Fleet aggregate = the sum over communities (the fleet engine's
    # agg_load); per-community series ride the fleet_rl block.
    agg._solve_iters = []
    agg.baseline_agg_load_list = loads.sum(axis=1).tolist()
    agg.all_rps = rps.mean(axis=1).astype(np.float64)
    agg.all_sps = sps.mean(axis=1).astype(np.float64)
    agg.fleet_rps = rps.astype(np.float64)
    agg.fleet_sps = sps.astype(np.float64)
    agg.extra_summary = {"agg_cost": costs.sum(axis=1).tolist()}
    _set_fleet_summary(agg, agent)
    agg.summary_only_case = True
    if agg.run_dir is None:
        agg.set_run_dir()
    agg.write_outputs()
    agg.extra_summary = {}
    agg.summary_only_case = False
    agent.write_rl_data(os.path.join(agg.run_dir, agg.case))
    agg.agent = agent
