"""The linear actor-critic price-signal agent as one step over explicit
state (counterpart of ``dragg_tpu/rl/core.py``).

The reference's ``RLAgent`` (dragg/agent.py:42-232): a Gaussian policy
with a linearly parameterized mean μ = θ_μ·φ(s) and fixed σ; a twin-Q
linear critic with an alternating update index; a replay buffer whose
batch refits the critic by ridge regression on targets
y = r + β·min_i θ_qᵢ·φ(s', a'~π); an eligibility-trace policy update
with the TD error clipped to ±1.  Every quantity is a tensor on the
carry's device, and every gate is a ``torch.where``, so a step never
reads a value back to the host.

Deviation from the reference (the JAX package's): the twin-Q ridge blend
uses the updated column ``theta_q[:, i]`` where the reference uses
``theta_q.flatten()`` (dragg/agent.py:213), which is shape-inconsistent
with two critics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dragg_tpu_torch import rng
from dragg_tpu_torch.rl.basis import (
    STATE_ACTION_DIM,
    STATE_DIM,
    state_action_basis,
    state_basis,
)

MEMORY_CAP = 2048  # circular replay capacity (the reference's list is unbounded)
F32 = torch.float32


class AgentParams(NamedTuple):
    """Hyperparameters (dragg/agent.py:78-86; config [rl.parameters])."""

    alpha_q: float
    alpha_mu: float
    alpha_r: float
    beta: float
    sigma: float
    batch_size: int
    n_q: int           # 2 if twin_q else 1
    lam_theta: float   # eligibility-trace decay (dragg/agent.py:61)
    ridge_alpha: float  # ridge regularization (dragg/agent.py:210)
    action_low: float
    action_high: float


class RLObservation(NamedTuple):
    """One observation s_{t+1} and the reward r_t, float32 scalars: the
    normalized forecast error, the forecast trend, the fractional time of
    day and the change in action (dragg/agent.py:89-107)."""

    fcst_error: torch.Tensor
    forecast_trend: torch.Tensor
    time_of_day: torch.Tensor
    delta_action: torch.Tensor
    reward: torch.Tensor


class AgentCarry(NamedTuple):
    """The agent's state between steps."""

    theta_mu: torch.Tensor     # (STATE_DIM,)
    theta_q: torch.Tensor      # (STATE_ACTION_DIM, n_q)
    z_theta_mu: torch.Tensor   # (STATE_DIM,) eligibility trace
    state: torch.Tensor        # (4,) current state scalars
    next_action: torch.Tensor  # () action chosen for the upcoming step
    avg_reward: torch.Tensor   # ()
    cum_reward: torch.Tensor   # ()
    i: torch.Tensor            # () int32 twin-Q index
    t: torch.Tensor            # () int32 steps taken
    mem_s: torch.Tensor        # (CAP, 4) replay: state
    mem_a: torch.Tensor        # (CAP,)   replay: action
    mem_r: torch.Tensor        # (CAP,)   replay: reward
    mem_s1: torch.Tensor       # (CAP, 4) replay: next state
    key: torch.Tensor          # (2,) threefry key words (rng.py)


class StepRecord(NamedTuple):
    """One step's telemetry, the reference's rl_data fields
    (dragg/agent.py:247-256)."""

    theta_q: torch.Tensor
    theta_mu: torch.Tensor
    q_obs: torch.Tensor
    q_pred: torch.Tensor
    action: torch.Tensor
    average_reward: torch.Tensor
    cumulative_reward: torch.Tensor
    reward: torch.Tensor
    mu: torch.Tensor


def init_carry(params: AgentParams, seed: int, device) -> AgentCarry:
    """A fresh agent on ``device``: θ_q ~ N(0, 0.3) as the reference's lazy
    critic init (dragg/agent.py:199), θ_μ zero (dragg/agent.py:161)."""
    key, kq = rng.split(rng.prng_key(seed, device=device), 2)
    z = lambda *shape: torch.zeros(shape, dtype=F32, device=device)  # noqa: E731
    return AgentCarry(
        theta_mu=z(STATE_DIM),
        theta_q=0.3 * rng.normal(kq, STATE_ACTION_DIM * params.n_q).reshape(
            STATE_ACTION_DIM, params.n_q),
        z_theta_mu=z(STATE_DIM),
        state=z(4),
        next_action=z(),
        avg_reward=z(),
        cum_reward=z(),
        i=torch.zeros((), dtype=torch.int32, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device),
        mem_s=z(MEMORY_CAP, 4),
        mem_a=z(MEMORY_CAP),
        mem_r=z(MEMORY_CAP),
        mem_s1=z(MEMORY_CAP, 4),
        key=key,
    )


def obs_to_state(obs: RLObservation) -> torch.Tensor:
    """The four observation scalars as the ``(..., 4)`` state vector, the
    one definition of the state layout (the linear and the DDPG core)."""
    return torch.stack([obs.fcst_error.to(F32), obs.forecast_trend.to(F32),
                        obs.time_of_day.to(F32), obs.delta_action.to(F32)], dim=-1)


def _phi_s(s: torch.Tensor) -> torch.Tensor:
    return state_basis(s[..., 0], s[..., 1], s[..., 2])


def _phi_sa(s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return state_action_basis(s[..., 0], s[..., 1], s[..., 2], s[..., 3], a)


def _policy_action(theta_mu, s, sigma: float, key):
    """a ~ N(θ_μ·φ(s), σ) (dragg/agent.py:151-165), over a batch of states
    ``(..., 4)`` and keys ``(..., 2)``; returns (a, μ)."""
    mu = _phi_s(s) @ theta_mu
    return mu + sigma * rng.normal(key, 1)[..., 0], mu


def _column(theta_q: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``theta_q[:, i]`` for a device index (no read-back)."""
    return theta_q.index_select(1, i.reshape(1).long())[:, 0]


def _ridge_update(carry: AgentCarry, params: AgentParams, key) -> torch.Tensor:
    """The batch critic refit (dragg/agent.py:203-213) as a closed-form
    solve: ``batch_size`` experiences from the valid prefix of the buffer,
    stochastic next actions under the current policy, TD targets with the
    min over critics, and a ridge fit of column ``i``.  Returns θ_q."""
    B = params.batch_size
    # carry.t is the post-increment step count; t = 0 stored nothing, so
    # the dense valid prefix holds t - 1 experiences.
    valid = torch.clamp(carry.t - 1, max=MEMORY_CAP)
    kidx, kact = rng.split(key, 2)
    idx = rng.randint(kidx, B, 0, torch.clamp(valid, min=1))
    s, a, r, s1 = carry.mem_s[idx], carry.mem_a[idx], carry.mem_r[idx], carry.mem_s1[idx]
    a1, _ = _policy_action(carry.theta_mu, s1, params.sigma, rng.split(kact, B))
    q1 = torch.amin(_phi_sa(s1, a1) @ carry.theta_q, dim=1)  # dragg/agent.py:174
    y = r + params.beta * q1
    phi = _phi_sa(s, a)
    # sklearn's Ridge(fit_intercept=True) centres features and targets.
    phi_c = phi - phi.mean(dim=0)
    y_c = y - y.mean()
    gram = phi_c.T @ phi_c + params.ridge_alpha * torch.eye(
        STATE_ACTION_DIM, dtype=F32, device=phi.device)
    # solve_ex: no singularity check, which would read back to the host.
    theta_r = torch.linalg.solve_ex(gram, phi_c.T @ y_c)[0]
    old = _column(carry.theta_q, carry.i)
    blended = params.alpha_q * theta_r + (1.0 - params.alpha_q) * old
    do = (carry.t - 1) > B  # len(memory) > BATCH_SIZE (dragg/agent.py:203)
    new_col = torch.where(do, blended, old)
    cols = torch.arange(params.n_q, device=old.device) == carry.i
    return torch.where(cols, new_col[:, None], carry.theta_q)


def memorize(carry, first, state, action, r, next_state):
    """The replay buffers after storing (s, a, r, s') at slot
    ``(t - 1) mod CAP`` (dragg/agent.py:125-128).  The t = 0 self-loop is
    dropped, so slot k - 1 holds step k's experience and the valid prefix
    stays dense.  Returns (mem_s, mem_a, mem_r, mem_s1)."""
    slot = torch.remainder(torch.clamp(carry.t - 1, min=0), MEMORY_CAP)
    row = (torch.arange(MEMORY_CAP, device=slot.device) == slot) & ~first
    return (torch.where(row[:, None], state, carry.mem_s),
            torch.where(row, action, carry.mem_a),
            torch.where(row, r, carry.mem_r),
            torch.where(row[:, None], next_state, carry.mem_s1))


def train_step(carry: AgentCarry, obs: RLObservation, params: AgentParams):
    """One agent step, the reference's ``train(env)`` (dragg/agent.py:130-149)
    with the observation passed in.  Returns ``(new_carry, record)``;
    ``new_carry.next_action`` is the action for the next timestep (the
    reward price before clipping)."""
    next_state = obs_to_state(obs)
    # Timestep 0: state ← next_state, action stays 0 (dragg/agent.py:132-136).
    first = carry.t == 0
    state = torch.where(first, next_state, carry.state)
    action = carry.next_action
    r = obs.reward.to(F32)

    key, k_next, k_ridge = rng.split(carry.key, 3)
    xu_k = _phi_sa(state, action)
    next_action, _ = _policy_action(carry.theta_mu, next_state, params.sigma, k_next)
    xu_k1 = _phi_sa(next_state, next_action)
    mem_s, mem_a, mem_r, mem_s1 = memorize(carry, first, state, action, r, next_state)

    # Twin-Q index flip before the TD pair (dragg/agent.py:190-201).
    i = torch.remainder(carry.i + 1, params.n_q).to(torch.int32)
    col = _column(carry.theta_q, i)
    q_pred = col @ xu_k
    q_obs = r + params.beta * (col @ xu_k1)

    t = carry.t + 1
    mid = carry._replace(mem_s=mem_s, mem_a=mem_a, mem_r=mem_r, mem_s1=mem_s1,
                         i=i, t=t, state=state)
    theta_q = _ridge_update(mid, params, k_ridge)

    # Policy update (dragg/agent.py:215-232), with the JAX package's three
    # documented deviations from the reference, which as written cannot
    # improve its policy: the TD error is target minus prediction; the
    # Gaussian score is (a - μ)/σ²·φ(s), not ·σ²; and the score is
    # standardized to (a - μ)/σ·φ(s), the 1/σ² folded into the step size,
    # so that ``alpha`` stays a dimensionless learning rate at any σ.
    x_k = _phi_s(state)
    delta = torch.clamp(q_obs - q_pred, -1.0, 1.0)
    avg_reward = carry.avg_reward + params.alpha_r * delta
    cum_reward = carry.cum_reward + r
    mu = torch.clamp(carry.theta_mu @ x_k, params.action_low, params.action_high)
    grad_pi_mu = (action - mu) / params.sigma * x_k
    z = params.lam_theta * carry.z_theta_mu + grad_pi_mu
    theta_mu = carry.theta_mu + params.alpha_mu * delta * z

    new_carry = AgentCarry(
        theta_mu=theta_mu, theta_q=theta_q, z_theta_mu=z, state=next_state,
        next_action=next_action, avg_reward=avg_reward, cum_reward=cum_reward,
        i=i, t=t, mem_s=mem_s, mem_a=mem_a, mem_r=mem_r, mem_s1=mem_s1, key=key)
    record = StepRecord(
        theta_q=_column(theta_q, i), theta_mu=theta_mu, q_obs=q_obs, q_pred=q_pred,
        action=action, average_reward=avg_reward, cumulative_reward=cum_reward,
        reward=r, mu=mu)
    return new_carry, record


def params_from_config(config: dict) -> AgentParams:
    """AgentParams from the [rl] tables (dragg/agent.py:71-86)."""
    p = config["rl"]["parameters"]
    space = config["rl"]["utility"]["action_space"]
    alpha = float(p["alpha"])
    return AgentParams(
        alpha_q=alpha,
        alpha_mu=alpha,
        alpha_r=alpha * 4.0,   # ALPHA_r = alpha·2² (dragg/agent.py:82)
        beta=float(p["beta"]),
        sigma=float(p["epsilon"]),
        batch_size=int(p["batch_size"]),
        n_q=2 if p.get("twin_q", True) else 1,
        lam_theta=0.01,
        ridge_alpha=0.01,
        action_low=float(space[0]),
        action_high=float(space[1]),
    )
