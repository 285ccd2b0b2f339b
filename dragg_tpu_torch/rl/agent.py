"""Host-facing RL agent classes with the reference's API (counterpart of
``dragg_tpu/rl/agent.py``).

``RLAgent`` mirrors the reference's abstract class (dragg/agent.py:42-123):
``train(env)``, ``get_policy_action(state)``, rl_data recording and
writing, and a warm start from a previous run.  Every numeric update is
the functional core's step (:mod:`dragg_tpu_torch.rl.core`, or
:mod:`dragg_tpu_torch.rl.neural` with ``rl.parameters.agent = "ddpg"``)
on tensors on the agent's device.

``UtilityAgent`` is the concrete price-signal designer: its state
(forecast error and trend, time of day, change in action) and its
negative-quadratic tracking reward are :func:`dragg_tpu_torch.rl.env.observe`,
the same function the run's step loop calls.
"""

from __future__ import annotations

import json
import os

import torch

from dragg_tpu_torch import device as _device  # noqa: F401  (pins TF32 off)
from dragg_tpu_torch import rng
from dragg_tpu_torch.checkpoint import to_host
from dragg_tpu_torch.device import resolve_device
from dragg_tpu_torch.parallel.world import current_world
from dragg_tpu_torch.rl import core, neural
from dragg_tpu_torch.rl.core import RLObservation, StepRecord
from dragg_tpu_torch.rl.env import EnvCarry, observe

RL_DATA_KEYS = (
    "theta_q", "theta_mu", "q_obs", "q_pred", "action",
    "average_reward", "cumulative_reward", "reward", "mu",
)
F32 = torch.float32


def new_rl_data(beta: float, batch_size: int, sigma: float, extra_params: dict) -> dict:
    """A fresh rl_data telemetry dict (dragg/agent.py:247-256 schema)."""
    data: dict = {k: [] for k in RL_DATA_KEYS}
    data["parameters"] = {"beta": beta, "batch_size": batch_size, "sigma": sigma,
                          **extra_params}
    return data


class RLAgent:
    """The price-signal agent (dragg/agent.py:42) with a linear or a DDPG
    core.  Subclasses provide ``calc_state(env)`` and ``reward(env)``;
    ``train(env)`` runs one core step."""

    name = "agent"

    def __init__(self, config: dict, seed: int | None = None, device=None):
        self.config = config
        self.device = resolve_device(device)
        if seed is None:
            seed = int(config["simulation"]["random_seed"])
        self.kind = str(config["rl"]["parameters"].get("agent", "linear"))
        if self.kind == "ddpg":
            self.params = neural.params_from_config(config)
            self.carry = neural.init_carry(self.params, seed, self.device)
            self.step_core = neural.train_step
            extra_params = {"agent": "ddpg", "tau": self.params.tau,
                            "actor_lr": self.params.actor_lr,
                            "critic_lr": self.params.critic_lr}
        elif self.kind == "linear":
            self.params = core.params_from_config(config)
            self.carry = core.init_carry(self.params, seed, self.device)
            self.step_core = core.train_step
            extra_params = {"agent": "linear", "alpha_q": self.params.alpha_q,
                            "alpha_mu": self.params.alpha_mu,
                            "alpha_r": self.params.alpha_r,
                            "twin_q": self.params.n_q == 2}
        else:
            raise ValueError(f"Unknown rl.parameters.agent {self.kind!r} (linear | ddpg)")
        self.rl_data: dict = new_rl_data(self.params.beta, self.params.batch_size,
                                         self.params.sigma, extra_params)

    def scan_step(self, carry, obs: RLObservation):
        """(carry, obs) → (carry, StepRecord): the step the run loops call."""
        return self.step_core(carry, obs, self.params)

    # -- abstract surface (dragg/agent.py:67-69,113-123) --------------------
    def calc_state(self, env) -> dict:
        raise NotImplementedError

    def reward(self, env) -> float:
        raise NotImplementedError

    def _scalar(self, v) -> torch.Tensor:
        return torch.tensor(v, dtype=F32, device=self.device)

    # ----------------------------------------------------------------- train
    def train(self, env) -> float:
        """One RL step (dragg/agent.py:130-149); returns the next action."""
        s = self.calc_state(env)
        obs = RLObservation(*(self._scalar(s[k]) for k in RLObservation._fields[:4]),
                            reward=self._scalar(self.reward(env)))
        self.carry, rec = self.scan_step(self.carry, obs)
        self.record_chunk(StepRecord(*(torch.stack([f]) for f in rec)))
        return float(self.carry.next_action)

    def get_policy_action(self, state: dict) -> float:
        """a ~ N(μ(s), σ) without an update (dragg/agent.py:151-165)."""
        key, sub = rng.split(self.carry.key, 2)
        self.carry = self.carry._replace(key=key)
        sv = torch.tensor([state["fcst_error"], state["forecast_trend"],
                           state["time_of_day"], state["delta_action"]],
                          dtype=F32, device=self.device)
        if self.kind == "ddpg":
            a = neural._mu(self.carry.actor, sv, self.params) + \
                self.params.sigma * rng.normal(sub, 1)[0]
        else:
            a, _ = core._policy_action(self.carry.theta_mu, sv, self.params.sigma, sub)
        return float(a)

    # ------------------------------------------------------------- telemetry
    def record_chunk(self, recs: StepRecord) -> None:
        """Append a chunk of stacked StepRecords (tensors or arrays, steps
        first) to rl_data: one host copy a chunk."""
        host = StepRecord(*(to_host(f) for f in recs))
        for k in range(host.q_obs.shape[0]):
            self.rl_data["theta_q"].append(host.theta_q[k].tolist())
            self.rl_data["theta_mu"].append(host.theta_mu[k].tolist())
            for name in RL_DATA_KEYS[2:]:
                self.rl_data[name].append(float(getattr(host, name)[k]))

    def write_rl_data(self, output_dir: str) -> None:
        """<output_dir>/<name>_agent-results.json (dragg/agent.py:270-273);
        in a sharded run rank 0 alone writes, as every output writer."""
        if current_world().rank != 0:
            return
        with open(os.path.join(output_dir, f"{self.name}_agent-results.json"), "w") as f:
            json.dump(self.rl_data, f, indent=4)

    def load_from_previous(self, file: str) -> None:
        """Warm-start θ from a previous agent-results file
        (dragg/agent.py:275-282).  The linear core only: the DDPG
        telemetry holds parameter norms, not weights; a DDPG run resumes
        from its checkpoint directory instead."""
        if self.kind == "ddpg":
            raise ValueError(
                "load_from_previous applies to the linear agent; resume a "
                "DDPG run from its checkpoint directory instead"
            )
        with open(file) as f:
            data = json.load(f)
        if data.get("theta_mu"):
            self.carry = self.carry._replace(theta_mu=self._scalar(data["theta_mu"][-1]))
        if data.get("theta_q"):
            col = self._scalar(data["theta_q"][-1])
            self.carry = self.carry._replace(
                theta_q=torch.stack([col] * self.params.n_q, dim=1))


class UtilityAgent(RLAgent):
    """The community price-signal designer.

    ``env`` duck-type: ``agg_load``, ``forecast_load``,
    ``prev_forecast_load``, ``agg_setpoint``, ``timestep``, ``dt``,
    ``norm`` (the community's max possible load), ``prev_action``,
    ``action``."""

    name = "utility"

    def _observe(self, env) -> RLObservation:
        ec = EnvCarry(
            agg_load=self._scalar(env.agg_load),
            forecast_load=self._scalar(env.forecast_load),
            prev_forecast_load=self._scalar(env.prev_forecast_load),
            setpoint=self._scalar(env.agg_setpoint),
            prev_action=self._scalar(env.prev_action),
            action=self._scalar(env.action),
            tracker=None,  # observe() does not read it
        )
        return observe(ec, int(env.timestep), env.dt, env.norm)

    def calc_state(self, env) -> dict:
        o = self._observe(env)
        return {k: float(getattr(o, k)) for k in RLObservation._fields[:4]}

    def reward(self, env) -> float:
        return float(self._observe(env).reward)

