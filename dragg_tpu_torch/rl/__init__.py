"""The RL price-signal aggregator (counterpart of ``dragg_tpu/rl``).

The reference's linear actor-critic (polynomial / Fourier bases, a
Gaussian policy, a twin-Q critic refit by batch ridge regression over a
replay buffer, dragg/agent.py:42-232) as one functional step over an
explicit carry of tensors (:mod:`~dragg_tpu_torch.rl.core`), a DDPG
twin-Q core with the same step contract (:mod:`~dragg_tpu_torch.rl.neural`,
``[rl.parameters] agent = "ddpg"``), the environment side
(:mod:`~dragg_tpu_torch.rl.env`), the host agent classes
(:mod:`~dragg_tpu_torch.rl.agent`), the two RL run modes
(:mod:`~dragg_tpu_torch.rl.runner`) and their fleet form, a shared or a
per-community policy trained on C communities at once
(:mod:`~dragg_tpu_torch.rl.fleet`).
"""

from dragg_tpu_torch.rl.agent import RLAgent, UtilityAgent
from dragg_tpu_torch.rl.core import AgentCarry, AgentParams, RLObservation, init_carry, train_step

__all__ = [
    "RLAgent",
    "UtilityAgent",
    "AgentParams",
    "AgentCarry",
    "RLObservation",
    "init_carry",
    "train_step",
]
