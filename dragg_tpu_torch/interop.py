"""Host arrays → the port's tensors, cast exactly where the JAX package's
x64-off ``jnp.asarray`` casts: float64 → float32, int64 → int32.  uint32
PRNG key words become int64 (torch has no full uint32 arithmetic; see
``rng.py``).  Starting both packages from identical state mid-run (the
parity tests) goes through these: the engine's carry, and the RL agents'
and environment's."""

from __future__ import annotations

import numpy as np
import torch

_CASTS = {np.dtype(np.float64): torch.float32,
          np.dtype(np.int64): torch.int32,
          np.dtype(np.uint32): torch.int64}


def to_tensor(a, device) -> torch.Tensor:
    """One host array as a new tensor on ``device`` (never a view of the
    caller's array), with the JAX-package cast."""
    a = np.asarray(a)
    return torch.tensor(a, dtype=_CASTS.get(a.dtype), device=device)


def home_batch_from_numpy(fields: dict, device):
    """A ``HomeBatch._asdict()`` of numpy arrays → a HomeBatch of tensors."""
    from dragg_tpu_torch.homes import HomeBatch

    return HomeBatch(**{k: to_tensor(fields[k], device) for k in HomeBatch._fields})


def community_state_from_numpy(fields: dict, device):
    """A ``CommunityState._asdict()`` of numpy arrays → a CommunityState of
    tensors."""
    from dragg_tpu_torch.engine import CommunityState

    return CommunityState(**{k: to_tensor(fields[k], device)
                             for k in CommunityState._fields})


def engine_state_from_numpy(state, device):
    """The JAX engine's state (a CommunityState of arrays, or a tuple of
    them, one per bucket) → the port's, on ``device``: how a test starts
    both packages' engines, a fleet's included, from the same state."""
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        return tuple(engine_state_from_numpy(s, device) for s in state)
    return community_state_from_numpy(
        {k: np.asarray(v) for k, v in state._asdict().items()}, device)


def factor_carry_from_numpy(fields: dict, device, band_kernel: str = "xla"):
    """The JAX ADMM's ``FactorCarry._asdict()`` of numpy arrays (its Sinv a
    dense (B, m, m) inverse, float32 or bfloat16, or a (B, m, bw+1) band
    factor from its scan route) → the port's ``FactorCarry`` on either
    backend: a band factor is transposed to (m, bw+1, B) where the port's
    ADMM runs the band kernels (``band_kernel`` "auto" or "pallas"), and
    a bfloat16 inverse stays bfloat16."""
    from dragg_tpu_torch.ops.admm import FactorCarry

    kw = {k: to_tensor(fields[k], device) for k in FactorCarry._fields if k != "Sinv"}
    sinv = np.asarray(fields["Sinv"])
    band = sinv.shape[-1] != sinv.shape[-2]
    if sinv.dtype.name == "bfloat16":
        t = torch.tensor(sinv.astype(np.float32), device=device).to(torch.bfloat16)
    else:
        t = to_tensor(sinv, device)
    if band and band_kernel != "xla":
        t = t.permute(1, 2, 0).contiguous()
    return FactorCarry(Sinv=t, **kw)


def engine_factor_from_numpy(factor, device, band_kernel: str = "xla"):
    """The JAX engine's ADMM solver carry (a FactorCarry, or a tuple of
    them, one per bucket) → the port's (:func:`factor_carry_from_numpy`)."""
    if isinstance(factor, tuple) and not hasattr(factor, "_fields"):
        return tuple(engine_factor_from_numpy(f, device, band_kernel) for f in factor)
    return factor_carry_from_numpy({k: np.asarray(v) for k, v in factor._asdict().items()},
                                   device, band_kernel)


def agent_carry_from_numpy(fields: dict, device):
    """A linear ``AgentCarry._asdict()`` of numpy arrays → an AgentCarry of
    tensors."""
    from dragg_tpu_torch.rl.core import AgentCarry

    return AgentCarry(**{k: to_tensor(fields[k], device) for k in AgentCarry._fields})


def _net_from_flax(variables: dict, device) -> dict:
    """flax's ``{"params": {"Dense_i": {"kernel": (in, out), "bias"}}}`` →
    the port's ``nn.Linear`` weights ``{"l<i>.weight": (out, in),
    "l<i>.bias"}`` (a per-community stack keeps its leading axis)."""
    layers = variables["params"]
    out = {}
    for i in range(len(layers)):
        dense = layers[f"Dense_{i}"]
        out[f"l{i}.bias"] = to_tensor(dense["bias"], device)
        out[f"l{i}.weight"] = to_tensor(np.swapaxes(np.asarray(dense["kernel"]), -1, -2),
                                        device)
    return out


def _ddpg_fields(cls, fields: dict, device):
    """A DDPG carry of class ``cls`` from its numpy fields: the six
    networks and the three Adam states ``(mu, nu, count)`` in
    ``nn.Linear``'s layout, every other field a tensor."""
    from dragg_tpu_torch.rl.neural import AdamState

    nets = ("actor", "critic1", "critic2", "t_actor", "t_critic1", "t_critic2")
    kw = {k: _net_from_flax(fields[k], device) for k in nets}
    for k in ("opt_actor", "opt_critic1", "opt_critic2"):
        mu, nu, count = fields[k]
        kw[k] = AdamState(mu=_net_from_flax(mu, device), nu=_net_from_flax(nu, device),
                          count=to_tensor(count, device))
    for k in cls._fields:
        if k not in kw:
            kw[k] = to_tensor(fields[k], device)
    return cls(**kw)


def ddpg_carry_from_numpy(fields: dict, device):
    """A ``DDPGCarry._asdict()`` of numpy arrays (flax weights, Adam states
    as ``(mu, nu, count)``) → a DDPGCarry of tensors, the weights and
    their Adam moments in ``nn.Linear``'s layout.  A per-community stack
    (leading C axis on every leaf) converts alike."""
    from dragg_tpu_torch.rl.neural import DDPGCarry

    return _ddpg_fields(DDPGCarry, fields, device)


def env_carry_from_numpy(fields: dict, device):
    """An ``EnvCarry._asdict()`` of numpy arrays (its tracker a
    one-field tuple) → an EnvCarry of tensors; a fleet's (C,) leaves
    alike."""
    from dragg_tpu_torch.rl.env import EnvCarry, SetpointTracker

    kw = {k: to_tensor(fields[k], device) for k in EnvCarry._fields if k != "tracker"}
    (tracked,) = fields["tracker"]
    return EnvCarry(**kw, tracker=SetpointTracker(to_tensor(tracked, device)))


def fleet_linear_carry_from_numpy(fields: dict, device):
    """A ``FleetLinearCarry._asdict()`` of numpy arrays → the port's."""
    from dragg_tpu_torch.rl.fleet import FleetLinearCarry

    return FleetLinearCarry(**{k: to_tensor(fields[k], device)
                               for k in FleetLinearCarry._fields})


def fleet_ddpg_carry_from_numpy(fields: dict, device):
    """A ``FleetDDPGCarry._asdict()`` of numpy arrays (flax ``(in, out)``
    kernels) → the port's, in ``nn.Linear``'s ``(out, in)`` layout."""
    from dragg_tpu_torch.rl.fleet import FleetDDPGCarry

    return _ddpg_fields(FleetDDPGCarry, fields, device)


def fleet_env_carry_from_numpy(fields: dict, device):
    """A ``FleetEnvCarry`` as ``{"env": EnvCarry._asdict(), "drda": (C,)}``
    of numpy arrays → the port's."""
    from dragg_tpu_torch.rl.fleet import FleetEnvCarry

    return FleetEnvCarry(env=env_carry_from_numpy(fields["env"], device),
                         drda=to_tensor(fields["drda"], device))
