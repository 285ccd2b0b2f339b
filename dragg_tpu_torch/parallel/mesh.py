"""The sharded community engine (counterpart of
``dragg_tpu/parallel/mesh.py``).

The JAX package shards the home axis over a device mesh, every per-home
array placed with ``NamedSharding(mesh, P("homes"))``, and lets XLA insert
the collectives.  Here each rank of the process's world
(:mod:`~dragg_tpu_torch.parallel.world`) builds the whole padded host
batch (home synthesis is seeded, so the ranks agree), keeps its block of
every padded bucket on its own device (``Engine(world=...)``: the rows JAX
device r holds) and steps it, with the band kernels launched on the block.
The collectives are explicit:

* in the solvers, their batch-global decisions (``ops/ipm.py``,
  ``ops/admm.py``, ``ops/reluqp.py``);
* per step of a driven step, or once a chunk, the outputs' community
  totals (sum), the solver maxima (max) and the observatory fold (its
  histograms summed, each bucket's worst homes gathered and re-ranked):
  ``Engine._global_outputs``;
* per chunk, the per-home rows gathered to rank 0 in the world's slot
  order (``Engine.gather_homes``), on the host group.

Environment series and event timelines are whole on every rank, as
JAX's replicated ones; so are the PRNG key and the other non-per-home
leaves of the state.
"""

from __future__ import annotations

import numpy as np
import torch

from dragg_tpu_torch import kernel_cache
from dragg_tpu_torch.engine import (
    CommunityState,
    Engine,
    check_mask_for,
    engine_params,
    env_hour0,
    resolve_engine_events,
)
from dragg_tpu_torch.parallel.world import World, current_world

HOMES_AXIS = "homes"


def rank_device(world: World, device=None):
    """The device a rank runs on: ``device`` as given, else its card
    (``world.card()``, ``cuda:{local_rank}``; ``"cuda"`` in the world of
    one)."""
    if device is not None or world.size == 1:
        return device
    return world.card()


class ShardedEngine(Engine):
    """An :class:`~dragg_tpu_torch.engine.Engine` over this rank's block
    of the home axis of the process's world (the name and defaults of the
    JAX package's): ``world`` defaults to the process's and ``device`` to
    the rank's card.  The engine itself pads, splits and reduces."""

    def __init__(self, params, batch, env_oat, env_ghi, env_tou, check_mask=None,
                 device=None, fleet=None, events=None, hour0: int = 0,
                 world: World | None = None, axis_name: str = HOMES_AXIS):
        world = current_world() if world is None else world
        self.axis_name = axis_name
        super().__init__(params, batch, env_oat, env_ghi, env_tou,
                         check_mask=check_mask, device=rank_device(world, device),
                         fleet=fleet, events=events, hour0=hour0, world=world)


def shard_state(state, engine: Engine):
    """This rank's block of a whole-world state (one ``CommunityState`` a
    bucket, a tuple when bucketed, each per-home leaf over the bucket's
    padded slots), on the engine's device: every per-home leaf sliced to
    the rank's rows, the PRNG key whole."""
    states = state if engine.bucketed else (state,)
    out = []
    for c, st in zip(engine._buckets, states):
        out.append(CommunityState(*[
            torch.as_tensor(np.array(v) if name == "key"
                            else np.array(v)[c.block_start:c.block_start + c.n],
                            device=engine.device)
            for name, v in zip(CommunityState._fields, st)]))
    return tuple(out) if engine.bucketed else out[0]


def make_sharded_engine(batch, env, config, start_index: int, world: World | None = None,
                        device=None, fleet=None, events=None,
                        data_dir=None) -> ShardedEngine:
    """Sharded counterpart of :func:`dragg_tpu_torch.engine.make_engine`:
    this rank's engine over ``world`` (default: the process's), on
    ``device`` (default: the rank's card).  ``tpu.mesh_axis`` names the
    axis in logs; the port has no named axes.  The config places the
    kernel library, as in ``make_engine``."""
    kernel_cache.configure(config)
    axis = str(config.get("tpu", {}).get("mesh_axis", HOMES_AXIS))
    params = engine_params(config, start_index)
    if events is None:
        events = resolve_engine_events(config, env, params, fleet=fleet,
                                       data_dir=data_dir)
    return ShardedEngine(params, batch, env.oat, env.ghi, env.tou,
                         check_mask=check_mask_for(batch, config), device=device,
                         fleet=fleet, events=events, hour0=env_hour0(env),
                         world=world, axis_name=axis)
