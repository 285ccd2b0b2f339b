"""Sharding over ``torch.distributed`` (counterpart of
``dragg_tpu/parallel/``): the home axis split in contiguous blocks over
the ranks of a gloo group, one process per card.

* :mod:`~dragg_tpu_torch.parallel.world`: the :class:`World` (rank, size,
  local rank, the groups and the few collectives a run needs), the world
  of one, and :func:`init_from_env`, which ``python -m dragg_tpu_torch
  run`` calls under ``$DRAGG_DISTRIBUTED=1``;
* :mod:`~dragg_tpu_torch.parallel.mesh`: :class:`ShardedEngine`,
  :func:`make_sharded_engine` and :func:`shard_state`.

A deliberate difference from the JAX package: one process drives one
card.  A JAX process drives every local device of its mesh; here four
cards take four processes (the ``$DRAGG_*`` variables, or ``torchrun``).
"""

from dragg_tpu_torch.parallel.world import (  # noqa: F401
    ONE,
    World,
    current_world,
    init_from_env,
    init_world,
    shutdown,
)

_MESH = ("ShardedEngine", "make_sharded_engine", "rank_device", "shard_state")


def __getattr__(name):
    # The engine imports world; mesh imports the engine, so it loads lazily.
    if name in _MESH:
        from dragg_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    raise AttributeError(f"module 'dragg_tpu_torch.parallel' has no attribute {name!r}")
