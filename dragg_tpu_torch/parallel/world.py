"""The ranks of a sharded run and the few collectives it needs.

One process drives one card.  A run over W cards is W processes in one
``torch.distributed`` group: ``python -m dragg_tpu_torch run`` with
``$DRAGG_DISTRIBUTED=1`` (and ``$DRAGG_COORDINATOR_ADDRESS``,
``$DRAGG_NUM_PROCESSES``, ``$DRAGG_PROCESS_ID``, as the JAX package reads
them), or under ``torchrun`` (``env://``).  What crosses ranks is small and
already crosses to the host — a flag a solver check window, a load vector
a step, a chunk's per-home rows — so the collectives run over gloo on
host tensors, which also serves two ranks sharing one card (NCCL refuses
that layout).

A :class:`World` holds two gloo groups over the same ranks: ``group`` for
the engine's collectives (the solvers' stop decisions and the step's
reductions, on the thread that drives the chunks) and ``host_group`` for
the aggregator's (the chunk gather and the checkpoint protocol, which the
host pipeline runs on its worker thread).  Each group's collectives are
called from one thread in the same order on every rank.

The world of one (:data:`ONE`) has no group: every collective is the
identity, so an unsharded run makes none.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch

ENV_ADDRESS = "DRAGG_COORDINATOR_ADDRESS"
ENV_NUM = "DRAGG_NUM_PROCESSES"
ENV_ID = "DRAGG_PROCESS_ID"
# Seconds a collective waits for the other ranks before it raises (and
# the run ends non-zero).
TIMEOUT = datetime.timedelta(seconds=600)

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


@dataclass(frozen=True)
class World:
    """``rank`` of ``size`` processes; ``local_rank`` picks the card
    (``cuda:{local_rank}``).  ``group`` is None in the world of one."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    group: object = None
    host_group: object = None

    @property
    def distributed(self) -> bool:
        """Whether a process group exists (a world of one launched through
        the distributed entry has one): checkpoints are then written as
        per-rank shard files."""
        return self.group is not None

    def _group(self, host: bool):
        return self.host_group if host else self.group

    def all_reduce(self, values, op: str = "sum", host: bool = False) -> np.ndarray:
        """Element-wise ``op`` (sum | min | max) of a small array over the
        ranks, in float64 (exact for the counts and float32 values that
        cross)."""
        a = np.asarray(values, dtype=np.float64)
        if self.group is None:
            return a
        import torch.distributed as dist

        t = torch.from_numpy(np.ascontiguousarray(a))
        dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]), group=self._group(host))
        return t.numpy()

    def any(self, flag: bool, host: bool = False) -> bool:
        return bool(self.all_reduce([float(flag)], "max", host)[0] > 0)

    def all(self, flag: bool, host: bool = False) -> bool:
        return bool(self.all_reduce([float(flag)], "min", host)[0] > 0)

    def max(self, value, host: bool = False):
        return type(value)(self.all_reduce([value], "max", host)[0])

    def all_gather(self, values, host: bool = False) -> np.ndarray:
        """(size, *shape) stack of every rank's equal-shaped array, in rank
        order, in the array's dtype."""
        a = np.ascontiguousarray(values)
        if self.group is None:
            return a[None]
        import torch.distributed as dist

        t = torch.from_numpy(a)
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self._group(host))
        return np.stack([o.numpy() for o in out])

    def gather(self, values, host: bool = True) -> np.ndarray | None:
        """Rank 0's (size, *shape) stack of every rank's equal-shaped array
        in rank order; None on the other ranks."""
        a = np.ascontiguousarray(values)
        if self.group is None:
            return a[None]
        import torch.distributed as dist

        t = torch.from_numpy(a)
        out = [torch.empty_like(t) for _ in range(self.size)] if self.rank == 0 else None
        dist.gather(t, out, dst=0, group=self._group(host))
        return np.stack([o.numpy() for o in out]) if self.rank == 0 else None

    def broadcast(self, values, host: bool = True) -> np.ndarray:
        """Rank 0's array on every rank (the other ranks pass an array of
        the same shape and dtype)."""
        a = np.ascontiguousarray(values)
        if self.group is None:
            return a
        import torch.distributed as dist

        t = torch.from_numpy(a.copy())
        dist.broadcast(t, src=0, group=self._group(host))
        return t.numpy()

    def barrier(self, host: bool = True) -> None:
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self._group(host))


ONE = World()

_WORLD: World | None = None


def current_world() -> World:
    """The process's world: the one :func:`init_from_env` (or
    :func:`init_world`) made, else the world of one."""
    return _WORLD if _WORLD is not None else ONE


def init_world(init_method: str, size: int, rank: int,
               local_rank: int | None = None) -> World:
    """Join a gloo group of ``size`` ranks at ``init_method``
    (``tcp://host:port`` or ``env://``) as ``rank``; the process's world
    from then on.  ``local_rank`` (default: ``$LOCAL_RANK``, else the
    rank) picks the card."""
    global _WORLD
    import torch.distributed as dist

    if not 0 <= rank < size:
        raise ValueError(f"process rank {rank} outside a world of {size}")
    dist.init_process_group("gloo", init_method=init_method, world_size=size,
                            rank=rank, timeout=TIMEOUT)
    host_group = dist.new_group(backend="gloo", timeout=TIMEOUT)
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    _WORLD = World(rank=rank, size=size, local_rank=local_rank,
                   group=dist.group.WORLD, host_group=host_group)
    return _WORLD


def missing_env() -> list[str]:
    """The process variables missing beside ``$DRAGG_COORDINATOR_ADDRESS``
    (empty when it is unset or all three are set)."""
    if not os.environ.get(ENV_ADDRESS):
        return []
    return [v for v in (ENV_NUM, ENV_ID) if not os.environ.get(v)]


def missing_env_message(missing: list[str]) -> str:
    """The JAX package's message for an incomplete explicit init."""
    return (f"{ENV_ADDRESS} is set but {' and '.join(missing)} is missing; all "
            "three are required for explicit multi-process init.")


def init_from_env() -> World:
    """The world a ``$DRAGG_DISTRIBUTED=1`` run joins: with
    ``$DRAGG_COORDINATOR_ADDRESS`` a gloo group at ``tcp://<address>`` of
    ``$DRAGG_NUM_PROCESSES`` ranks as ``$DRAGG_PROCESS_ID``; without it,
    torchrun's ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``).  Raises ``ValueError`` with the JAX package's message
    when the address is set and a variable is missing."""
    if _WORLD is not None:
        return _WORLD
    missing = missing_env()
    if missing:
        raise ValueError(missing_env_message(missing))
    if os.environ.get(ENV_ADDRESS):
        return init_world(f"tcp://{os.environ[ENV_ADDRESS]}",
                          int(os.environ[ENV_NUM]), int(os.environ[ENV_ID]))
    return init_world("env://", int(os.environ["WORLD_SIZE"]),
                      int(os.environ["RANK"]))


def shutdown() -> None:
    """Leave the group (the world is the world of one again)."""
    global _WORLD
    if _WORLD is not None and _WORLD.group is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    _WORLD = None
