"""The ranks of a sharded run and the few collectives it needs.

One process drives one card.  A run over W cards is W processes in one
``torch.distributed`` group: ``python -m dragg_tpu_torch run`` with
``$DRAGG_DISTRIBUTED=1``.  :func:`detect` finds the ranks, trying in turn
``$DRAGG_COORDINATOR_ADDRESS`` with ``$DRAGG_NUM_PROCESSES`` and
``$DRAGG_PROCESS_ID`` (as the JAX package reads them), torchrun's
``env://``, then Open MPI and SLURM as ``jax.distributed.initialize()``
finds them (``jax/_src/clusters/ompi_cluster.py``, ``slurm_cluster.py``):
the same presence tests, coordinator address, port and ids.  torchrun
comes before them, unlike in JAX (which has no torchrun detector),
because torchrun inside ``srun`` starts several processes that share
one ``$SLURM_PROCID``.  Each rank drives the card of its local id.  What
crosses ranks is small and
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
import re
from dataclasses import dataclass

import numpy as np
import torch

ENV_ADDRESS = "DRAGG_COORDINATOR_ADDRESS"
ENV_NUM = "DRAGG_NUM_PROCESSES"
ENV_ID = "DRAGG_PROCESS_ID"
# The variables each launcher sets, as each detector tests for them.
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
OMPI_URI = "OMPI_MCA_orte_hnp_uri"
OMPI_VARS = ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")
SLURM_VARS = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS", "SLURM_PROCID",
              "SLURM_LOCALID")
# Overrides the coordinator port derived from the job id (JAX's variable).
ENV_PORT = "JAX_COORDINATOR_PORT"
NO_CLUSTER = (f"DRAGG_DISTRIBUTED=1 but no cluster was found: set {ENV_ADDRESS}, "
              f"{ENV_NUM} and {ENV_ID}, or run under torchrun ({', '.join(TORCHRUN_VARS)}), "
              f"Open MPI ({OMPI_URI}) or SLURM ({', '.join(SLURM_VARS)})")
# Seconds a collective waits for the other ranks before it raises (and
# the run ends non-zero).
TIMEOUT = datetime.timedelta(seconds=600)

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


@dataclass(frozen=True)
class World:
    """``rank`` of ``size`` processes; ``local_rank`` picks the card
    (:meth:`card`).  ``group`` is None in the world of one."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    group: object = None
    host_group: object = None

    def card(self) -> str:
        """``cuda:{local_rank}``, the rank's card; raises when the local id
        is not below the number of visible cards (no other card is
        taken)."""
        n = torch.cuda.device_count()
        if self.local_rank >= n:
            raise RuntimeError(f"rank {self.rank}: local id {self.local_rank} is not below "
                               f"the {n} visible CUDA devices")
        return f"cuda:{self.local_rank}"

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


@dataclass(frozen=True)
class Cluster:
    """The ranks :func:`detect` found: the launcher (``"dragg"``,
    ``"torchrun"``, ``"ompi"`` or ``"slurm"``), the coordinator's
    ``host:port`` as JAX gives it (None under torchrun, whose ``env://``
    reads ``MASTER_ADDR`` and ``MASTER_PORT``), and the count, id and
    local id."""

    name: str
    address: str | None
    size: int
    rank: int
    local_rank: int

    @property
    def init_method(self) -> str:
        if self.address is None:
            return "env://"
        host, _, port = self.address.rpartition(":")
        bare_v6 = ":" in host and not host.startswith("[")
        return f"tcp://[{host}]:{port}" if bare_v6 else f"tcp://{host}:{port}"


def _job_port(job_id: int) -> str:
    """``$JAX_COORDINATOR_PORT``, else a port in 61440-65535 from the job id."""
    return os.environ.get(ENV_PORT) or str(job_id % 2**12 + (65535 - 2**12 + 1))


def ompi_address() -> str:
    """The coordinator of an Open MPI job: the launcher's first address in
    ``$OMPI_MCA_orte_hnp_uri`` (``tcp://`` or ``tcp6://``) and the port
    of its job id (a multiple of 2^12, divided by it)."""
    uri = os.environ[OMPI_URI]
    port = _job_port(int(uri.split(".", maxsplit=1)[0]) // 2**12)
    match = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
    if match is None:
        raise ValueError(f"cannot read the coordinator's address from {OMPI_URI}={uri!r}")
    return f"{next(g for g in match.groups() if g is not None)}:{port}"


def slurm_address() -> str:
    """The coordinator of a SLURM step: the first host of
    ``$SLURM_STEP_NODELIST`` (``node001``, ``node001,host2``,
    ``node[001-015],host2`` or ``node[001,007-015],host2``) and the port
    of ``$SLURM_JOB_ID``."""
    port = _job_port(int(os.environ["SLURM_JOB_ID"]))
    nodes = os.environ["SLURM_STEP_NODELIST"]
    i = next((k for k, ch in enumerate(nodes) if ch in ",["), len(nodes))
    if i == len(nodes) or nodes[i] == ",":
        return f"{nodes[:i]}:{port}"
    suffix = nodes[i + 1:]
    j = next((k for k, ch in enumerate(suffix) if ch in ",-"), None)
    return f"{nodes[:i]}{suffix[:j]}:{port}"


def detect() -> Cluster | None:
    """The ranks the environment describes, tried in the module
    docstring's order; None when none does.  Raises ``ValueError`` with
    the JAX package's message when ``$DRAGG_COORDINATOR_ADDRESS`` is set
    and a variable beside it is missing."""
    env = os.environ
    if env.get(ENV_ADDRESS):
        missing = missing_env()
        if missing:
            raise ValueError(missing_env_message(missing))
        rank = int(env[ENV_ID])
        return Cluster("dragg", env[ENV_ADDRESS], int(env[ENV_NUM]), rank,
                       int(env.get("LOCAL_RANK", rank)))
    if all(v in env for v in TORCHRUN_VARS):
        rank = int(env["RANK"])
        return Cluster("torchrun", None, int(env["WORLD_SIZE"]), rank,
                       int(env.get("LOCAL_RANK", rank)))
    if OMPI_URI in env:
        return Cluster("ompi", ompi_address(), *(int(env[v]) for v in OMPI_VARS))
    if all(v in env for v in SLURM_VARS):
        return Cluster("slurm", slurm_address(), int(env["SLURM_NTASKS"]),
                       int(env["SLURM_PROCID"]), int(env["SLURM_LOCALID"]))
    return None


def init_from_env() -> World:
    """The world a ``$DRAGG_DISTRIBUTED=1`` run joins: the gloo group of
    the ranks :func:`detect` finds.  Raises ``ValueError`` with the JAX
    package's message when the address is set and a variable is missing,
    and with :data:`NO_CLUSTER` when nothing describes the ranks."""
    if _WORLD is not None:
        return _WORLD
    found = detect()
    if found is None:
        raise ValueError(NO_CLUSTER)
    return init_world(found.init_method, found.size, found.rank, found.local_rank)


def shutdown() -> None:
    """Leave the group (the world is the world of one again)."""
    global _WORLD
    if _WORLD is not None and _WORLD.group is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    _WORLD = None
