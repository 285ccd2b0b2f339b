"""Device enumeration for the sharded run (counterpart of
``dragg_tpu/resilience/devices.py``).

The JAX package counts the devices of its one program (every local
device, and with ``jax.distributed`` every process's); its aggregator
shards the home axis when that count exceeds one.  Here one process
drives one card, so the count is the number of ranks in the process's
world (:func:`dragg_tpu_torch.parallel.current_world`): a process with no
group runs unsharded whatever cards it sees, and four cards take four
processes.

Import rule: the world is imported inside the function, so the torch-free
parent of a supervised run can import the ``resilience`` package.
"""

from __future__ import annotations


def device_count() -> int:
    """The ranks of the process's world: the devices a run shards over."""
    from dragg_tpu_torch.parallel.world import current_world

    return current_world().size

