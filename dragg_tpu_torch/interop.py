"""Host arrays → the port's tensors, cast exactly where the JAX package's
x64-off ``jnp.asarray`` casts: float64 → float32, int64 → int32.  uint32
PRNG key words become int64 (torch has no full uint32 arithmetic; see
``rng.py``).  Starting both packages from identical state mid-run (the
parity tests) goes through these."""

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
