"""Device resolution for the PyTorch port (counterpart of
``dragg_tpu/resilience/devices.py``).

Every entry point takes an explicit ``device``; ``None`` means the CUDA
card, and a missing card is an error rather than a silent move to the
CPU.  Tests and CPU users pass ``device="cpu"``.

Importing this module pins float32 matmuls and convolutions to full
float32 (TF32 off), the contract of the JAX package's
``precision=HIGHEST`` contractions (``dragg_tpu/ops/precision.py``).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` → ``"cuda"``, which must
    exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu'")
    return dev
