"""Device resolution for the PyTorch port (counterpart of
``dragg_tpu/resilience/devices.py``).

Every entry point takes an explicit ``device``; ``None`` means the CUDA
card, and a missing card is an error rather than a silent move to the
CPU.  Tests and CPU users pass ``device="cpu"``.

Float32 matmuls and convolutions run in full float32 (TF32 off), the
contract of the JAX package's ``precision=HIGHEST`` contractions
(``dragg_tpu/ops/precision.py``).  The pin is set when this module is
imported, which every module that computes on tensors does (the engine,
the aggregator, ``ops``, ``rl``, ``checkpoint``, ``interop``), and again
by :func:`resolve_device`.  ``import dragg_tpu_torch`` itself does not
import torch, so that a supervising parent stays free of it.
"""

from __future__ import annotations

import torch


def pin_precision() -> None:
    """TF32 off for float32 matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


pin_precision()


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` → ``"cuda"``, which must
    exist, as must a numbered card.  Applies :func:`pin_precision`."""
    pin_precision()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu'")
    if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"no CUDA device {dev.index}: {torch.cuda.device_count()} visible")
    return dev
