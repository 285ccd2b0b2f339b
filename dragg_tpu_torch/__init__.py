"""dragg_tpu_torch — the PyTorch/CUDA port of dragg_tpu.

The same community MPC simulation (config, homes, batched interior-point
solve, results.json) on an NVIDIA GPU, with the banded-Schur factor and
solves in hand-written CUDA kernels (``csrc/band.cu``).  The JAX package
``dragg_tpu`` stays the reference; this package imports nothing of it.

    from dragg_tpu_torch import Aggregator
    Aggregator(config, device="cuda").run()
"""

__version__ = "0.1.0"

from dragg_tpu_torch import device as _device  # noqa: F401  (pins TF32 off)
from dragg_tpu_torch.config import default_config, load_config  # noqa: F401


def __getattr__(name):
    # Lazy import keeps `import dragg_tpu_torch` light.
    if name == "Aggregator":
        from dragg_tpu_torch.aggregator import Aggregator

        return Aggregator
    raise AttributeError(f"module 'dragg_tpu_torch' has no attribute {name!r}")
