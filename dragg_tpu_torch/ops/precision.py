"""Mixed-precision policy for the dense solver hot loop (counterpart of
``dragg_tpu/ops/precision.py``).

Every dense contraction of the ReLU-QP iteration (``ops/reluqp.py``) and
of the ADMM's dense-inverse apply (``ops/admm.py``) routes through
:func:`mxu_einsum`, and the residual/convergence path
declares itself with :func:`f32_guard`.

Two policies (``tpu.precision``):

* ``"f32"`` (default): a plain float32 ``torch.einsum``.  TF32 is off
  (``device.py``), so on the card this is full float32, as the JAX
  package's ``precision=HIGHEST``.
* ``"bf16x3"``: each float32 operand splits into a bf16 high part and a
  bf16 low remainder, and the contraction runs as the three products
  ``lo·hi + hi·lo + hi·hi`` accumulated in float32 (the ``lo·lo`` term,
  about 2⁻¹⁶ of the product, is dropped).

PyTorch's bf16 × bf16 product returns bf16, where JAX's
``preferred_element_type=float32`` returns float32.  So the split parts
are cast back to float32 (exactly: a bf16 value is a float32 value) and
contracted in float32.  A product of two 8-bit mantissas is exact in
float32, so this is the bf16-product, f32-accumulation scheme of the JAX
package up to the order of the float32 sums.
"""

from __future__ import annotations

import torch

# The policy registry: config validation (engine.engine_params) resolves
# against this tuple.
PRECISIONS = ("f32", "bf16x3")


def validate_precision(name: str) -> str:
    """Raise ValueError unless ``name`` is a registered policy."""
    if name not in PRECISIONS:
        raise ValueError(
            f"tpu.precision must be one of {'|'.join(PRECISIONS)}, "
            f"got {name!r}")
    return name


def _split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 split of ``x``: hi carries the top ~8 mantissa bits,
    lo the next ~8 (computed against hi in float32)."""
    hi = x.to(torch.bfloat16)
    lo = (x.to(torch.float32) - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def mxu_einsum(spec: str, a: torch.Tensor, b: torch.Tensor, *,
               precision: str = "f32", out_dtype=None) -> torch.Tensor:
    """The dense contraction of the solver hot path (module docstring).
    Accumulation is float32 under every policy.

    ``out_dtype`` is the JAX package's ``preferred_element_type``: under
    ``"f32"`` both operands are cast to it before the contraction, so the
    ADMM's bf16 ``Sinv`` (``admm_matvec_dtype = "bf16"``) contracts as
    exact bf16 products summed in float32, never as a bf16 einsum whose
    output cuBLAS would round to bf16."""
    if precision == "f32":
        if out_dtype is not None:
            a, b = a.to(out_dtype), b.to(out_dtype)
        return torch.einsum(spec, a, b)
    validate_precision(precision)
    a_hi, a_lo = (t.float() for t in _split_bf16(a))
    b_hi, b_lo = (t.float() for t in _split_bf16(b))

    def p(x, y):
        return torch.einsum(spec, x, y)

    # Small cross terms first, head term last, as the JAX package.
    out = (p(a_lo, b_hi) + p(a_hi, b_lo)) + p(a_hi, b_hi)
    return out if out_dtype is None else out.to(out_dtype)


def f32_guard(x: torch.Tensor, what: str) -> torch.Tensor:
    """Assert that a residual/convergence-path tensor is float32; returns
    ``x``.  Only the x-update contractions may run at reduced precision."""
    if x.dtype != torch.float32:
        raise TypeError(
            f"precision discipline: {what} must be float32 on the "
            f"residual/convergence path, got {x.dtype} — only the "
            f"x-update matmuls may run reduced precision")
    return x
