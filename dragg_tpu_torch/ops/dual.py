"""Forward-mode AD in the solver loops (the fleet's ``rl.fleet.gradient =
"mpc"``, ``torch.autograd.forward_ad`` through the engine step).

PyTorch's forward formula for an operation between a tensor with a tangent
and one without meets the missing tangent with an efficient zero tensor,
whose elementwise operations take a slow path on the host (about 0.2 ms
each, against a few µs between two dual tensors).  A solver loop that
meets a tangent therefore lifts its constant operands to explicit zero
tangents once (:func:`with_zero_tangents`), and computes its control
quantities (residuals, certificates) on primal values (:func:`primal`).
Outside a dual level both are no-ops.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD


def has_tangent(*tensors) -> bool:
    """Whether any of ``tensors`` carries a forward-mode tangent."""
    return any(isinstance(t, torch.Tensor) and fwAD.unpack_dual(t).tangent is not None
               for t in tensors)


def primal(t):
    """``t`` without its tangent (``t`` itself when it has none)."""
    return fwAD.unpack_dual(t).primal if has_tangent(t) else t


def with_zero_tangents(*values, like: torch.Tensor):
    """Each value as a dual tensor: a tangent kept, a missing one zero; a
    Python number becomes a 0-dim tensor of ``like``'s dtype and device."""
    out = []
    for v in values:
        if not isinstance(v, torch.Tensor):
            v = torch.tensor(v, dtype=like.dtype, device=like.device)
        out.append(v if has_tangent(v) else fwAD.make_dual(v, torch.zeros_like(v)))
    return out
