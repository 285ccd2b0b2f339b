"""JAX's threefry2x32 random streams in PyTorch.

The engine's per-home forecast noise decides the seasonal gate, so it is
part of the result: the port reproduces ``jax.random.PRNGKey``,
``fold_in``, ``bits`` and ``normal`` (the partitionable threefry layout
that JAX uses by default) instead of drawing from ``torch.Generator``.

Keys are int64 tensors of shape ``(..., 2)`` holding the two uint32 key
words; torch has no full uint32 arithmetic, so every word lives in int64
and is masked back to 32 bits after each add or shift.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 block cipher (20 rounds), elementwise over
    broadcastable int64 tensors of 32-bit words; returns ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _MASK
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a non-negative 32-bit seed."""
    seed = int(seed)
    if not 0 <= seed <= 0x7FFFFFFF:
        raise ValueError(f"seed must be a non-negative int32, got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: ``key`` is ``(..., 2)``,
    ``data`` an int or an int tensor broadcastable to ``key[..., 0]``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32 words in int64) for a batch
    of keys ``(..., 2)`` → ``(..., n)``."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(idx), idx)
    return y0 ^ y1


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' polynomial approximation), so the
    normals track JAX's to a few ulps on every device."""
    w_lt5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
             -4.39150654e-06, 0.00021858087, -0.00125372503,
             -0.00417768164, 0.246640727, 1.50140941)
    w_ge5 = (-0.000200214257, 0.000100950558, 0.00134934322,
             -0.00367342844, 0.00573950773, -0.0076224613,
             0.00943887047, 1.00167406, 2.83297682)
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, w_lt5[0], w_ge5[0]).to(x.dtype)
    for a, b in zip(w_lt5[1:], w_ge5[1:]):
        # One rounding per multiply-add, as XLA's contracted f32 FMA: the
        # f32 product is exact in float64.
        c = torch.where(lt, a, b).to(torch.float64)
        p = (c + p.double() * w.double()).to(x.dtype)
    res = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, res)


def normal(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.normal(key, (n,), float32)`` for a batch of keys."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # float32 nextafter(-1, 0): the open lower end of JAX's uniform draw.
    lo32 = torch.tensor(-(1.0 - 2.0 ** -24), dtype=torch.float32,
                        device=key.device)
    u = torch.maximum(lo32, f * 2.0 + lo32)
    return _erfinv_f32(u) * math.sqrt(2.0)
