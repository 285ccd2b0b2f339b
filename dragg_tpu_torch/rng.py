"""JAX's threefry2x32 random streams in PyTorch.

The engine's per-home forecast noise decides the seasonal gate, and the
RL agents' exploration noise, replay indices and weight initialization
steer the reward price, so they are part of the result: the port
reproduces ``jax.random.PRNGKey``, ``split``, ``fold_in``, ``bits``,
``randint``, ``normal`` and ``truncated_normal`` (the partitionable
threefry layout that JAX uses by default, ``jax_threefry_partitionable``)
instead of drawing from ``torch.Generator``.

Keys are int64 tensors of shape ``(..., 2)`` holding the two uint32 key
words; torch has no full uint32 arithmetic, so every word lives in int64
and is masked back to 32 bits after each add, multiply or shift.

The float draws follow XLA's CPU code for ``erf_inv`` and ``log1p`` step
for step, each multiply-add that XLA contracts into one FMA rounded once,
so they equal ``jax.random``'s on the CPU bit for bit.
"""

from __future__ import annotations

import hashlib
import math
import struct

import torch

from dragg_tpu_torch import device as _device  # noqa: F401  (pins TF32 off)
from dragg_tpu_torch import telemetry

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
    if not (isinstance(data, torch.Tensor) and data.device == key.device):
        telemetry.inc("engine.host_syncs")  # a copy to the card waits for it
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


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)`` for a batch of keys ``(..., 2)`` →
    ``(..., n, 2)``: key ``i`` is threefry of the counter pair ``(0, i)``,
    which is ``fold_in(key, i)``."""
    return fold_in(key[..., None, :], torch.arange(n, device=key.device))


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """The top 23 bits of each word as a float32 in [0, 1) (JAX's
    ``uniform`` before scaling)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, n: int, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)`` (int32 bounds,
    which may be tensors on the key's device, so a traced bound never
    leaves the device) as int64.  JAX draws two words a value from the
    key's two halves and folds them into the span with a multiplier and
    a modulus; a span of at most 0 gives ``minval``."""
    k = split(key, 2)
    hi, lo = random_bits(k[..., 0, :], n), random_bits(k[..., 1, :], n)
    # A Python bound stays a Python number: a tensor made from it on a CUDA
    # device would be a host-to-device copy that waits for the device.
    minval, maxval = (v.long() if isinstance(v, torch.Tensor) else int(v)
                      for v in (minval, maxval))
    empty = maxval <= minval
    span = (torch.where(empty, 1, (maxval - minval) & _MASK)
            if isinstance(empty, torch.Tensor) else 1 if empty else (maxval - minval) & _MASK)
    # 2**16 % span < 2**16, so its square fits in a 32-bit word.
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = ((hi % span) * mult + lo % span) & _MASK
    return minval + off % span


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a·b + c`` rounded once to float32, as XLA's contracted multiply-add
    on the CPU: the product of two float32 values is exact in float64."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


# XLA's float32 ``log`` on the CPU (Cephes' logf: the mantissa in
# [sqrt(1/2), sqrt(2)) - 1, a degree-8 polynomial, the exponent's log2 in
# two parts) and ``log1p`` (log of 1 + x, or below sqrt(2) - 1 in
# magnitude a 6/6 rational function).
_LOG_P = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
          -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
          0.2000071406364441, -0.24999994039535522, 0.3333333134651184)
_LOG_Q1, _LOG_Q2 = -0.00021219444170128554, 0.693359375
_SQRT_HALF = 0.7071067690849304
_FLT_MIN = 1.1754943508222875e-38
_LOG1P_NUM = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
              29.91191864013672, 60.949668884277344, 57.11296463012695,
              20.039552688598633)
_LOG1P_DEN = (1.0, 15.062909126281738, 83.04756927490234, 221.7624053955078,
              309.0987243652344, 216.42788696289062, 60.11865997314453)
_LOG1P_SMALL = 0.4142135679721832


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` on the CPU, bit for bit."""
    xc = torch.where(x > _FLT_MIN, x, _FLT_MIN)
    bits = xc.view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0 - small.to(torch.float32)
    f = (m - 1.0) + torch.where(small, m, 0.0)
    z = f * f
    f3 = z * f
    p = _LOG_P
    y1 = _fma(_fma(f, p[0], p[1]), f, p[2])
    y2 = _fma(_fma(f, p[3], p[4]), f, p[5])
    y3 = _fma(_fma(f, p[6], p[7]), f, p[8])
    y = _fma(_fma(y1, f3, y2), f3, y3)
    y = _fma(y, f3, e * _LOG_Q1)
    r = _fma(e, _LOG_Q2, (f - z * 0.5) + y)
    r = torch.where((x < 0) | torch.isnan(x), math.nan, r)
    return torch.where(x == 0, -math.inf, torch.where(x == math.inf, math.inf, r))


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` on the CPU, bit for bit."""
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, x, c)
    den = torch.ones_like(x)
    for c in _LOG1P_DEN[1:]:
        den = _fma(den, x, c)
    x2 = x * x
    small = x + _fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log_f32(x + 1.0))


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' polynomial approximation) on the
    CPU, bit for bit."""
    w_lt5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
             -4.39150654e-06, 0.00021858087, -0.00125372503,
             -0.00417768164, 0.246640727, 1.50140941)
    w_ge5 = (-0.000200214257, 0.000100950558, 0.00134934322,
             -0.00367342844, 0.00573950773, -0.0076224613,
             0.00943887047, 1.00167406, 2.83297682)
    w = -_log1p_f32(-(x * x))
    lt = w < 5.0
    # float64's square root rounded to float32 is the correctly rounded
    # float32 one, which torch's float32 sqrt on the CPU is not always.
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, w_lt5[0], w_ge5[0]).to(x.dtype)
    for a, b in zip(w_lt5[1:], w_ge5[1:]):
        c = torch.where(lt, _f32(a), _f32(b)).to(torch.float64)
        p = _fma(p, w, c)
    res = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, res)


def normal(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.normal(key, (n,), float32)`` for a batch of keys
    ``(..., 2)`` → ``(..., n)``.  JAX's draw of shape ``()`` uses the same
    counter as element 0 of shape ``(1,)``: ``normal(key, 1)[..., 0]``."""
    f = _unit_floats(random_bits(key, n))
    # float32 nextafter(-1, 0): the open lower end of JAX's uniform draw.
    lo32 = -(1.0 - 2.0 ** -24)
    u = torch.clamp(f * 2.0 + lo32, min=lo32)
    return _erfinv_f32(u) * math.sqrt(2.0)


def truncated_normal(key: torch.Tensor, n: int, lower: float,
                     upper: float) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, (n,), float32)``
    for constant bounds: a uniform draw between erf(lower/√2) and
    erf(upper/√2), mapped through √2·erf_inv and clamped to the open
    interval."""
    sqrt2 = _f32(math.sqrt(2.0))
    a = _f32(math.erf(_f32(_f32(lower) / sqrt2)))
    b = _f32(math.erf(_f32(_f32(upper) / sqrt2)))
    f = _unit_floats(random_bits(key, n))
    u = torch.clamp(_fma(f, _f32(b - a), a), min=a)
    out = _erfinv_f32(u) * sqrt2
    lo = torch.nextafter(torch.tensor(lower, dtype=torch.float32),
                         torch.tensor(math.inf)).item()
    hi = torch.nextafter(torch.tensor(upper, dtype=torch.float32),
                         torch.tensor(-math.inf)).item()
    return torch.clamp(out, lo, hi)


def flax_param_key(key: torch.Tensor, module: str) -> torch.Tensor:
    """The key flax's ``Module.init`` gives the first parameter (a
    ``Dense``'s kernel) that the submodule named ``module`` creates from
    the root key ``key``: the key folded with the first four bytes
    (big-endian) of the SHA-1 of the module name followed by the
    parameter counter, 1, as one byte."""
    h = hashlib.sha1(module.encode() + b"\x01")
    return fold_in(key, int.from_bytes(h.digest()[:4], "big"))


def lecun_normal(key: torch.Tensor, fan_in: int, fan_out: int) -> torch.Tensor:
    """flax ``Dense``'s default kernel, ``lecun_normal()(key, (fan_in,
    fan_out))``: a normal truncated to ±2, scaled to variance 1/fan_in
    over the truncated normal's own standard deviation; the (fan_in,
    fan_out) kernel in row-major order."""
    std = _f32(_f32(math.sqrt(_f32(1.0 / fan_in))) / _f32(0.87962566103423978))
    return (truncated_normal(key, fan_in * fan_out, -2.0, 2.0) * std).reshape(fan_in, fan_out)
