"""The PyTorch port's threefry2x32 streams (dragg_tpu_torch/rng.py) against
``jax.random``: keys, ``fold_in`` and raw bits bit for bit; normals within
a few float32 ulps (XLA's and PyTorch's float32 ``log1p`` inside ``erf_inv``
may round differently); and the engine's seasonal gate, which the noise
decides, exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dragg_tpu_torch import rng

H = 24
N_HOMES = 200


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _jax_home_keys(seed, t, n):
    """The JAX engine's per-home noise keys (dragg_tpu/engine.py:1161-1163)."""
    base = jnp.broadcast_to(jax.random.PRNGKey(seed), (n, 2))
    keys_t = jax.vmap(jax.random.fold_in, in_axes=(0, None))(base, t)
    return jax.vmap(jax.random.fold_in)(keys_t, jnp.arange(n))


def _port_home_keys(seed, t, n):
    base = rng.prng_key(seed).expand(n, 2)
    return rng.fold_in(rng.fold_in(base, t), torch.arange(n))


@pytest.mark.parametrize("seed", [0, 12, 2**31 - 1])
def test_keys_and_bits_are_bitwise(seed):
    np.testing.assert_array_equal(rng.prng_key(seed).numpy(),
                                  _words(jax.random.PRNGKey(seed)))
    for t in (0, 1, 23, 8759):
        kj, kt = _jax_home_keys(seed, t, N_HOMES), _port_home_keys(seed, t, N_HOMES)
        np.testing.assert_array_equal(kt.numpy(), _words(kj))
        bits_j = jax.vmap(lambda k: jax.random.bits(k, (H,)))(kj)
        np.testing.assert_array_equal(rng.random_bits(kt, H).numpy(), _words(bits_j))


def test_normals_within_ulps():
    worst = 0
    for t in range(0, 48, 7):
        kj, kt = _jax_home_keys(12, t, N_HOMES), _port_home_keys(12, t, N_HOMES)
        nj = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (H,), jnp.float32))(kj))
        nt = rng.normal(kt, H).numpy()
        assert nt.dtype == np.float32
        ulps = np.abs(nj.view(np.int32).astype(np.int64) - nt.view(np.int32))
        worst = max(worst, int(ulps.max()))
    assert worst <= 4, f"normals differ by {worst} ulps"


def test_seasonal_gate_is_exact():
    """The winter flag (dragg_tpu/engine.py:1164-1170) on forecast windows
    near the 30 degC threshold, where the noise decides it."""
    cap = 3.0
    oat = np.linspace(28.0, 31.0, H + 1).astype(np.float32)
    std_j = jnp.minimum(jnp.power(jnp.asarray(1.1, jnp.float32),
                                  jnp.arange(H, dtype=jnp.float32)), cap)
    std_t = torch.minimum(torch.pow(torch.tensor(1.1), torch.arange(H, dtype=torch.float32)),
                          torch.tensor(cap))
    flips = 0
    for t in range(24):
        kj, kt = _jax_home_keys(12, t, N_HOMES), _port_home_keys(12, t, N_HOMES)
        noise_j = jax.vmap(lambda k: jax.random.normal(k, (H,), jnp.float32))(kj) * std_j
        gate_j = np.asarray(jnp.maximum(oat[0], jnp.max(oat[None, 1:] - 2.0 + noise_j, axis=1))
                            <= 30.0)
        noise_t = rng.normal(kt, H) * std_t
        gate_t = (torch.maximum(torch.tensor(oat[0]),
                                torch.amax(torch.from_numpy(oat)[None, 1:] - 2.0 + noise_t, dim=1))
                  <= 30.0).numpy()
        np.testing.assert_array_equal(gate_t, gate_j)
        flips += int(gate_j.sum())
    assert 0 < flips < 24 * N_HOMES  # the noise really decides some gates
