"""The PyTorch port's threefry2x32 streams (dragg_tpu_torch/rng.py) against
``jax.random``: keys, ``fold_in`` and raw bits bit for bit; the engine's
normals within a few float32 ulps (and, since the port follows XLA's CPU
``erf_inv`` and ``log1p`` step for step, bit for bit); the engine's
seasonal gate, which the noise decides, exactly; and the RL agents' draws
(``split``, ``randint`` with a traced bound, scalar ``normal``,
``truncated_normal`` and flax's lecun-normal kernels) bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

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


# ------------------------------------------------- the RL agents' draws
def _agent_keys(n=500):
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    return keys, torch.from_numpy(_words(keys))


def test_split_is_bitwise():
    keys, kt = _agent_keys(50)
    for n in (2, 3, 4, 32):
        want = _words(jax.vmap(lambda k: jax.random.split(k, n))(keys))
        np.testing.assert_array_equal(rng.split(kt, n).numpy(), want)


@pytest.mark.parametrize("maxval", [1, 33, 2048])
def test_randint_traced_maxval_is_bitwise(maxval):
    """randint(key, (32,), 0, maxval) with maxval a traced int32, as the
    replay sampler draws it (dragg_tpu/rl/core.py:172)."""
    keys, kt = _agent_keys()
    draw = jax.jit(jax.vmap(lambda k, m: jax.random.randint(k, (32,), 0, m), (0, None)))
    want = np.asarray(draw(keys, jnp.int32(maxval)))
    got = rng.randint(kt, 32, 0, torch.tensor(maxval, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < maxval


def test_normals_are_bitwise():
    """Scalar draws (the agents' exploration noise, shape ()) and vector
    draws equal jax.random.normal's bit for bit; a shape-() draw is
    element 0 of a shape-(1,) draw."""
    keys, kt = _agent_keys(4000)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (), jnp.float32))(keys))
    got = rng.normal(kt, 1)[:, 0].numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (64,), jnp.float32))(keys))
    np.testing.assert_array_equal(rng.normal(kt, 64).numpy().view(np.int32),
                                  want.view(np.int32))


def test_truncated_normal_and_lecun_are_bitwise():
    """truncated_normal(-2, 2) and flax Dense's lecun-normal kernels with
    flax's per-layer keys (the DDPG core's init, dragg_tpu/rl/neural.py:147-155)."""
    from dragg_tpu.rl.neural import MLP

    keys, kt = _agent_keys(2000)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.truncated_normal(k, -2.0, 2.0, (40,), jnp.float32))(keys))
    got = rng.truncated_normal(kt, 40, -2.0, 2.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        params = MLP(hidden=64, out=1).init(key, jnp.zeros((5,), jnp.float32))["params"]
        kt = torch.from_numpy(_words(key))
        for i, (fan_in, fan_out) in enumerate(((5, 64), (64, 64), (64, 1))):
            k = rng.flax_param_key(kt, f"Dense_{i}")
            np.testing.assert_array_equal(rng.lecun_normal(k, fan_in, fan_out).numpy(),
                                          np.asarray(params[f"Dense_{i}"]["kernel"]))
