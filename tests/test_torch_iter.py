"""The port's fused ReLU-QP check window (dragg_tpu_torch/ops/iter_kernels.py)
against the JAX package's (dragg_tpu/ops/pallas_iter.py) on the CPU: the
plain version ``fused_window_plain`` against ``reference_window`` and
against the Pallas kernel ``fused_window`` in interpret mode, on the
consistent fixture of tests/test_pallas_iter.py (S⁻¹ the true inverse of
Â D⁻¹ Âᵀ, so the window is the real contractive solver map).

Tolerance: rtol 1e-3 / atol 1e-4 on the window state and the four
residual maxima, as tests/test_pallas_iter.py holds the Pallas kernel to
its reference: the float32 sums are taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragg_tpu.ops import pallas_iter
from dragg_tpu_torch.ops import iter_kernels as ik

NAMES = ("x", "z", "nu", "y", "r_prim", "r_dual", "p_sc", "d_sc")


@pytest.fixture
def window_problem():
    """The fixture of tests/test_pallas_iter.py, as numpy arrays."""
    rng = np.random.RandomState(7)
    B, m, n = 6, 9, 21
    A = rng.randn(B, m, n).astype(np.float32) * 0.5
    reg, sigma, rho0 = 1e-3, 1e-6, 0.4
    w = (0.5 + rng.rand(B, n)).astype(np.float32)
    rho = np.full(B, rho0, np.float32)
    p_diag = np.full((B, n), reg, np.float32)
    Dinv = (1.0 / (p_diag + sigma + rho[:, None] * w * w)).astype(np.float32)
    S = np.einsum("bmn,bn,bkn->bmk", A, Dinv, A) + 1e-4 * np.eye(m)[None]
    Sinv = np.linalg.inv(S).astype(np.float32)
    qs = rng.randn(B, n).astype(np.float32)
    bs = rng.randn(B, m).astype(np.float32)
    ls = (-1.0 - rng.rand(B, n)).astype(np.float32)
    us = (1.0 + rng.rand(B, n)).astype(np.float32)
    state = (rng.randn(B, n).astype(np.float32) * 0.1,
             np.clip(rng.randn(B, n).astype(np.float32), ls, us),
             rng.randn(B, m).astype(np.float32) * 0.1,
             rng.randn(B, n).astype(np.float32) * 0.1)
    e_eq = (0.5 + rng.rand(B, m)).astype(np.float32)
    e_box = (0.5 + rng.rand(B, n)).astype(np.float32)
    cd = (0.5 + rng.rand(B, n)).astype(np.float32)
    args = (A, Sinv, Dinv, w, qs, bs, ls, us, rho, *state, e_eq, e_box, cd, p_diag)
    return args, dict(sigma=float(sigma), alpha=1.6)


def _flat(out):
    return [np.asarray(a) for a in out[0] + out[1]]


@pytest.mark.parametrize("jax_fn", ["reference_window", "fused_window"])
@pytest.mark.parametrize("k", [1, 25])
def test_plain_matches_jax(window_problem, jax_fn, k):
    args, kw = window_problem
    ref = getattr(pallas_iter, jax_fn)(*(jnp.asarray(a) for a in args), k=k, **kw)
    out = ik.fused_window_plain(*(torch.from_numpy(a) for a in args), k=k, **kw)
    for a, b, name in zip(_flat(out), _flat(ref), NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4, err_msg=name)


def test_wrapper_on_cpu_is_the_plain_version(window_problem):
    args, kw = window_problem
    t = [torch.from_numpy(a) for a in args]
    ik.reset_launches()
    out = ik.fused_window(*t, k=25, **kw)
    plain = ik.fused_window_plain(*t, k=25, **kw)
    for a, b in zip(_flat(out), _flat(plain)):
        np.testing.assert_array_equal(a, b)
    assert ik.LAUNCHES == {"fused_window": 0}


def test_wrapper_refuses_other_dtypes_and_shapes(window_problem):
    args, kw = window_problem
    t = [torch.from_numpy(a) for a in args]
    for i in (0, 1, 9):  # A, S⁻¹, x
        bad = list(t)
        bad[i] = bad[i].double()
        with pytest.raises(ValueError, match="float32"):
            ik.fused_window(*bad, k=1, **kw)
    bad = list(t)
    bad[1] = bad[1][:, :-1]  # S⁻¹ not (B, m, m)
    with pytest.raises(ValueError, match="Sinv"):
        ik.fused_window(*bad, k=1, **kw)
