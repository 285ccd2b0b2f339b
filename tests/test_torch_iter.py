"""The port's fused ReLU-QP check window (dragg_tpu_torch/ops/iter_kernels.py)
against the JAX package's (dragg_tpu/ops/pallas_iter.py) on the CPU: the
plain version ``fused_window_plain`` against ``reference_window`` and
against the Pallas kernel ``fused_window`` in interpret mode, on the
consistent fixture of tests/test_pallas_iter.py (S⁻¹ the true inverse of
Â D⁻¹ Âᵀ, so the window is the real contractive solver map).

Tolerance: rtol 1e-3 / atol 1e-4 on the window state and the four
residual maxima, as tests/test_pallas_iter.py holds the Pallas kernel to
its reference: the float32 sums are taken in another order.

Also the kernel's host-side plan (``window_plan``) at the engine's bucket
shapes, which the CPU can check without the card.
"""

import os
import re
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu.ops import pallas_iter
from dragg_tpu_torch.ops import iter_kernels as ik

NAMES = ("x", "z", "nu", "y", "r_prim", "r_dual", "p_sc", "d_sc")


def make_window_problem(B, m, n, seed=7):
    """The fixture of tests/test_pallas_iter.py at (B, m, n), as numpy
    arrays."""
    rng = np.random.RandomState(seed)
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


@pytest.fixture
def window_problem():
    return make_window_problem(6, 9, 21)


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


def test_plain_matches_reference_window_at_h48_pv_battery():
    """The H = 48 pv_battery bucket's shape (m = 149, n = 437), the one the
    kernel runs on a cluster of two blocks."""
    args, kw = make_window_problem(2, 149, 437, seed=48)
    ref = pallas_iter.reference_window(*(jnp.asarray(a) for a in args), k=25, **kw)
    out = ik.fused_window_plain(*(torch.from_numpy(a) for a in args), k=25, **kw)
    for a, b, name in zip(_flat(out), _flat(ref), NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4, err_msg=name)


def _bucket_shapes(horizon):
    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.config import mixed_community_config

    with tempfile.TemporaryDirectory() as d:
        agg = Aggregator(mixed_community_config(40, horizon, "2015-01-01 01",
                                                bucketed="true"),
                         outputs_dir=d, device="cpu")
        agg.get_homes()
        agg._build_engine()
        return [(b["m_eq"], b["n_var"]) for b in agg.engine.bucket_info()]


@pytest.mark.parametrize("horizon", [4, 24, 48])
def test_window_plan_at_bucket_shapes(horizon):
    """Every bucket shape gets a plan that covers it: blocks within one
    SM's shared memory and thread limit, threads a multiple of 32, a
    cluster (of at most 8) only where no single block can hold the home."""
    shapes = _bucket_shapes(horizon)
    assert len(shapes) == 4
    for m, n in shapes:
        p = ik.window_plan(m, n)
        assert p.threads % 32 == 0 and 1 <= p.cluster <= 8
        assert p.threads // 32 * p.rows * p.cluster >= m
        assert 32 * p.cols >= n and 32 * p.scols >= m
        assert p.smem == ik.window_smem(p.threads, p.rows, p.cols, p.scols, p.regs, m, n)
        assert p.smem <= ik.MAX_SMEM
        # The blocks the kernel's occupancy bound asks for fit one SM: 228 KB
        # of shared memory (1 KB reserved per block), 2,048 threads.
        assert p.blocks_per_sm * (p.smem + 1024) <= 233_472
        assert p.blocks_per_sm * p.threads <= 2048
        single = [k for k in ik.KERNELS if k[4] == 1
                  and k[0] // 32 * k[1] >= m and 32 * k[2] >= n and 32 * k[3] >= m]
        fits_one_block = any(ik.window_smem(*k[:4], k[5], m, n) <= ik.MAX_SMEM
                             for k in single)
        assert (p.cluster > 1) == (not fits_one_block)
    if horizon == 24:   # Â in registers at the main path's buckets
        assert all(ik.window_plan(m, n).regs for m, n in shapes)
    if horizon == 48:   # the two largest buckets need a cluster
        assert sorted(ik.window_plan(m, n).cluster for m, n in shapes) == [1, 1, 2, 2]


def test_window_plan_refuses_what_it_cannot_run():
    for m, n in ((161, 200), (100, 449)):
        with pytest.raises(ValueError, match="no kernel for a home"):
            ik.window_plan(m, n)


def test_kernel_table_matches_the_cuda_source():
    """``KERNELS`` lists exactly the instantiations of csrc/iter.cu's
    WINDOW_KERNELS, in the same order (the C entry point refuses any
    other plan)."""
    src = os.path.join(os.path.dirname(ik.__file__), "..", "csrc", "iter.cu")
    with open(src) as f:
        text = f.read()
    block = text[text.index("#define WINDOW_KERNELS(X)"):]
    block = block[:block.index("\n\n")]
    rows = [tuple(int(v) for v in r.split(","))
            for r in re.findall(r"X\(([\d, ]+)\)", block)]
    assert rows == [(*k[:5], int(k[5]), k[6]) for k in ik.KERNELS]
