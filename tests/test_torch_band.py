"""The PyTorch port's band operations (dragg_tpu_torch/ops/banded.py) and
the plain versions of its three CUDA band kernels
(dragg_tpu_torch/ops/band_kernels.py, run here on CPU tensors) against the
JAX package's XLA scans and its Pallas kernels, which run in interpret mode
on the CPU as tests/test_pallas_band.py runs them.

Tolerance: where no multiply-add chain is involved (scatter, matvec) the
results are bitwise equal.  The factor and the substitutions are 1e-6
absolute on O(1-10) values: XLA:CPU contracts ``s - a*b`` into one fused
multiply-add where PyTorch rounds the product first, which moves a result
by about one float32 ulp per recurrence step.
"""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dragg_tpu.ops import banded as jb
from dragg_tpu.ops import pallas_band as pb
from dragg_tpu_torch.ops import band_kernels as bk
from dragg_tpu_torch.ops import banded as tb

ATOL = 1e-6


def _band_problem(B, m, bw, seed=0):
    """A diagonally dominant band SPD system in (B, m, bw+1) storage."""
    rng = np.random.default_rng(seed)
    Sb = np.zeros((B, m, bw + 1), np.float32)
    Sb[:, :, 0] = 10.0 + rng.random((B, m))
    for k in range(1, bw + 1):
        Sb[:, k:, k] = rng.standard_normal((B, m - k)).astype(np.float32) * 0.5
    r = rng.standard_normal((B, m)).astype(np.float32)
    return Sb, r


@pytest.mark.parametrize("bw", [1, 4, 7, 12])
def test_band_ops_match_scan_path(bw):
    Sb, r = _band_problem(5, 29, bw, seed=bw)
    L_j = np.asarray(jb.banded_cholesky(jnp.asarray(Sb), bw))
    L_t = tb.banded_cholesky(torch.from_numpy(Sb), bw).numpy()
    np.testing.assert_allclose(L_t, L_j, rtol=0, atol=ATOL)
    x_j = np.asarray(jb.banded_solve(jnp.asarray(L_j), jnp.asarray(r), bw))
    x_t = tb.banded_solve(torch.from_numpy(L_j), torch.from_numpy(r), bw).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=ATOL)
    mv_j = np.asarray(jb.band_matvec(jnp.asarray(Sb), jnp.asarray(r), bw))
    mv_t = tb.band_matvec(torch.from_numpy(Sb), torch.from_numpy(r), bw).numpy()
    np.testing.assert_array_equal(mv_t, mv_j)


def test_rcm_plan_is_identical():
    """The RCM permutation and band scatter come out identical for the real
    superset MPC pattern at H = 24."""
    from dragg_tpu.ops.admm import _schur_structure_for as j_schur
    from dragg_tpu.ops.qp import QPLayout as JLayout
    from dragg_tpu_torch.ops.admm import _schur_structure_for as t_schur
    from dragg_tpu_torch.ops.qp import SparsePattern

    sys.path.insert(0, "tests")
    from test_torch_qp import _patterns

    j_pat, t_pat = _patterns(24)
    assert isinstance(t_pat, SparsePattern) and tuple(t_pat) == tuple(j_pat)
    j_ss, t_ss = j_schur(j_pat), t_schur(t_pat)
    assert tuple(t_ss) == tuple(j_ss)
    j_plan = jb.plan_for(j_ss, JLayout(24).m_eq)
    t_plan = tb.plan_for(t_ss, t_pat.m)
    assert j_plan.bw == t_plan.bw
    for f in ("perm", "inv", "ent_row", "ent_off", "ent_src"):
        np.testing.assert_array_equal(getattr(t_plan, f), getattr(j_plan, f))
    contrib = np.random.default_rng(3).standard_normal(
        (7, j_ss.n_s)).astype(np.float32)
    np.testing.assert_array_equal(
        bk.band_scatter_t(t_plan, torch.from_numpy(contrib)).numpy(),
        np.asarray(pb.band_scatter_t(j_plan, jnp.asarray(contrib))))
    np.testing.assert_array_equal(
        tb.band_scatter(t_plan, torch.from_numpy(contrib)).numpy(),
        np.asarray(jb.band_scatter(j_plan, jnp.asarray(contrib))))


@pytest.mark.parametrize("bw", [1, 4, 7, 12])
def test_kernel_plain_versions_match_pallas(bw):
    """The three wrappers on CPU tensors (their plain versions) against the
    Pallas kernels at a ragged home count, refine 0 and 1; the fused
    factor + solve equals the split route bit for bit."""
    B, m = 37, 29
    Sb, r = _band_problem(B, m, bw, seed=10 + bw)
    St = np.ascontiguousarray(np.transpose(Sb, (1, 2, 0)))
    rt = np.ascontiguousarray(r.T)
    St_t, rt_t = torch.from_numpy(St), torch.from_numpy(rt)

    L_pal = pb.banded_cholesky_t(jnp.asarray(St), bw)
    L_t = bk.banded_cholesky_t(St_t, bw)
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_pal), rtol=0, atol=ATOL)
    for refine in (0, 1):
        x_pal = pb.refined_banded_solve_t(L_pal, jnp.asarray(St), jnp.asarray(rt),
                                          bw, refine=refine)
        x_t = bk.refined_banded_solve_t(L_t, St_t, rt_t, bw, refine=refine)
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_pal), rtol=0, atol=ATOL)
        Lf_pal, xf_pal = pb.factor_refined_solve_t(jnp.asarray(St), jnp.asarray(rt),
                                                   bw, refine=refine)
        Lf_t, xf_t = bk.factor_refined_solve_t(St_t, rt_t, bw, refine=refine)
        np.testing.assert_allclose(xf_t.numpy(), np.asarray(xf_pal), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(Lf_t.numpy(), L_t.numpy())
        np.testing.assert_array_equal(xf_t.numpy(), x_t.numpy())
    assert all(v == 0 for v in bk.LAUNCHES.values())  # CPU: no kernel launch


def test_make_band_ops_routes_agree():
    """make_band_ops' fused and split routes return the same (L, x), and the
    Tikhonov add_diag matches the Pallas layout's."""
    bw = 4
    none = np.zeros(0, np.int32)
    plan = type("Plan", (), dict(bw=bw, ent_row=none, ent_off=none, ent_src=none))()
    Sb, r = _band_problem(9, 21, bw, seed=2)
    St = torch.from_numpy(np.ascontiguousarray(np.transpose(Sb, (1, 2, 0))))
    rp = torch.from_numpy(r)
    *_, add_diag, split_fs = bk.make_band_ops(plan, "cpu", fused=False)
    *_, fused_fs = bk.make_band_ops(plan, "cpu", fused=True)
    for refine in (0, 1):
        (L1, x1), (L2, x2) = split_fs(St, rp, refine), fused_fs(St, rp, refine)
        assert torch.equal(L1, L2) and torch.equal(x1, x2)
    j_ops = pb.make_band_ops(plan, "pallas")
    np.testing.assert_array_equal(
        add_diag(St, 1e-6).numpy(),
        np.asarray(j_ops[3](jnp.asarray(St.numpy()), 1e-6)))


def test_wrappers_validate_inputs():
    St = torch.zeros((5, 3, 4))
    with pytest.raises(ValueError, match="bandwidth"):
        bk.banded_cholesky_t(St, 13)
    with pytest.raises(ValueError, match="float32"):
        bk.banded_cholesky_t(St.double(), 2)
    with pytest.raises(ValueError, match="vector"):
        bk.refined_banded_solve_t(St, St, torch.zeros((5, 3)), 2)
    with pytest.raises(ValueError, match="contiguous"):
        bk.factor_refined_solve_t(St, torch.zeros((4, 5)).T, 2)
