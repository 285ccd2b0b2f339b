"""The port's ReLU-QP solver (dragg_tpu_torch/ops/reluqp.py, on the CPU)
against the JAX package's (dragg_tpu/ops/reluqp.py) on identical inputs,
and against HiGHS.

Tolerances: the host-side helpers are equal; the bank inverses agree to
1e-4 relative / 1e-5 absolute (two float32 Cholesky codes), the ``ok``
masks exactly; solved flags are equal and objectives within rtol 1e-2 /
atol 5e-3 (the solver's own tolerance is 1e-4 on scaled residuals, and
first-order iterates stop anywhere inside it — tests/test_reluqp.py's
convention); against HiGHS each home is within 1 %.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores
from scipy.optimize import linprog

from dragg_tpu.fixtures import assemble_community_qp
from dragg_tpu.ops import reluqp as jr
from dragg_tpu.ops.qp import densify_A
from dragg_tpu_torch.ops import qp as tqp
from dragg_tpu_torch.ops import reluqp as tr


@pytest.fixture(scope="module")
def community_qp():
    qp, pat, _lay, _s = assemble_community_qp(horizon_hours=4, n_homes=6, season="heat")
    port = (tqp.SparsePattern(*pat),
            *[torch.tensor(np.asarray(a)) for a in (qp.vals, qp.b_eq, qp.l_box,
                                                    qp.u_box, qp.q)])
    return qp, pat, port


def _objectives(q, x):
    return (np.asarray(q, np.float64) * np.asarray(x, np.float64)).sum(1)


@pytest.mark.parametrize("m,n,bank", [(3, 5, 4), (52, 124, 5), (77, 221, 7)])
def test_host_helpers_equal_jax(m, n, bank):
    assert tr.iteration_flops(m, n) == jr.iteration_flops(m, n)
    assert tr.bank_factor_flops(m, bank) == jr.bank_factor_flops(m, bank)
    np.testing.assert_array_equal(tr.bank_rhos(0.1, 6.0, bank), jr.bank_rhos(0.1, 6.0, bank))


@pytest.mark.parametrize("rho0,factor,bank", [(0.1, 6.0, 5), (0.1, 6.0, 7), (0.3, 10.0, 9),
                                              (0.05, 4.0, 5)])
def test_bank_array_equals_the_jax_solver_bank(rho0, factor, bank):
    """The solver's float32 rhos bit for bit as dragg_tpu/ops/reluqp.py
    forms them (float32 arithmetic, ``bank_arr``); the float64 schedule
    rounded once is an ulp off at (0.1, 6.0, 5)'s top entry."""
    f32 = jnp.float32
    want = (jnp.asarray(rho0, f32) * jnp.asarray(factor, f32)
            ** (jnp.arange(bank, dtype=f32) - bank // 2))
    np.testing.assert_array_equal(tr.bank_array(rho0, factor, bank).numpy(), np.asarray(want))


def test_equilibrated_spd_inverse_matches_jax():
    """SPD members, a singular member (rescued by the Tikhonov retry) and a
    NaN member (identity, ok false), as tests/test_reluqp.py builds them."""
    rng = np.random.RandomState(0)
    A = rng.randn(4, 6, 6).astype(np.float32)
    S = np.einsum("bij,bkj->bik", A, A) + 6 * np.eye(6, dtype=np.float32)
    S[2] = 0.0
    S[3, 0, 0] = np.nan
    Sj, okj = jr.equilibrated_spd_inverse(jnp.asarray(S))
    St, okt = tr.equilibrated_spd_inverse(torch.from_numpy(S))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.tolist() == [True, True, True, False]
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(St[3].numpy(), np.eye(6))
    for b in range(2):
        np.testing.assert_allclose(S[b] @ St[b].numpy(), np.eye(6), atol=5e-4)


def test_indefinite_member_is_not_ok():
    """``cholesky_ex`` leaves a finite partial factor for an indefinite
    matrix; the home must still fail (JAX's factor is NaN there)."""
    S = np.stack([np.eye(3), np.diag([1.0, -1.0, 1.0])]).astype(np.float32)
    Sinv, ok = tr.equilibrated_spd_inverse(torch.from_numpy(S))
    _, okj = jr.equilibrated_spd_inverse(jnp.asarray(S))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    assert ok.tolist() == [True, False]
    np.testing.assert_array_equal(Sinv[1].numpy(), np.eye(3))


@pytest.mark.parametrize("iter_kernel,precision", [("lax", "f32"), ("pallas", "f32"),
                                                   ("lax", "bf16x3")])
def test_solve_matches_jax(community_qp, iter_kernel, precision):
    qp, pat, port = community_qp
    sj = jr.reluqp_solve_qp(pat, qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q,
                            iters=3000, precision=precision)
    st = tr.reluqp_solve_qp(*port, iters=3000, iter_kernel=iter_kernel,
                            precision=precision)
    np.testing.assert_array_equal(st.solved.numpy(), np.asarray(sj.solved))
    assert st.solved.all()
    np.testing.assert_allclose(_objectives(qp.q, st.x), _objectives(qp.q, sj.x),
                               rtol=1e-2, atol=5e-3)
    np.testing.assert_array_equal(st.bank_fallback.numpy(), np.asarray(sj.bank_fallback))
    assert st.x.dtype == torch.float32 and st.conv_iters.dtype == torch.int32


def test_pallas_route_refuses_bf16x3(community_qp):
    with pytest.raises(ValueError, match="precision"):
        tr.reluqp_solve_qp(*community_qp[2], iters=100, iter_kernel="pallas",
                           precision="bf16x3")


def test_cached_carry_roundtrip(community_qp):
    """A warm-started solve on the carried bank (no refresh) reaches the
    one-shot objectives in fewer iterations (tests/test_reluqp.py:163-190)."""
    qp, pat, port = community_qp
    B = qp.vals.shape[0]
    carry0 = tr.init_reluqp_carry(B, port[0], bank=5)
    sol1, c1 = tr.reluqp_solve_qp_cached(*port, carry0, True, iters=3000)
    assert sol1.solved.all()
    assert tuple(c1.Sinv_bank.shape) == (B, 5, pat.m, pat.m)
    sol2, _ = tr.reluqp_solve_qp_cached(*port, c1, False, iters=3000, x0=sol1.x,
                                        y_box0=sol1.y_box, rho_warm=sol1.rho)
    assert sol2.solved.all()
    assert sol2.iters < sol1.iters
    np.testing.assert_allclose(_objectives(qp.q, sol2.x), _objectives(qp.q, sol1.x),
                               rtol=1e-2, atol=5e-3)
    assert sol1.bank_fallback.dtype == torch.bool
    assert np.isin(sol1.rho.numpy(), tr.bank_array(0.1, 6.0, 5).numpy()).all()


def test_matches_highs(community_qp):
    """≤ 1 % objective gap vs HiGHS per home at H = 4
    (tests/test_reluqp.py:96-129); HiGHS-infeasible homes come back
    unsolved."""
    qp, pat, port = community_qp
    sol = tr.reluqp_solve_qp(*port, iters=4000, eps_abs=1e-4, eps_rel=1e-4)
    A = np.asarray(densify_A(pat, qp.vals), np.float64)
    beq, lo, hi, q = (np.asarray(a, np.float64) for a in (qp.b_eq, qp.l_box, qp.u_box, qp.q))
    x = sol.x.numpy().astype(np.float64)
    n_checked = 0
    for i in range(A.shape[0]):
        bounds = [(a if np.isfinite(a) else None, b if np.isfinite(b) else None)
                  for a, b in zip(lo[i], hi[i])]
        ref = linprog(q[i], A_eq=A[i], b_eq=beq[i], bounds=bounds, method="highs")
        if not ref.success:
            assert not sol.solved[i]
            continue
        assert sol.solved[i], f"home {i} unsolved"
        gap = (q[i] @ x[i] - ref.fun) / max(abs(ref.fun), 1e-3)
        assert -0.005 < gap < 0.01, f"home {i}: cost gap {gap:.4%}"
        assert np.max(np.abs(A[i] @ x[i] - beq[i])) < 1e-2
        n_checked += 1
    assert n_checked >= 4
