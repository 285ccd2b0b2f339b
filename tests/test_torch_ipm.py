"""The PyTorch port's interior point (dragg_tpu_torch/ops/ipm.py, band ops on
the CPU plain versions of its CUDA kernels) against the JAX package's
``ipm_solve_qp`` on identical inputs — with ``band_kernel="xla"`` and with
``"pallas"`` (interpret mode) — and against HiGHS.

Tolerances: solved flags, iteration counts and per-home live-iteration
counts are equal; primal solutions agree to 1e-3 absolute (the two float32
implementations round ~1 ulp apart per operation, far inside the solver's
own 10·eps_abs = 2e-3 residual tolerance); objectives are within 1 % of
HiGHS per home (BASELINE.md north star, tests/test_ipm.py).
"""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

sys.path.insert(0, "tests")
from test_qp_parity import _assemble_real_step, _linprog_reference  # noqa: E402

from dragg_tpu.fixtures import assemble_community_qp  # noqa: E402
from dragg_tpu.ops.ipm import ipm_solve_qp as jax_ipm  # noqa: E402
from dragg_tpu.ops.qp import densify_A  # noqa: E402
from dragg_tpu_torch.ops import qp as tqp  # noqa: E402
from dragg_tpu_torch.ops.ipm import ipm_solve_qp  # noqa: E402


def _port_args(qp, pat):
    return (tqp.SparsePattern(*pat),
            *[torch.tensor(np.asarray(a)) for a in (qp.vals, qp.b_eq, qp.l_box,
                                                    qp.u_box, qp.q)])


@pytest.fixture(scope="module", params=[8, 24])
def step_qp(request):
    return _assemble_real_step(horizon_hours=request.param, n_homes=6)


@pytest.mark.parametrize("band_kernel", ["xla", "pallas"])
def test_matches_jax_ipm(step_qp, band_kernel):
    qp, pat = step_qp
    sj = jax_ipm(pat, qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q, iters=25,
                 band_kernel=band_kernel)
    st = ipm_solve_qp(*_port_args(qp, pat), iters=25)
    np.testing.assert_array_equal(st.solved.numpy(), np.asarray(sj.solved))
    assert st.iters == int(sj.iters)
    np.testing.assert_array_equal(st.conv_iters.numpy(), np.asarray(sj.conv_iters))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(st.diverged.numpy(), np.asarray(sj.diverged))


def test_tail_compaction_matches_jax():
    """An unreachable tolerance forces phase 1 (10 iterations) and the tail
    phase (the worst ceil(12/4) = 3 homes, 12 more): the same stragglers run
    the same iteration counts in both packages."""
    qp, pat, _, _ = assemble_community_qp(horizon_hours=24, n_homes=12, homes_pv=3,
                                          homes_battery=3, homes_pv_battery=3)
    kw = dict(iters=12, tail_frac=0.25, eps_abs=1e-7, eps_rel=1e-7)
    sj = jax_ipm(pat, qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q, **kw)
    st = ipm_solve_qp(*_port_args(qp, pat), **kw)
    assert st.iters == int(sj.iters) == 22
    np.testing.assert_array_equal(st.conv_iters.numpy(), np.asarray(sj.conv_iters))
    assert int((st.conv_iters == 22).sum()) == 3


def test_matches_highs():
    """≤1 % objective gap vs HiGHS on the real 24 h community QP."""
    qp, pat = _assemble_real_step(horizon_hours=24, n_homes=6)
    sol = ipm_solve_qp(*_port_args(qp, pat), iters=25)
    A = np.asarray(densify_A(pat, qp.vals), np.float64)
    n_checked = 0
    for i in range(6):
        ref = _linprog_reference(
            A[i], np.asarray(qp.b_eq, np.float64)[i], np.asarray(qp.l_box, np.float64)[i],
            np.asarray(qp.u_box, np.float64)[i], np.asarray(qp.q, np.float64)[i])
        if not ref.success:
            assert not bool(sol.solved[i])
            continue
        assert bool(sol.solved[i]), f"home {i} unsolved"
        gap = (float(np.asarray(qp.q)[i] @ sol.x[i].numpy()) - ref.fun) / max(abs(ref.fun), 1e-3)
        assert abs(gap) < 0.01, f"home {i}: gap {gap:.4%}"
        n_checked += 1
    assert n_checked >= 4


def test_infeasible_home_freezes_and_fixed_variables_pin():
    """A home whose WH comfort box sits above its pinned initial temperature
    is flagged unsolved without holding the batch at the cap, and the
    winter gate's [0, 0] boxes come back pinned exactly."""
    qp, pat = _assemble_real_step(horizon_hours=8, n_homes=6)
    lay = tqp.QPLayout(8)
    l = np.asarray(qp.l_box).copy()
    l[0, lay.i_twh: lay.i_twh + 9] = float(np.asarray(qp.b_eq)[0, lay.r_twh0]) + 5.0
    args = list(_port_args(qp, pat))
    args[3] = torch.from_numpy(l)
    sol = ipm_solve_qp(*args, iters=25)
    sj = jax_ipm(pat, qp.vals, qp.b_eq, jnp.asarray(l), qp.u_box, qp.q, iters=25)
    assert not bool(sol.solved[0]) and bool(sol.diverged[0])
    assert int(sol.solved[1:].sum()) >= 4
    assert sol.iters == int(sj.iters) < 20
    u = np.asarray(qp.u_box)
    fixed = np.isfinite(l) & np.isfinite(u) & (u - l <= 1e-9 * (1 + np.abs(l)))
    assert fixed.any()
    np.testing.assert_array_equal(sol.x.numpy()[fixed], l[fixed])


def test_fused_route_equals_split():
    qp, pat = _assemble_real_step(horizon_hours=8, n_homes=6)
    a = ipm_solve_qp(*_port_args(qp, pat), iters=25, fused=False)
    b = ipm_solve_qp(*_port_args(qp, pat), iters=25, fused=True)
    for f in ("x", "y_eq", "y_box", "r_prim", "r_dual", "solved"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_warm_start_matches_jax():
    """The warm-start path (``tpu.ipm_warm_start``): x0 pushed into the
    interior with clipped margins — crossed clip bounds on narrow boxes
    resolve as jnp.clip does."""
    qp, pat = _assemble_real_step(horizon_hours=8, n_homes=6)
    x0 = np.asarray(jax_ipm(pat, qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q,
                            iters=25).x)
    x0 = x0 + np.random.default_rng(0).normal(0, 0.1, x0.shape).astype(np.float32)
    sj = jax_ipm(pat, qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q, iters=25,
                 x0=jnp.asarray(x0))
    st = ipm_solve_qp(*_port_args(qp, pat), iters=25, x0=torch.from_numpy(x0))
    np.testing.assert_array_equal(st.solved.numpy(), np.asarray(sj.solved))
    assert st.iters == int(sj.iters)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-3)
