"""Block cyclic reduction in the port (dragg_tpu_torch/ops/block_cr.py,
``tpu.band_kernel = "cr"``) against the JAX package's ``block_cr`` and the
sequential band Cholesky, through ``band_kernels.make_band_ops`` and the
interior point, and through the engine (tests/test_block_cr.py without the
mesh).

Tolerances: the block-tridiagonal form is a copy, so it equals the JAX
package's bit for bit; CR solutions agree with the sequential solve and
with the JAX CR to 1e-4 relative (a different float32 elimination order);
the interior point on CR stops where the JAX one on CR does, with the
primal within 1e-3 (the IPM's own tolerance, tests/test_torch_ipm.py), and
objectives within 2e-3 relative of the sequential route's.
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

sys.path.insert(0, "tests")
from test_pallas_band import _random_band_spd  # noqa: E402
from test_qp_parity import _assemble_real_step  # noqa: E402

from dragg_tpu.ops import block_cr as jcr  # noqa: E402
from dragg_tpu.ops.ipm import ipm_solve_qp as jax_ipm  # noqa: E402
from dragg_tpu_torch.ops import band_kernels as bk  # noqa: E402
from dragg_tpu_torch.ops import banded as bd  # noqa: E402
from dragg_tpu_torch.ops import block_cr as tcr  # noqa: E402
from dragg_tpu_torch.ops import qp as tqp  # noqa: E402
from dragg_tpu_torch.ops.ipm import band_plan, ipm_solve_qp  # noqa: E402

SHAPES = [(3, 29, 4), (2, 149, 4), (2, 16, 4), (1, 7, 4), (2, 23, 3)]


def _band(B, m, bw, seed):
    return torch.tensor(np.asarray(_random_band_spd(B, m, bw, seed=seed)))


def test_blocktri_matches_jax_and_dense():
    """(D, U) equal the JAX package's and tile the dense symmetric matrix
    the band storage describes (identity padding beyond m)."""
    B, m, bw = 2, 19, 4
    Sb = _band(B, m, bw, 3)
    D, U, N, mp = tcr.band_to_blocktri(Sb, bw)
    Dj, Uj, Nj, mpj = jcr.band_to_blocktri(jnp.asarray(Sb.numpy()), bw)
    assert (N, mp) == (Nj, mpj)
    np.testing.assert_array_equal(D.numpy(), np.asarray(Dj))
    np.testing.assert_array_equal(U.numpy(), np.asarray(Uj))
    dense = np.zeros((B, mp, mp), np.float32)
    S = Sb.numpy()
    for i in range(m):
        for d in range(bw + 1):
            if i - d >= 0:
                dense[:, i, i - d] = dense[:, i - d, i] = S[:, i, d]
    dense[:, range(m, mp), range(m, mp)] = 1.0
    s = bw
    for k in range(N):
        np.testing.assert_array_equal(D[:, k].numpy(), dense[:, k * s:(k + 1) * s,
                                                             k * s:(k + 1) * s])
    for k in range(N - 1):
        np.testing.assert_array_equal(U[:, k].numpy(), dense[:, k * s:(k + 1) * s,
                                                             (k + 1) * s:(k + 2) * s])


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_cr_solve_matches_sequential_and_jax(i):
    """Even and odd block counts, bw 3 and 4, one block (m < bw·2)."""
    B, m, bw = SHAPES[i]
    Sb = _band(B, m, bw, i)
    r = torch.tensor(np.random.default_rng(100 + i).standard_normal((B, m)).astype(np.float32))
    x_seq = bd.banded_solve(bd.banded_cholesky(Sb, bw), r, bw).numpy()
    x_cr = tcr.cr_solve(tcr.cr_factor(Sb, bw), r).numpy()
    x_j = np.asarray(jax.jit(lambda S, rr: jcr.cr_solve(jcr.cr_factor(S, bw), rr))(
        jnp.asarray(Sb.numpy()), jnp.asarray(r.numpy())))
    scale = np.abs(x_seq).max()
    assert np.abs(x_cr - x_seq).max() / scale < 1e-4
    assert np.abs(x_cr - x_j).max() / scale < 1e-4


def test_non_spd_block_gives_nan():
    """A block that is not positive definite gives NaNs, as the JAX
    package's Cholesky does, not a finite partial factor."""
    Sb = _band(1, 9, 3, 0)
    Sb[0, 4, 0] = -50.0
    x = tcr.cr_solve(tcr.cr_factor(Sb, 3), torch.ones(1, 9))
    xj = jcr.cr_solve(jcr.cr_factor(jnp.asarray(Sb.numpy()), 3), jnp.ones((1, 9)))
    assert torch.isnan(x).any() and np.isnan(np.asarray(xj)).any()


def test_make_band_ops_cr_on_the_transposed_band():
    """make_band_ops(kernel="cr") takes the port's transposed (m, bw+1, B)
    band and (B, m) right-hand sides: its refined solve matches the plain
    sequential route's to 1e-4 relative and improves on the unrefined one."""
    B, m, bw = 4, 31, 4
    Sb = _band(B, m, bw, 7)
    St = Sb.permute(1, 2, 0).contiguous()
    r = torch.tensor(np.random.default_rng(5).standard_normal((B, m)).astype(np.float32))
    plan = bd.BandPlan(m=m, bw=bw, perm=np.arange(m), inv=np.arange(m),
                       ent_row=np.zeros(0, np.int32), ent_off=np.zeros(0, np.int32),
                       ent_src=np.zeros(0, np.int32))
    _, chol_c, solve_c, add_c, fsolve_c = bk.make_band_ops(plan, "cpu", kernel="cr")
    _, chol_x, solve_x, add_x, _ = bk.make_band_ops(plan, "cpu", kernel="xla")
    torch.testing.assert_close(add_c(St, 1e-6), add_x(St, 1e-6), rtol=0, atol=0)
    want = solve_x(chol_x(St), St, r, 1)
    Lf, got = fsolve_c(St, r, 1)
    assert isinstance(Lf, dict)
    scale = want.abs().max()
    assert (got - want).abs().max() / scale < 1e-4
    res = lambda x: (r - bd.band_matvec(Sb, x, bw)).abs().max()  # noqa: E731
    assert res(solve_c(chol_c(St), St, r, 1)) <= res(solve_c(chol_c(St), St, r, 0))


@pytest.mark.parametrize("tail_frac", [0.0, 0.25])
def test_ipm_cr_matches_jax(tail_frac):
    """The interior point on CR against the JAX one on CR (same solved
    flags, iterations, primal within 1e-3) and against the port's
    sequential route (objectives within 2e-3 relative), with and without
    tail compaction."""
    qp, pat = _assemble_real_step(horizon_hours=24, n_homes=16)
    args = [torch.tensor(np.asarray(a)) for a in (qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q)]
    tpat = tqp.SparsePattern(*pat)
    kw = dict(iters=30, tail_frac=tail_frac, tail_iters=20)
    sj = jax_ipm(pat, qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q, band_kernel="cr", **kw)
    st = ipm_solve_qp(tpat, *args, band_kernel="cr", **kw)
    sx = ipm_solve_qp(tpat, *args, band_kernel="xla", **kw)
    np.testing.assert_array_equal(st.solved.numpy(), np.asarray(sj.solved))
    assert st.iters == int(sj.iters)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-3)
    assert int(st.solved.sum()) >= int(sx.solved.sum()) - 1
    both = (st.solved & sx.solved).numpy()
    assert both.sum() >= 12
    q = np.asarray(qp.q)
    np.testing.assert_allclose((q * st.x.numpy()).sum(1)[both], (q * sx.x.numpy()).sum(1)[both],
                               rtol=2e-3, atol=1e-2)
    assert band_plan(tpat).bw <= 6


def test_engine_on_cr_matches_jax():
    """tpu.band_kernel = "cr" builds and steps the port's IPM engine; three
    steps from each step's JAX state match the JAX engine on CR (flags
    equal, series within 1e-3)."""
    from dragg_tpu import data as jd
    from dragg_tpu import engine as je
    from dragg_tpu import homes as jh
    from dragg_tpu_torch import engine as te
    from dragg_tpu_torch.config import default_config
    from dragg_tpu_torch.interop import engine_state_from_numpy

    cfg = default_config()
    cfg["community"].update(total_number_homes=6, homes_pv=1, homes_battery=1,
                            homes_pv_battery=1)
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["tpu"]["band_kernel"] = "cr"
    env = jd.load_environment(cfg)
    wd = jd.load_waterdraw_profiles(None, seed=12)
    batch = jh.build_home_batch(jh.create_homes(cfg, 24, 1, wd), 4, 1, 6)
    ej = je.make_engine(batch, env, cfg, 0)
    et = te.make_engine(batch, env, cfg, 0, device="cpu")
    assert ej.band_kernel == et.params.band_kernel == "cr"
    state = ej.init_state()
    rp = np.zeros(4, np.float32)
    for t in range(3):
        _, ot = et.step(engine_state_from_numpy(state, "cpu"), t, rp)
        state, oj = ej.step(state, t, rp)
        np.testing.assert_array_equal(ot.correct_solve.numpy(), np.asarray(oj.correct_solve))
        for f in ("p_grid", "temp_in", "temp_wh", "e_batt", "cost"):
            np.testing.assert_allclose(getattr(ot, f).numpy(), np.asarray(getattr(oj, f)),
                                       rtol=0, atol=1e-3, err_msg=f)
        assert float(ot.correct_solve.mean()) > 0.8
