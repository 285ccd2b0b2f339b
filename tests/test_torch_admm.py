"""The PyTorch port's ADMM (dragg_tpu_torch/ops/admm.py, on the CPU) against
the JAX package's ``dragg_tpu.ops.admm`` on identical inputs, and against
HiGHS: the cases of tests/test_admm.py, the ADMM tests of
tests/test_banded.py and tests/test_pallas_band.py, the real-step parity
and infeasibility cases of tests/test_qp_parity.py, the bf16x3 case of
tests/test_precision.py, and bf16 ``Sinv`` storage.

Tolerances, each beside its test: iteration counts, solved and infeasible
flags and per-home convergence iterations are equal to the JAX solver's
(both stop on the same check window); primal solutions agree to 2e-4
absolute on the real MPC steps (the two float32 solvers round ~1 ulp apart
per operation, far inside the 1e-4 relative stopping tolerance on rows of
scale ~40), adapted rhos to 1e-3 relative (rho·sqrt of a ratio of residuals
that near the stopping point carry ~1e-4 relative noise); HiGHS gaps are ≤ 1 % per home
(BASELINE.md north star).  The port's "pallas" band route (the kernels'
plain versions on the CPU) is bit-equal to its "xla" route.
"""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

sys.path.insert(0, "tests")
from test_admm import random_feasible_lp, scipy_lp  # noqa: E402
from test_qp_parity import _assemble_real_step, _linprog_reference  # noqa: E402

from dragg_tpu.ops import admm as ja  # noqa: E402
from dragg_tpu.ops import banded as jbd  # noqa: E402
from dragg_tpu.ops import precision as jprec  # noqa: E402
from dragg_tpu.ops.qp import QPLayout, densify_A as jax_densify  # noqa: E402
from dragg_tpu_torch.ops import admm as ta  # noqa: E402
from dragg_tpu_torch.ops import banded as tbd  # noqa: E402
from dragg_tpu_torch.ops import precision as tprec  # noqa: E402
from dragg_tpu_torch.ops import qp as tqp  # noqa: E402

T = lambda a: torch.tensor(np.asarray(a))  # noqa: E731


def _port(qp, pat, l_box=None):
    return (tqp.SparsePattern(*pat), T(qp.vals), T(qp.b_eq),
            T(qp.l_box if l_box is None else l_box), T(qp.u_box), T(qp.q))


def _assert_same(st, sj, atol=2e-4):
    """Equal stopping point and flags; primal within ``atol``."""
    assert st.iters == int(sj.iters)
    np.testing.assert_array_equal(st.solved.numpy(), np.asarray(sj.solved))
    np.testing.assert_array_equal(st.infeasible.numpy(), np.asarray(sj.infeasible))
    np.testing.assert_array_equal(st.conv_iters.numpy(), np.asarray(sj.conv_iters))
    np.testing.assert_array_equal(st.diverged.numpy(), np.asarray(sj.diverged))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=0, atol=atol)
    # An adapted rho is rho·sqrt(ratio of the residuals), which near the
    # stopping point carry ~1e-4 relative float32 noise.
    np.testing.assert_allclose(st.rho.numpy(), np.asarray(sj.rho), rtol=1e-3)


@pytest.fixture(scope="module")
def step8():
    return _assemble_real_step(horizon_hours=8, n_homes=6)


def _highs_gaps(qp, pat, x, solved):
    """Per-home objective gap against HiGHS on the same matrices; a home
    HiGHS finds infeasible must come back unsolved."""
    A = np.asarray(jax_densify(pat, qp.vals), np.float64)
    gaps = []
    for i in range(A.shape[0]):
        ref = _linprog_reference(A[i], *(np.asarray(a, np.float64)[i]
                                         for a in (qp.b_eq, qp.l_box, qp.u_box, qp.q)))
        if not ref.success:
            assert not solved[i], f"home {i}: HiGHS infeasible but solved"
            continue
        assert solved[i], f"home {i}: HiGHS feasible but unsolved"
        obj = float(np.asarray(qp.q, np.float64)[i] @ x[i].astype(np.float64))
        gaps.append((obj - ref.fun) / max(abs(ref.fun), 1e-3))
    return np.asarray(gaps)


# ------------------------------------------------------ tests/test_admm.py
def test_random_lps_match_jax_and_highs(rng):
    """16 random feasible LPs through the dense-matrix API: the JAX
    solver's stopping point, and ≤ 1 % of HiGHS per LP (tolerance
    2e-3, reg 1e-6, as tests/test_admm.py)."""
    B, n, m_eq = 16, 12, 5
    lps = [random_feasible_lp(rng, n, m_eq) for _ in range(B)]
    refs = [scipy_lp(*lp) for lp in lps]
    assert all(r.success for r in refs)
    arrs = [np.stack([lp[k] for lp in lps]).astype(np.float32) for k in range(5)]
    kw = dict(iters=2000, eps_abs=2e-3, eps_rel=2e-3, reg=1e-6)
    sj = ja.admm_solve(*map(jnp.asarray, arrs), **kw)
    st = ta.admm_solve(*map(torch.tensor, arrs), **kw)
    assert bool(st.solved.all())
    # Random LPs are far less well scaled than the MPC steps: the primal
    # agrees to 2e-3 (the stopping tolerance), the stopping point exactly.
    _assert_same(st, sj, atol=2e-3)
    obj = np.einsum("bn,bn->b", st.x.numpy(), arrs[4])
    ref = np.asarray([r.fun for r in refs])
    assert np.max(np.abs(obj - ref) / np.maximum(np.abs(ref), 1e-3)) < 0.01


def test_infinite_bounds(rng):
    """Free variables (infinite bounds) solve, within 1 % of HiGHS, at the
    JAX solver's stopping point."""
    n, m_eq = 6, 2
    A = rng.randn(m_eq, n)
    x_feas = rng.uniform(-1, 1, n)
    l = np.full(n, -np.inf)
    l[:3] = -1.0
    u = np.full(n, np.inf)
    u[:3] = 1.0
    q = np.abs(rng.randn(n)) + 0.1
    A2 = np.vstack([A, np.eye(n)[3:]])
    b2 = np.concatenate([A @ x_feas, x_feas[3:]])
    ref = scipy_lp(A2, b2, l, u, q)
    assert ref.success
    arrs = [v[None].astype(np.float32) for v in (A2, b2, l, u, q)]
    kw = dict(iters=2000, eps_abs=2e-3, eps_rel=2e-3, reg=1e-6)
    st = ta.admm_solve(*map(torch.tensor, arrs), **kw)
    _assert_same(st, ta_jax := ja.admm_solve(*map(jnp.asarray, arrs), **kw), atol=2e-3)
    assert bool(st.solved[0]) and bool(ta_jax.solved[0])
    obj = float(st.x.numpy()[0] @ q)
    assert abs(obj - ref.fun) / max(abs(ref.fun), 1e-3) < 0.01


def test_infeasible_flags_unsolved():
    """Contradictory equalities (x0 = 0.2 and x0 = 0.8) come back unsolved
    in both packages."""
    n = 4
    A = np.vstack([np.eye(n)[:1], np.eye(n)[:1]])
    arrs = [v[None].astype(np.float32)
            for v in (A, np.array([0.2, 0.8]), np.zeros(n), np.ones(n), np.ones(n))]
    sj = ja.admm_solve(*map(jnp.asarray, arrs), iters=500)
    st = ta.admm_solve(*map(torch.tensor, arrs), iters=500)
    assert not bool(st.solved[0]) and not bool(sj.solved[0])
    assert st.iters == int(sj.iters)


def test_warm_start_cuts_iterations(rng):
    """A warm start from the cold solution takes no more iterations than
    the cold start, and each matches the JAX solver's count."""
    arrs = [v[None].astype(np.float32) for v in random_feasible_lp(rng, 12, 5)]
    kw = dict(iters=4000, eps_abs=1e-4, eps_rel=1e-4, check_every=10)
    cold_j = ja.admm_solve(*map(jnp.asarray, arrs), **kw)
    cold_t = ta.admm_solve(*map(torch.tensor, arrs), **kw)
    assert cold_t.iters == int(cold_j.iters)
    warm_j = ja.admm_solve(*map(jnp.asarray, arrs), **kw, x0=cold_j.x,
                           y_box0=cold_j.y_box, rho0=cold_j.rho)
    warm_t = ta.admm_solve(*map(torch.tensor, arrs), **kw, x0=cold_t.x,
                           y_box0=cold_t.y_box, rho0=cold_t.rho)
    assert warm_t.iters <= cold_t.iters
    assert warm_t.iters == int(warm_j.iters)


def test_anderson_matches_jax(step8):
    """Anderson acceleration (depth 5) on the real 8 h step: the JAX
    solver's stopping point and solution, and the plain solver's solved
    homes and objectives within 1 % (tests/test_admm.py)."""
    qp, pat = step8
    kw = dict(iters=2000, anderson=5)
    sj = ja.admm_solve_qp(pat, qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q, **kw)
    st = ta.admm_solve_qp(*_port(qp, pat), **kw)
    _assert_same(st, sj)
    plain = ta.admm_solve_qp(*_port(qp, pat), iters=2000)
    np.testing.assert_array_equal(st.solved.numpy(), plain.solved.numpy())
    q = np.asarray(qp.q)
    sel = plain.solved.numpy()
    assert sel.sum() >= 4
    np.testing.assert_allclose(np.einsum("bn,bn->b", q, st.x.numpy())[sel],
                               np.einsum("bn,bn->b", q, plain.x.numpy())[sel],
                               rtol=1e-2, atol=1e-2)


# ---------------------------------------------------- tests/test_banded.py
@pytest.mark.parametrize("kw", [dict(banded_factor=False),
                                dict(solve_backend="band"),
                                dict(solve_backend="band", refine=0)],
                         ids=["dense-factor", "band", "band-refine0"])
def test_backends_match_jax(step8, kw):
    """The dense Cholesky factor and the band backend (refine 1 and the
    engine's default 0) each stop where the JAX solver stops, and walk the
    default banded dense-inverse path's trajectory (same iterations and
    flags, primal within 1e-3, as tests/test_banded.py)."""
    qp, pat = step8
    sj = ja.admm_solve_qp(pat, qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q, iters=2000, **kw)
    st = ta.admm_solve_qp(*_port(qp, pat), iters=2000, **kw)
    _assert_same(st, sj)
    ref = ta.admm_solve_qp(*_port(qp, pat), iters=2000)
    assert st.iters == ref.iters
    np.testing.assert_array_equal(st.solved.numpy(), ref.solved.numpy())
    np.testing.assert_allclose(st.x.numpy(), ref.x.numpy(), rtol=1e-3, atol=1e-3)


def test_resolve_backend_matches_jax():
    """"auto" goes banded past 1 GiB of one shard's Sinv (bf16 halves the
    bytes); unknown names and a band request without a plan raise."""
    for args in [("auto", 100, 77, True), ("auto", 200_000, 77, True),
                 ("auto", 200_000, 77, False), ("dense_inv", 10, 5, False),
                 ("auto", 60_000, 77, True, 2), ("auto", 60_000, 77, True, 4),
                 ("band", 10, 5, True)]:
        assert ta.resolve_backend(*args) == ja.resolve_backend(*args), args
    assert ta.resolve_backend("auto", 50_000, 149, True, n_shards=8) == ja.resolve_backend(
        "auto", 50_000, 149, True, n_shards=8) == "dense_inv"
    for bad in [("band", 10, 5, False), ("nope", 10, 5, True)]:
        with pytest.raises(ValueError):
            ta.resolve_backend(*bad)
    assert ta.BAND_AUTO_BYTES == ja.BAND_AUTO_BYTES


@pytest.mark.parametrize("band_kernel,backend,matvec_dtype", [
    ("xla", "band", "f32"), ("auto", "band", "f32"), ("pallas", "band", "f32"),
    ("auto", "dense_inv", "f32"), ("auto", "dense_inv", "bf16")])
def test_init_factor_carry_shapes(step8, band_kernel, backend, matvec_dtype):
    """The zero carry: (B, m, m) dense inverse (bf16 under bf16 storage),
    the band factor (B, m, bw+1) under "xla" as the JAX package's, and
    (m, bw+1, B), transposed, under the kernels."""
    _, pat = step8
    kw = dict(matvec_dtype=matvec_dtype, solve_backend=backend)
    cj = ja.init_factor_carry(6, pat, band_kernel="xla", **kw)
    ct = ta.init_factor_carry(6, tqp.SparsePattern(*pat), band_kernel=band_kernel, **kw)
    for f in ("d", "e_eq", "e_box", "c"):
        assert tuple(getattr(ct, f).shape) == getattr(cj, f).shape
    want = cj.Sinv.shape
    if backend == "band" and band_kernel != "xla":
        want = (want[1], want[2], want[0])
    assert tuple(ct.Sinv.shape) == want
    assert ct.Sinv.dtype == (torch.bfloat16 if matvec_dtype == "bf16" else torch.float32)


def test_banded_explicit_inverse_and_helpers(step8):
    """banded_explicit_inverse against the JAX package's and against the
    float64 inverse of the dense S; densify_A and dense_pattern equal the
    JAX package's."""
    qp, pat = step8
    tpat = tqp.SparsePattern(*pat)
    np.testing.assert_array_equal(tqp.densify_A(tpat, T(qp.vals)).numpy(),
                                  np.asarray(jax_densify(pat, qp.vals)))
    assert ta.dense_pattern(3, 4) == tqp.SparsePattern(*ja.dense_pattern(3, 4))
    ss = ta._schur_structure_for(tpat)
    plan = tbd.plan_for(ss, pat.m)
    rng = np.random.default_rng(0)
    Dinv = rng.uniform(0.5, 2.0, (6, pat.n)).astype(np.float32)
    contrib = tqp.schur_contrib(tqp.schur_index(ss, "cpu"), T(qp.vals), T(Dinv))
    got = tbd.banded_explicit_inverse(plan, contrib).numpy()
    want = np.asarray(jbd.banded_explicit_inverse(plan, jnp.asarray(contrib.numpy())))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    S = tqp.scatter_schur(ss, pat.m, contrib).numpy().astype(np.float64)
    np.testing.assert_allclose(got, np.linalg.inv(S), rtol=0, atol=1e-4 * scale)


# ------------------------------------------------ tests/test_pallas_band.py
def test_band_kernel_route_matches_xla(step8):
    """The band backend under "pallas" (the kernels' plain versions on the
    CPU, transposed band) is bit-equal to the "xla" route ((B, m, bw+1)),
    and both stop where the JAX solver's kernel route stops."""
    qp, pat = _assemble_real_step(horizon_hours=4, n_homes=4)
    kw = dict(iters=300, solve_backend="band", banded_factor=True)
    sj = ja.admm_solve_qp(pat, qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q,
                          band_kernel="pallas", **kw)
    sx = ta.admm_solve_qp(*_port(qp, pat), band_kernel="xla", **kw)
    sp = ta.admm_solve_qp(*_port(qp, pat), band_kernel="pallas", **kw)
    for f in ("x", "y_eq", "y_box", "r_prim", "r_dual", "solved", "rho", "conv_iters"):
        assert torch.equal(getattr(sx, f), getattr(sp, f)), f
    assert sx.iters == sp.iters
    _assert_same(sp, sj)


# ------------------------------------------------- tests/test_qp_parity.py
def test_real_step_within_one_percent_of_highs():
    """Every home of the real 24 h step solves, within 1 % of HiGHS and no
    more than 0.5 % below it, at the JAX solver's stopping point
    (tests/test_qp_parity.py::test_parity_24h_horizon)."""
    qp, pat = _assemble_real_step(horizon_hours=24, n_homes=6)
    kw = dict(iters=1500, eps_abs=1e-4, eps_rel=1e-4)
    sj = ja.admm_solve_qp(pat, qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q, **kw)
    st = ta.admm_solve_qp(*_port(qp, pat), **kw)
    _assert_same(st, sj)
    gaps = _highs_gaps(qp, pat, st.x.numpy(), st.solved.numpy())
    assert len(gaps) >= 4
    assert np.all(gaps < 0.01) and np.all(gaps > -0.005), gaps


def test_infeasibility_certificate():
    """Home 0's water-heater box raised 5 degC above its pinned initial
    temperature is primal-infeasible: both packages certify it, HiGHS
    agrees, and every other home solves as in the JAX solver."""
    qp, pat = _assemble_real_step()
    l = np.asarray(qp.l_box).copy()
    lay = QPLayout((pat.n - 5) // 9)
    b0 = float(np.asarray(qp.b_eq)[0, lay.r_twh0])
    l[0, lay.i_twh:lay.i_twh + lay.H + 1] = b0 + 5.0
    kw = dict(iters=4000, eps_abs=1e-4, eps_rel=1e-4)
    sj = ja.admm_solve_qp(pat, qp.vals, qp.b_eq, jnp.asarray(l), qp.u_box, qp.q, **kw)
    st = ta.admm_solve_qp(*_port(qp, pat, l_box=l), **kw)
    assert bool(st.infeasible[0]) and bool(st.diverged[0]) and not bool(st.solved[0])
    _assert_same(st, sj)
    A0 = np.asarray(jax_densify(pat, qp.vals)[0], np.float64)
    ref = _linprog_reference(A0, np.asarray(qp.b_eq[0], np.float64), l[0].astype(np.float64),
                             np.asarray(qp.u_box[0], np.float64),
                             np.asarray(qp.q[0], np.float64))
    assert not ref.success


# ---------------------------------------- precision: bf16x3 and bf16 Sinv
def test_mxu_einsum_out_dtype_matches_jax():
    """bf16 × bf16 with a float32 output: the port upcasts both operands
    (exact) and sums in float32, as JAX's preferred_element_type; the
    result is float32, never a bf16-rounded product."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((5, 24, 24)).astype(np.float32)
    b = rng.standard_normal((5, 24)).astype(np.float32)
    got = tprec.mxu_einsum("bmn,bn->bm", torch.tensor(a).bfloat16(),
                           torch.tensor(b).bfloat16(), out_dtype=torch.float32)
    want = np.asarray(jprec.mxu_einsum("bmn,bn->bm", jnp.asarray(a, jnp.bfloat16),
                                       jnp.asarray(b, jnp.bfloat16),
                                       out_dtype=jnp.float32))
    assert got.dtype == torch.float32
    ab = torch.tensor(a).bfloat16().double()
    exact = torch.einsum("bmn,bn->bm", ab, torch.tensor(b).bfloat16().double()).numpy()
    # Both are float32 sums of exact products: within a few float32 ulps
    # of the float64 sum, and of each other.
    tol = 1e-6 * np.abs(ab.numpy()).sum(axis=2) * np.abs(b).max()
    assert np.all(np.abs(got.numpy() - exact) <= tol)
    assert np.all(np.abs(got.numpy() - want) <= 2 * tol)
    x3 = tprec.mxu_einsum("bmn,bn->bm", torch.tensor(a).bfloat16(), torch.tensor(b),
                          precision="bf16x3", out_dtype=torch.float32)
    assert x3.dtype == torch.float32


@pytest.mark.parametrize("kw,atol", [
    (dict(precision="bf16x3", banded_factor=False, solve_backend="dense_inv"), 2e-4),
    (dict(matvec_dtype="bf16"), 2e-3)], ids=["bf16x3", "bf16-sinv"])
def test_reduced_precision_apply(kw, atol):
    """The dense-inverse apply under bf16x3 (tests/test_precision.py) and
    with the inverse stored in bf16: every home still solves at the JAX
    solver's stopping point, objectives within 2 % / 1e-2 of the float32
    solve.  A bf16 Sinv rounds each right-hand side to bf16 too, so an
    ulp of float32 difference between the packages can move an entry by
    2⁻⁹ relative: the primal agrees to 2e-3 there (half the stopping
    tolerance on the ~40-scale rows), 2e-4 under bf16x3."""
    qp, pat = _assemble_real_step(horizon_hours=4, n_homes=6)
    sj = ja.admm_solve_qp(pat, qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q, iters=3000, **kw)
    st = ta.admm_solve_qp(*_port(qp, pat), iters=3000, **kw)
    s32 = ta.admm_solve_qp(*_port(qp, pat), iters=3000)
    assert bool(st.solved.all()) and bool(s32.solved.all())
    _assert_same(st, sj, atol=atol)
    q64 = np.asarray(qp.q, np.float64)
    np.testing.assert_allclose((q64 * st.x.numpy()).sum(1), (q64 * s32.x.numpy()).sum(1),
                               rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("solve_backend", ["dense_inv", "band"])
def test_cached_stale_factor_matches_jax(solve_backend):
    """The cross-step cache: step t = 1's solve reuses step t = 0's scalings
    and factor (refresh false; refinement absorbs the drift), warm-started
    from t = 0's solution, as the JAX solver does."""
    from dragg_tpu.fixtures import assemble_community_qp

    qp0, pat, _, _ = assemble_community_qp(horizon_hours=8, n_homes=6, season="heat")
    qp1 = qp0._replace(b_eq=qp0.b_eq * 1.001, q=qp0.q * 0.97)
    kw = dict(iters=2000, solve_backend=solve_backend)
    cj = ja.init_factor_carry(6, pat, solve_backend=solve_backend)
    ct = ta.init_factor_carry(6, tqp.SparsePattern(*pat), solve_backend=solve_backend)
    sj0, cj = ja.admm_solve_qp_cached(pat, qp0.vals, qp0.b_eq, qp0.l_box, qp0.u_box,
                                      qp0.q, cj, True, **kw)
    st0, ct = ta.admm_solve_qp_cached(*_port(qp0, pat), ct, True, **kw)
    _assert_same(st0, sj0)
    sj1, _ = ja.admm_solve_qp_cached(pat, qp1.vals, qp1.b_eq, qp1.l_box, qp1.u_box, qp1.q,
                                     cj, False, x0=sj0.x, y_box0=sj0.y_box, rho0=sj0.rho,
                                     **kw)
    st1, _ = ta.admm_solve_qp_cached(*_port(qp1, pat), ct, False, x0=st0.x,
                                     y_box0=st0.y_box, rho0=st0.rho, **kw)
    _assert_same(st1, sj1)
    assert bool(st1.solved.any())


@pytest.mark.parametrize("backend,matvec_dtype,band_kernel", [
    ("dense_inv", "bf16", "auto"), ("band", "f32", "xla"), ("band", "f32", "auto")])
def test_factor_carry_from_numpy(step8, backend, matvec_dtype, band_kernel):
    """A JAX FactorCarry (numpy leaves) becomes the port's on either
    backend, value for value: a bf16 inverse stays bf16, and a band factor
    is transposed to (m, bw+1, B) for the kernels' route."""
    from dragg_tpu_torch.interop import factor_carry_from_numpy

    qp, pat = step8
    kw = dict(solve_backend=backend, matvec_dtype=matvec_dtype)
    _, cj = ja.admm_solve_qp_cached(pat, qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q,
                                    ja.init_factor_carry(6, pat, **kw), True, iters=100, **kw)
    ct = factor_carry_from_numpy({k: np.asarray(v) for k, v in cj._asdict().items()}, "cpu",
                                 band_kernel)
    want = ta.init_factor_carry(6, tqp.SparsePattern(*pat), band_kernel=band_kernel, **kw)
    for f in ta.FactorCarry._fields:
        got, jv = getattr(ct, f), np.asarray(getattr(cj, f)).astype(np.float32)
        assert got.shape == getattr(want, f).shape and got.dtype == getattr(want, f).dtype, f
        if f == "Sinv" and backend == "band" and band_kernel != "xla":
            jv = jv.transpose(1, 2, 0)
        np.testing.assert_array_equal(got.float().numpy(), jv, err_msg=f)
