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

import os
import re
import sys
import tempfile
from functools import lru_cache

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

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


@lru_cache(maxsize=None)
def _bucket_ms(horizon):
    """The distinct equality-row counts m of the mixed community's type
    buckets at ``horizon`` (the band kernels' m)."""
    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.config import mixed_community_config

    with tempfile.TemporaryDirectory() as d:
        agg = Aggregator(mixed_community_config(40, horizon, "2015-01-01 01",
                                                bucketed="true"),
                         outputs_dir=d, device="cpu")
        agg.get_homes()
        agg._build_engine()
        return sorted({b["m_eq"] for b in agg.engine.bucket_info()})


@pytest.mark.parametrize("bw", [1, 4, 7, 12])
@pytest.mark.parametrize("horizon", [4, 24, 48])
def test_band_plan_at_bucket_shapes(horizon, bw):
    """Every bucket's m at H = 4, 24 and 48, at every bandwidth, refine 0
    and 1 and batches from one home to 10,000, gets a plan of each staged
    kernel (the factor, the refined solve, the fused factor and solve)
    that the C entry point accepts: (homes per block, ring depth) one of
    BAND_KERNELS, rows per chunk m (whole band) or RING_ROWS, its shared
    memory within one block's 232,448 bytes; of the plans that fit, the
    one needing the fewest waves of blocks on the H100's 132 SMs, then the
    whole band, then the larger block."""
    for m in _bucket_ms(horizon):
        for kernel in bk.KERNEL_NAMES:
            for refine in (0, 1):
                fits = bk.band_plans(m, bw, kernel, refine)
                for B in (1, bk.BLOCK_HOMES, 1000, 4000, 10_000):
                    p = bk.band_plan(m, bw, kernel, B, refine=refine)
                    assert (p.hb, p.depth) in bk.BAND_KERNELS and p in fits
                    assert p.rows == (m if p.depth == 0 else min(bk.RING_ROWS, m))
                    assert p.smem == bk.band_smem(kernel, m, bw, p.hb, p.depth, p.rows, refine)
                    assert p.smem <= bk.MAX_SMEM == 232_448
                    least = min(bk.band_waves(q, B) for q in fits)
                    assert bk.band_waves(p, B) == least
                    tied = [q for q in fits if bk.band_waves(q, B) == least]
                    assert p.depth == min(q.depth for q in tied)
                    assert p.hb == max(q.hb for q in tied if q.depth == p.depth)
        # Refining, the fused kernel holds what the solve holds and its
        # progress word.
        assert ([p[:3] for p in bk.band_plans(m, bw, "factor_solve", 1)]
                == [p[:3] for p in bk.band_plans(m, bw, "solve")])
    if horizon == 24 and bw == 4:
        # The main path (B = 1,000 and 4,000) stages whole bands, 32 homes
        # a block; at 10,000 homes the solve's whole band would take 2-3
        # waves, and it streams (m = 77) or halves the block (m = 52), as
        # the card measured fastest.  The fused kernel at refine 0 holds
        # one band array (S, turning into L), one vector and its progress
        # word: 59,264 bytes at m = 77, three blocks an SM, so 10,000 homes
        # stay whole.
        for m in _bucket_ms(24):
            for k in bk.KERNEL_NAMES:
                assert bk.band_plan(m, 4, k, 1000)[:2] == (32, 0)
                assert bk.band_plan(m, 4, k, 4000)[:2] == (32, 0)
            assert bk.band_plan(m, 4, "factor_solve", 10_000)[:2] == (32, 0)
        assert bk.band_plan(77, 4, "solve", 10_000)[:2] == (32, 4)
        assert bk.band_plan(52, 4, "solve", 10_000)[:2] == (16, 0)
        assert bk.band_plan(77, 4, "factor_solve", 1000).smem == 59_264
        assert bk.band_plan(77, 4, "factor_solve", 10_000, refine=1)[:2] == (32, 4)
    if horizon == 48 and bw == 4:
        # m = 149: 32 homes' whole L, S and vectors exceed a block, 16
        # homes' fit; at 10,000 homes the ring.  m = 100: the factor's
        # whole band at 10,000 homes, the solve's ring of 16-home blocks.
        # The fused kernel at refine 0: 114,560 bytes at m = 149, whole up
        # to 4,000 homes (two blocks an SM), the ring at 10,000.
        assert bk.band_plan(149, 4, "solve", 1000)[:2] == (16, 0)
        assert bk.band_plan(149, 4, "solve", 10_000)[:2] == (32, 4)
        assert bk.band_plan(149, 4, "cholesky", 1000)[:2] == (32, 0)
        assert bk.band_plan(149, 4, "cholesky", 10_000)[:2] == (32, 4)
        assert bk.band_plan(100, 4, "cholesky", 10_000)[:2] == (32, 0)
        assert bk.band_plan(100, 4, "solve", 10_000)[:2] == (16, 4)
        assert bk.band_plan(149, 4, "factor_solve", 1000) == (32, 0, 149, 114_560)
        assert bk.band_plan(149, 4, "factor_solve", 4000)[:2] == (32, 0)
        assert bk.band_plan(149, 4, "factor_solve", 10_000)[:2] == (32, 4)
        # m = 100: 76,928 bytes leave room for two 32-home blocks an SM
        # (two waves at 10,000 homes), five 16-home blocks fit one wave.
        assert bk.band_plan(100, 4, "factor_solve", 10_000)[:2] == (16, 0)
        assert bk.band_plan(149, 4, "factor_solve", 1000, refine=1)[:2] == (16, 0)
    if horizon == 4 and bw == 4:
        for m in _bucket_ms(4):
            for k in bk.KERNEL_NAMES:
                assert bk.band_plan(m, 4, k, 10_000)[:3] == (32, 0, m)


def test_band_plan_refuses_what_it_cannot_run():
    """No plan where even the smallest block's vectors exceed one block's
    shared memory (the solve's three, or the fused kernel's one at refine
    0 and three when refining), for m < 1, a bandwidth beyond MAX_BAND or
    an unknown kernel; the factor alone streams any m through the ring."""
    with pytest.raises(ValueError, match="no solve kernel"):
        bk.band_plan(3000, 12, "solve", 1000)
    with pytest.raises(ValueError, match="no factor_solve kernel"):
        bk.band_plan(3000, 12, "factor_solve", 1000)
    assert bk.band_plan(2000, 12, "factor_solve", 1000)[:2] == (16, 4)
    with pytest.raises(ValueError, match="no factor_solve kernel"):
        bk.band_plan(2000, 12, "factor_solve", 1000, refine=1)
    assert bk.band_plan(3000, 12, "cholesky", 1000).depth > 0
    for m, bw in ((0, 4), (10, 0), (10, tb.MAX_BAND + 1)):
        for kernel in bk.KERNEL_NAMES:
            with pytest.raises(ValueError, match="no kernel"):
                bk.band_plan(m, bw, kernel, 1000)
    with pytest.raises(ValueError, match="kernel"):
        bk.band_plans(10, 4, "factor")


def test_ipm_step_ab_dry_run_on_the_cpu():
    """bench_band.ipm_ab's loop on CPU tensors, with the plain versions in
    the older kernels' place: both sides run the same steps in turns, the
    band wrappers' calls are counted, and the outputs agree bit for bit."""
    from dragg_tpu_torch.bench_band import ipm_ab

    older = (lambda St, bw: bk.cholesky_t_plain(St, bw),
             lambda L, S, r, bw, refine=1: bk.refined_solve_t_plain(L, S, r, bw, refine))
    res = ipm_ab(older, pairs=1, steps=2, homes=16, device="cpu")
    for side in ("this", "older"):
        assert len(res[side]["s_per_step"]) == 1 and res[side]["band_calls_per_step"] > 0
    assert res["this"]["band_calls_per_step"] == res["older"]["band_calls_per_step"]
    assert bk.banded_cholesky_t.__name__ == "banded_cholesky_t"   # restored


def test_route_ab_dry_run_on_the_cpu():
    """bench_band.route_ab's loop on CPU tensors: the split and the fused
    band route run the same steps in turns, the fused route makes fewer
    band calls a step (one launch in place of the predictor's two), the
    outputs agree bit for bit, and the wrappers and the route come back."""
    from dragg_tpu_torch.bench_band import route_ab, route_verdict

    res = route_ab(pairs=2, steps=2, homes=16, device="cpu")
    for side in ("split", "fused"):
        assert len(res[side]["s_per_step"]) == 2
        assert res[side]["band_calls_per_step"] > 0
    assert res["fused"]["band_calls_per_step"] < res["split"]["band_calls_per_step"]
    assert res["outputs_equal"] and res["verdict"] in ("split", "fused", "unresolved")
    assert bk.factor_refined_solve_t.__name__ == "factor_refined_solve_t"   # restored
    # The rule: a lower median, 7 of 10 pairs won, and a gap wider than
    # either side's interquartile half-width.
    split = [1.0, 1.1, 1.2, 1.3, 1.4, 1.0, 1.1, 1.2, 1.3, 1.4]
    assert route_verdict(split, [v - 0.5 for v in split]) == "fused"
    assert route_verdict([v - 0.5 for v in split], split) == "split"
    assert route_verdict(split, [v - 0.01 for v in split]) == "unresolved"
    assert route_verdict(split, split[::-1]) == "unresolved"


def test_band_kernel_table_matches_the_cuda_source():
    """``BAND_KERNELS`` lists exactly the instantiations of csrc/band.cu's
    BAND_KERNELS, in the same order (the C entry points refuse any other
    plan), and every ring depth is the source's kRingDepth; the kernels'
    shared-memory terms (``SMEM_TERMS``, read by ``band_smem``) are the
    source's BAND_SMEM, and its plan_smem gives band_smem's bytes."""
    src = os.path.join(os.path.dirname(bk.__file__), "..", "csrc", "band.cu")
    with open(src) as f:
        text = f.read()

    def table(name):
        block = text[text.index(f"#define {name}(X)"):]
        block = block[:block.index("\n\n")]
        return [tuple(int(v) for v in r.split(","))
                for r in re.findall(r"X\(([\d, ]+)\)", block)]

    assert table("BAND_KERNELS") == list(bk.BAND_KERNELS)
    depth = int(re.search(r"constexpr int kRingDepth = (\d+);", text).group(1))
    assert {d for _, d in bk.BAND_KERNELS} == {0, depth}
    enum = re.search(r"enum Kernel \{([^}]*)\}", text).group(1)
    codes = [int(v) for v in re.findall(r"= (\d+)", enum)]
    assert codes == list(range(len(bk.KERNEL_NAMES)))
    terms = {(bk.KERNEL_NAMES[k], bool(f)): tuple(t) for k, f, *t in table("BAND_SMEM")}
    assert terms == bk.SMEM_TERMS

    # plan_smem's arithmetic, evaluated as the source writes it.
    body = text[text.index("int plan_smem("):]
    body = body[:body.index("\n}\n")]
    band_rows = re.search(r"const long band_rows = (.*);", body).group(1)
    nbytes = re.search(r"const long bytes = (.*);", body).group(1)
    assert band_rows == "depth == 0 ? arrays * m : static_cast<long>(depth) * rows"
    assert nbytes == "4L * hb * (band_rows * (bw + 1) + vecs * m + words)"
    for kernel in bk.KERNEL_NAMES:
        for refine in (0, 2):
            arrays, vecs, words = terms[kernel, refine > 0]
            for m, bw, hb, depth, rows in ((77, 4, 32, 0, 77), (149, 12, 16, 4, 16)):
                want = 4 * hb * ((arrays * m if depth == 0 else depth * rows) * (bw + 1)
                                 + vecs * m + words)
                assert bk.band_smem(kernel, m, bw, hb, depth, rows, refine) == want
