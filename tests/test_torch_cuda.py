"""The port's CUDA kernels on the card against their plain PyTorch
versions: the band kernels bit for bit (both round every multiply, add,
divide and square root separately, in the same order), the fused ReLU-QP
window to float32 sum-order rounding, also at the shapes of grid-event
buckets; a short RL run through the band kernels; ``doctor``'s kernel
self-test.
Marked ``cuda``: they skip without a CUDA device; run them on the GPU with
``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu_torch.ops import band_kernels as bk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("batch", ["one", "below_block", "block_plus_one", "ragged"])
@pytest.mark.parametrize("m", [29, 1, 149])
@pytest.mark.parametrize("bw", [1, 4, 12])
def test_kernels_match_plain_versions(card, bw, m, batch):
    """The band kernels bit for bit against their plain versions, refine
    0, 1 and 2: the staged factor, solve and fused factor and solve at
    their plan and at every other plan the shape admits (whole band and
    ring, both block sizes); B = 1, fewer homes than a block, a block and
    one, a ragged 1,001; m = 1, and m = 149, where 32 homes' whole band
    does not fit a block for the solve at bw 4 and 12 and for the factor
    at bw 12.  The fused kernel equals the split route at every plan, the
    ring's included, which reads back the L this launch wrote."""
    from dragg_tpu_torch.bench_band import band_fixture

    hb = bk.BLOCK_HOMES
    B = {"one": 1, "below_block": hb - 3, "block_plus_one": hb + 1, "ragged": 1001}[batch]
    St, r = band_fixture(m, bw, B, seed=100 * bw + m + B)
    chol_plans, solve_plans = bk.band_plans(m, bw, "cholesky"), bk.band_plans(m, bw, "solve")
    if m == 149:
        assert ((32, 0) not in [p[:2] for p in solve_plans]) == (bw > 1)
        assert ((32, 0) not in [p[:2] for p in chol_plans]) == (bw == 12)
    bk.reset_launches()
    L = bk.banded_cholesky_t(St, bw)
    Lp = bk.cholesky_t_plain(St, bw)
    assert torch.equal(L, Lp)
    for plan in chol_plans:
        assert torch.equal(bk.cholesky_launch(St, bw, plan), Lp), plan
    fused = 0
    for refine in (0, 1, 2):
        x = bk.refined_banded_solve_t(L, St, r, bw, refine)
        xp = bk.refined_solve_t_plain(Lp, St, r, bw, refine)
        assert torch.equal(x, xp)
        for plan in solve_plans:
            assert torch.equal(bk.solve_launch(L, St, r, bw, refine, plan), xp), (plan, refine)
        L2, x2 = bk.factor_refined_solve_t(St, r, bw, refine)
        assert torch.equal(L2, L) and torch.equal(x2, x)
        fused_plans = bk.band_plans(m, bw, "factor_solve", refine)
        assert any(p.depth > 0 for p in fused_plans)
        for plan in fused_plans:
            L3, x3 = bk.factor_solve_launch(St, r, bw, refine, plan)
            assert torch.equal(L3, Lp) and torch.equal(x3, xp), (plan, refine)
        fused += 1 + len(fused_plans)
    torch.cuda.synchronize()
    assert bk.LAUNCHES == {"banded_cholesky_t": 1 + len(chol_plans),
                           "refined_banded_solve_t": 3 * (1 + len(solve_plans)),
                           "factor_refined_solve_t": fused}


@pytest.mark.parametrize("m,bw,B", [(76, 5, 2500), (76, 5, 10000), (101, 7, 1000),
                                    (101, 7, 10000), (101, 7, 1001)])
def test_grid_block_shapes_match_plain_versions(card, m, bw, B):
    """The band kernels bit for bit against their plain versions at the
    shapes an explicit grid-power block gives the interior point's
    buckets (a community under grid events: m = 76, bw = 5 and m = 101,
    bw = 7 at H = 24), at their bucket sizes of 10,000 homes under the
    shipped stress_dr_outage pack: the refined solve of (101, 7) with
    1,000 homes runs on 16-home blocks."""
    from dragg_tpu_torch.bench_band import band_fixture

    sms = bk._sms(card)
    if (m, bw, B) == (101, 7, 1000):
        assert bk.band_plan(m, bw, "solve", B, sms).hb == 16
    St, r = band_fixture(m, bw, B, seed=m + bw + B)
    L, Lp = bk.banded_cholesky_t(St, bw), bk.cholesky_t_plain(St, bw)
    assert torch.equal(L, Lp)
    for refine in (0, 1):
        x = bk.refined_banded_solve_t(L, St, r, bw, refine)
        assert torch.equal(x, bk.refined_solve_t_plain(Lp, St, r, bw, refine))
        L2, x2 = bk.factor_refined_solve_t(St, r, bw, refine)
        assert torch.equal(L2, L) and torch.equal(x2, x)


def test_refused_band_plan_raises(card):
    """A plan the C entry point does not list, or whose bytes do not match
    the shape (or, for the fused kernel, the refine), is refused and never
    runs."""
    from dragg_tpu_torch.bench_band import band_fixture

    St, r = band_fixture(29, 4, 10, seed=0)
    good = bk.band_plan(29, 4, "cholesky", 10)
    for plan in (bk.BandPlan(24, 0, 29, bk.band_smem("cholesky", 29, 4, 24, 0, 29)),
                 good._replace(smem=good.smem + 4), good._replace(depth=2, rows=5)):
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            bk.cholesky_launch(St, 4, plan)
    fused = bk.band_plan(29, 4, "factor_solve", 10)
    for plan, refine in ((fused, 1), (fused._replace(hb=24), 0),
                         (bk.band_plan(29, 4, "cholesky", 10), 0)):
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            bk.factor_solve_launch(St, r, 4, refine, plan)


@pytest.mark.parametrize("m,n,B", [(9, 21, 1001), (77, 221, 64), (52, 148, 300),
                                   (100, 292, 40), (149, 437, 37), (101, 245, 1000)])
def test_fused_window_matches_plain_version(card, m, n, B):
    """The fused ReLU-QP window against its plain version on a consistent
    fixture (S⁻¹ the inverse of Â D⁻¹ Âᵀ): rtol 1e-3 / atol 1e-4, the sums
    being taken in another order; any slice of homes reproduces the full
    batch bit for bit.  The shapes cover Â held in registers (m = 52 and
    77, the H = 24 buckets), in shared memory (the H = 48 pv_only bucket)
    and split over a cluster of two blocks (the H = 48 pv_battery
    bucket)."""
    from dragg_tpu_torch.ops import iter_kernels as ik

    g = torch.Generator(device=card).manual_seed(m)
    rnd = lambda *s: torch.rand(s, device=card, generator=g)  # noqa: E731
    A = (torch.randn((B, m, n), device=card, generator=g) * 0.5)
    w = 0.5 + rnd(B, n)
    rho = torch.full((B,), 0.4, device=card)
    pd = torch.full((B, n), 1e-3, device=card)
    Dinv = 1.0 / (pd + 1e-6 + rho[:, None] * w * w)
    S = torch.einsum("bmn,bn,bkn->bmk", A.double(), Dinv.double(), A.double())
    Sinv = torch.linalg.inv(S + 1e-4 * torch.eye(m, device=card, dtype=torch.float64))
    Sinv = Sinv.float().contiguous()
    ls, us = -1.0 - rnd(B, n), 1.0 + rnd(B, n)
    args = (A, Sinv, Dinv, w, torch.randn((B, n), device=card, generator=g),
            torch.randn((B, m), device=card, generator=g), ls, us, rho,
            0.1 * torch.randn((B, n), device=card, generator=g),
            torch.minimum(torch.maximum(torch.randn((B, n), device=card, generator=g), ls), us),
            0.1 * torch.randn((B, m), device=card, generator=g),
            0.1 * torch.randn((B, n), device=card, generator=g),
            0.5 + rnd(B, m), 0.5 + rnd(B, n), 0.5 + rnd(B, n), pd)
    ik.reset_launches()
    for k in (1, 25):
        out = ik.fused_window(*args, k=k, sigma=1e-6, alpha=1.6)
        ref = ik.fused_window_plain(*args, k=k, sigma=1e-6, alpha=1.6)
        for a, b in zip(out[0] + out[1], ref[0] + ref[1]):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)
            assert torch.isfinite(a).all()
        part = ik.fused_window(*(a[3:17].contiguous() for a in args), k=k,
                               sigma=1e-6, alpha=1.6)
        for a, b in zip(part[0] + part[1], out[0] + out[1]):
            assert torch.equal(a, b[3:17])
    torch.cuda.synchronize()
    assert ik.LAUNCHES == {"fused_window": 4}


def test_rl_agg_launches_band_kernels(card, tmp_path):
    """A short run_rl_agg on the card (8 homes, 4 h horizon, 3 steps, the
    linear agent and the interior point's split route) goes through the
    band kernels, and its reward price stays finite and within max_rp."""
    import json
    import math
    import os

    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.config import mixed_community_config

    cfg = mixed_community_config(8, 4, "2015-01-01 03")
    cfg["simulation"].update(run_rbo_mpc=False, run_rl_agg=True)
    bk.reset_launches()
    agg = Aggregator(cfg, outputs_dir=str(tmp_path), device="cuda")
    agg.run()
    assert bk.LAUNCHES["banded_cholesky_t"] > 0 and bk.LAUNCHES["refined_banded_solve_t"] > 0
    with open(os.path.join(agg.run_dir, "rl_agg", "results.json")) as f:
        rp = json.load(f)["Summary"]["RP"]
    assert len(rp) == 3 and all(math.isfinite(v) and abs(v) <= 0.02 + 1e-9 for v in rp)
    assert agg.agent.carry.theta_q.device.type == "cuda"


def test_doctor_kernel_selftest(card):
    """``doctor``'s ``cuda_kernels`` self-test: all four kernels equal their
    plain versions at its shape."""
    from dragg_tpu_torch.doctor import cuda_kernel_selftest

    rep = cuda_kernel_selftest()
    assert rep["ok"], rep
    assert sorted(rep["kernels"]) == ["banded_cholesky_t", "factor_refined_solve_t",
                                      "fused_window", "refined_banded_solve_t"]


def test_host_sync_counters_match_sync_debug_mode(card, tmp_path):
    """Every wait for the card in an engine chunk (three interior-point
    steps of a four-bucket community) is counted at its site: torch's sync
    debug mode warns once a sync, and the program's two counters add up
    to its warnings."""
    import collections
    import warnings

    import numpy as np

    from dragg_tpu_torch import telemetry
    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.config import mixed_community_config

    cfg = mixed_community_config(40, 6, "2015-01-01 12")
    cfg["home"]["hems"]["solver"] = "ipm"
    agg = Aggregator(cfg, outputs_dir=str(tmp_path), device="cuda")
    agg.get_homes()
    agg._build_engine()
    eng = agg.engine
    rps = np.zeros((3, eng.params.horizon), np.float32)
    state, _ = eng.run_chunk(eng.init_state(), 0, rps)      # compiles and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, telemetry.recording() as rec:
            warnings.simplefilter("always")
            eng.run_chunk(state, 8, rps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    counted = rec.counters["ipm.host_syncs"] + rec.counters["engine.host_syncs"]
    sites = collections.Counter(f"{w.filename}:{w.lineno}" for w in syncs)
    assert len(syncs) == counted > 0, (rec.counters, sorted(sites.items()))
