"""The port's observatory fold (dragg_tpu_torch/engine.py ``per_home_obs``,
on the CPU) against the JAX engine's ``_per_home_obs``, and the engines'
observatory leaves over a run.

The pure fold is held bit for bit (all nine leaves, dtypes and shapes) on
inputs from a seed with NaN, ±inf, 0, 1e-30 and 1e30 residuals, non-finite
dual residuals, conv_iters at, one below and one above every
``OBS_ITER_EDGES`` entry, diverged homes (so several homes tie at the
float32-max sentinel), masked pad homes, and k below, equal to and above
the bucket's size.  Residuals are kept 1e-4 of a bin away from the
half-decade edges: the two packages' ``log10`` may differ by an ulp there.

Over a run (8 homes, H = 4, 12 steps, bucketed: 4 buckets of 2 homes) the
two float32 solvers land at different points of their tolerance, so:
histogram totals are equal, and every count that differs moved to an
adjacent bin only (measured: 4 of 96 residual counts for the interior
point, 22 of 96 for ReLU-QP, 0 iteration counts); divergence counts and
the captured homes are equal; a captured home's iterations are equal
(interior point) or within one check window (ReLU-QP), and its residual
within the solvers' noise where both packages solved it (the interior
point's per-home residuals differ by up to 6.6e-5 absolute, which at
1e-6 residuals reorders homes, so the order is not held across the
packages; each package's capture is sorted).  With ``telemetry.per_home =
false`` the leaves are zero-width and every other output is bit-equal.
"""

from types import SimpleNamespace as NS

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu import data as jd
from dragg_tpu import engine as je
from dragg_tpu import homes as jh
from dragg_tpu_torch import engine as te
from dragg_tpu_torch.config import default_config


def _fold_inputs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    rp = (10.0 ** rng.uniform(-9.5, 3.5, n)).astype(np.float32)
    lg = np.log10(rp.astype(np.float64)) / te.OBS_RES_LOG_STEP
    rp[np.abs(lg - np.round(lg)) < 1e-4] *= np.float32(1.01)
    rp[:8] = [np.nan, np.inf, -np.inf, 1e-30, 1e30, 0.0, np.nan, 3e-5]
    rd = (10.0 ** rng.uniform(-8, 1, n)).astype(np.float32)
    rd[3], rd[9] = np.nan, np.inf
    edges = np.asarray(te.OBS_ITER_EDGES)
    cit = np.resize(np.concatenate([edges - 1, edges, edges + 1, [0, 1, 600, 1000]]), n)
    cit = cit.astype(np.int32)
    rng.shuffle(cit)
    div = rng.random(n) < 0.1
    div[10:13] = True
    mask = (rng.random(n) < 0.8).astype(np.float32)
    mask[:2] = 1.0
    home_idx = (np.arange(n) * 3 + 7).astype(np.int32)
    return rp, rd, cit, div, mask, home_idx


def test_obs_constants_match_jax():
    for name in ("OBS_RES_LOG_LO", "OBS_RES_LOG_STEP", "OBS_RES_BINS", "OBS_ITER_EDGES",
                 "OBS_ITER_BINS", "OBS_FIELDS"):
        assert getattr(te, name) == getattr(je, name), name
    assert set(te.StepOutputs._fields) == set(je.StepOutputs._fields)


@pytest.mark.parametrize("seed,n,k", [(0, 64, 8), (1, 14, 20), (2, 200, 16), (3, 4000, 8)])
def test_fold_bit_equal_to_jax(seed, n, k):
    rp, rd, cit, div, mask, home_idx = _fold_inputs(seed, n)
    fake = NS(params=NS(obs_per_home=True, obs_worst_k=k))
    ctx = NS(check_mask=jnp.asarray(mask), n=n, home_idx=jnp.asarray(home_idx), ordinal=2)
    sol = NS(r_prim=jnp.asarray(rp), r_dual=jnp.asarray(rd), conv_iters=jnp.asarray(cit),
             diverged=jnp.asarray(div), iters=jnp.asarray(5), infeasible=None)
    want = je.Engine._per_home_obs(fake, ctx, sol)
    t = torch.from_numpy
    got = te.per_home_obs(t(rp), t(rd), t(cit), t(div), t(mask), t(home_idx), 2, min(k, n),
                          torch.tensor(te.OBS_ITER_EDGES, dtype=torch.int32))
    assert set(got) == set(want) == te.OBS_FIELDS
    for f in want:
        a, b = np.asarray(want[f]), got[f].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    # The sentinel ties (NaN, ±inf and diverged residuals) are captured
    # lowest index first, as lax.top_k orders them.
    assert got["worst_rp"][0] == np.float32(3.4e38)


def _engines(solver: str, per_home: bool = True):
    cfg = default_config()
    cfg["community"].update(total_number_homes=8, homes_pv=2, homes_battery=2,
                            homes_pv_battery=2)
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["home"]["hems"]["solver"] = solver
    cfg["tpu"]["bucketed"] = "true"
    cfg["telemetry"]["per_home"] = per_home
    env = jd.load_environment(cfg)
    wd = jd.load_waterdraw_profiles(jd.waterdraw_path(cfg, None), seed=12)
    batch = jh.build_home_batch(jh.create_homes(cfg, 24, 1, wd), 4, 1, 6)
    start = env.start_index(jd.parse_dt(cfg["simulation"]["start_datetime"]))
    return (je.make_engine(batch, env, cfg, start),
            te.make_engine(batch, env, cfg, start, device="cpu"))


def adjacent_moves(a: np.ndarray, b: np.ndarray) -> int | None:
    """The counts that differ between two histograms of equal total when
    every one of them moved to an adjacent bin, else None: the net flow
    D_i across each bin boundary must leave no bin of ``a`` with more
    counts going out (right D_i, left -D_{i-1}) than it holds."""
    flow = np.cumsum(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert flow[-1] == 0, "totals differ"
    for i in range(len(flow)):
        out = max(flow[i], 0.0) + (max(-flow[i - 1], 0.0) if i else 0.0)
        if out > a[i]:
            return None
    return int(np.abs(flow).sum())


def test_adjacent_moves_helper():
    assert adjacent_moves(np.array([2, 1, 0]), np.array([1, 2, 0])) == 1
    assert adjacent_moves(np.array([1, 1, 0]), np.array([0, 1, 1])) == 2
    assert adjacent_moves(np.array([1, 0, 0]), np.array([0, 0, 1])) is None


@pytest.mark.parametrize("solver,max_moves,iters_tol,rp_tol", [
    ("ipm", 8, 0, 1e-4),
    ("reluqp", 30, 25, 1e-3),
])
def test_engine_run_obs_matches_jax(solver, max_moves, iters_tol, rp_tol):
    ej, et = _engines(solver)
    assert et.obs_enabled and ej.obs_enabled
    rps = np.zeros((12, 4), np.float32)
    _, oj = ej.run_chunk(ej.init_state(), 0, rps)
    _, ot = et.run_chunk(et.init_state(), 0, rps)
    j = {f: np.asarray(getattr(oj, f)) for f in te.OBS_FIELDS | {"correct_solve"}}
    t = {f: getattr(ot, f).numpy() for f in te.OBS_FIELDS | {"correct_solve"}}
    for f in te.OBS_FIELDS:
        assert j[f].shape == t[f].shape and j[f].dtype == t[f].dtype, f
    binfo = et.bucket_info()
    assert [b["name"] for b in binfo] == [b["name"] for b in ej.bucket_info()]
    moves = 0
    for key in ("conv_hist", "iters_hist"):
        for s in range(12):
            for bi, b in enumerate(binfo):
                assert t[key][s, bi].sum() == j[key][s, bi].sum() == b["n_real"], key
                m = adjacent_moves(j[key][s, bi], t[key][s, bi])
                assert m is not None, (key, s, b["name"], j[key][s, bi], t[key][s, bi])
                moves += m
    assert moves <= max_moves, moves
    np.testing.assert_array_equal(t["diverged_count"], j["diverged_count"])
    np.testing.assert_array_equal(t["worst_bucket"], j["worst_bucket"])
    assert np.all(np.abs(t["iters_sum"] - j["iters_sum"]) <= iters_tol * 2)
    solved_both = (t["correct_solve"] > 0) & (j["correct_solve"] > 0)
    for s in range(12):
        for bi in range(len(binfo)):
            sel = t["worst_bucket"][s] == bi
            assert np.all(np.diff(t["worst_rp"][s, sel]) <= 0)  # sorted, worst first
            cap_j = dict(zip(j["worst_idx"][s, sel], zip(j["worst_rp"][s, sel],
                                                          j["worst_iters"][s, sel])))
            cap_t = dict(zip(t["worst_idx"][s, sel], zip(t["worst_rp"][s, sel],
                                                          t["worst_iters"][s, sel])))
            assert set(cap_t) == set(cap_j)
            for h, (rp, it) in cap_t.items():
                assert abs(it - cap_j[h][1]) <= iters_tol, (s, h)
                if solved_both[s, h]:
                    assert abs(rp - cap_j[h][0]) <= rp_tol, (s, h, rp, cap_j[h][0])


@pytest.mark.parametrize("solver", ["ipm", "reluqp"])
def test_per_home_off_is_zero_width_and_bit_equal(solver):
    _, on = _engines(solver, per_home=True)
    _, off = _engines(solver, per_home=False)
    assert on.obs_enabled and not off.obs_enabled
    rps = np.zeros((4, 4), np.float32)
    _, o_on = on.run_chunk(on.init_state(), 0, rps)
    _, o_off = off.run_chunk(off.init_state(), 0, rps)
    for f in te.StepOutputs._fields:
        a, b = getattr(o_on, f), getattr(o_off, f)
        if f in te.OBS_FIELDS:
            assert b.numel() == 0 and a.numel() > 0, f
            assert b.shape[0] == 4 and a.dtype == b.dtype, f
        else:
            assert torch.equal(a, b), f


def test_state_slice_names_the_home():
    """``state_slice`` reads one home's chunk-start state from the engine's
    tensors and from a host copy alike, through the bucket that holds it."""
    from dragg_tpu_torch.checkpoint import host_snapshot

    _, et = _engines("ipm")
    state = et.init_state()
    host = host_snapshot(state)
    for h in range(8):
        got = et.state_slice(state, h)
        assert got == et.state_slice(host, h)
        assert set(got) == {"temp_in", "temp_wh", "e_batt", "counter"}
        b = next(i for i, b in enumerate(et.bucket_info())
                 if b["comm_start"] <= h < b["comm_start"] + b["n_real"])
        assert got["temp_in"] == float(state[b].temp_in[h - et.bucket_info()[b]["comm_start"]])
    assert et.state_slice(state, 8) == {}
