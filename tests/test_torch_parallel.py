"""The port's sharded engine (dragg_tpu_torch/parallel, on the CPU) against
the JAX package's ``ShardedEngine`` on ``make_mesh(W)``, over the first W
of conftest's 8 CPU devices; in one process.

* Each rank's block of every padded bucket's per-home constants equals the
  addressable shard JAX device r holds (W = 2 and 4, bucketed and not, one
  community and a fleet of two, whose community rows and fold arrays are
  the rank's block of JAX's).
* ``engine_params``, the ADMM's resolved backend (whose "auto" budget is
  per rank) and ``iter_kernel`` (``"pallas"`` → ``"lax"`` above one rank)
  resolve as JAX's at W = 1, 2 and 4.
* A world of one is an unsharded engine, bit for bit.
* Two ranks step their blocks as two threads joined by an in-process
  world (``_ThreadWorld``: the collectives of ``parallel.World`` over a
  barrier; the gloo group itself runs in tests/test_torch_distributed*.py)
  against JAX on ``make_mesh(2)``: the IPM (an 18-home superset batch, so
  each rank's block of 9 runs the per-rank straggler tail) with
  tests/test_torch_engine.py's tolerances (solved flags, iteration
  counts, cooling duty and water draws equal; every other series within
  1e-4), ReLU-QP with tests/test_torch_engine_reluqp.py's flip-aware set
  and its iteration and exact-tail counts equal to JAX's on every step
  where the unsharded port's equal the unsharded JAX engine's, and off by
  exactly as much on the others (one step of six on this 18-home
  community, a check window and a tail home: float32 noise, unsharded
  too), the ADMM at its defaults with its iteration counts equal to JAX's,
  and in its fixed-iteration mode (tests/test_parallel.py:95-160: eps 0,
  patience 0, 150 iterations, no integer pin) within 1e-3, its iteration
  counts equal; the observatory's histogram totals and divergence counts
  equal JAX's sharded fold.
"""

import threading
from dataclasses import dataclass

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu import data as jd  # noqa: E402
from dragg_tpu import engine as je  # noqa: E402
from dragg_tpu import homes as jh  # noqa: E402
from dragg_tpu.ops import admm as ja  # noqa: E402
from dragg_tpu.parallel import make_mesh  # noqa: E402
from dragg_tpu.parallel import make_sharded_engine as jax_sharded_engine  # noqa: E402
from dragg_tpu_torch import engine as te  # noqa: E402
from dragg_tpu_torch import telemetry as ttel  # noqa: E402
from dragg_tpu_torch.config import default_config  # noqa: E402
from dragg_tpu_torch.ops import admm as ta  # noqa: E402
from dragg_tpu_torch.parallel import ONE, ShardedEngine, make_sharded_engine, shard_state  # noqa: E402
from dragg_tpu_torch.parallel.world import World  # noqa: E402
from tests.test_torch_engine import _compare  # noqa: E402
from tests.test_torch_engine_reluqp import _assert_outputs_match_flip_aware  # noqa: E402

H = 4


class _Hub:
    """Where the ranks' threads meet: each collective is one exchange."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n, timeout=300)
        self.slots = [None] * n

    def exchange(self, rank: int, value):
        self.slots[rank] = value
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


@dataclass(frozen=True)
class _ThreadWorld(World):
    """``parallel.World``'s collectives between threads of one process."""

    hub: object = None

    def all_reduce(self, values, op="sum", host=False):
        g = np.stack(self.hub.exchange(self.rank, np.asarray(values, np.float64)))
        return {"sum": np.sum, "min": np.min, "max": np.max}[op](g, axis=0)

    def all_gather(self, values, host=False):
        return np.stack(self.hub.exchange(self.rank, np.ascontiguousarray(values)))

    def gather(self, values, host=True):
        g = self.all_gather(values)
        return g if self.rank == 0 else None

    def broadcast(self, values, host=True):
        return np.asarray(self.hub.exchange(self.rank, np.ascontiguousarray(values))[0])

    def barrier(self, host=True):
        self.hub.exchange(self.rank, None)


def run_ranks(W: int, fn):
    """``fn(world)`` on W threads, one a rank; their results in rank order."""
    hub, results, errors = _Hub(W), [None] * W, []

    def target(r):
        try:
            results[r] = fn(_ThreadWorld(rank=r, size=W, local_rank=r, hub=hub))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=target, args=(r,)) for r in range(W)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if errors:
        raise errors[0]
    return results


def _config(bucketed, n=18, **tpu):
    cfg = default_config()
    cfg["community"].update(total_number_homes=n, homes_pv=4, homes_battery=4,
                            homes_pv_battery=4)
    cfg["home"]["hems"]["prediction_horizon"] = H
    cfg["tpu"].update(bucketed=bucketed, **tpu)
    return cfg


def _inputs(cfg):
    env = jd.load_environment(cfg)
    wd = jd.load_waterdraw_profiles(jd.waterdraw_path(cfg, None), seed=12)
    batch = jh.build_home_batch(jh.create_homes(cfg, 24, 1, wd), H, 1, 6)
    start = env.start_index(jd.parse_dt(cfg["simulation"]["start_datetime"]))
    return batch, env, start


def _fleet_inputs(cfg):
    """A fleet's type-major batch and its FleetSpec (two communities)."""
    cfg["fleet"].update(communities=2, seed_stride=5, weather_offset_hours=24)
    env = jd.load_environment(cfg)
    wd = jd.load_waterdraw_profiles(jd.waterdraw_path(cfg, None), seed=12)
    batch, fleet = jh.build_fleet_batch(jh.create_fleet_homes(cfg, 48, 1, wd), cfg, H, 1, 6)
    start = env.start_index(jd.parse_dt(cfg["simulation"]["start_datetime"]))
    return batch, fleet, env, start


def _jax_contexts(eng):
    return eng._buckets if eng.bucketed else [eng._ctx0]


def _shard_block(arr, r: int) -> np.ndarray:
    """JAX device r's block of a home-sharded array."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start or 0)
    return np.asarray(shards[r].data)


@pytest.mark.parametrize("bucketed", ["true", "false"])
@pytest.mark.parametrize("W", [2, 4])
def test_rank_blocks_equal_jax_shards(W, bucketed):
    _assert_rank_blocks_equal_jax_shards(W, bucketed, 1)


@pytest.mark.parametrize("bucketed", ["true", "false"])
@pytest.mark.parametrize("W", [2, 4])
def test_fleet_rank_blocks_equal_jax_shards(W, bucketed):
    _assert_rank_blocks_equal_jax_shards(W, bucketed, 2)


def _assert_rank_blocks_equal_jax_shards(W, bucketed, communities):
    cfg = _config(bucketed)
    if communities > 1:
        batch, fleet, env, start = _fleet_inputs(cfg)
    else:
        (batch, env, start), fleet = _inputs(cfg), None
    ej = jax_sharded_engine(batch, env, cfg, start, mesh=make_mesh(W), fleet=fleet)
    assert ej.n_communities == communities
    jctx = _jax_contexts(ej)
    comm_j, mask_j = ej.community_fold_arrays()
    for r in range(W):
        et = make_sharded_engine(batch, env, cfg, start, world=World(rank=r, size=W),
                                 device="cpu", fleet=fleet)
        assert (et.n_homes, et.true_n_homes) == (ej.n_homes, ej.true_n_homes)
        # The fold arrays: the rank's block of each bucket of JAX's merged ones.
        blocks = [np.arange(b["start_slot"], b["start_slot"] + b["n_slots"])
                  .reshape(W, -1)[r] for b in ej.bucket_info()]
        cols = np.concatenate(blocks)
        comm_t, mask_t = et.community_fold_arrays()
        np.testing.assert_array_equal(comm_t, comm_j[cols])
        np.testing.assert_array_equal(mask_t, mask_j[cols])
        assert set(comm_j[mask_j > 0]) == set(range(communities))
        keys = ("name", "comm_start", "n_real", "start_slot", "n_slots", "m_eq", "n_var")
        assert ([{k: b[k] for k in keys} for b in et.bucket_info()]
                == [{k: b[k] for k in keys} for b in ej.bucket_info()])
        np.testing.assert_array_equal(et.real_home_cols, ej.real_home_cols)
        # The initial state: the rank's block of JAX's, the key whole.
        wrap = (lambda s: s) if et.bucketed else (lambda s: (s,))  # noqa: E731
        for a, b in zip(wrap(shard_state(ej.init_state(), et)), wrap(et.init_state())):
            for name, x, y in zip(te.CommunityState._fields, a, b):
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6, err_msg=name)
        for cj, ct in zip(jctx, et._buckets):
            for name in ("check_mask", "home_idx", "noise_idx", "env_off", "comm_idx",
                         "home_key"):
                np.testing.assert_array_equal(
                    getattr(ct, name).numpy(), _shard_block(getattr(cj, name), r),
                    err_msg=f"{name} rank {r}")
            for f in type(ct.batch)._fields:
                np.testing.assert_array_equal(
                    getattr(ct.batch, f).numpy(),
                    _shard_block(getattr(cj.batch, f), r).astype(
                        getattr(ct.batch, f).numpy().dtype), err_msg=f)
            for f in ("vals", "a_in", "a_wh", "kin", "kwh", "awr"):
                np.testing.assert_allclose(
                    getattr(ct.static, f).numpy(), _shard_block(getattr(cj.static, f), r),
                    rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("W", [1, 2, 4])
def test_params_and_routes_resolve_as_jax(W, monkeypatch):
    """The ADMM's "auto" backend goes banded only past a budget per rank:
    with the budget lowered to fall between one and four ranks' Sinv, the
    resolution depends on W, in both packages alike."""
    cfg = _config("true", admm_solve_backend="auto", iter_kernel="pallas")
    cfg["home"]["hems"]["solver"] = "reluqp"
    batch, env, start = _inputs(cfg)
    budget = 4 * 6 * 17 * 17 // 2
    monkeypatch.setattr(ja, "BAND_AUTO_BYTES", budget)
    monkeypatch.setattr(ta, "BAND_AUTO_BYTES", budget)
    ej = jax_sharded_engine(batch, env, cfg, start, mesh=make_mesh(W))
    et = make_sharded_engine(batch, env, cfg, start, world=World(rank=0, size=W),
                             device="cpu")
    pj, pt = je.engine_params(cfg, start), et.params
    for f in te.EngineParams._fields:
        if f in je.EngineParams._fields:
            assert getattr(pt, f) == getattr(pj, f), f
    assert et.iter_kernel == ej.iter_kernel == ("pallas" if W == 1 else "lax")
    assert et.solve_backends == [c.solve_backend for c in _jax_contexts(ej)]
    assert ("band" in et.solve_backends) == (W == 1)


def test_world_of_one_equals_unsharded():
    cfg = _config("true", n=12)
    batch, env, start = _inputs(cfg)
    eu = te.make_engine(batch, env, cfg, start, device="cpu")
    es = make_sharded_engine(batch, env, cfg, start, world=ONE, device="cpu")
    assert isinstance(es, ShardedEngine) and es.n_homes == eu.n_homes == 12
    rps = np.zeros((3, H), np.float32)
    su, ou = eu.run_chunk(eu.init_state(), 0, rps)
    ss, os_ = es.run_chunk(es.init_state(), 0, rps)
    for a, b in zip(ou, os_):
        assert torch.equal(a, b)
    for a, b in zip(su, ss):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _two_rank_run(cfg, n_steps):
    """(JAX sharded outputs on make_mesh(2), the port's two ranks' outputs
    with rank 0's gathered per-home rows in real-home columns, each rank's
    local outputs)."""
    batch, env, start = _inputs(cfg)
    rps = np.zeros((n_steps, H), np.float32)
    ej = jax_sharded_engine(batch, env, cfg, start, mesh=make_mesh(2))
    _, out_j = ej.run_chunk(ej.init_state(), 0, rps)
    cols = np.asarray(ej.real_home_cols)
    out_j = je.StepOutputs(*[
        np.asarray(a)[:, cols] if np.asarray(a).ndim == 2 and f not in je.OBS_FIELDS
        else np.asarray(a) for f, a in zip(je.StepOutputs._fields, out_j)])

    def rank(world):
        et = make_sharded_engine(batch, env, cfg, start, world=world, device="cpu")
        _, out = et.run_chunk(et.init_state(), 0, rps)
        per_home = {f: a.numpy() for f, a in out._asdict().items()
                    if a.ndim == 2 and f not in te.OBS_FIELDS}
        whole = et.gather_homes(per_home)
        return et, out, whole

    (e0, o0, whole), (_, o1, _) = run_ranks(2, rank)
    assert np.array_equal(e0.real_home_cols, cols)
    merged = o0._asdict()
    merged.update({f: torch.as_tensor(a[:, cols]) for f, a in whole.items()})
    return out_j, te.StepOutputs(**merged), (o0, o1)


def _assert_ranks_agree(o0, o1):
    """Every rank holds the same totals, maxima and observatory fold."""
    for f in te.StepOutputs._fields:
        a, b = getattr(o0, f), getattr(o1, f)
        if a.ndim <= 1 or f in te.OBS_FIELDS:
            assert torch.equal(a, b), f


def _assert_obs_as_jax(out_j, out_t):
    for f in ("conv_hist", "iters_hist"):
        np.testing.assert_array_equal(getattr(out_t, f).numpy().sum(axis=2),
                                      np.asarray(getattr(out_j, f)).sum(axis=2), err_msg=f)
    np.testing.assert_array_equal(out_t.diverged_count.numpy(),
                                  np.asarray(out_j.diverged_count))
    for f in ("worst_idx", "worst_rp", "worst_bucket"):
        assert getattr(out_t, f).shape == np.asarray(getattr(out_j, f)).shape, f


def _phase1_iterations(rec) -> int:
    """Full-batch iterations over a recording: before any cross-rank
    reduction, so every rank of a sharded solve counts the same ones."""
    return sum(r["attrs"]["iterations"] for r in rec.records if r["name"] == "ipm.phase1_s")


def test_two_ranks_ipm_match_jax():
    cfg = _config("false")
    with ttel.recording() as sharded:
        out_j, out_t, (o0, o1) = _two_rank_run(cfg, 4)
    assert o0.p_grid.shape == (4, 9)        # each rank's block, a 9-home tail batch
    _compare(out_j, out_t)
    _assert_ranks_agree(o0, o1)
    _assert_obs_as_jax(out_j, out_t)
    assert float(out_t.correct_solve.mean()) > 0.5
    # Each rank ran the phase-1 iterations of one rank over the whole batch.
    batch, env, start = _inputs(cfg)
    eu = te.make_engine(batch, env, cfg, start, device="cpu")
    with ttel.recording() as single:
        eu.run_chunk(eu.init_state(), 0, np.zeros((4, H), np.float32))
    assert _phase1_iterations(sharded) == 2 * _phase1_iterations(single) > 0


def test_two_ranks_reluqp_match_jax():
    cfg = _config("true", admm_refactor_every=4)
    cfg["home"]["hems"]["solver"] = "reluqp"
    ta.reset_factorizations()
    out_j, out_t, (o0, o1) = _two_rank_run(cfg, 6)
    sharded_windows = ta.CHECK_WINDOWS["windows"]
    _assert_outputs_match_flip_aware(out_j, out_t, float(je.engine_params(cfg, 0).s))
    # The unsharded port stops whole check windows away from JAX on some
    # steps (float32 noise in the 0.99 descent test), and the same flips
    # move the count of homes that needed the exact tail by a home.  Two
    # ranks stop where one does, so they are off from JAX's two devices
    # exactly as one rank is off from JAX's one, and equal on every other
    # step.
    batch, env, start = _inputs(cfg)
    rps = np.zeros((6, H), np.float32)
    eu = te.make_engine(batch, env, cfg, start, device="cpu")
    ta.reset_factorizations()
    _, out_u = eu.run_chunk(eu.init_state(), 0, rps)
    # Each rank read the check windows of one rank over the whole batch.
    assert sharded_windows == 2 * ta.CHECK_WINDOWS["windows"] > 0
    eju = je.make_engine(batch, env, cfg, start)
    _, out_ju = eju.run_chunk(eju.init_state(), 0, rps)
    for f in ("admm_iters", "bank_fallback_count"):
        t, j = getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f))
        u, ju = getattr(out_u, f).numpy(), np.asarray(getattr(out_ju, f))
        np.testing.assert_array_equal(t, u, err_msg=f)
        np.testing.assert_array_equal(t - j, u - ju, err_msg=f)
        assert np.mean(t == j) >= 0.7, (f, t, j)
    assert np.all((out_t.admm_iters.numpy() - np.asarray(out_j.admm_iters)) % 25 == 0)
    _assert_ranks_agree(o0, o1)


def test_two_ranks_admm_fixed_iterations_match_jax():
    cfg = _config("true", admm_eps=0.0, admm_patience=0, admm_iters=150,
                  integer_first_action=False)
    cfg["home"]["hems"]["solver"] = "admm"
    out_j, out_t, (o0, o1) = _two_rank_run(cfg, 3)
    assert out_t.admm_iters.tolist() == [150, 150, 150]
    np.testing.assert_array_equal(out_t.admm_iters.numpy(), np.asarray(out_j.admm_iters))
    for f in te.StepOutputs._fields:
        if f in te.OBS_FIELDS or f in ("r_prim_max", "r_dual_max"):
            continue
        np.testing.assert_allclose(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)),
                                   rtol=0, atol=1e-3, err_msg=f)
    _assert_ranks_agree(o0, o1)


def test_two_ranks_admm_match_jax():
    """The ADMM at its defaults, held as tests/test_torch_engine_admm.py
    holds the unsharded port (its EXACT fields equal, the series within
    1e-3), its stop windows JAX's and the unsharded port's, and its
    factorizations the unsharded port's on each rank."""
    from tests.test_torch_engine_admm import EXACT as ADMM_EXACT

    cfg = _config("true")
    cfg["home"]["hems"]["solver"] = "admm"
    ta.reset_factorizations()
    out_j, out_t, (o0, o1) = _two_rank_run(cfg, 2)
    sharded_facts = dict(ta.FACTORIZATIONS)
    sharded_windows = ta.CHECK_WINDOWS["windows"]
    np.testing.assert_array_equal(out_t.admm_iters.numpy(), np.asarray(out_j.admm_iters))
    for f in te.StepOutputs._fields:
        if f in te.OBS_FIELDS or f in ("r_prim_max", "r_dual_max", "admm_iters"):
            continue
        a, b = getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f))
        if f in ADMM_EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, err_msg=f)
    batch, env, start = _inputs(cfg)
    eu = te.make_engine(batch, env, cfg, start, device="cpu")
    ta.reset_factorizations()
    _, out_u = eu.run_chunk(eu.init_state(), 0, np.zeros((2, H), np.float32))
    assert torch.equal(out_t.admm_iters, out_u.admm_iters)
    # Both ranks read and refactor at the same windows: twice the one
    # rank's counts.
    assert sharded_facts == {k: 2 * v for k, v in ta.FACTORIZATIONS.items()}
    assert sharded_windows == 2 * ta.CHECK_WINDOWS["windows"] > 0
    _assert_ranks_agree(o0, o1)
