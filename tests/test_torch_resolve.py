"""``tpu.integer_repair = "resolve"`` and ``tpu.band_kernel`` in the port's
engine (dragg_tpu_torch/engine.py, on the CPU).

The pinned-box re-solve against ``dragg_tpu.engine.Engine``: an 8-home
mixed community at a 4 h horizon, one superset batch (the bucketed
engine solves each bucket through the same code), 12 steps, each run by
both engines from the JAX engine's state (through ``interop``), so that a
fallback home whose replayed temperature sits on its comfort bound cannot
carry a float32 threshold flip from one step into the next.

Tolerances:

* interior point: solved flags, iteration counts (relaxed solve plus
  re-solve) and repair failures equal; every other series within
  tests/test_torch_engine.py's 1e-4 scaled by repair_eps / ipm_eps = 5
  (5e-4), because the re-solve stops at 1e-3, five times looser than the
  relaxed solve's 2e-4, and its iterate is what the applied plan holds;
* ReLU-QP: solved flags and repair failures equal, and the flip-aware
  assertion set of tests/test_torch_engine_reluqp.py.

``band_kernel``: "auto" and "pallas" call the CUDA kernels' wrappers
(which run the plain versions on a CPU tensor), "xla" the plain versions
directly; counted by wrapping the wrappers, with bit-equal outputs.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu import data as jd
from dragg_tpu import engine as je
from dragg_tpu import homes as jh
from dragg_tpu_torch import engine as te
from dragg_tpu_torch.config import default_config
from dragg_tpu_torch.interop import community_state_from_numpy
from dragg_tpu_torch.ops import band_kernels as bk
from test_torch_engine_reluqp import _assert_outputs_match_flip_aware

N_STEPS = 12
EXACT = ("correct_solve", "repair_failed", "waterdraws", "bank_fallback_count")


def _config(solver, **tpu):
    cfg = default_config()
    cfg["community"].update(total_number_homes=8, homes_pv=2, homes_battery=2,
                            homes_pv_battery=2)
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["home"]["hems"]["solver"] = solver
    cfg["tpu"].update({"bucketed": "false", "integer_repair": "resolve", **tpu})
    return cfg


def _inputs(cfg):
    env = jd.load_environment(cfg)
    wd = jd.load_waterdraw_profiles(jd.waterdraw_path(cfg, None), seed=12)
    batch = jh.build_home_batch(jh.create_homes(cfg, 24, 1, wd), 4, 1, 6)
    start = env.start_index(jd.parse_dt(cfg["simulation"]["start_datetime"]))
    return batch, env, start


def _stack(outs, cat):
    return te.StepOutputs(*[cat([getattr(o, f) for o in outs]) for f in te.StepOutputs._fields])


@pytest.fixture(scope="module", params=["ipm", "reluqp"])
def stepped(request):
    """(solver, JAX outputs, port outputs, duty steps s) over N_STEPS steps,
    each step run by both engines from the JAX engine's state."""
    cfg = _config(request.param)
    batch, env, start = _inputs(cfg)
    ej = je.make_engine(batch, env, cfg, start)
    et = te.make_engine(batch, env, cfg, start, device="cpu")
    assert ej.params.integer_repair == et.params.integer_repair == "resolve"
    assert et.params.repair_eps == ej.params.repair_eps == 1e-3
    rp = np.zeros((1, 4), np.float32)
    state_j, out_j, out_t = ej.init_state(), [], []
    for t in range(N_STEPS):
        state_t = community_state_from_numpy(
            {k: np.asarray(v) for k, v in state_j._asdict().items()}, "cpu")
        state_j, oj = ej.run_chunk(state_j, t, rp)
        _, ot = et.run_chunk(state_t, t, rp)
        out_j.append(oj)
        out_t.append(ot)
    return (request.param, _stack(out_j, np.concatenate), _stack(out_t, torch.cat),
            float(et.params.s))


def test_resolve_matches_jax(stepped):
    solver, out_j, out_t, s = stepped
    for f in EXACT:
        np.testing.assert_array_equal(getattr(out_t, f).numpy(), getattr(out_j, f), err_msg=f)
    assert float(out_t.correct_solve.mean()) > 0.5  # mostly solved
    if solver == "reluqp":
        _assert_outputs_match_flip_aware(out_j, out_t, s)
        return
    np.testing.assert_array_equal(out_t.admm_iters.numpy(), out_j.admm_iters)
    for f in te.StepOutputs._fields:
        if f in EXACT or f in ("admm_iters", "r_prim_max", "r_dual_max") or f in te.OBS_FIELDS:
            continue
        np.testing.assert_allclose(getattr(out_t, f).numpy(), getattr(out_j, f), rtol=0,
                                   atol=5e-4, err_msg=f)


def test_resolve_runs_a_second_solve():
    """Under "resolve" each step solves twice: the iteration count is the
    relaxed solve's plus the re-solve's, above "project"'s."""
    cfg = _config("ipm")
    batch, env, start = _inputs(cfg)
    rps = np.zeros((2, 4), np.float32)
    iters = {}
    for mode in ("project", "resolve"):
        cfg["tpu"]["integer_repair"] = mode
        et = te.make_engine(batch, env, cfg, start, device="cpu")
        iters[mode] = et.run_chunk(et.init_state(), 0, rps)[1].admm_iters.numpy()
    assert np.all(iters["resolve"] > iters["project"])


@pytest.mark.parametrize("route", ["auto", "pallas", "xla"])
def test_band_kernel_route(monkeypatch, route):
    """``tpu.band_kernel`` picks the band operations the interior point
    calls: the CUDA kernels' wrappers for "auto" and "pallas", their plain
    versions for "xla"; the outputs are the same bits on the CPU."""
    calls = {name: 0 for name in bk.LAUNCHES}

    def counted(name):
        wrapper = getattr(bk, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return wrapper(*args, **kwargs)
        return call

    for name in calls:
        monkeypatch.setattr(bk, name, counted(name))
    cfg = _config("ipm", band_kernel=route, integer_repair="project")
    batch, env, start = _inputs(cfg)
    et = te.make_engine(batch, env, cfg, start, device="cpu")
    assert et.params.band_kernel == route
    _, out = et.run_chunk(et.init_state(), 0, np.zeros((2, 4), np.float32))
    if route == "xla":
        assert sum(calls.values()) == 0, calls
    else:
        assert calls["banded_cholesky_t"] > 0 and calls["refined_banded_solve_t"] > 0, calls
    monkeypatch.undo()
    cfg["tpu"]["band_kernel"] = "auto"
    ref = te.make_engine(batch, env, cfg, start, device="cpu")
    _, want = ref.run_chunk(ref.init_state(), 0, np.zeros((2, 4), np.float32))
    for f in te.StepOutputs._fields:
        assert getattr(out, f).equal(getattr(want, f)), f
