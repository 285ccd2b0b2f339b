"""The port's engine and aggregator under ``hems.solver = "admm"``
(dragg_tpu_torch on the CPU) against the JAX package's: an 8-home mixed
community at a 4 h horizon, bucketed and not.

Each step of the day runs from the JAX engine's state and solver carry
(``interop.engine_state_from_numpy`` / ``engine_factor_from_numpy``), so a
step's comparison is not blurred by the previous step's.  Fields equal on
every step: solved flags, cooling duty, water draws, the EV and
repair/bank counters (``EXACT``).  ``admm_iters`` is not exact: the
stagnation exit keeps the loop alive while an unfinished home's residual
falls below 0.99 of its best, and on steps where only certified-
infeasible or stalled homes remain that comparison flips on float32
noise, so the two packages stop one or more whole check windows apart
(the homes that stop differ only in the flagged-unsolved stragglers).
Every other series agrees to 1e-3 absolute: a first-order iterate is
pinned only to its stopping ball, 1e-4 + 1e-4·|row| (4.6e-3 on the 45 degC
water-heater rows), and the two packages' iterates were measured at most
2.7e-4 apart (forecast_p_grid, the plan's step-1 grid power; 1.4e-4 on
temp_wh; under 1e-5 on the applied powers).  The final residual maxima
are set by the certified-infeasible homes, whose residuals grow with every
window and carry the packages' float32 noise amplified (measured within a
factor of 2.1 of each other): they are held within a factor of 10, on
steps that stopped at the same iteration.
"""

import json
import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores
import jax.numpy as jnp  # noqa: E402

from dragg_tpu import data as jd  # noqa: E402
from dragg_tpu import engine as je  # noqa: E402
from dragg_tpu import homes as jh  # noqa: E402
from dragg_tpu.aggregator import Aggregator as JaxAggregator  # noqa: E402
from dragg_tpu_torch import engine as te  # noqa: E402
from dragg_tpu_torch.aggregator import Aggregator  # noqa: E402
from dragg_tpu_torch.config import default_config  # noqa: E402
from dragg_tpu_torch.interop import engine_factor_from_numpy, engine_state_from_numpy  # noqa: E402
from dragg_tpu_torch.ops import admm as ta  # noqa: E402
from tests.test_torch_observatory import adjacent_moves  # noqa: E402

EXACT = ("correct_solve", "hvac_cool_on", "waterdraws", "p_ev_ch", "e_ev",
         "bank_fallback_count", "repair_failed")
RESIDUALS = ("r_prim_max", "r_dual_max")
K = 8  # admm_refactor_every


def _config(bucketed="true", **tpu):
    cfg = default_config()
    cfg["community"].update(total_number_homes=8, homes_pv=2, homes_battery=2,
                            homes_pv_battery=2)
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["home"]["hems"]["solver"] = "admm"
    cfg["tpu"].update(bucketed=bucketed, admm_refactor_every=K, **tpu)
    return cfg


def _inputs(cfg):
    env = jd.load_environment(cfg)
    wd = jd.load_waterdraw_profiles(jd.waterdraw_path(cfg, None), seed=12)
    batch = jh.build_home_batch(jh.create_homes(cfg, 24, 1, wd), 4, 1, 6)
    return batch, env, env.start_index(jd.parse_dt(cfg["simulation"]["start_datetime"]))


def _jax_steps(cfg, steps):
    """The JAX engine's run, one jitted step at a time: per step the state
    and carry it started from, its refresh flag and its outputs."""
    batch, env, start = _inputs(cfg)
    ej = je.make_engine(batch, env, cfg, start)
    state, factor = ej.init_state(), ej.init_factor()
    rp = jnp.zeros(ej.params.horizon, jnp.float32)
    rec = []
    for t in range(steps):
        refresh = t == 0 or t % K == 0
        nxt, nxt_f, out = ej._step_fn(ej._consts(), state, jnp.asarray(t), rp,
                                      jnp.asarray(refresh), factor)
        rec.append((state, factor, refresh, out))
        state, factor = nxt, nxt_f
    return rec


_JAX_RUNS: dict = {}


def jax_steps(steps=24, bucketed="true", **tpu):
    """:func:`_jax_steps` of ``_config(bucketed, **tpu)``, run once per
    module (the JAX engine's band route is its scan path whatever
    ``band_kernel`` says on the CPU, so the band variants share one)."""
    key = (bucketed, tuple(sorted(tpu.items())))
    if key not in _JAX_RUNS or len(_JAX_RUNS[key]) < steps:
        _JAX_RUNS[key] = _jax_steps(_config(bucketed, **tpu), steps)
    return _JAX_RUNS[key][:steps]


def _stack_j(outs):
    return {f: np.stack([np.asarray(getattr(o, f)) for o in outs]) for f in outs[0]._fields}


def _stack_t(outs):
    return {f: torch.stack([getattr(o, f) for o in outs]).numpy() for f in outs[0]._fields}


def _stepwise(et, rec, first=0):
    """Each recorded step of the port from the JAX engine's state and
    carry: (JAX outputs, port outputs), stacked over the steps."""
    outs_t = []
    for t, (state, factor, refresh, _) in enumerate(rec[first:], start=first):
        _, _, ot = et._step(engine_state_from_numpy(state, "cpu"), t,
                            torch.zeros(et.params.horizon), refresh,
                            engine_factor_from_numpy(factor, "cpu", et.admm_band_kernel))
        outs_t.append(ot)
    return _stack_j([r[3] for r in rec[first:]]), _stack_t(outs_t)


def _port_engine(cfg):
    batch, env, start = _inputs(cfg)
    return te.make_engine(batch, env, cfg, start, device="cpu")


def _compare(j, t, atol=1e-3):
    same_iters = j["admm_iters"] == t["admm_iters"]
    assert np.all((j["admm_iters"] - t["admm_iters"]) % 25 == 0)  # whole windows
    for f in te.StepOutputs._fields:
        if f in te.OBS_FIELDS or f == "admm_iters":
            continue
        a, b = j[f], t[f]
        assert a.shape == b.shape, f
        if f in EXACT:
            np.testing.assert_array_equal(b, a, err_msg=f)
        elif f in RESIDUALS:
            a, b = a[same_iters], b[same_iters]
            assert np.all(b <= 10 * a + 2e-3) and np.all(a <= 10 * b + 2e-3), f
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=f)
    return same_iters


@pytest.mark.parametrize("bucketed", ["true", "false"])
def test_engine_day_matches_jax(bucketed):
    """24 steps, each from the JAX state and carry: the carry refreshes at
    t = 0, 8 and 16 and is reused stale in between, in both packages."""
    et = _port_engine(_config(bucketed))
    assert et.bucketed == (bucketed == "true")
    assert et.solve_backends == ["dense_inv"] * len(et.bucket_info())
    j, t = _stepwise(et, jax_steps(24, bucketed))
    same_iters = _compare(j, t)
    # Most steps stop on the same window.
    assert same_iters.mean() >= 0.7, (j["admm_iters"], t["admm_iters"])
    assert 0.3 < t["correct_solve"].mean() < 1.0


def test_restart_from_jax_state_and_carry():
    """The port continues six steps with its own carry from the JAX
    engine's state and carry after 12 steps (a stale factor, refreshed at
    t = 16), against the JAX engine's continuous run: the module's
    tolerances."""
    rec = jax_steps(18)
    et = _port_engine(_config())
    state0, factor0, _, _ = rec[12]
    st_t = engine_state_from_numpy(state0, "cpu")
    fac_t = engine_factor_from_numpy(factor0, "cpu")
    assert isinstance(fac_t[0], ta.FactorCarry)
    assert fac_t[0].Sinv.shape[1:] == (fac_t[0].e_eq.shape[1],) * 2
    outs_t = []
    for t in range(12, 18):
        st_t, fac_t, ot = et._step(st_t, t, torch.zeros(4), t % K == 0, fac_t)
        outs_t.append(ot)
    _compare(_stack_j([r[3] for r in rec[12:]]), _stack_t(outs_t))


def test_engine_params_read_as_jax():
    """The ADMM's config keys read as the JAX engine reads them; an unknown
    backend raises the JAX engine's ValueError at construction."""
    cfg = _config(admm_iters=700, admm_rho_update_every=2, admm_matvec_dtype="bf16",
                  admm_refine=1, admm_anderson=3, admm_banded_factor=False,
                  admm_solve_backend="dense_inv")
    pt, pj = te.engine_params(cfg, 0), je.engine_params(cfg, 0)
    for f in ("solver", "admm_iters", "admm_rho_update_every", "admm_matvec_dtype",
              "admm_refine", "admm_anderson", "admm_banded_factor", "admm_solve_backend",
              "admm_eps", "admm_sigma", "admm_alpha", "admm_patience",
              "admm_refactor_every"):
        assert getattr(pt, f) == getattr(pj, f), f
    assert (pt.warm_rho, pt.reg) == (pj.admm_rho, pj.admm_reg)
    # Cyclic reduction's factor is a dict, so the ADMM runs "cr" on the
    # plain band versions, as the JAX engine runs it on its scan path.
    batch, env, start = _inputs(cfg)
    cr = _config(band_kernel="cr")
    assert te.make_engine(batch, env, cr, start, device="cpu").admm_band_kernel == "xla"
    assert je.make_engine(batch, env, cr, start).admm_band_kernel == "xla"
    bad = _config(admm_solve_backend="sparse")
    batch, env, start = _inputs(bad)
    for make in (je.make_engine, lambda *a: te.make_engine(*a, device="cpu")):
        with pytest.raises(ValueError, match="unknown solve_backend"):
            make(batch, env, bad, start)


def test_observatory_matches_jax_fold():
    """The per-home observatory over 12 steps from the JAX state and carry:
    each bucket's histograms hold every home, differ from the JAX fold
    only by moves to an adjacent bin, and the divergence counts are equal;
    on steps that stopped on the same window the iteration histograms and
    sums are equal too."""
    et = _port_engine(_config())
    j, t = _stepwise(et, jax_steps(12))
    same = j["admm_iters"] == t["admm_iters"]
    binfo = et.bucket_info()
    for key in ("conv_hist", "iters_hist"):
        for s in range(12):
            for bi, b in enumerate(binfo):
                assert t[key][s, bi].sum() == j[key][s, bi].sum() == b["n_real"], key
                if key == "iters_hist" and same[s]:
                    np.testing.assert_array_equal(t[key][s, bi], j[key][s, bi])
                else:
                    assert adjacent_moves(j[key][s, bi], t[key][s, bi]) is not None, (
                        key, s, b["name"])
    np.testing.assert_array_equal(t["diverged_count"], j["diverged_count"])
    np.testing.assert_array_equal(t["iters_sum"][same], j["iters_sum"][same])


# ------------------------------------------------------------ aggregator
def _agg_config(**sim):
    cfg = default_config()
    cfg["community"].update(total_number_homes=6, homes_pv=1, homes_battery=1,
                            homes_pv_battery=1)
    cfg["simulation"].update(end_datetime="2015-01-01 08", **sim)
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["home"]["hems"]["solver"] = "admm"
    cfg["tpu"]["sharded"] = False
    return cfg


def _results(agg):
    with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
        return json.load(f)


def test_aggregator_results_match_jax(tmp_path):
    """An 8-step baseline run: results.json has the JAX aggregator's keys,
    solved flags, and series within the module's 1e-3."""
    ja = JaxAggregator(config=_agg_config(), outputs_dir=str(tmp_path / "jax"))
    ja.run()
    tg = Aggregator(config=_agg_config(), outputs_dir=str(tmp_path / "torch"), device="cpu")
    tg.run()
    rj, rt = _results(ja), _results(tg)
    assert list(rt) == list(rj)
    for name, series in rj.items():
        assert list(rt[name]) == list(series), name
        if name == "Summary":
            continue
        assert rt[name]["correct_solve"] == series["correct_solve"], name
        for key, v in series.items():
            if isinstance(v, list):
                np.testing.assert_allclose(rt[name][key], v, rtol=0, atol=1e-3,
                                           err_msg=f"{name}.{key}")
    assert tg.engine.params.solver == ja.engine.params.solver == "admm"
    assert rt["Summary"]["solver_iterations"] == rj["Summary"]["solver_iterations"]


def test_resume_bit_equal(tmp_path):
    """A run stopped after two hourly chunks and resumed writes the same
    results.json as one uninterrupted run."""
    cfg = lambda: _agg_config(checkpoint_interval="hourly")  # noqa: E731
    full = Aggregator(config=cfg(), outputs_dir=str(tmp_path / "full"), device="cpu")
    full.run()
    part = Aggregator(config=cfg(), outputs_dir=str(tmp_path / "part"), device="cpu")
    part.stop_after_chunks = 2
    part.run()
    c2 = cfg()
    c2["simulation"]["resume"] = True
    resumed = Aggregator(config=c2, outputs_dir=str(tmp_path / "part"), device="cpu")
    resumed.run()
    assert resumed.resumed_from is not None
    a, b = _results(full), _results(resumed)
    for name in a:
        if name != "Summary":
            assert a[name] == b[name], name
