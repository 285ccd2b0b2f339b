"""The PyTorch port's engine (dragg_tpu_torch/engine.py, on the CPU) against
``dragg_tpu.engine.Engine`` step by step: an 8-home mixed community at a
4 h horizon over 24 steps, bucketed and not, and the same run restarted
from the JAX engine's mid-run state through ``interop``.

Tolerances: solved flags, iteration counts and the seasonal gate's
consequences (cooling duty) are equal; every other series agrees to 1e-4
absolute (temperatures ~10-60 degC, loads ~1-10 kW: the two float32
solvers land ~1e-5 apart, well inside their 2e-4 stopping tolerance).
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

EXACT = ("correct_solve", "admm_iters", "hvac_cool_on", "waterdraws",
         "bank_fallback_count", "repair_failed")


def _config(bucketed):
    cfg = default_config()
    cfg["community"].update(total_number_homes=8, homes_pv=2, homes_battery=2,
                            homes_pv_battery=2)
    cfg["home"]["hems"]["prediction_horizon"] = 4
    cfg["tpu"]["bucketed"] = bucketed
    return cfg


def _engines(bucketed):
    cfg = _config(bucketed)
    env = jd.load_environment(cfg)
    wd = jd.load_waterdraw_profiles(jd.waterdraw_path(cfg, None), seed=12)
    batch = jh.build_home_batch(jh.create_homes(cfg, 24, 1, wd), 4, 1, 6)
    start = env.start_index(jd.parse_dt(cfg["simulation"]["start_datetime"]))
    return (je.make_engine(batch, env, cfg, start),
            te.make_engine(batch, env, cfg, start, device="cpu"))


def _compare(out_j, out_t):
    assert set(te.StepOutputs._fields) == set(je.StepOutputs._fields)
    for f in te.StepOutputs._fields:
        if f in te.OBS_FIELDS:
            continue  # the observatory's leaves: tests/test_torch_observatory.py
        a, b = np.asarray(getattr(out_j, f)), getattr(out_t, f).numpy()
        assert a.shape == b.shape, f
        if f in EXACT:
            np.testing.assert_array_equal(b, a, err_msg=f)
        elif f in ("r_prim_max", "r_dual_max"):
            # final residuals at the float32 floor: same order of magnitude
            assert np.all(b <= np.maximum(10 * a, 2e-3)), f
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("bucketed", ["true", "false"])
def test_engine_day_matches_jax(bucketed):
    ej, et = _engines(bucketed)
    assert et.bucketed == ej.bucketed == (bucketed == "true")
    rps = np.zeros((24, 4), np.float32)
    _, out_j = ej.run_chunk(ej.init_state(), 0, rps)
    _, out_t = et.run_chunk(et.init_state(), 0, rps)
    _compare(out_j, out_t)
    assert float(np.asarray(out_j.correct_solve).mean()) > 0.5  # mostly solved


def test_restart_from_jax_state():
    """Both engines continue 12 steps from the JAX engine's state after 12."""
    ej, et = _engines("true")
    rps = np.zeros((12, 4), np.float32)
    state_j, _ = ej.run_chunk(ej.init_state(), 0, rps)
    state_t = tuple(community_state_from_numpy(
        {k: np.asarray(v) for k, v in s._asdict().items()}, "cpu") for s in state_j)
    assert state_t[0].counter.dtype == torch.int32
    assert state_t[0].temp_in.dtype == torch.float32
    _, out_j = ej.run_chunk(state_j, 12, rps)
    _, out_t = et.run_chunk(state_t, 12, rps)
    _compare(out_j, out_t)


@pytest.mark.parametrize("section,key,value", [
    ("home", "hems", {"solver": "admm"}),
    ("tpu", "band_kernel", "cr"),
    ("telemetry", "per_home", True),
])
def test_out_of_slice_settings_raise(section, key, value):
    """Settings once outside the port (the ADMM, cyclic reduction, the
    observatory's ``telemetry.per_home``) now build the JAX package's
    engine parameters."""
    cfg = _config("auto")
    if isinstance(value, dict):
        cfg[section][key].update(value)
    else:
        cfg[section][key] = value
    got, want = te.engine_params(cfg, 0), je.engine_params(cfg, 0)
    if key == "per_home":
        assert (got.obs_per_home, got.obs_worst_k) == (want.obs_per_home, want.obs_worst_k)
        assert got.obs_per_home is True and got.obs_worst_k == 8
    elif key == "band_kernel":
        assert got.band_kernel == want.band_kernel == "cr"
    else:
        assert got.solver == want.solver == "admm"
        for f in ("admm_iters", "admm_rho_update_every", "admm_matvec_dtype", "admm_refine",
                  "admm_anderson", "admm_banded_factor", "admm_solve_backend"):
            assert getattr(got, f) == getattr(want, f), f


def test_scenario_home_types_raise():
    """ev and heat_pump homes build the JAX engine's buckets (names,
    shapes, band widths); an event timeline sized for another number of
    communities raises the JAX engine's ValueError."""
    from dragg_tpu.scenarios import build_timeline

    cfg = _config("true")
    cfg["community"].update(homes_ev=1, homes_heat_pump=1)
    env = jd.load_environment(cfg)
    wd = jd.load_waterdraw_profiles(None, seed=12)
    batch = jh.build_home_batch(jh.create_homes(cfg, 24, 1, wd), 4, 1, 6)
    keys = ("name", "comm_start", "n_real", "m_eq", "n_var", "nnz", "band_bw")
    shapes = lambda eng: [[b[k] for k in keys] for b in eng.bucket_info()]  # noqa: E731
    assert shapes(te.make_engine(batch, env, cfg, 0, device="cpu")) == shapes(
        je.make_engine(batch, env, cfg, 0))
    tl = build_timeline([dict(kind="dr", start_hour=1, duration_hours=2, p_cap_kw=2.0)],
                        2, len(env.oat), 1, 0)
    for make in (lambda: je.make_engine(batch, env, cfg, 0, events=tl),
                 lambda: te.make_engine(batch, env, cfg, 0, device="cpu", events=tl)):
        with pytest.raises(ValueError, match="covers 2 communities but the engine runs 1"):
            make()


def test_models_match_jax():
    """The home physics and the fallback controller, elementwise, on the
    same random float32 inputs: the same operations in the same order, so
    within a few float32 ulps (1e-5 absolute on temperatures ~20-55 degC)."""
    from dragg_tpu.models import battery as jbat, fallback as jfb, pv as jpv, thermal as jth
    from dragg_tpu_torch.models import battery as tbat, fallback as tfb, pv as tpv, thermal as tth

    rng = np.random.default_rng(7)
    n = 64
    u = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa: E731
    args = dict(
        counter=rng.integers(0, 8, n).astype(np.int32), timestep=5, horizon=6,
        replay_cool=u(0, 6), replay_heat=u(0, 6), replay_wh=u(0, 6),
        temp_in_init=u(15, 25), temp_wh_init=u(40, 55), oat1=np.float32(3.0),
        hvac_r=u(6.8, 9.2), hvac_c=u(4250, 5750), hvac_p_c=u(0.5, 0.6),
        hvac_p_h=u(0.5, 0.6), wh_r=u(18700, 25300), wh_c=u(840, 1260),
        wh_p=u(0.4, 0.45), temp_in_min=u(17, 19), temp_in_max=u(21, 23),
        temp_wh_min=u(41, 44), temp_wh_max=u(49, 53),
        cool_max=np.zeros(n, np.float32), heat_max=np.full(n, 6.0, np.float32),
        wh_max=np.full(n, 6.0, np.float32), dt=1)
    tensors = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in args.items()}
    rj, rt = jfb.fallback_control(**args), tfb.fallback_control(**tensors)
    for f in tfb.FallbackResult._fields:
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
    x = [u(0.5, 10) for _ in range(5)]
    t = [torch.from_numpy(a) for a in x]
    for jf, tf, a_j, a_t in ((jth.wh_mix, tth.wh_mix, x[:3], t[:3]),
                             (jbat.battery_step, tbat.battery_step, x + [1], t + [1]),
                             (jpv.pv_power, tpv.pv_power, x[:4], t[:4])):
        np.testing.assert_allclose(tf(*a_t).numpy(), np.asarray(jf(*a_j)),
                                   rtol=1e-6, err_msg=jf.__name__)
