"""QP assembly of the PyTorch port (dragg_tpu_torch/ops/qp.py) against the
JAX package's on identical inputs: the shared t = 0 community QP of
``dragg_tpu.fixtures.assemble_community_qp``, at the superset shape and at
each of the four base home types' bucket shapes.

Sparsity tuples, Schur structures and band plans must be identical.
Values are float32 on both sides from the same float64 host arithmetic;
the one libm-dependent term is ``discount ** k`` (XLA's and PyTorch's
float32 pow may differ by an ulp), so values are held to a float32
relative tolerance of 2e-7 (atol 1e-6 for entries near zero).
"""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

sys.path.insert(0, "tests")

from dragg_tpu.config import default_config  # noqa: E402
from dragg_tpu.data import load_environment, load_waterdraw_profiles  # noqa: E402
from dragg_tpu.fixtures import assemble_community_qp  # noqa: E402
from dragg_tpu.homes import build_home_batch, create_homes  # noqa: E402
from dragg_tpu.ops import qp as jqp  # noqa: E402
from dragg_tpu_torch.interop import home_batch_from_numpy  # noqa: E402
from dragg_tpu_torch.ops import qp as tqp  # noqa: E402

H_HOURS = 8
COUNTS = dict(n_homes=8, homes_pv=2, homes_battery=2, homes_pv_battery=2)


def _host_batch(horizon_hours, n_homes, homes_pv, homes_battery, homes_pv_battery):
    """The fixture's population as a float64 host HomeBatch (the batch the
    fixture's engine built its static pieces from)."""
    cfg = default_config()
    cfg["community"].update(total_number_homes=n_homes, homes_pv=homes_pv,
                            homes_battery=homes_battery,
                            homes_pv_battery=homes_pv_battery)
    cfg["home"]["hems"]["prediction_horizon"] = horizon_hours
    seed = int(cfg["simulation"]["random_seed"])
    dt = load_environment(cfg).dt
    homes = create_homes(cfg, 24 * dt, dt, load_waterdraw_profiles(None, seed=seed))
    return build_home_batch(homes, horizon_hours * dt, dt,
                            int(cfg["home"]["hems"]["sub_subhourly_steps"]))


def _patterns(horizon_hours):
    """(JAX, port) sparsity patterns of the superset layout."""
    batch = _host_batch(horizon_hours, **{k: v for k, v in COUNTS.items()})
    return (jqp.build_qp_static(batch, horizon_hours, 1).pattern,
            tqp.build_qp_static(batch, horizon_hours, 1).pattern)


@pytest.fixture(scope="module")
def fixture_qp():
    qp, pat, lay, s, inputs = assemble_community_qp(
        horizon_hours=H_HOURS, return_inputs=True, **COUNTS)
    return qp, pat, lay, s, inputs, _host_batch(H_HOURS, **COUNTS)


def _close(a_t, a_j):
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=2e-7, atol=1e-6)


@pytest.mark.parametrize("bucket", ["superset", "pv_battery", "pv_only",
                                    "battery_only", "base"])
def test_assemble_matches(fixture_qp, bucket):
    qp_fix, pat_fix, _, s, inp, batch = fixture_qp
    codes = np.asarray(batch.type_code)
    if bucket == "superset":
        rows, spec = np.arange(len(codes)), jqp.SUPERSET_SPEC
    else:
        rows = np.nonzero(codes == ["pv_battery", "pv_only", "battery_only",
                                    "base"].index(bucket))[0]
        spec = jqp.TYPE_SPECS[bucket]
    sub = type(batch)(*[np.asarray(f)[rows] for f in batch])
    H = H_HOURS * inp["dt"]
    j_static = jqp.build_qp_static(sub, H, inp["dt"], spec)
    t_static = tqp.build_qp_static(sub, H, inp["dt"], tqp.HomeTypeSpec(*spec))
    assert tuple(t_static.pattern) == tuple(j_static.pattern)
    assert tuple(tqp.build_schur_structure(t_static.pattern)) == tuple(
        jqp.build_schur_structure(j_static.pattern))
    for f in ("vals", "a_in", "a_wh", "kin", "kwh", "awr"):
        np.testing.assert_array_equal(getattr(t_static, f).numpy(),
                                      np.asarray(getattr(j_static, f)))

    f64 = lambda a: np.asarray(a, np.float64)[rows]  # noqa: E731
    lay_j, lay_t = jqp.QPLayout(H, spec), tqp.QPLayout(H, tqp.HomeTypeSpec(*spec))
    j_batch = type(batch)(*[jnp.asarray(np.asarray(f)) for f in sub])
    common = dict(wh_cap=s, discount=inp["discount"])
    qp_j = jqp.assemble_qp_step(
        j_static, lay_j, j_batch,
        oat_window=inp["oat_window"], ghi_window=inp["ghi_window"],
        price_total=jnp.asarray(inp["price"][rows]),
        draw_frac=jnp.asarray(f64(inp["draw_size"]) / f64(inp["tank"])[:, None]),
        temp_in_init=jnp.asarray(f64(inp["temp_in_init"]), jnp.float32),
        temp_wh_init=jnp.asarray(f64(inp["temp_wh_init"]), jnp.float32),
        e_batt_init=jnp.asarray(f64(inp["e_batt_init"]), jnp.float32),
        cool_cap=jnp.asarray(f64(inp["cool_cap"]), jnp.float32),
        heat_cap=jnp.asarray(f64(inp["heat_cap"]), jnp.float32), **common)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    qp_t = tqp.assemble_qp_step(
        t_static, lay_t, home_batch_from_numpy(sub._asdict(), "cpu"),
        oat_window=f32(inp["oat_window"]), ghi_window=f32(inp["ghi_window"]),
        price_total=f32(inp["price"][rows]),
        draw_frac=torch.from_numpy(f64(inp["draw_size"]) / f64(inp["tank"])[:, None]),
        temp_in_init=f32(f64(inp["temp_in_init"])),
        temp_wh_init=f32(f64(inp["temp_wh_init"])),
        e_batt_init=f32(f64(inp["e_batt_init"])),
        cool_cap=f32(f64(inp["cool_cap"])), heat_cap=f32(f64(inp["heat_cap"])),
        **common)
    for f in ("vals", "b_eq", "l_box", "u_box", "q"):
        _close(getattr(qp_t, f), getattr(qp_j, f))
    if bucket == "superset":
        # ...and the superset QP is the fixture's own.
        assert tuple(t_static.pattern) == tuple(pat_fix)
        for f in ("vals", "b_eq", "l_box", "u_box", "q"):
            _close(getattr(qp_t, f), getattr(qp_fix, f))


def test_recover_and_shift(fixture_qp):
    """recover_solution and shift_warm_start on one primal vector."""
    qp_j, _, lay_j, s, inp, batch = fixture_qp
    x = np.random.default_rng(0).standard_normal(np.asarray(qp_j.q).shape).astype(np.float32)
    lay_t = tqp.QPLayout(lay_j.H)
    j_batch = type(batch)(*[jnp.asarray(np.asarray(f)) for f in batch])
    t_batch = home_batch_from_numpy(batch._asdict(), "cpu")
    price = np.asarray(inp["price"], np.float32)
    rj = jqp.recover_solution(jnp.asarray(x), lay_j, j_batch,
                              jnp.asarray(inp["ghi_window"], jnp.float32),
                              jnp.asarray(price), float(s))
    rt = tqp.recover_solution(torch.from_numpy(x), lay_t, t_batch,
                              torch.as_tensor(inp["ghi_window"], dtype=torch.float32),
                              torch.from_numpy(price), float(s))
    for f in tqp.MPCSolution._fields:
        _close(getattr(rt, f), getattr(rj, f))
    np.testing.assert_array_equal(
        tqp.shift_warm_start(torch.from_numpy(x), lay_t).numpy(),
        np.asarray(jqp.shift_warm_start(jnp.asarray(x), lay_j)))


def test_hp_cops_and_ev_bounds():
    """The scenario-type helpers on the same numbers."""
    rng = np.random.default_rng(1)
    oat = rng.uniform(-10, 40, (5, 6)).astype(np.float32)
    base = rng.uniform(2.4, 3.2, 5).astype(np.float32)
    slope = rng.uniform(0.04, 0.08, 5).astype(np.float32)
    for a_t, a_j in zip(tqp.hp_cops(torch.from_numpy(oat), torch.from_numpy(base),
                                    torch.from_numpy(slope)),
                        jqp.hp_cops(oat, base, slope)):
        _close(a_t, a_j)
    fields = dict(is_ev=[1, 0, 1], ev_away_start=[7.5, 8, 23.0],
                  ev_away_end=[16.0, 17, 30.0], ev_rate=[7.0, 3.3, 9.6],
                  ev_ch_eff=[0.9, 1.0, 0.95], ev_target_kwh=[40.0, 0, 60.0])
    bj = type("B", (), {k: jnp.asarray(v, jnp.float32) for k, v in fields.items()})
    bt = type("B", (), {k: torch.tensor(v, dtype=torch.float32) for k, v in fields.items()})
    hod_c, hod_s = np.arange(6, 14) % 24, np.arange(7, 15) % 24
    e0 = np.asarray([10.0, 0.0, 55.0], np.float32)
    for a_t, a_j in zip(
            tqp.ev_charge_bounds(torch.from_numpy(hod_c), torch.from_numpy(hod_s), bt,
                                 torch.from_numpy(e0), 1),
            jqp.ev_charge_bounds(hod_c, hod_s, bj, e0, 1)):
        _close(a_t, a_j)
