"""The plain reference against the port on a tiny community (CPU)."""

import numpy as np
import pytest

from conftest import run_tiny, tiny_cell


@pytest.mark.parametrize("communities", [1, 2])
def test_port_within_every_limit(communities):
    res = run_tiny(communities=communities)
    assert res["correct"], res["checks"]
    for name, c in res["checks"].items():
        assert np.isfinite(c["value"]) and c["value"] <= c["limit"], name
    assert res["sample"]["n"] == 16 and res["sample"]["unconverged"] == 0


def test_reference_solver_matches_an_exact_lp():
    """The reference's interior point reaches the optimum of its own
    assembled problems (checked against a vertex of the same LP)."""
    scipy_optimize = pytest.importorskip("scipy.optimize")
    from perfbench.harness import inputs as inputs_mod, reference as ref, runner

    cfg, traffic, _, _ = tiny_cell(homes=40)
    inp = inputs_mod.make_inputs(cfg, traffic, 5, runner.ROOT)
    h = inp["homes"]
    sel = np.arange(0, 40, 5)
    prev = {"temp_in": h["temp_in_init"][sel], "temp_wh": h["temp_wh_init"][sel],
            "e_batt": (h["e_batt_init_frac"] * h["batt_capacity"])[sel]}
    A, b, c, lo, hi, _ = ref.assemble(inp, sel, 0, prev, np.zeros(inp["H"]),
                                      ref.season(inp, sel, 0, 3.0))
    _, obj, ok = ref.ipm(A, b, c, lo, hi)
    assert ok.all()
    for i in range(len(sel)):
        lp = scipy_optimize.linprog(c[i], A_eq=A[i], b_eq=b[i], bounds=list(zip(lo[i], hi[i])),
                                    method="highs")
        assert lp.status == 0
        assert abs(lp.fun - obj[i]) <= 1e-6 * (1 + abs(lp.fun))


def test_control_in_bfloat16_is_not_correct():
    """The reference in the program's place, one precision below the
    configuration's float32, fails the cell's limits."""
    from perfbench import control

    cfg, traffic, limits, _ = tiny_cell()
    r = control.readings("tiny", 2**33 + 5, 0.5, device="cpu", cfg_file=cfg, traffic=traffic,
                         limits=limits)
    failed = [k for k, v in r["control"].items() if not v <= limits[k]]
    assert failed, r["control"]
    assert all(v <= limits[k] for k, v in r["program"].items()), r["program"]
