"""The comparison that decides ``correct``: the program's outputs over the
window against the plain reference (``reference.py``).

Numbers compared (each has its limit in ``perfbench/limits/<cell>.json``):

* ``state_err``: the largest gap, over every home and step of the window,
  between the program's next indoor and water-heater temperatures (degC)
  and battery charge (kWh) and the reference's RC dynamics applied to the
  program's own actions from the state the step began in;
* ``power_err``: the same for grid, load and PV power (kW);
* ``cost_err``: the same for a home's cost of the step, which carries the
  time-of-use and reward price ($);
* ``agg_err``: the largest relative gap between the community's load a
  step and the sum of the reference's grid powers;
* ``mpc_gap``: over a sample of solved home-steps drawn from the seed,
  the largest cost of the applied first action, as a share of the
  home's heating and water-heating cost over the horizon, in the problem
  the reference assembles anew and solves (``reference.mpc_gap``); over
  :data:`MPC_SAMPLE` home-steps drawn from the seed.

``attempted`` counts the home-steps of the window; ``failed`` those whose
solve failed, whom the fallback controller and not the MPC drove.
"""

from __future__ import annotations

import numpy as np

from perfbench.harness import reference as ref

NUMBERS = ("state_err", "power_err", "cost_err", "agg_err", "mpc_gap")
# Solved home-steps a run prices for ``mpc_gap``: enough that a solve which
# is off now and then shows in every run, not only in some.
MPC_SAMPLE = 512


def steps_of(records: list):
    """Each step of the window in order: (episode, t, chunk record, row)."""
    for rec in records:
        for i in range(rec["n"]):
            yield rec["episode"], rec["t0"] + i, rec, i


def initial_state(inputs: dict) -> dict:
    h = inputs["homes"]
    return {"temp_in": h["temp_in_init"], "temp_wh": h["temp_wh_init"],
            "e_batt": h["e_batt_init_frac"] * h["batt_capacity"]}


def actions(host: dict, i: int) -> dict:
    return {"cool": host["hvac_cool_on"][i], "heat": host["hvac_heat_on"][i],
            "wh": host["wh_heat_on"][i], "p_ch": host["p_batt_ch"][i],
            "p_d": host["p_batt_disch"][i], "u": host["u_pv_curt"][i],
            "solved": host["correct_solve"][i]}


def judge(inputs: dict, records: list, seed: int, limits: dict, cap: float, device="cpu",
          rnd=ref.ident) -> dict:
    """Every number of :data:`NUMBERS` over the window's ``records`` and
    whether each is within its limit.  ``rnd`` is the identity for a run;
    the control passes its bfloat16 rounding, computing the one-step
    outputs and the first actions itself."""
    h = inputs["homes"]
    worst = dict.fromkeys(NUMBERS[:4], 0.0)
    candidates = []   # per step: (index, episode, t, state before, solved homes, record, row)
    prev = initial_state(inputs)
    for k, (ep, t, rec, i) in enumerate(steps_of(records)):
        if t == 0:
            prev = initial_state(inputs)
        host = rec["host"]
        act = actions(host, i)
        out = ref.step(h, inputs, prev, act, t, 0.0, rnd=rnd)
        if rnd is ref.ident:
            got = {f: host[f][i].astype(np.float64) for f in out}
        else:
            got, out = out, ref.step(h, inputs, prev, act, t, 0.0)
        worst["state_err"] = max(worst["state_err"], *(
            float(np.max(np.abs(got[f] - out[f]))) for f in ("temp_in", "temp_wh", "e_batt")))
        worst["power_err"] = max(worst["power_err"], *(
            float(np.max(np.abs(got[f] - out[f]))) for f in ("p_grid", "p_load", "p_pv")))
        worst["cost_err"] = max(worst["cost_err"], float(np.max(np.abs(got["cost"] - out["cost"]))))
        agg = (float(host["agg_load"][i]) if rnd is ref.ident
               else ref.aggregate(got["p_grid"], rnd))
        agg_ref = ref.aggregate(out["p_grid"])
        worst["agg_err"] = max(worst["agg_err"],
                               abs(agg - agg_ref) / max(float(np.abs(out["p_grid"]).sum()), 1e-9))
        candidates.append((k, ep, t, {f: np.asarray(v).copy() for f, v in prev.items()},
                           np.flatnonzero(host["correct_solve"][i] > 0.5), rec, i))
        prev = {"temp_in": host["temp_in"][i], "temp_wh": host["temp_wh"][i],
                "e_batt": host["e_batt"][i]}
    gap = sample_gap(inputs, candidates, seed, MPC_SAMPLE, cap, device, rnd)
    worst["mpc_gap"] = gap["worst"]
    checks = {name: {"value": worst[name], "limit": limits[name]} for name in NUMBERS}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return {"correct": bool(correct), "checks": checks, "gap": gap}


def sample_gap(inputs: dict, candidates: list, seed: int, sample: int, cap: float,
               device, rnd) -> dict:
    """``mpc_gap`` over ``sample`` solved home-steps drawn from the seed,
    as evenly as they allow over the home types and the window's steps."""
    rng = np.random.default_rng([int(seed) % 2**63, 11])
    code = inputs["homes"]["type_code"]
    pool = []
    per_type = {}
    for c, cand in enumerate(candidates):
        for tc in np.unique(code):
            hs = cand[4][code[cand[4]] == tc]
            if len(hs):
                per_type.setdefault(int(tc), []).append((c, hs))
    for tc, lst in sorted(per_type.items()):
        want = sample // max(len(per_type), 1)
        for j in range(want):
            c, hs = lst[rng.integers(len(lst))]
            pool.append((c, int(hs[rng.integers(len(hs))])))
    if not pool:
        return {"worst": float("nan"), "n": 0, "skipped": 0, "unconverged": 0}
    sel = np.array([hm for _, hm in pool])
    t_of = np.array([candidates[c][2] for c, _ in pool])
    prev = {f: np.array([candidates[c][3][f][hm] for c, hm in pool])
            for f in ("temp_in", "temp_wh", "e_batt")}
    acts = {f: [] for f in ("cool", "heat", "wh", "p_ch", "p_d", "u", "solved")}
    for c, hm in pool:
        rec, i = candidates[c][5], candidates[c][6]
        a = actions(rec["host"], i)
        for f in acts:
            acts[f].append(a[f][hm])
    acts = {f: np.array(v, dtype=np.float64) for f, v in acts.items()}
    control = None if rnd is ref.ident else rnd
    res = ref.mpc_gap(inputs, sel, t_of, prev, acts, np.zeros(inputs["H"]), cap, device=device,
                      solve_rnd=control, solve_dtype=_f32() if control else None)
    g = res["gap"]
    fin = g[np.isfinite(g)]
    worst = float(np.max(g)) if len(g) and not np.isnan(g).all() else float("nan")
    if res["unconverged"]:
        worst = float("nan")
    return {"worst": worst, "n": int(len(fin)), "skipped": res["skipped"],
            "unconverged": res["unconverged"], "outside": res.get("outside", 0),
            "finite_worst": float(fin.max()) if len(fin) else None,
            "median": float(np.median(fin)) if len(fin) else None}


def _f32():
    import torch

    return torch.float32


def bf16(a):
    """A round trip through bfloat16: the control's storage precision."""
    import torch

    t = torch.as_tensor(np.asarray(a, dtype=np.float32)) if not isinstance(a, torch.Tensor) else a
    r = t.to(torch.bfloat16).to(t.dtype if t.dtype != torch.float64 else torch.float32)
    return r.numpy().astype(np.float64) if not isinstance(a, torch.Tensor) else r.to(a.dtype)
