"""A run with its timed path broken underneath comes out not correct:
once for each fault a cell of this system can have (one card, so no
exchange between cards to leave out)."""

import pytest
import torch

from conftest import run_tiny


def _wrap_run_chunk(monkeypatch, alter):
    from dragg_tpu_torch.engine import Engine

    orig = Engine.run_chunk

    def broken(self, state, t0, rps):
        state, outs = orig(self, state, t0, rps)
        return state, alter(outs)

    monkeypatch.setattr(Engine, "run_chunk", broken)


def test_state_left_unchanged(monkeypatch):
    """A step that returns the state it was given."""
    from dragg_tpu_torch.engine import Engine

    orig = Engine._step_local

    def stuck(self, state, t, rp, refresh, factor):
        _, factor, out = orig(self, state, t, rp, refresh, factor)
        return state, factor, out

    monkeypatch.setattr(Engine, "_step_local", stuck)
    res = run_tiny()
    assert not res["correct"]
    assert res["checks"]["state_err"]["value"] > res["checks"]["state_err"]["limit"]


def test_half_the_batch_left_out(monkeypatch):
    """The community's load taken over half the homes, scaled up as their
    mean would be."""
    def half(outs):
        n = outs.p_grid.shape[1] // 2
        return outs._replace(agg_load=2.0 * outs.p_grid[:, :n].sum(dim=1))

    _wrap_run_chunk(monkeypatch, half)
    res = run_tiny()
    assert not res["correct"]
    assert res["checks"]["agg_err"]["value"] > res["checks"]["agg_err"]["limit"]


@pytest.mark.parametrize("field,number", [("temp_in", "state_err"), ("p_grid", "power_err"),
                                          ("cost", "cost_err")])
def test_answer_altered_where_produced(monkeypatch, field, number):
    def alter(outs):
        v = getattr(outs, field).clone()
        v[-1, 0] += 0.5
        return outs._replace(**{field: v})

    _wrap_run_chunk(monkeypatch, alter)
    res = run_tiny()
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


def test_action_off_its_optimum(monkeypatch):
    """Every home's first battery action flipped: the homes' dynamics follow
    it, so only the MPC's own comparison can see it."""
    from dragg_tpu_torch.engine import Engine

    orig = Engine._finish

    def flipped(self, ctx, state, t, sol, aux, warm_sol, repair_failed):
        lay = ctx.lay
        if lay.has_batt:
            x = sol.x.clone()
            ch, d = x[:, lay.i_pch].clone(), x[:, lay.i_pd].clone()
            x[:, lay.i_pch], x[:, lay.i_pd] = -d, -ch
            e0 = x[:, lay.i_eb]
            x[:, lay.i_eb + 1] = (e0 + ctx.batch.batt_ch_eff * x[:, lay.i_pch] / self.params.dt
                                  + x[:, lay.i_pd] / (ctx.batch.batt_disch_eff * self.params.dt))
            sol = sol._replace(x=x)
        return orig(self, ctx, state, t, sol, aux, warm_sol, repair_failed)

    monkeypatch.setattr(Engine, "_finish", flipped)
    res = run_tiny()
    assert not res["correct"]
    assert res["checks"]["mpc_gap"]["value"] > res["checks"]["mpc_gap"]["limit"]
    assert res["checks"]["state_err"]["value"] <= res["checks"]["state_err"]["limit"]


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of every cell on the card: it builds, runs and is
    correct (run with ``python3 -m pytest perfbench/tests -m cuda``)."""
    import json
    import subprocess
    import sys

    from conftest import ROOT, manifest

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for wl in manifest()["workloads"]:
        out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", wl["name"],
                              "--seed", "3141592653", "--seconds", "5", "--trace", "0"],
                             cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
