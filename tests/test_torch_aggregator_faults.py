"""Three aggregator behaviours of the JAX package that the port lacked,
each held against the JAX aggregator on the CPU
(tests/test_observability.py's tiny community: 3 homes, a 2 h horizon,
six hourly steps):

* ``tpu.sharded`` takes only "auto", true or false, and raises the JAX
  aggregator's ValueError otherwise (true stays out of the port's slice);
* ``$VERBOSE`` logs one PROG-level solver line a chunk;
* ``Aggregator.reset_seed`` changes the population the next
  ``get_homes`` draws, and ``write_home_configs`` writes it.

The IPM's iteration counts and solved flags are equal in the two packages
(tests/test_torch_engine.py), so the VERBOSE lines are compared as text.
"""

import logging
import os

import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu.aggregator import Aggregator as JaxAggregator  # noqa: E402
from dragg_tpu_torch.aggregator import Aggregator  # noqa: E402
from dragg_tpu_torch.config import default_config  # noqa: E402


def _tiny_cfg(**tpu):
    cfg = default_config()
    cfg["community"].update(total_number_homes=3, homes_pv=0, homes_battery=0,
                            homes_pv_battery=0)
    cfg["simulation"]["end_datetime"] = "2015-01-01 06"
    cfg["home"]["hems"]["prediction_horizon"] = 2
    cfg["tpu"].update(**tpu)
    return cfg


@pytest.mark.parametrize("value", ["on", "yes", None, 2])
def test_sharded_rejects_other_values_as_jax(tmp_path, value):
    cfg = _tiny_cfg(sharded=value)
    with pytest.raises(ValueError) as want:
        JaxAggregator(_tiny_cfg(sharded=value), outputs_dir=str(tmp_path / "jax")).run()
    with pytest.raises(ValueError) as got:
        Aggregator(cfg, outputs_dir=str(tmp_path / "torch"), device="cpu")
    assert str(got.value) == str(want.value)
    assert "tpu.sharded must be 'auto', true, or false" in str(got.value)


def test_sharded_true_and_false(tmp_path):
    with pytest.raises(NotImplementedError, match="tpu.sharded"):
        Aggregator(_tiny_cfg(sharded=True), outputs_dir=str(tmp_path), device="cpu")
    Aggregator(_tiny_cfg(sharded=False), outputs_dir=str(tmp_path), device="cpu")


def _verbose_lines(agg, logger_name, caplog, monkeypatch):
    monkeypatch.setattr(logging.getLogger(logger_name), "propagate", True)
    caplog.clear()
    with caplog.at_level("INFO", logger=logger_name):
        agg.run()
    return [(r.levelname, r.message) for r in caplog.records
            if r.name == logger_name and "solve_rate" in r.message]


def test_verbose_chunk_line_as_jax(tmp_path, caplog, monkeypatch):
    """Hourly checkpoints: six chunks, one PROG line each, the same text
    as the JAX aggregator's; without $VERBOSE none."""
    def cfg():
        c = _tiny_cfg(sharded=False)
        c["simulation"]["checkpoint_interval"] = "hourly"
        return c

    monkeypatch.setenv("VERBOSE", "1")
    want = _verbose_lines(JaxAggregator(cfg(), outputs_dir=str(tmp_path / "jax")),
                          "dragg_tpu.aggregator", caplog, monkeypatch)
    got = _verbose_lines(Aggregator(cfg(), outputs_dir=str(tmp_path / "torch"), device="cpu"),
                         "dragg_tpu_torch.aggregator", caplog, monkeypatch)
    assert len(got) == 6 and all(level == "PROG" for level, _ in got)
    assert "mean ADMM iters" in got[0][1]
    assert got == want
    monkeypatch.delenv("VERBOSE")
    assert _verbose_lines(Aggregator(cfg(), outputs_dir=str(tmp_path / "quiet"), device="cpu"),
                          "dragg_tpu_torch.aggregator", caplog, monkeypatch) == []


def test_reset_seed_changes_population_as_jax(tmp_path):
    """A new seed renames the population on the next ``get_homes`` in both
    packages alike, and the homes file the port writes is byte-identical
    to the JAX aggregator's, before and after."""
    aggs = [JaxAggregator(_tiny_cfg(), outputs_dir=str(tmp_path / "jax")),
            Aggregator(_tiny_cfg(), outputs_dir=str(tmp_path / "torch"), device="cpu")]
    files = []
    for seed in (None, 999):
        for agg in aggs:
            if seed is not None:
                agg.reset_seed(seed)
                agg.all_homes = None
            agg.get_homes()
        assert aggs[1].all_homes == aggs[0].all_homes
        path = lambda a: os.path.join(a.outputs_dir, "all_homes-3-config.json")  # noqa: E731
        with open(path(aggs[0]), "rb") as fj, open(path(aggs[1]), "rb") as ft:
            want, got = fj.read(), ft.read()
        assert got == want
        files.append(got)
    assert files[0] != files[1]
    assert aggs[1].config["simulation"]["random_seed"] == 999
    aggs[1].all_homes[0]["name"] = "renamed"
    aggs[1].write_home_configs()
    with open(os.path.join(aggs[1].outputs_dir, "all_homes-3-config.json")) as f:
        assert '"renamed"' in f.read()
