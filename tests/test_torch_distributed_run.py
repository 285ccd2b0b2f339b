"""The port's sharded run as real processes: ranks of one gloo group on
the CPU (``OMP_NUM_THREADS=1`` each, a timeout on every process), against
the JAX package's Aggregator sharded over two of conftest's CPU devices
(``dragg_tpu.resilience.devices`` patched to enumerate two: its one
enumeration site).

* ``python -m dragg_tpu_torch run --device cpu`` with
  ``$DRAGG_DISTRIBUTED=1`` as two processes: rank 0 alone writes
  results.json, whose series are within 1e-4 of the JAX run's (the
  unsharded port's tolerance, tests/test_torch_aggregator.py) with the
  solved flags and iteration counts equal; 7 homes, so the batch is
  padded to 8 slots;
* a missing ``$DRAGG_*`` variable gives the JAX package's message and
  exit 2; ``--supervised`` is refused under ``$DRAGG_DISTRIBUTED=1``.

:func:`launch_ranks` and :data:`RANK_SCRIPT` (a rank that joins the
group from the environment and runs ``Aggregator(...).run()`` on a
config JSON) serve tests/test_torch_distributed_rl.py and
test_torch_distributed_ckpt.py.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

import dragg_tpu.resilience.devices as jax_devices  # noqa: E402
from dragg_tpu.aggregator import Aggregator as JaxAggregator  # noqa: E402
from dragg_tpu_torch.config import default_config  # noqa: E402
from tests.test_distributed import _toml_dump  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300

RANK_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    from dragg_tpu_torch import parallel
    world = parallel.init_from_env()
    from dragg_tpu_torch.aggregator import Aggregator
    cfg_path, outputs_dir, stop = sys.argv[1], sys.argv[2], int(sys.argv[3])
    with open(cfg_path) as f:
        cfg = json.load(f)
    agg = Aggregator(cfg, data_dir=None, outputs_dir=outputs_dir, device="cpu")
    if stop:
        agg.stop_after_chunks = stop
    agg.run()
    print("RANK_DONE " + json.dumps(dict(
        rank=world.rank, size=world.size, resumed_from=agg.resumed_from,
        timestep=agg.timestep, engine=type(agg.engine).__name__)), flush=True)
    parallel.shutdown()
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(argv_for, W: int = 2, env_extra=None, timeout: float = TIMEOUT_S):
    """Run W ranks of one group concurrently (``argv_for(rank)``); their
    ``(returncode, output)`` in rank order.  A rank past ``timeout`` kills
    them all and fails."""
    port = free_port()
    procs = []
    for r in range(W):
        env = dict(os.environ)
        env.update({"DRAGG_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "DRAGG_NUM_PROCESSES": str(W), "DRAGG_PROCESS_ID": str(r),
                    "OMP_NUM_THREADS": "1"})
        env.update(env_extra or {})
        procs.append(subprocess.Popen(argv_for(r), env=env, cwd=REPO, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def run_rank_script(tmp_path, cfg: dict, dirs: list, stop: int = 0) -> list[dict]:
    """The ranks of :data:`RANK_SCRIPT` on ``cfg``, rank r on ``dirs[r]``; each
    rank's RANK_DONE record (its exit code checked)."""
    cfg_path = tmp_path / f"cfg{len(os.listdir(tmp_path))}.json"
    cfg_path.write_text(json.dumps(cfg))
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT.format(repo=REPO))
    outs = launch_ranks(lambda r: [sys.executable, str(script), str(cfg_path),
                                   str(dirs[r]), str(stop)], W=len(dirs))
    done = []
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out[-4000:]}"
        line = next(ln for ln in out.splitlines() if ln.startswith("RANK_DONE "))
        done.append(json.loads(line.split(" ", 1)[1]))
    return done


def find_files(root, name: str) -> list[str]:
    return [os.path.join(d, name) for d, _, files in os.walk(root) if name in files]


def jax_on_two_devices(monkeypatch):
    """The JAX package's device enumeration cut to two devices."""
    import jax

    devices = list(jax.devices())[:2]
    monkeypatch.setattr(jax_devices, "device_list", lambda: list(devices))
    monkeypatch.setattr(jax_devices, "device_count", lambda: len(devices))


def day_config(n_homes: int = 7) -> dict:
    cfg = default_config()
    cfg["community"].update(total_number_homes=n_homes, homes_pv=1, homes_battery=1,
                            homes_pv_battery=1)
    cfg["simulation"]["end_datetime"] = "2015-01-02 00"
    cfg["home"]["hems"]["prediction_horizon"] = 4
    return cfg


def test_run_entry_two_ranks_as_jax(tmp_path, monkeypatch):
    cfg = day_config()
    cfg_path = tmp_path / "config.toml"
    cfg_path.write_text(_toml_dump(cfg))
    dirs = [tmp_path / f"rank{r}" for r in range(2)]
    outs = launch_ranks(lambda r: [sys.executable, "-m", "dragg_tpu_torch", "run",
                                   "--config", str(cfg_path), "--outputs-dir", str(dirs[r]),
                                   "--device", "cpu"],
                        env_extra={"DRAGG_DISTRIBUTED": "1"})
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert "sharded engine: 2 ranks" in out and "8 home slots (7 real)" in out
    got = find_files(dirs[0], "results.json")
    assert len(got) == 1 and not find_files(dirs[1], "results.json")
    assert not find_files(dirs[1], "events.jsonl") and find_files(dirs[0], "events.jsonl")
    with open(got[0]) as f:
        rt = json.load(f)

    jax_on_two_devices(monkeypatch)
    ja = JaxAggregator(config=day_config(), outputs_dir=str(tmp_path / "jax"))
    ja.run()
    assert ja.engine.mesh.devices.size == 2 and ja.engine.n_homes == 8
    with open(os.path.join(ja.run_dir, "baseline", "results.json")) as f:
        rj = json.load(f)
    assert list(rt) == list(rj)
    for name, series in rj.items():
        if name == "Summary":
            continue
        for key, v in series.items():
            if isinstance(v, list):
                np.testing.assert_allclose(rt[name][key], v, rtol=0, atol=1e-4,
                                           err_msg=f"{name}.{key}")
        assert rt[name]["correct_solve"] == series["correct_solve"]
    sj, st = rj["Summary"], rt["Summary"]
    assert st["solver_iterations"] == sj["solver_iterations"]
    assert len(st["p_grid_aggregate"]) == 24
    np.testing.assert_allclose(st["p_grid_aggregate"], sj["p_grid_aggregate"], atol=1e-3)


@pytest.mark.parametrize("unset", [("DRAGG_PROCESS_ID",),
                                   ("DRAGG_NUM_PROCESSES", "DRAGG_PROCESS_ID")])
def test_missing_variable_exits_2_as_jax(tmp_path, unset):
    env = {k: v for k, v in os.environ.items() if k not in unset}
    env.update(DRAGG_DISTRIBUTED="1", DRAGG_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}")
    for k in ("DRAGG_NUM_PROCESSES", "DRAGG_PROCESS_ID"):
        if k not in unset:
            env[k] = "0" if k.endswith("ID") else "2"
    runs = {}
    for pkg in ("dragg_tpu", "dragg_tpu_torch"):
        p = subprocess.run([sys.executable, "-m", pkg, "run", "--outputs-dir",
                            str(tmp_path / pkg)], env=env, cwd=REPO, capture_output=True,
                           text=True, timeout=TIMEOUT_S)
        runs[pkg] = (p.returncode, p.stderr.strip().splitlines()[-1])
    assert runs["dragg_tpu_torch"] == runs["dragg_tpu"]
    assert runs["dragg_tpu_torch"][0] == 2
    assert " and ".join(unset) + " is missing" in runs["dragg_tpu_torch"][1]


def test_supervised_refused_when_distributed(monkeypatch, capsys):
    from dragg_tpu_torch.__main__ import main

    monkeypatch.setenv("DRAGG_DISTRIBUTED", "1")
    with pytest.raises(SystemExit) as e:
        main(["run", "--supervised"])
    assert e.value.code == 2
    assert "not supervised" in capsys.readouterr().err
