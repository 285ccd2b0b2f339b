"""The PyTorch port's deployment layer on the CPU
(dragg_tpu_torch/parallel/world.py's cluster detection,
dragg_tpu_torch/kernel_cache.py's library directory, and the image,
compose file and sbatch script in dragg_tpu_torch/deploy/):

* the ranks found under Open MPI and SLURM equal those of JAX's own
  detectors (``jax._src.clusters``'s ``OmpiCluster`` and ``SlurmCluster``,
  tried in JAX's order) for every node-list form, both orte URIs and the
  ``$JAX_COORDINATOR_PORT`` override; ``$DRAGG_*`` and torchrun win over
  both (torchrun has no JAX detector: a recorded difference); a run with
  nothing to find exits 2 with one line; a local id beyond the visible
  cards raises;
* ``batch.sh`` under a stand-in ``srun`` that starts two local tasks:
  rank 0's results.json within 1e-4 of a one-process run
  (tests/test_torch_distributed_run.py's tolerance), solved flags and
  iteration counts equal;
* the kernel library, built by a stand-in ``nvcc`` that records its
  calls: in ``$DRAGG_COMPILE_CACHE_DIR``, ``tpu.compile_cache_dir`` first,
  one build for four concurrent processes, a new name for a new toolkit,
  an unwritable directory raising;
* the deployment files' shapes, as tests/test_deploy.py checks the JAX
  package's.
"""

import json
import os
import stat
import subprocess
import sys
import textwrap
import time
import tomllib

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from jax._src.clusters import ClusterEnv, OmpiCluster, SlurmCluster  # noqa: E402

from dragg_tpu_torch import kernel_cache, native  # noqa: E402
from dragg_tpu_torch.ops import cuda_lib  # noqa: E402
from dragg_tpu_torch.parallel import world  # noqa: E402
from tests.test_distributed import _toml_dump  # noqa: E402
from tests.test_torch_distributed_run import day_config, free_port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "dragg_tpu_torch", "deploy")
TIMEOUT_S = 300
LAUNCHER_VARS = (world.ENV_ADDRESS, world.ENV_NUM, world.ENV_ID, *world.TORCHRUN_VARS,
                 "MASTER_PORT", "LOCAL_RANK", world.OMPI_URI, *world.OMPI_VARS,
                 *world.SLURM_VARS, world.ENV_PORT, "DRAGG_DISTRIBUTED")

SLURM = {"SLURM_JOB_ID": "1234567", "SLURM_NTASKS": "16", "SLURM_PROCID": "9",
         "SLURM_LOCALID": "1"}
OMPI = {"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "5",
        "OMPI_COMM_WORLD_LOCAL_RANK": "1"}
TCP_URI = "1531576320.0;tcp://10.96.0.1,10.148.0.1,10.108.0.1:34911"
TCP6_URI = "1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,2620:10d:c083:150e::3000:2]:43370"


@pytest.fixture()
def clean_env(monkeypatch):
    """No launcher variable of any kind in the environment."""
    for var in LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def jax_detect():
    """What ``jax.distributed.initialize()`` finds: the first of JAX's Open
    MPI and SLURM detectors, in the order JAX registers them, whose
    environment is present: (name, address, count, id, local id)."""
    order = sorted((OmpiCluster, SlurmCluster), key=ClusterEnv._cluster_types.index)
    env = next((c for c in order if c.is_env_present()), None)
    if env is None:
        return None
    address = env.get_coordinator_address(None, os.environ.get("JAX_COORDINATOR_PORT"))
    return (env.name, address, env.get_process_count(), env.get_process_id(),
            env.get_local_process_id())


def port_detect():
    c = world.detect()
    return None if c is None else (c.name, c.address, c.size, c.rank, c.local_rank)


CASES = {
    "slurm-one-node": {**SLURM, "SLURM_STEP_NODELIST": "node001"},
    "slurm-list": {**SLURM, "SLURM_STEP_NODELIST": "node001,host2"},
    "slurm-range": {**SLURM, "SLURM_STEP_NODELIST": "node[001-0015],host2"},
    "slurm-ranges": {**SLURM, "SLURM_STEP_NODELIST": "node[001,007-015],host2"},
    "slurm-port-override": {**SLURM, "SLURM_STEP_NODELIST": "gpu[17-20]",
                            "JAX_COORDINATOR_PORT": "23456"},
    "ompi-tcp": {**OMPI, "OMPI_MCA_orte_hnp_uri": TCP_URI},
    "ompi-tcp6": {**OMPI, "OMPI_MCA_orte_hnp_uri": TCP6_URI},
    "ompi-port-override": {**OMPI, "OMPI_MCA_orte_hnp_uri": TCP_URI,
                           "JAX_COORDINATOR_PORT": "23457"},
    "ompi-before-slurm": {**SLURM, "SLURM_STEP_NODELIST": "node001", **OMPI,
                          "OMPI_MCA_orte_hnp_uri": TCP_URI},
    "slurm-incomplete": {"SLURM_JOB_ID": "7", "SLURM_STEP_NODELIST": "node001",
                         "SLURM_NTASKS": "2", "SLURM_PROCID": "0"},
}


@pytest.mark.parametrize("case", list(CASES))
def test_detection_equals_jax(clean_env, case):
    for k, v in CASES[case].items():
        clean_env.setenv(k, v)
    assert port_detect() == jax_detect()
    if case == "ompi-tcp6":
        assert world.detect().init_method == (
            "tcp://[fe80::b9b:ac5d:9cf0:b858]:" + world.detect().address.rsplit(":", 1)[1])
    if case == "slurm-incomplete":
        assert port_detect() is None


@pytest.mark.parametrize("first", ["dragg", "torchrun"])
def test_dragg_and_torchrun_come_before_the_cluster(clean_env, first):
    """The ``$DRAGG_*`` variables, then torchrun, win over SLURM and Open
    MPI; JAX (no torchrun detector) would take SLURM here."""
    for k, v in {**SLURM, "SLURM_STEP_NODELIST": "node001", **OMPI,
                 "OMPI_MCA_orte_hnp_uri": TCP_URI}.items():
        clean_env.setenv(k, v)
    if first == "dragg":
        clean_env.setenv(world.ENV_ADDRESS, "10.0.0.2:1234")
        clean_env.setenv(world.ENV_NUM, "4")
        clean_env.setenv(world.ENV_ID, "3")
        want = ("dragg", "10.0.0.2:1234", 4, 3, 3)
    else:
        clean_env.setenv("RANK", "6")
        clean_env.setenv("WORLD_SIZE", "12")
        clean_env.setenv("MASTER_ADDR", "10.0.0.3")
        clean_env.setenv("LOCAL_RANK", "2")
        want = ("torchrun", None, 12, 6, 2)
    assert port_detect() == want
    assert jax_detect()[0] == "ompi"
    assert world.detect().init_method == ("tcp://10.0.0.2:1234" if first == "dragg"
                                          else "env://")


def test_nothing_to_find_raises_in_process(clean_env):
    assert world.detect() is None
    with pytest.raises(ValueError, match="no cluster was found"):
        world.init_from_env()


def test_nothing_to_find_exits_2_with_one_line(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env["DRAGG_DISTRIBUTED"] = "1"
    p = subprocess.run([sys.executable, "-m", "dragg_tpu_torch", "run", "--outputs-dir",
                        str(tmp_path)], env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=TIMEOUT_S)
    assert p.returncode == 2
    assert p.stderr.splitlines() == [world.NO_CLUSTER]
    for var in ("DRAGG_COORDINATOR_ADDRESS", "MASTER_ADDR", "OMPI_MCA_orte_hnp_uri",
                "SLURM_LOCALID"):
        assert var in p.stderr


@pytest.mark.parametrize("size", [1, 4])
def test_a_local_id_beyond_the_cards_raises(size):
    """cuda:<local id> or an error naming both numbers; never another card
    (this host sees no card)."""
    from dragg_tpu_torch.parallel.mesh import rank_device

    w = world.World(rank=9, size=size, local_rank=torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match=f"local id {w.local_rank} is not below the "
                                           f"{torch.cuda.device_count()} visible"):
        w.card()
    if size > 1:
        with pytest.raises(RuntimeError, match="is not below"):
            rank_device(w)
    assert rank_device(w, "cpu") == "cpu"


# ------------------------------------------------------------ batch.sh
SRUN = textwrap.dedent("""\
    #!/bin/bash
    # A stand-in srun: $STANDIN_NTASKS local tasks of one step on this host.
    pids=()
    for ((r = 0; r < STANDIN_NTASKS; r++)); do
        SLURM_JOB_ID=4242 SLURM_STEP_NODELIST=localhost SLURM_NTASKS=$STANDIN_NTASKS \\
        SLURM_PROCID=$r SLURM_LOCALID=$r "$@" > "$STANDIN_LOGS/task$r.txt" 2>&1 &
        pids+=($!)
    done
    rc=0
    for p in "${pids[@]}"; do wait "$p" || rc=$?; done
    exit $rc
""")


def test_batch_script_runs_two_ranks_as_one_process(tmp_path):
    from dragg_tpu_torch.aggregator import Aggregator

    bin_dir, logs = tmp_path / "bin", tmp_path / "logs"
    bin_dir.mkdir()
    logs.mkdir()
    srun = bin_dir / "srun"
    srun.write_text(SRUN)
    srun.chmod(srun.stat().st_mode | stat.S_IEXEC)
    python = bin_dir / "python"  # this interpreter, whatever "python" names here
    python.write_text(f'#!/bin/sh\nexec {sys.executable} "$@"\n')
    python.chmod(python.stat().st_mode | stat.S_IEXEC)
    cfg_path = tmp_path / "config.toml"
    cfg_path.write_text(_toml_dump(day_config()))
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env.update(PATH=f"{bin_dir}{os.pathsep}{env['PATH']}", STANDIN_NTASKS="2",
               STANDIN_LOGS=str(logs), JAX_COORDINATOR_PORT=str(free_port()),
               OMP_NUM_THREADS="1")
    p = subprocess.run(["bash", os.path.join(DEPLOY, "batch.sh"), "--config", str(cfg_path),
                        "--outputs-dir", str(tmp_path / "out"), "--device", "cpu"],
                       env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    outs = [(logs / f"task{r}.txt").read_text() for r in range(2)]
    assert p.returncode == 0, "\n".join(o[-3000:] for o in outs)
    for r, out in enumerate(outs):
        assert f"[run] slurm: rank {r} of 2, local id {r}, coordinator localhost:" in out
        assert "sharded engine: 2 ranks" in out
    got = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "out") for f in fs
           if f == "results.json"]
    assert len(got) == 1
    with open(got[0]) as f:
        rt = json.load(f)

    one = Aggregator(day_config(), outputs_dir=str(tmp_path / "one"), device="cpu")
    one.run()
    with open(os.path.join(one.run_dir, "baseline", "results.json")) as f:
        ro = json.load(f)
    assert list(rt) == list(ro)
    for name, series in ro.items():
        if name == "Summary":
            continue
        for key, v in series.items():
            if isinstance(v, list):
                np.testing.assert_allclose(rt[name][key], v, rtol=0, atol=1e-4,
                                           err_msg=f"{name}.{key}")
        assert rt[name]["correct_solve"] == series["correct_solve"]
    assert rt["Summary"]["solver_iterations"] == ro["Summary"]["solver_iterations"]


# -------------------------------------------------------- the library
NVCC = textwrap.dedent("""\
    #!/bin/bash
    # A stand-in nvcc: records its arguments, prints a version, writes -o.
    echo "$*" >> "$STANDIN_NVCC_LOG"
    if [ "$1" = "--version" ]; then echo "stand-in nvcc ${STANDIN_NVCC_TAG:-12.4}"; exit 0; fi
    out=""; prev=""
    for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
    sleep "${STANDIN_NVCC_SLEEP:-0}"
    echo built > "$out"
""")


@pytest.fixture()
def standin(tmp_path, monkeypatch):
    """A stand-in nvcc first on PATH, and this process's library directory
    and toolkit version unresolved (restored after the test)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("STANDIN_NVCC_LOG", str(log))
    monkeypatch.delenv(kernel_cache.ENV, raising=False)
    monkeypatch.setattr(kernel_cache, "_CHOSEN", None)
    monkeypatch.setattr(kernel_cache, "_FRESH", None)
    monkeypatch.setattr(cuda_lib, "_NVCC_VERSION", {})
    monkeypatch.setattr(cuda_lib, "_BUILT", set())

    def calls() -> dict:
        lines = log.read_text().splitlines() if log.exists() else []
        return {"version": sum(ln == "--version" for ln in lines),
                "compile": sum(" -c " in f" {ln} " for ln in lines),
                "link": sum(ln.startswith("-shared") for ln in lines)}

    return calls


def small_engine_config(**tpu):
    from dragg_tpu_torch.config import default_config

    cfg = default_config()
    cfg["community"].update(total_number_homes=4, homes_pv=1, homes_battery=1,
                            homes_pv_battery=1)
    cfg["simulation"]["end_datetime"] = "2015-01-01 02"
    cfg["home"]["hems"]["prediction_horizon"] = 2
    cfg["tpu"].update(tpu)
    return cfg


def test_library_in_the_variables_directory_and_the_config_first(tmp_path, standin,
                                                                 monkeypatch, caplog):
    from dragg_tpu_torch.aggregator import Aggregator

    env_dir, cfg_dir = tmp_path / "from-env", tmp_path / "from-config"
    monkeypatch.setenv(kernel_cache.ENV, str(env_dir))
    # An engine built from a config places the library (before any launch).
    agg = Aggregator(small_engine_config(compile_cache_dir=str(cfg_dir)),
                     outputs_dir=str(tmp_path / "out"), device="cpu")
    agg.get_homes()
    agg._build_engine()
    path = cuda_lib.build_library()
    assert os.path.dirname(path) == str(cfg_dir) and os.path.isfile(path)
    assert standin() == {"version": 1, "compile": len(cuda_lib.UNITS), "link": 1}
    assert cuda_lib.built_here() and not env_dir.exists()
    # A later request for another directory keeps the first, and says so.
    kernel_cache.configure({"tpu": {"compile_cache_dir": str(tmp_path / "other")}})
    assert kernel_cache.build_dir() == str(cfg_dir)
    assert "ignoring the later request" in caplog.text
    assert cuda_lib.build_library() == path and standin()["compile"] == len(cuda_lib.UNITS)
    # Without the config's key, the variable's directory.
    monkeypatch.setattr(kernel_cache, "_CHOSEN", None)
    kernel_cache.configure(small_engine_config())
    assert os.path.dirname(cuda_lib.build_library()) == str(env_dir)
    # Without either, the package's _build (resolved, not built here).
    monkeypatch.delenv(kernel_cache.ENV)
    monkeypatch.setattr(kernel_cache, "_CHOSEN", None)
    assert kernel_cache.build_dir() == kernel_cache.DEFAULT_DIR == native._BUILD_DIR


def test_the_images_build_step_builds_both_libraries_without_torch(tmp_path, standin):
    """The Dockerfile's build line: both libraries into the variable's
    directory, nvcc once a unit, torch never imported (no card touched)."""
    cmd = next(ln[len("RUN "):] for ln in read("Dockerfile").splitlines()
               if ln.startswith("RUN CUDA_VISIBLE_DEVICES= "))
    env = dict(os.environ, **{kernel_cache.ENV: str(tmp_path / "image")})
    env["PATH"] = f"{tmp_path / 'bin'}{os.pathsep}{os.path.dirname(sys.executable)}" \
                  f"{os.pathsep}{env['PATH']}"
    p = subprocess.run(["bash", "-c", cmd], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=TIMEOUT_S)
    assert p.returncode == 0, p.stderr[-3000:]
    rep = json.loads(p.stdout.strip().splitlines()[-1])
    assert rep["directory"] == str(tmp_path / "image") and rep["built"]
    assert (rep["cuda_visible_devices"], rep["torch_imported"]) == ("", False)
    for lib in (rep["kernels"], rep["host"]):
        assert os.path.dirname(lib) == rep["directory"] and os.path.isfile(lib)
    assert standin() == {"version": 1, "compile": len(cuda_lib.UNITS), "link": 1}


def test_compile_cache_false_builds_into_a_fresh_directory(tmp_path):
    """A fresh temporary directory a process, removed at its exit (the
    module imports no torch, so this child is cheap)."""
    code = ("import os\n"
            "from dragg_tpu_torch import kernel_cache\n"
            "kernel_cache.configure({'tpu': {'compile_cache': False,\n"
            "                                'compile_cache_dir': 'ignored'}})\n"
            "d = kernel_cache.build_dir()\n"
            "open(os.path.join(d, 'lib.so'), 'w').close()\n"
            "print(d)\n")
    env = dict(os.environ, TMPDIR=str(tmp_path), **{kernel_cache.ENV: str(tmp_path / "env")})
    dirs = [subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                           text=True, timeout=TIMEOUT_S, check=True).stdout.strip()
            for _ in range(2)]
    assert dirs[0] != dirs[1]
    for d in dirs:
        assert os.path.dirname(d) == str(tmp_path) and not os.path.exists(d)


BUILD_SCRIPT = textwrap.dedent("""\
    import os, sys, time
    sys.path.insert(0, {repo!r})
    from dragg_tpu_torch.ops import cuda_lib
    ready, go = sys.argv[1], sys.argv[2]
    open(ready, "w").close()
    while not os.path.exists(go):
        time.sleep(0.01)
    print(cuda_lib.build_library())
""")


def test_concurrent_builds_run_nvcc_once(tmp_path, standin):
    script = tmp_path / "build_once.py"
    script.write_text(BUILD_SCRIPT.format(repo=REPO))
    go = tmp_path / "go"
    env = dict(os.environ, STANDIN_NVCC_SLEEP="0.5", OMP_NUM_THREADS="1",
               **{kernel_cache.ENV: str(tmp_path / "shared")})
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp_path / f"ready{i}"),
                               str(go)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(4)]
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while not all((tmp_path / f"ready{i}").exists() for i in range(4)):
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs)
            time.sleep(0.05)
        go.write_text("")
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1 and os.path.isfile(paths.pop())
    assert standin() == {"version": 4, "compile": len(cuda_lib.UNITS), "link": 1}


def test_another_toolkit_gets_another_library(tmp_path, standin, monkeypatch):
    monkeypatch.setenv(kernel_cache.ENV, str(tmp_path / "shared"))
    first = cuda_lib.library_path()
    monkeypatch.setattr(cuda_lib, "_NVCC_VERSION", {})
    monkeypatch.setenv("STANDIN_NVCC_TAG", "12.8")
    second = cuda_lib.library_path()
    assert first != second and os.path.dirname(first) == os.path.dirname(second)
    assert standin()["version"] == 2


def test_a_directory_that_cannot_be_written_raises(tmp_path, standin, monkeypatch):
    """Under a regular file no directory can be made: both libraries
    raise naming it, and nothing lands in the package's _build."""
    (tmp_path / "file").write_text("")
    bad = str(tmp_path / "file" / "kernels")
    monkeypatch.setenv(kernel_cache.ENV, bad)
    with pytest.raises(RuntimeError, match=f"library directory {bad} cannot be written"):
        cuda_lib.build_library()
    with pytest.raises(RuntimeError, match=f"library directory {bad} cannot be written"):
        native._build_lib()
    assert standin()["compile"] == 0


def test_a_built_library_loads_from_a_read_only_directory(tmp_path, standin, monkeypatch):
    """A library found built is returned without the lock or a compile."""
    d = tmp_path / "image"
    monkeypatch.setenv(kernel_cache.ENV, str(d))
    path = cuda_lib.library_path()
    d.mkdir()
    with open(path, "w") as f:
        f.write("prebuilt")
    d.chmod(0o555)
    try:
        assert cuda_lib.build_library() == path and not cuda_lib.built_here()
        assert standin() == {"version": 1, "compile": 0, "link": 0}
        assert not os.path.exists(f"{path}.lock")
    finally:
        d.chmod(0o755)


# ------------------------------------------------------------ shapes
def read(name: str) -> str:
    with open(os.path.join(DEPLOY, name)) as f:
        return f.read()


def test_dockerfile_is_the_ports_image():
    text = read("Dockerfile")
    lines = [ln.strip() for ln in text.splitlines() if ln.strip() and not ln.startswith("#")]
    assert "jax" not in "\n".join(lines).lower() and "pandas" not in "\n".join(lines)
    assert lines[0].startswith("ARG BASE=") and "devel" in lines[0]
    assert "FROM ${BASE}" in lines
    for src in ("pyproject.toml", "dragg_tpu_torch", "native", "data"):
        assert any(ln.startswith("COPY") and src in ln.split() for ln in lines), src
    assert any(ln.startswith("RUN pip install") and "-e ." in ln and "--no-deps" in ln
               for ln in lines)
    assert "ENV DRAGG_COMPILE_CACHE_DIR=/opt/dragg/kernels" in lines
    assert "RUN CUDA_VISIBLE_DEVICES= python -m dragg_tpu_torch.kernel_cache" in lines
    assert lines[-1] == ('CMD ["python", "-m", "dragg_tpu_torch", "run", "--outputs-dir", '
                         '"/app/outputs"]')


def test_compose_file_keeps_the_roots_surface_and_reserves_a_gpu():
    import yaml

    with open(os.path.join(REPO, "docker-compose.yml")) as f:
        root = next(iter(yaml.safe_load(f)["services"].values()))
    svc = yaml.safe_load(read("docker-compose.yml"))["services"]["dragg-tpu-torch"]
    assert svc["build"]["dockerfile"] == "dragg_tpu_torch/deploy/Dockerfile"
    assert svc["environment"] == root["environment"]
    assert [v.rsplit(":", 2)[1:] for v in svc["volumes"]] == \
        [v.rsplit(":", 2)[1:] for v in root["volumes"]]
    gpu = svc["deploy"]["resources"]["reservations"]["devices"][0]
    assert gpu["driver"] == "nvidia" and gpu["capabilities"] == ["gpu"]


def test_batch_script_is_sbatch_shaped():
    text = read("batch.sh")
    directives = [ln.split()[1].split("=")[0] for ln in text.splitlines()
                  if ln.startswith("#SBATCH")]
    for d in ("--nodes", "--ntasks-per-node", "--gpus-per-node"):
        assert d in directives
    assert not {"--gpus-per-task", "--gpu-bind"} & set(directives)
    assert "export DRAGG_DISTRIBUTED=1" in text
    assert 'srun python -u -m dragg_tpu_torch run "$@"' in text
    assert "redis" not in text.lower() and "jax " not in text.lower()
    assert os.access(os.path.join(DEPLOY, "batch.sh"), os.X_OK)


def test_console_script_resolves_to_main():
    import importlib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    module, _, attr = scripts["dragg-tpu-torch"].partition(":")
    assert module == "dragg_tpu_torch.__main__"
    assert callable(getattr(importlib.import_module(module), attr))
