"""Environment diagnosis: ``python -m dragg_tpu_torch doctor`` (the
counterpart of ``dragg_tpu/doctor.py``; the same check names and
semantics).

Answers "why isn't this working" in one screen: CUDA reachability
(checked in a SUBPROCESS with a hard timeout, so a lost or hung card can
never hang the diagnosis), device inventory, the CUDA kernels against
their plain versions, the native C++ host runtime, data-file resolution,
and output-directory writability.

Importing this module imports no torch: every check that needs torch
runs in a subprocess.  Where the JAX doctor checks its Pallas kernels
(``pallas_kernels``, a WARN on failure: its XLA scans carry on), this
one runs ``cuda_kernels``, a FAIL on failure: the port has no fallback
route, so nothing would carry on.

Exit code 0 when every check passes or degrades gracefully (an
unreachable card with a healthy CPU torch counts as degraded-ok: every
entry point still runs with ``device="cpu"``); 1 when something is
broken outright.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

OK, WARN, FAIL = "ok", "warn", "FAIL"


def _check_backend(timeout_s: float = 60.0) -> dict:
    """Probe CUDA init via the SHARED subprocess probe
    (dragg_tpu_torch/probe.py) so doctor and the supervised runs cannot
    disagree about the card's liveness."""
    from dragg_tpu_torch.probe import probe_backend

    r = probe_backend(timeout_s)
    if r.pop("ok"):
        r.pop("elapsed_s", None)
        return {"status": OK, **r}
    return {"status": FAIL, "error": r["error"]}


def _check_cpu_fallback(timeout_s: float) -> dict:
    """torch on the CPU, in a subprocess with every CUDA device hidden
    (the environment of a degraded child)."""
    code = (
        "import torch\n"
        "assert float(torch.ones(8).sum()) == 8.0\n"
        "print('cpu-ok')\n"
    )
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=timeout_s, env=env)
        ok = proc.returncode == 0 and "cpu-ok" in proc.stdout
        return {"status": OK if ok else FAIL,
                **({} if ok else {"error": (proc.stderr or "")[-300:]})}
    except subprocess.TimeoutExpired:
        return {"status": FAIL, "error": "CPU torch init hung"}


def _check_native() -> dict:
    try:
        from dragg_tpu_torch.native import StateBus

        bus = StateBus()
        bus.hset("doctor", "k", "v")
        ok = bus.hget("doctor", "k") == "v"
        return {"status": OK if ok else FAIL,
                "native_extension": bool(bus.native),
                **({} if bus.native else
                   {"note": "pure-Python fallback active (g++ build unavailable)"})}
    except Exception as e:
        return {"status": FAIL, "error": repr(e)}


def _check_data(cfg: dict | None) -> dict:
    data_dir = os.environ.get("DATA_DIR")
    if not data_dir:
        from dragg_tpu_torch.data import bundled_data_dir

        bundled = bundled_data_dir()
        if bundled is not None:
            # No DATA_DIR resolves to the repo's bundled assets
            # (reference-default file-ingestion path), not synthetic.
            data_dir = bundled
        else:
            return {"status": OK,
                    "note": "no DATA_DIR and no bundled data/ — synthetic "
                            "weather/draws/prices"}
    # The exact file names the runtime resolves (dragg_tpu_torch/data.py), env
    # overrides included.
    wanted = [os.environ.get("SOLAR_TEMPERATURE_DATA_FILE", "nsrdb.csv")]
    if cfg is not None:
        wanted.append(cfg["home"]["wh"].get("waterdraw_file",
                                            "waterdraw_profiles.csv"))
        if cfg["agg"].get("spp_enabled", False):
            wanted.append(os.environ.get("SPP_DATA_FILE", "spp_data.csv"))
    missing = [f for f in wanted
               if not os.path.isfile(os.path.join(data_dir, f))]
    return {"status": WARN if missing else OK, "data_dir": data_dir,
            **({"missing": missing,
                "note": "missing files substitute SYNTHETIC data (loudly)"}
               if missing else {})}


def _check_telemetry() -> dict:
    """Unified-telemetry plumbing: registry loads, a throwaway bus round-
    trips one event (dragg_tpu_torch/telemetry).  Reports the shared stream
    when ``$DRAGG_TELEMETRY_DIR`` routes this process's events."""
    try:
        from dragg_tpu_torch import telemetry

        r = telemetry.selftest()
        stream = os.environ.get(telemetry.ENV_DIR)
        return {"status": OK if r["ok"] else FAIL,
                "registered": f"{r['events']} events / {r['metrics']} metrics",
                **({"stream": stream} if stream else {})}
    except Exception as e:
        return {"status": FAIL, "error": repr(e)}


def _check_trace_plane(timeout_s: float = 30.0) -> dict:
    """Trace-plane selftest (``--telemetry``): a SUBPROCESS
    runs a tiny traced bus run — root + child spans, a skew record,
    a sub-second live-flush cadence — then this process asserts the
    stream assembles to one COMPLETE causal tree (>=1 root, zero
    orphans), that metrics.json existed BEFORE close (the crash-loss
    fix), and that the rollup folds with Prometheus exposition.  A
    subprocess so the probe never perturbs this process's own bus or
    trace context."""
    code = (
        "import json, os, tempfile, time\n"
        "from dragg_tpu_torch import telemetry\n"
        "from dragg_tpu_torch.telemetry import trace\n"
        "d = tempfile.mkdtemp(prefix='dragg_traceck_')\n"
        "trace.enable()\n"
        "telemetry.init_run(d, flush_s=0.05)\n"
        "telemetry.emit('run.start', config_label='doctor', platform='cpu')\n"
        "telemetry.inc('wire.dedup', 1)\n"
        "telemetry.emit('chunk.done', t0=0, t1=2, device_s=0.01,\n"
        "               **trace.child_fields())\n"
        "telemetry.emit('trace.skew', shard=0, offset_s=0.0, rtt_s=0.001)\n"
        "time.sleep(0.1)\n"
        "telemetry.emit('run.end', ok=True)\n"
        "live = os.path.exists(os.path.join(d, telemetry.METRICS_FILE))\n"
        "telemetry.close_run(write_metrics=True)\n"
        "print('TRACECK ' + json.dumps({'dir': d, 'live_flush': live}))\n")
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=timeout_s)
        line = next((l for l in (proc.stdout or "").splitlines()
                     if l.startswith("TRACECK ")), None)
        if proc.returncode != 0 or line is None:
            return {"status": FAIL, "error": (proc.stderr or "")[-300:]}
        child = json.loads(line[len("TRACECK "):])
        from dragg_tpu_torch.telemetry import rollup, traces

        rep = traces.trace_report(child["dir"])
        roll = rollup.fold_rollup(child["dir"])
        prom = rollup.prometheus_text(roll)
        import shutil

        shutil.rmtree(child["dir"], ignore_errors=True)
        problems = traces.completeness_problems(rep)
        if not child["live_flush"]:
            problems.append("no metrics.json before close "
                            "(live flush did not fire)")
        if "dragg_" not in prom:
            problems.append("prometheus exposition empty")
        return {"status": OK if not problems else FAIL,
                "traces": len(rep["traces"]),
                "live_flush": child["live_flush"],
                "rollup_streams": len(roll.get("streams", {})),
                **({"problems": problems} if problems else {})}
    except subprocess.TimeoutExpired:
        return {"status": FAIL,
                "error": f"trace selftest hung >{timeout_s:.0f}s"}
    except Exception as e:
        return {"status": FAIL, "error": repr(e)}


def _check_staged_compile(timeout_s: float, device: str) -> dict:
    """Opt-in (``--compile-check``): a tiny engine's chunk warm-up run
    through the STAGED path (telemetry/compile_obs: lower → compile →
    first-execute, the kernel library's hit/miss verdict) on ``device``
    ("cuda" when the probe found a card, else "cpu") in a hard-timeouted
    subprocess — proves the stage-attribution machinery works in this
    environment and reports where warm-up time goes.  A hang here names
    the stuck stage instead of wedging doctor."""
    code = ("import json\n"
            "from dragg_tpu_torch.telemetry.compile_obs import selftest\n"
            f"print('STAGED ' + json.dumps(selftest(device={device!r})))\n")
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=timeout_s)
        line = next((l for l in (proc.stdout or "").splitlines()
                     if l.startswith("STAGED ")), None)
        if proc.returncode != 0 or line is None:
            return {"status": FAIL, "error": (proc.stderr or "")[-300:]}
        rep = json.loads(line[len("STAGED "):])
        return {"status": OK if rep.get("ok") else FAIL,
                "stages": rep.get("stages"), "cache": rep.get("cache")}
    except subprocess.TimeoutExpired:
        return {"status": FAIL,
                "error": f"staged compile hung >{timeout_s:.0f}s"}


def _check_serve_journal() -> dict:
    """Serving-substrate plumbing (dragg_tpu_torch/serve): a throwaway journal
    round-trips the accepted→done lifecycle, refuses a double answer,
    and replays a torn tail without losing the durable record — the
    crash-safety contract the daemon's zero-lost-requests guarantee
    stands on.  Pure stdlib; never launches a worker."""
    import tempfile

    try:
        from dragg_tpu_torch.serve.journal import Journal, replay

        with tempfile.TemporaryDirectory(prefix="dragg_serve_") as d:
            path = os.path.join(d, "journal.jsonl")
            j = Journal(path)
            j.accepted("probe", {"id": "probe", "home": 0})
            j.accepted("torn", {"id": "torn", "home": 1})
            ok = j.done("probe", {"p_grid": 1.0})
            ok &= not j.done("probe", {"p_grid": 2.0})  # exactly-once
            j.close()
            with open(path, "ab") as f:
                f.write(b'{"state": "done", "id": "torn", "resp')  # torn
            rep = replay(path)
            ok &= set(rep.pending) == {"torn"}      # torn line dropped,
            ok &= set(rep.terminal) == {"probe"}    # durable kept
            ok &= rep.dropped_lines == 1
        return {"status": OK if ok else FAIL,
                **({} if ok else {"error": "journal selftest mismatch"})}
    except Exception as e:
        return {"status": FAIL, "error": repr(e)}


def _check_shard_journal() -> dict:
    """Shard-coordinator crash-safety selftest (``--shard-check``),
    mirroring the serve_journal check for the shard substrate
    (dragg_tpu_torch/shard/journal.py): the epoch → plan → chunk
    lifecycle round-trips, a DUPLICATE epoch token is refused (reusing a
    dead coordinator's token would re-admit the orphan workers the spool
    EPOCH fence exists to stop), and replay survives truncation at EVERY
    byte boundary — the frontier only ever walks backward to a prefix,
    never corrupts.  Pure stdlib; never launches a worker."""
    import tempfile

    try:
        from dragg_tpu_torch.shard.journal import Journal, replay

        with tempfile.TemporaryDirectory(prefix="dragg_shard_") as d:
            path = os.path.join(d, "shard_journal.jsonl")
            j = Journal(path)
            j.epoch("probe-epoch")
            j.plan(4, 2, [(0, 2), (2, 4)], steps=8, chunk_steps=2)
            j.launch(0, 1, "cpu", 0, 2)
            j.chunk(0, 0, 0, 2)
            j.chunk(0, 1, 2, 4)
            j.chunk(1, 0, 0, 2)
            ok = True
            try:
                j.epoch("probe-epoch")  # duplicate must be refused
                ok = False
            except ValueError:
                pass
            j.close()
            # A successor instance must refuse the duplicate too (the
            # claim set survives via replay, not process memory).
            j2 = Journal(path)
            try:
                j2.epoch("probe-epoch")
                ok = False
            except ValueError:
                pass
            j2.epoch("probe-epoch-2")
            j2.close()
            rep_full = replay(path)
            ok &= rep_full.frontier == {0: 2, 1: 1}
            ok &= rep_full.epochs == ["probe-epoch", "probe-epoch-2"]
            # Torn-tail truncation at every byte boundary: replay never
            # raises, the frontier is monotone non-increasing toward the
            # head, and a torn final line drops silently (serve journal
            # property-test precedent).
            with open(path, "rb") as f:
                raw = f.read()
            prev_total = None
            for cut in range(len(raw), -1, -1):
                with open(path, "wb") as f:
                    f.write(raw[:cut])
                rep = replay(path)
                total = sum(rep.frontier.values())
                ok &= rep.dropped_lines <= 1
                if prev_total is not None:
                    ok &= total <= prev_total
                prev_total = total
        return {"status": OK if ok else FAIL,
                "note": f"torn-tail sweep over {len(raw) + 1} boundaries",
                **({} if ok else {"error": "shard journal selftest "
                                           "mismatch"})}
    except Exception as e:
        return {"status": FAIL, "error": repr(e)}


def _check_shard_wire() -> dict:
    """Networked shard transport selftest (``--shard-check``), run
    against a LIVE loopback chunk-ingest server (shard/transport.py):

    * a pushed chunk frame is journal-acked BEFORE the 200 and its
      retained spool file matches the payload byte-for-byte;
    * a TORN frame at EVERY byte boundary is discarded whole (400,
      no state change) — the wire analog of the journal torn-tail sweep;
    * a duplicate ``(epoch, shard, chunk)`` token is refused (acked
      without re-merge) ACROSS a transport restart — the dedup set is
      re-seeded from the journal + spool, not process memory;
    * a fenced (stale-epoch) push is refused with 409 naming the stale
      token.

    Pure stdlib + loopback TCP; never launches a worker."""
    import tempfile

    try:
        from http.client import HTTPConnection

        from dragg_tpu_torch.serve import spool as sp
        from dragg_tpu_torch.shard import journal as sj
        from dragg_tpu_torch.shard import wire
        from dragg_tpu_torch.shard.transport import (ChunkIngestServer,
                                                     EpochFenced, WireClient)

        with tempfile.TemporaryDirectory(prefix="dragg_wire_") as d:
            spool_dir = os.path.join(d, "spool")
            jpath = os.path.join(d, "shard_journal.jsonl")
            journal = sj.Journal(jpath)
            journal.epoch("probe-epoch")
            sp.write_epoch(spool_dir, "probe-epoch")
            payload = {"shard": 0, "gen": 1, "seq": 0, "t0": 0, "t1": 2,
                       "series": {"agg_load": [[1.0], [2.0]]}}
            srv = ChunkIngestServer(spool_dir, journal, "probe-epoch")
            srv.start()
            ok = True
            try:
                client = WireClient(srv.endpoint, "probe-epoch", 0,
                                    spool_dir, retry_s=5.0)
                ok &= client.push_chunk(0, payload) == "acked"
                ok &= sj.replay(jpath).acked == {0: [0]}  # ack before 200
                ok &= sp.read_json(
                    sp.chunk_path(spool_dir, 0, 0)) == payload
                ok &= client.push_chunk(0, payload) == "dup"
                # Torn frame at EVERY byte boundary: 400, no state change.
                frame = wire.encode_frame(
                    {"kind": "chunk", "epoch": "probe-epoch", "shard": 0,
                     "seq": 1, "payload": {**payload, "seq": 1}})
                host, port = srv.endpoint.rsplit(":", 1)
                for cut in range(len(frame)):
                    conn = HTTPConnection(host, int(port), timeout=10.0)
                    try:
                        conn.request(
                            "POST", "/chunk", body=frame[:cut],
                            headers={"Content-Type":
                                     "application/octet-stream"})
                        r = conn.getresponse()
                        r.read()
                        ok &= r.status == 400
                    finally:
                        conn.close()
                ok &= sp.read_json(
                    sp.chunk_path(spool_dir, 0, 1)) is None
                ok &= sj.replay(jpath).acked == {0: [0]}
            finally:
                srv.stop()
            # Transport restart: dedup token survives (seeded from the
            # journal + retained spool files, not process memory).
            srv2 = ChunkIngestServer(spool_dir, journal, "probe-epoch")
            srv2.start()
            try:
                client2 = WireClient(srv2.endpoint, "probe-epoch", 0,
                                     spool_dir, retry_s=5.0)
                ok &= client2.push_chunk(0, payload) == "dup"
                ok &= sj.replay(jpath).acked == {0: [0]}  # no re-journal
                # Fenced-epoch push: refused, stale token named.
                stale = WireClient(srv2.endpoint, "dead-epoch", 0,
                                   spool_dir, retry_s=5.0)
                try:
                    stale.push_chunk(2, {**payload, "seq": 2})
                    ok = False
                except EpochFenced as e:
                    ok &= wire.chunk_token("dead-epoch", 0, 2) in str(e)
            finally:
                srv2.stop()
            journal.close()
        return {"status": OK if ok else FAIL,
                "note": f"torn-frame sweep over {len(frame)} boundaries, "
                        f"dedup across restart, fence named",
                **({} if ok else {"error": "shard wire selftest "
                                           "mismatch"})}
    except Exception as e:
        return {"status": FAIL, "error": repr(e)}


# The small bucket shape the kernel self-test runs at: a 52-row band of
# bandwidth 4 and the (52, 124) window of the H = 24 main path's smallest
# bucket, 64 homes.
SELFTEST_BAND = (52, 4)
SELFTEST_WINDOW = (52, 124)
SELFTEST_HOMES = 64


def cuda_kernel_selftest() -> dict:
    """Build or load the kernel library (``ops/cuda_lib.lib()``, in the
    directory that the config the doctor reads and the environment
    resolve, ``kernel_cache.py``) and hold
    each of the four kernels against its plain version on the card at
    one small bucket shape: the band kernels bit for bit
    (``torch.equal``), the window at ``bench_window.check_window``'s
    tolerance.  Runs in the doctor's subprocess; raises on the card's
    absence, a build failure or a disagreement."""
    import torch

    from dragg_tpu_torch.bench_band import band_fixture
    from dragg_tpu_torch.bench_window import (CHECK_EVERY, KW, check_window,
                                              window_fixture)
    from dragg_tpu_torch.ops import band_kernels as bk
    from dragg_tpu_torch.ops import iter_kernels as ik
    from dragg_tpu_torch import kernel_cache
    from dragg_tpu_torch.ops.cuda_lib import lib, library_path

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    kernel_cache.configure(_check_config()[1])
    cached = os.path.isfile(library_path())
    lib()
    m, bw = SELFTEST_BAND
    St, r = band_fixture(m, bw, SELFTEST_HOMES, seed=7)
    L = bk.banded_cholesky_t(St, bw)
    Lp = bk.cholesky_t_plain(St, bw)
    x = bk.refined_banded_solve_t(L, St, r, bw, 1)
    xp = bk.refined_solve_t_plain(Lp, St, r, bw, 1)
    Lf, xf = bk.factor_refined_solve_t(St, r, bw, 0)
    Lfp, xfp = bk.factor_solve_t_plain(St, r, bw, 0)
    torch.cuda.synchronize()
    kernels = {
        "banded_cholesky_t": torch.equal(L, Lp),
        "refined_banded_solve_t": torch.equal(x, xp),
        "factor_refined_solve_t": torch.equal(Lf, Lfp) and torch.equal(xf, xfp),
    }
    mw, nw = SELFTEST_WINDOW
    args = window_fixture(mw, nw, SELFTEST_HOMES, seed=11)
    try:
        check_window(lambda a, k: ik.fused_window(*a, k=k, **KW), args,
                     CHECK_EVERY, "doctor")
        kernels["fused_window"] = True
    except AssertionError:
        kernels["fused_window"] = False
    return {"ok": all(kernels.values()), "kernels": kernels,
            "library": "hit" if cached else "miss",
            "directory": kernel_cache.build_dir(),
            "shapes": {"band": [m, bw, SELFTEST_HOMES],
                       "window": [mw, nw, SELFTEST_HOMES]}}


def _check_cuda_kernels(timeout_s: float) -> dict:
    """The four CUDA kernels against their plain versions
    (:func:`cuda_kernel_selftest`) in a hard-timeouted subprocess."""
    code = ("import json\n"
            "from dragg_tpu_torch.doctor import cuda_kernel_selftest\n"
            "print('KERNELS ' + json.dumps(cuda_kernel_selftest()))\n")
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=timeout_s)
        line = next((l for l in (proc.stdout or "").splitlines()
                     if l.startswith("KERNELS ")), None)
        if proc.returncode != 0 or line is None:
            return {"status": FAIL, "error": (proc.stderr or "")[-300:]}
        rep = json.loads(line[len("KERNELS "):])
        return {"status": OK if rep["ok"] else FAIL,
                "kernels": rep["kernels"], "library": rep["library"],
                "directory": rep["directory"], "shapes": rep["shapes"]}
    except subprocess.TimeoutExpired:
        return {"status": FAIL,
                "error": f"kernel self-test hung >{timeout_s:.0f}s"}


def _check_outputs(outputs_dir: str) -> dict:
    try:
        os.makedirs(outputs_dir, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=outputs_dir, delete=True):
            pass
        return {"status": OK, "outputs_dir": os.path.abspath(outputs_dir)}
    except OSError as e:
        return {"status": FAIL, "error": repr(e)}


def _check_config() -> tuple[dict, dict | None]:
    try:
        from dragg_tpu_torch.config import configured_solver, load_config

        # Report what load_config actually resolves: the default path only
        # loads when the file exists (config.py load_config).
        path = os.path.join(os.path.expanduser(os.environ.get("DATA_DIR", "data")),
                            os.environ.get("CONFIG_FILE", "config.toml"))
        source = f"file:{path}" if os.path.exists(path) else "defaults"
        cfg = load_config(None)
        return {"status": OK, "source": source,
                "homes": cfg["community"]["total_number_homes"],
                "solver": configured_solver(cfg)}, cfg
    except Exception as e:
        return {"status": FAIL, "error": repr(e)}, None


def run_classify(backend_timeout: float = 60.0, stream=None) -> int:
    """``python -m dragg_tpu_torch doctor --classify``: one classified
    liveness verdict as a JSON line — NAMES the failure (resilience
    taxonomy: TUNNEL_DOWN / WEDGED / alive) instead of printing raw probe
    output, so operators and the runbook branch on a word, not a stderr
    tail.  Exit 0 = a CUDA device is up; 1 = it is not (kind says why)."""
    from dragg_tpu_torch.resilience.liveness import check_liveness

    stream = stream or sys.stdout
    r = check_liveness(backend_timeout)
    print(json.dumps(r._asdict()), file=stream)
    return 0 if r.alive else 1


def run_doctor(outputs_dir: str = "outputs", backend_timeout: float = 60.0,
               stream=None, compile_check: bool = False,
               shard_check: bool = False,
               telemetry_check: bool = False) -> int:
    stream = stream or sys.stdout
    config_res, cfg = _check_config()
    backend_res = _check_backend(backend_timeout)
    checks = {
        "config": config_res,
        "backend": backend_res,
        # The backend probe succeeding on "cpu" already proves CPU init.
        "cpu_fallback": ({"status": OK, "note": "backend probe ran on cpu"}
                         if backend_res.get("backend") == "cpu"
                         else _check_cpu_fallback(max(backend_timeout, 120.0))),
        "native_runtime": _check_native(),
        "data_files": _check_data(cfg),
        "outputs_writable": _check_outputs(outputs_dir),
        "telemetry": _check_telemetry(),
        "serve_journal": _check_serve_journal(),
    }
    if compile_check:
        checks["staged_compile"] = _check_staged_compile(
            max(backend_timeout, 300.0),
            "cuda" if backend_res.get("backend") == "cuda" else "cpu")
    if shard_check:
        checks["shard_journal"] = _check_shard_journal()
        checks["shard_wire"] = _check_shard_wire()
    if telemetry_check:
        checks["trace_plane"] = _check_trace_plane()
    # The CUDA kernels only matter when a card is up — and their check
    # builds or loads the kernel library and launches every kernel, so it
    # runs in a SUBPROCESS with the same hard timeout as the backend probe
    # (a card can hang between probes).  A failure is FAIL: no route
    # carries on without the kernels.
    if checks["backend"].get("backend") == "cuda":
        checks["cuda_kernels"] = _check_cuda_kernels(
            max(backend_timeout, 300.0))

    hard_fail = False
    cpu_only = False
    for name, res in checks.items():
        status = res["status"]
        # No card (the probe failed, or torch resolved to the CPU) with a
        # healthy CPU is WARN, as in the JAX doctor — but the port's entry
        # points default to the card and raise without one, so only runs
        # asked onto the CPU work, and the row and the verdict say so.
        if name == "backend" and res.get("backend") != "cuda" \
                and checks["cpu_fallback"]["status"] == OK:
            status = WARN
            cpu_only = True
            res = {**res, "note": "no card: only --device cpu / "
                                  "--platform cpu runs work"}
        hard_fail |= status == FAIL
        detail = {k: v for k, v in res.items() if k != "status"}
        print(f"  {name:18s} [{status:4s}] "
              f"{json.dumps(detail) if detail else ''}", file=stream)
    print(("DOCTOR: FAIL — see [FAIL] lines above" if hard_fail else
           "DOCTOR: environment usable"
           + (" on the CPU only (--device cpu / --platform cpu)"
              if cpu_only else "")), file=stream)
    return 1 if hard_fail else 0
