"""One run of one cell: set-up, the measured window, the traced chunks,
the comparison, and the result line.  ``perfbench/run.py`` calls
:func:`run_cell` after its look for the card; the tests call it on the
CPU at a small size.

The window runs a fixed **episode** (the traffic mix's ``episode_steps``
hourly steps from the configuration's start) in chunks of
``chunk_steps``; at each episode's end the community, and in RL cells the
agent, go back to their seeded starting state, so every run and every
commit simulates the same hours.  The window closes at the first
episode's end after ``seconds``, so its rate is always over whole
episodes; a chunk is complete once its outputs are on the host.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time

import numpy as np

from perfbench.harness import compare, inputs as inputs_mod, trace as trace_mod

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "perfbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "dragg_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(workload: str) -> tuple[dict, dict, dict, dict, list]:
    """(workload entry, configuration file, traffic mix, limits, per-layer
    metric entries of this cell) found by name through BENCHMARK.json."""
    manifest = load_json(ROOT, "BENCHMARK.json")
    wl = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == wl["config"])
    metrics = [m for m in manifest["per_layer"]
               if "workloads" not in m or workload in m["workloads"]]
    return (wl, load_json(ROOT, cfg_entry["file"]),
            load_json(BENCH, "traffic", wl["traffic"] + ".json"),
            load_json(BENCH, "limits", workload + ".json"), metrics)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold,
    compared whole: ``dragg_tpu_torch`` is not ``dragg_tpu``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What a per-layer reader reads: the trace of the traced episode (the
    card's activity), the benchmark's spans (seconds by name) and
    counters, and the window's per-step records.  ``labelled`` is the
    trace of the one chunk recorded with the host's activity too, which
    only labels the breakdown's idle gaps."""

    def __init__(self):
        self.trace = None
        self.labelled = None
        self.spans: dict = {}
        self.counters: dict = {}
        self.records: list = []
        self.steps_traced = 0


def window(system, traffic: dict, seconds: float, trace: bool = False, on_cuda: bool = False,
           hooks=(), run=None):
    """The measured window: chunks of the episode until the first episode
    end after ``seconds``; returns (records, seconds elapsed).  With
    ``trace`` the first episode runs under the profiler, recording the
    card's activity alone, and ``hooks`` (context managers of the
    per-layer readers), and at least one whole episode follows untraced;
    after the window one chunk more runs with the host's activity recorded
    too, whose heavier recording only labels the idle gaps.  Both traces
    go to ``run``."""
    import contextlib

    E, K = int(traffic["episode_steps"]), int(traffic["chunk_steps"])
    state = system.init_state()
    records, cursor = [], {"t": 0, "episode": 0}

    def chunk(state, traced=0):
        if cursor["t"] == E:
            state = system.init_state()
            cursor.update(t=0, episode=cursor["episode"] + 1)
        t0 = time.perf_counter()
        state, host = system.run_chunk(state, cursor["t"], K)
        records.append({"episode": cursor["episode"], "t0": cursor["t"], "n": K,
                        "host": host, "seconds": time.perf_counter() - t0, "traced": traced})
        cursor["t"] += K
        return state

    t_start = time.perf_counter()
    if trace:
        with contextlib.ExitStack() as stack:
            for hk in hooks:
                stack.enter_context(hk)
            box = stack.enter_context(trace_mod.profiled(on_cuda))
            t0 = time.perf_counter()
            for _ in range(E // K):
                state = chunk(state, traced=1)
            traced_s = time.perf_counter() - t0
        # The traced window is the episode's own span on the host's clock.
        run.trace = box[0]._replace(window_s=traced_s) if box else None
        run.steps_traced = (E // K) * K
    least = 2 * (E // K) if trace else 1
    while (len(records) < least or cursor["t"] < E
           or time.perf_counter() - t_start < seconds):
        state = chunk(state)
    elapsed = time.perf_counter() - t_start
    if trace:
        with trace_mod.profiled(on_cuda, host=True) as box:
            state = chunk(state, traced=2)
        run.labelled = box[0] if box else None
    return records, elapsed


def thread_cpu_s(top: int = 6) -> list:
    """[name, CPU seconds] of this process's busiest threads: the one
    launch loop should hold nearly all of it."""
    tick = os.sysconf("SC_CLK_TCK")
    out = []
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                st = f.read()
        except OSError:
            continue
        fields = st[st.rindex(")") + 2:].split()
        out.append([st[st.index("(") + 1:st.rindex(")")], (int(fields[11]) + int(fields[12])) / tick])
    return sorted(out, key=lambda r: -r[1])[:top]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_process: float,
             device=None, cfg_file=None, traffic=None, limits=None, metrics=None) -> dict:
    """One run; returns the result line's dict (its ``checks`` last)."""
    if cfg_file is None:
        _, c_file, t_file, l_file, m_list = cell(workload)
    else:
        c_file, t_file, l_file, m_list = cfg_file, traffic, limits, metrics
    import torch

    from perfbench.harness.system import System

    inp = inputs_mod.make_inputs(c_file, t_file, seed, ROOT)
    system = System(c_file, t_file, inp, device=device)
    on_cuda = system.device.type == "cuda"
    K = int(t_file["chunk_steps"])
    # Set-up ends with one untimed chunk, which loads (or builds) the
    # kernel library and warms every shape the window uses.
    system.run_chunk(system.init_state(), 0, K)
    system.sync()
    setup_s = time.perf_counter() - t_process

    run = Run()
    readers = [(m, importlib.import_module(f"perfbench.metrics.{m['name']}")) for m in m_list]
    hooks = []
    if trace:
        for _, mod in readers:
            if hasattr(mod, "instrument"):
                hooks.append(mod.instrument(run))
    records, elapsed = window(system, t_file, seconds, trace, on_cuda, hooks, run)
    system.sync()
    threads = thread_cpu_s()
    peak = int(torch.cuda.max_memory_allocated(system.device)) if on_cuda else 0
    run.records = records
    n_homes = len(inp["homes"]["type_code"])
    home_steps = sum(r["n"] for r in records) * n_homes
    failed = int(round(sum(float((1.0 - r["host"]["correct_solve"]).sum()) for r in records)))
    if trace:
        run.spans.update({f"phase.{k}": v for k, v in system.phase_split(
            system.init_state(), K).items()})
    device_info = {"platform": "gpu" if on_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(system.device) if on_cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    del system
    if on_cuda:
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": home_steps, "failed": failed}
    if trace:
        metrics_out = {}
        for m, mod in readers:
            v = mod.read(run)
            if v is not None:
                metrics_out[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = run.trace
        if tr is not None:
            busy, _, _ = trace_mod.busy_and_gaps(tr)
            device_info.update(busy_s=busy, window_s=tr.window_s)
            result["breakdown"] = trace_mod.breakdown(tr, run.labelled)
        result["metrics"] = metrics_out
    else:
        result["metrics"] = {
            "home_steps_per_s": {"value": home_steps / elapsed, "unit": "home-steps/s"},
            "peak_device_gib": {"value": peak / 2**30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    result["device"] = device_info
    verdict = compare.judge(inp, records, seed, l_file,
                            float(c_file["config"]["tpu"]["forecast_noise_cap"]),
                            device=("cuda" if on_cuda else "cpu"))
    result["correct"] = verdict["correct"]
    result["sample"] = {k: verdict["gap"][k] for k in ("n", "skipped", "unconverged", "outside")}
    # For a reader of the line (no metric reads these keys): each chunk's
    # hour, seconds, mean solver iterations and whether it ran traced (1:
    # the card's activity, 2: the host's too), and the busiest threads.
    result["chunks"] = [[r["t0"], r["seconds"], float(np.mean(r["host"]["admm_iters"])),
                         r["traced"]] for r in records]
    result["threads"] = threads
    result["checks"] = verdict["checks"]
    return result
