"""Staged warm-up observability (the counterpart of
``dragg_tpu/telemetry/compile_obs.py``, for eager PyTorch).

A serving worker's warm-up is split into three named stages, so that a
hang names its stage on the heartbeat and the supervisor's stall-kill
verdict says where the worker stopped, and so that the ready report says
whether the kernel library was built or loaded.  The JAX package's
stages are an AOT jit split (trace, XLA compile, first device run); the
port runs eagerly, so each stage maps onto what it does there:

    lower          the engine's device constants and its initial state
                   and solver carry, put on the device (the constants are
                   the engine's own, built on its device; the stage moves
                   the state there and builds the carry)
    compile        ``ops/cuda_lib.lib()``: the build (nvcc) or load of the
                   kernel library, on a CUDA device only.  No solver
                   captures a CUDA graph outside a step (the ADMM captures
                   its check window inside each solve), so the stage holds
                   no graph capture
    first_execute  the first ``engine.run_chunk`` at the fixed chunk shape
                   and a ``torch.cuda.synchronize``

Per stage: a heartbeat beat BEFORE the stage starts (a child that hangs
inside it leaves the stage name and the bucket shapes as its last
progress payload), a ``fault_hook("compile_<stage>")`` site, a
``compile.stage`` event and a ``compile.stage_s`` observation.

``cache`` says how the kernel library was had: ``hit`` when the
content-hashed ``libdraggkernels-<tag>.so`` existed in the library
directory before the compile stage, ``miss`` when nvcc built it there,
``unknown`` on the CPU, where no library is loaded.  The directory is
the counterpart of the JAX package's XLA persistent compile cache: the
engine's config places it (``tpu.compile_cache_dir``, else
``$DRAGG_COMPILE_CACHE_DIR``; ``kernel_cache.py``).

The returned ``runner`` re-runs ``engine.run_chunk`` at the fixed chunk
shape.
"""

from __future__ import annotations

import os
import time

from dragg_tpu_torch import telemetry

STAGES = ("lower", "compile", "first_execute")


def staged_compile(engine, state, t0: int, rps, label: str = "chunk"):
    """Lower → compile → first-execute ``engine``'s chunk program with
    per-stage telemetry, heartbeat and fault instrumentation (module
    docstring).  Returns ``(runner, state_out, outs, report)`` where
    ``runner(state, t0, rps)`` runs ``engine.run_chunk`` and ``report`` =
    {label, stages: {name: s}, cache: hit|miss|unknown, total_s,
    buckets}."""
    import torch

    from dragg_tpu_torch.ops import cuda_lib
    from dragg_tpu_torch.resilience.faults import fault_hook
    from dragg_tpu_torch.resilience.heartbeat import beat

    buckets = [dict(name=b["name"], n_slots=b["n_slots"], m_eq=b["m_eq"],
                    n_var=b["n_var"]) for b in engine.bucket_info()]
    bdesc = ",".join(f"{b['name']}[{b['n_slots']}x{b['m_eq']}]"
                     for b in buckets)
    dev = engine.device
    on_cuda = dev.type == "cuda"
    stages: dict[str, float] = {}

    def sync() -> None:
        if on_cuda:
            torch.cuda.synchronize(dev)

    def begin(stage: str) -> float:
        # Beat BEFORE the stage: if it hangs, this is the child's last
        # progress payload (stage + bucket attribution).
        beat({"stage": f"compile:{stage}", "label": label, "buckets": bdesc})
        fault_hook(f"compile_{stage}")
        return time.perf_counter()

    def end(stage: str, t_begin: float) -> None:
        s = time.perf_counter() - t_begin
        stages[stage] = round(s, 3)
        telemetry.observe("compile.stage_s", s)
        telemetry.emit("compile.stage", label=label, stage=stage,
                       s=round(s, 3), buckets=bdesc)

    tb = begin("lower")
    states = state if engine.bucketed else (state,)
    states = tuple(type(st)(*[v.to(dev) for v in st]) for st in states)
    state = states if engine.bucketed else states[0]
    engine.init_factor()
    sync()
    end("lower", tb)

    tb = begin("compile")
    if on_cuda:
        existed = os.path.exists(cuda_lib.library_path())
        cuda_lib.lib()
        cache = "hit" if existed else "miss"
    else:
        cache = "unknown"
    end("compile", tb)

    tb = begin("first_execute")
    state_out, outs = engine.run_chunk(state, t0, rps)
    sync()
    end("first_execute", tb)
    beat({"stage": "compile:done", "label": label})

    total = sum(stages.values())
    telemetry.emit("compile.done", label=label, total_s=round(total, 3),
                   cache=cache, stages=dict(stages), buckets=buckets)

    def runner(state, t0, rps):
        return engine.run_chunk(state, t0, rps)

    report = dict(label=label, stages=dict(stages), cache=cache,
                  total_s=round(total, 3), buckets=buckets)
    return runner, state_out, outs, report


def selftest(n_homes: int = 4, horizon: int = 2, steps: int = 2,
             device=None) -> dict:
    """Tiny end-to-end staged warm-up: builds a minimal community engine
    on ``device`` (None = the CUDA card), stages its chunk and returns the
    report with an ``ok`` verdict.  Synthetic data."""
    import numpy as np

    from dragg_tpu_torch.config import default_config
    from dragg_tpu_torch.data import load_environment, load_waterdraw_profiles
    from dragg_tpu_torch.engine import make_engine
    from dragg_tpu_torch.homes import build_home_batch, create_homes

    cfg = default_config()
    cfg["community"]["total_number_homes"] = n_homes
    cfg["community"]["homes_pv"] = 0
    cfg["home"]["hems"]["prediction_horizon"] = horizon
    env = load_environment(cfg, data_dir=None)
    wd = load_waterdraw_profiles(None, seed=12)
    homes = create_homes(cfg, 24, 1, wd)
    batch = build_home_batch(
        homes, max(1, horizon), 1,
        int(cfg["home"]["hems"]["sub_subhourly_steps"]))
    engine = make_engine(batch, env, cfg, 0, device=device)
    rps = np.zeros((steps, engine.params.horizon), np.float32)
    _runner, _state, outs, report = staged_compile(
        engine, engine.init_state(), 0, rps, label="selftest")
    report["ok"] = (all(s in report["stages"] for s in STAGES)
                    and bool(np.isfinite(float(outs.agg_load[0]))))
    return report
