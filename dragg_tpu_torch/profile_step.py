"""Where the engine's step time goes on the GPU.

    python -m dragg_tpu_torch.profile_step [--homes 10000] [--steps 8]
                                           [--solver ipm|reluqp|admm]
                                           [--admm-backend auto|dense_inv|band]
                                           [--pack stress_dr_outage]
                                           [--communities 4]

Builds the mixed community (the legacy bench mix: 40 % pv_only, 10 %
battery_only, 10 % pv_battery, the rest base; 24 h horizon) and steps it
through ``Engine.run_chunk``, as the aggregator does: a warm-up chunk of
``--steps`` steps from t = 0, a chunk of ``--steps`` more timed with the
host clock (synchronised, profiler off), and a third traced with
``torch.profiler``.  Each chunk starts a fresh solver carry, so with
``--steps`` equal to ``admm_refactor_every`` (8, the default) each timed
chunk holds exactly one ReLU-QP rho-bank refresh, the main path's
cadence (t = 0, 8 and 16 of the day), and the ADMM's factor refresh
likewise.  ``--solver reluqp`` runs the fused window kernel
(``tpu.iter_kernel = "pallas"``); ``--solver admm`` the ADMM on
``--admm-backend`` (``tpu.admm_solve_backend``; "band" runs the band
kernels).  ``--pack`` runs a
scenario pack's mix and events (``tpu.fix_tou_peak`` on), ``--communities``
a fleet of that many communities of ``--homes / communities`` homes, 24 h
of weather apart (the fleet of ``chip_smoke.py`` phase 13).

Prints one JSON object: seconds per step, device kernel time per step
(total; the band kernels; the fused window; the rho-bank build, from its
profiler range; the ADMM's factorizations, from theirs, with their
launches and count per step: under the dense inverse each is a band
Cholesky and a banded forward solve against I, ``banded_explicit_inverse``),
kernel launches per step, the device's busy share of the
step, and the top kernels by device time.  The full table goes to
``chiprun_out/profile_step_<solver>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

BAND_KERNELS = ("chol_kernel<", "refined_solve_kernel<", "factor_solve_kernel<")
WINDOW_KERNEL = "fused_window_kernel"


def _device_us(evt, attrs=("self_device_time_total", "self_cuda_time_total")) -> float:
    for attr in attrs:
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dragg_tpu_torch.profile_step")
    p.add_argument("--homes", type=int, default=10_000)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--solver", choices=("ipm", "reluqp", "admm"), default="ipm")
    p.add_argument("--admm-backend", choices=("auto", "dense_inv", "band"), default="auto")
    p.add_argument("--pack", default="")
    p.add_argument("--communities", type=int, default=1)
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.config import mixed_community_config
    from dragg_tpu_torch.ops.admm import FACTOR_RANGE
    from dragg_tpu_torch.ops.reluqp import BANK_BUILD_RANGE

    n, k, c = args.homes, args.steps, args.communities
    cfg = mixed_community_config(n // c, 24, "2015-01-02 00", iter_kernel="pallas",
                                 fix_tou_peak=bool(args.pack))
    cfg["home"]["hems"]["solver"] = args.solver
    cfg["tpu"]["admm_solve_backend"] = args.admm_backend
    cfg["scenarios"]["pack"] = args.pack
    cfg["fleet"].update(communities=c, weather_offset_hours=24 if c > 1 else 0)
    with tempfile.TemporaryDirectory() as d:
        agg = Aggregator(cfg, outputs_dir=d, device="cuda")
        agg.get_homes()
        agg._build_engine()
    eng = agg.engine
    rps = np.zeros((k, eng.params.horizon), np.float32)
    state, _ = eng.run_chunk(eng.init_state(), 0, rps)       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = eng.run_chunk(state, k, rps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / k                    # profiler off
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, out = eng.run_chunk(state, 2 * k, rps)
        torch.cuda.synchronize()

    def launched(e) -> list:
        return list(e.kernels) + [k for c in e.cpu_children for k in launched(c)]

    factor_kernels = [k for e in prof.events() if e.name == FACTOR_RANGE for k in launched(e)]
    n_factors = sum(e.name == FACTOR_RANGE for e in prof.events())
    kernels, bank_us = [], 0.0
    for evt in prof.key_averages():
        if evt.key in (BANK_BUILD_RANGE, FACTOR_RANGE):
            # A range's device span, not a kernel: the time of the kernels
            # launched inside it.
            if evt.key == BANK_BUILD_RANGE:
                bank_us = _device_us(evt, ("device_time_total", "cuda_time_total"))
            continue
        us = _device_us(evt)
        if us > 0 and evt.device_type.name == "CUDA":
            kernels.append((evt.key, us / k, evt.count / k))
    kernels.sort(key=lambda e: -e[1])
    total_ms = sum(e[1] for e in kernels) / 1e3
    band_ms = sum(e[1] for e in kernels if any(b in e[0] for b in BAND_KERNELS)) / 1e3
    window_ms = sum(e[1] for e in kernels if WINDOW_KERNEL in e[0]) / 1e3
    result = dict(
        card=torch.cuda.get_device_name(0), homes=n // c * c, communities=c,
        pack=args.pack or None, steps=k, solver=args.solver,
        iter_kernel=eng.iter_kernel if args.solver == "reluqp" else None,
        s_per_step=wall, device_ms_per_step=total_ms, band_kernel_ms_per_step=band_ms,
        fused_window_ms_per_step=window_ms,
        fused_window_share=window_ms / total_ms if total_ms else 0.0,
        bank_build_ms_per_step=bank_us / k / 1e3 if bank_us else "not measured",
        admm_backends=eng.solve_backends if args.solver == "admm" else None,
        admm_factors_per_step=n_factors / k,
        admm_factor_launches_per_step=len(factor_kernels) / k,
        admm_factor_ms_per_step=sum(x.duration for x in factor_kernels) / k / 1e3,
        other_kernel_ms_per_step=total_ms - band_ms - window_ms,
        kernel_launches_per_step=sum(e[2] for e in kernels),
        device_busy_share=total_ms / 1e3 / wall,
        solve_rate=float(out.correct_solve.float().mean()),
        iterations_per_step=[int(v) for v in out.admm_iters.cpu()],
        top=[dict(name=e[0][:90], ms_per_step=e[1] / 1e3, calls_per_step=e[2])
             for e in kernels[:15]],
    )
    os.makedirs("chiprun_out", exist_ok=True)
    tag = (args.solver + (f"_{args.admm_backend}" if args.solver == "admm" else "")
           + (f"_{args.pack}" if args.pack else "") + (f"_c{c}" if c > 1 else ""))
    with open(os.path.join("chiprun_out", f"profile_step_{tag}.json"), "w") as f:
        json.dump(dict(result, all=[list(e) for e in kernels]), f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
