"""Where one engine step's time goes on the GPU.

    python -m dragg_tpu_torch.profile_step [--homes 10000] [--steps 3]

Builds the mixed community (the legacy bench mix: 40 % pv_only, 10 %
battery_only, 10 % pv_battery, the rest base; 24 h horizon), runs one
warm-up step, then times ``--steps`` engine steps with the host clock
(synchronised, profiler off) and traces ``--steps`` more with
``torch.profiler``.  Prints one JSON
object: seconds per step, device kernel time per step (total, the band
kernels, the rest), kernel launches per step, the device's busy share of
the step, and the top kernels by device time.  The full table goes to
``chiprun_out/profile_step.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dragg_tpu_torch.profile_step")
    p.add_argument("--homes", type=int, default=10_000)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.config import mixed_community_config

    n = args.homes
    cfg = mixed_community_config(n, 24, "2015-01-02 00")
    with tempfile.TemporaryDirectory() as d:
        agg = Aggregator(cfg, outputs_dir=d, device="cuda")
        agg.get_homes()
        agg._build_engine()
    eng = agg.engine
    rp = np.zeros(eng.params.horizon, np.float32)
    state, _ = eng.step(eng.init_state(), 0, rp)        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(1, 1 + args.steps):
        state, out = eng.step(state, t, rp)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps       # profiler off
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(1 + args.steps, 1 + 2 * args.steps):
            state, out = eng.step(state, t, rp)
        torch.cuda.synchronize()

    kernels = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type.name == "CUDA":
            kernels.append((evt.key, us / args.steps, evt.count / args.steps))
    kernels.sort(key=lambda k: -k[1])
    total_ms = sum(k[1] for k in kernels) / 1e3
    band_ms = sum(k[1] for k in kernels if any(
        b in k[0] for b in ("chol_kernel<", "refined_solve_kernel<",
                            "factor_solve_kernel<"))) / 1e3
    launches = sum(k[2] for k in kernels)
    result = dict(
        card=torch.cuda.get_device_name(0), homes=n, steps=args.steps,
        s_per_step=wall, device_ms_per_step=total_ms, band_kernel_ms_per_step=band_ms,
        other_kernel_ms_per_step=total_ms - band_ms, kernel_launches_per_step=launches,
        device_busy_share=total_ms / 1e3 / wall,
        solve_rate=float(out.correct_solve.float().mean()),
        top=[dict(name=k[0][:90], ms_per_step=k[1] / 1e3, calls_per_step=k[2])
             for k in kernels[:15]],
    )
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_step.json"), "w") as f:
        json.dump(dict(result, all=[list(k) for k in kernels]), f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
