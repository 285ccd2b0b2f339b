"""Readings for the limits of ``correct``: for each seed, one run of a cell
(set-up and a window as a run makes them), then its compared numbers twice,
for the program and for the control, in one process.

    python3 perfbench/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

The control is the reference put in the program's place in bfloat16, the
precision below the configuration's float32: each step's outputs computed
from the same states and actions, and each sampled home's first action
from the reference's own solve, with every value stored in bfloat16
(products accumulated in float32), then clamped into its bounds as the
program's integer pin clamps its own.  Its numbers have to fail the limits;
the program's dozen seeds set the lower reading.  The benchmark's own runs
never run this.  One JSON line a seed on standard output.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seed: int, seconds: float, device=None, cfg_file=None,
             traffic=None, limits=None) -> dict:
    """The program's numbers and the control's for one seed."""
    from perfbench.harness import compare, inputs as inputs_mod, runner
    from perfbench.harness.system import System

    if cfg_file is None:
        _, cfg_file, traffic, limits, _ = runner.cell(workload)
    inp = inputs_mod.make_inputs(cfg_file, traffic, seed, runner.ROOT)
    system = System(cfg_file, traffic, inp, device=device)
    dev = "cuda" if system.device.type == "cuda" else "cpu"
    system.run_chunk(system.init_state(), 0, int(traffic["chunk_steps"]))
    records, _ = runner.window(system, traffic, seconds)
    del system
    cap = float(cfg_file["config"]["tpu"]["forecast_noise_cap"])
    out = {"seed": seed, "steps": sum(r["n"] for r in records)}
    for side, rnd in (("program", None), ("control", compare.bf16)):
        kw = {} if rnd is None else {"rnd": rnd}
        v = compare.judge(inp, records, seed, limits, cap, device=dev, **kw)
        out[side] = {k: c["value"] for k, c in v["checks"].items()}
        out[side + "_gap"] = {k: v["gap"].get(k) for k in ("n", "skipped", "unconverged", "outside",
                                                             "finite_worst", "median")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    os.environ["DRAGG_COMPILE_CACHE_DIR"] = os.path.join(ROOT, ".perfbench_cache", "kernels")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("perfbench control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(args.workload, seed, args.seconds, device=torch.device("cuda", 0))
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
