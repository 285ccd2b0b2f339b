"""The benchmark of ``dragg_tpu_torch`` on an NVIDIA card: one run of one
cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It prints, as the last line of its
standard output, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``; with ``--trace 1`` also ``breakdown``; the
compared numbers with their limits last, under ``checks``), and the same
numbers as the last lines of its standard error.  ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics.  It
exits non-zero, printing no result, without a CUDA card, or if a module
of JAX or of the JAX package ``dragg_tpu`` is loaded once the window has
closed.  See ``perfbench/README.md``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".perfbench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every build and kernel cache of the program lives at a fixed path
    # inside the checkout, so only a checkout's first run builds.
    for var, sub in (("DRAGG_COMPILE_CACHE_DIR", "kernels"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    # One host thread for torch's CPU work: the step is paced by the host's
    # launch loop, which other threads would only crowd.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)

    from perfbench.harness import runner

    wl = runner.cell(args.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"perfbench: {args.workload} needs {wl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             T_PROCESS, device=torch.device("cuda", 0))
    if args.trace:
        result["device"]["power_limit_w"] = power_limit_w()
    bad = runner.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; the port must not", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def power_limit_w():
    """The card's power limit in W as nvidia-smi reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    sys.exit(main())
