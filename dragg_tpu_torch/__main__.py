"""CLI entry point of the PyTorch port.

    python -m dragg_tpu_torch run --outputs-dir D [--config F] [--device cuda|cpu]

runs the simulation cases the config enables (``Aggregator(...).run()``:
the baseline ``simulation.run_rbo_mpc``, the RL aggregator
``run_rl_agg`` and the RL agent against the simplified community
``run_rl_simplified``, with ``rl.parameters.agent`` "linear" or "ddpg")
on the CUDA card by default.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dragg_tpu_torch",
                                description="Community energy MPC simulator (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run the simulation cases the config enables")
    run.add_argument("--config", default=None, help="TOML config path (default: $DATA_DIR/$CONFIG_FILE)")
    run.add_argument("--data-dir", default=None, help="directory with nsrdb.csv / waterdraw profiles")
    run.add_argument("--outputs-dir", default="outputs")
    run.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from dragg_tpu_torch.aggregator import Aggregator

    agg = Aggregator(config=args.config, data_dir=args.data_dir,
                     outputs_dir=args.outputs_dir, device=args.device)
    agg.run()
    print(agg.run_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
