"""CLI entry point of the PyTorch port (the counterpart of
``dragg_tpu/__main__.py``).

    python -m dragg_tpu_torch run --outputs-dir D [--config F] [--device cuda|cpu]
    python -m dragg_tpu_torch run --supervised [--platform auto|cuda|cpu] [--deadline S]
    python -m dragg_tpu_torch reformat [--outputs-dir D] [--home NAME] [--no-save]
    python -m dragg_tpu_torch sweep [--horizons 2,4,8] [--no-figures]
    python -m dragg_tpu_torch dashboard [--outputs-dir D] [--port 8050]

``run`` runs the simulation cases the config enables
(``Aggregator(...).run()``: the baseline ``simulation.run_rbo_mpc``, the
RL aggregator ``run_rl_agg`` and the RL agent against the simplified
community ``run_rl_simplified``) on the CUDA card by default.  With
``--supervised`` this process stays free of torch and runs the
simulation in a supervised child (:mod:`dragg_tpu_torch.resilience`):
a deadline, heartbeat-stall detection, and on a card lost mid-run
(``resilience.degrade_to_cpu``) the same run resumed on the CPU from its
latest checkpoint; it prints one provenance JSON line.  With
``$DRAGG_DISTRIBUTED=1`` ``run`` is one rank of a sharded run
(:mod:`dragg_tpu_torch.parallel`): it joins a gloo group at
``tcp://$DRAGG_COORDINATOR_ADDRESS`` of ``$DRAGG_NUM_PROCESSES`` ranks as
``$DRAGG_PROCESS_ID`` (or torchrun's ``env://`` without the address), and
runs on its card, ``cuda:$LOCAL_RANK``, unless ``--device`` says
otherwise.  ``reformat``,
``sweep`` and ``dashboard`` read run trees (:mod:`~dragg_tpu_torch.reformat`,
:mod:`~dragg_tpu_torch.dashboard`); their figures need matplotlib.
``doctor``, ``serve``, ``shard`` and ``bench`` are not ported.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dragg_tpu_torch",
                                description="Community energy MPC simulator (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run the simulation cases the config enables")
    run.add_argument("--config", default=None, help="TOML config path (default: $DATA_DIR/$CONFIG_FILE)")
    run.add_argument("--data-dir", default=None, help="directory with nsrdb.csv / waterdraw profiles")
    run.add_argument("--outputs-dir", default="outputs")
    run.add_argument("--device", default=None, choices=["cuda", "cpu"],
                     help="unsupervised mode only: the device the run uses "
                          "(default cuda)")
    run.add_argument("--supervised", action="store_true",
                     help="run the simulation in a supervised child process "
                          "(hard deadline, heartbeat-stall detection, "
                          "checkpointed CUDA→CPU degradation on a card lost "
                          "mid-run); prints one provenance JSON line")
    run.add_argument("--platform", choices=["auto", "cuda", "cpu"], default=None,
                     help="supervised mode only: the devices the run may use "
                          "(default auto; neither auto nor cuda degrades to "
                          "the CPU without having acquired the card)")
    run.add_argument("--deadline", type=float, default=None,
                     help="supervised mode only: per-attempt hard deadline "
                          "in seconds (default: resilience.deadline_s)")

    ref = sub.add_parser("reformat", help="discover finished runs and build comparison figures")
    ref.add_argument("--config", default=None)
    ref.add_argument("--outputs-dir", default=None, help="default: $OUTPUT_DIR or ./outputs")
    ref.add_argument("--home", default=None, help="sample home name for per-home plots")
    ref.add_argument("--no-save", action="store_true", help="don't write PNGs")

    sweep = sub.add_parser(
        "sweep",
        help="run a prediction-horizon sweep and compare the runs "
             "(the reference paper's horizon study)")
    sweep.add_argument("--horizons", default="2,4,8",
                       help="comma-separated prediction horizons (hours)")
    sweep.add_argument("--config", default=None)
    sweep.add_argument("--data-dir", default=None)
    sweep.add_argument("--outputs-dir", default="outputs")
    sweep.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sweep.add_argument("--no-figures", action="store_true")

    dash = sub.add_parser("dashboard", help="serve the results dashboard over HTTP")
    dash.add_argument("--config", default=None)
    dash.add_argument("--outputs-dir", default=None, help="default: $OUTPUT_DIR or ./outputs")
    dash.add_argument("--port", type=int, default=8050)
    dash.add_argument("--host", default="127.0.0.1")
    return p


def run_sweep(args) -> int:
    """Prediction-horizon sweep: one full run per horizon, then the
    parametric comparison over all of them (the JAX package's
    ``run_sweep``; the reference paper's horizon study through the
    workflow the reference ships commented out in main.py:9-19).  Prints
    a per-horizon table and, unless ``--no-figures``, saves the
    parametric comparison figures."""
    import copy

    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.config import load_config
    from dragg_tpu_torch.reformat import Reformat

    try:
        horizons = sorted({int(h) for h in str(args.horizons).split(",") if h.strip()})
    except ValueError:
        print(f"sweep: --horizons must be comma-separated integers, got "
              f"{args.horizons!r}", file=sys.stderr)
        return 1
    if not horizons or min(horizons) < 1:
        print("sweep: need at least one horizon >= 1", file=sys.stderr)
        return 1
    base_cfg = load_config(args.config)
    for h in horizons:
        cfg = copy.deepcopy(base_cfg)
        cfg["home"]["hems"]["prediction_horizon"] = h
        Aggregator(cfg, data_dir=args.data_dir, outputs_dir=args.outputs_dir,
                   device=args.device).run()

    # Discovery permutes over value sets: extend the horizon axis to the
    # sweep and discover again (dragg/reformat.py:86-99).
    r = Reformat(config=base_cfg, outputs_dir=args.outputs_dir)
    r.mpc_params["mpc_prediction_horizons"] = set(horizons)
    r.mpc_folders = r.set_mpc_folders()
    r.files = r.set_files()

    rows = []
    for file in r.files:
        s = r._load(file["results"])["Summary"]  # warms the figure cache too
        rows.append((s.get("horizon"), s.get("solve_time"),
                     s.get("p_max_aggregate"), file["case"]))
    print(f"{'horizon':>8} {'solve_time_s':>13} {'p_max_kW':>10}  case")
    for h, st, pmax, case in sorted(rows, key=lambda x: (x[0] or 0)):
        print(f"{h!s:>8} {st:13.2f} {pmax:10.2f}  {case}")

    if not args.no_figures:
        r.save_images([("parametric", r.plot_parametric()),
                       ("typical_day", r.plot_typ_day()),
                       ("max_and_12hravg", r.plot_max_and_12hravg())])
    return 0


def run_supervised_cli(args) -> int:
    """``run --supervised``: this process never imports torch; the
    simulation runs in supervised children (resilience/runner.py)."""
    import json

    from dragg_tpu_torch import telemetry
    from dragg_tpu_torch.config import load_config
    from dragg_tpu_torch.resilience.runner import run_dir_for, supervised_sim_run
    from dragg_tpu_torch.resilience.supervisor import assert_parent_has_no_torch

    assert_parent_has_no_torch()
    config = load_config(args.config)
    if args.data_dir is not None:
        os.environ["DATA_DIR"] = args.data_dir
    # One event stream for the whole supervised run: the parent opens the
    # bus on the run directory, so its probe, supervisor and degradation
    # events interleave with the child's records in one events.jsonl.
    # The child writes the run's metrics.json.
    tel = config.get("telemetry", {})
    if tel.get("enabled", True):
        telemetry.init_run(tel.get("dir") or os.environ.get(telemetry.ENV_DIR)
                           or run_dir_for(config, args.outputs_dir))
    try:
        provenance = supervised_sim_run(
            config, args.outputs_dir, platform=args.platform or "auto",
            deadline_s=args.deadline,
            log=lambda m: print(f"[supervised] {m}", file=sys.stderr, flush=True))
    finally:
        telemetry.close_run()
    print(json.dumps(provenance))
    return 0 if provenance["completed"] else 1


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cmd == "run":
        # One flag for each decision: --device picks the unsupervised run's
        # device, --platform the supervised run's.
        if args.supervised and args.device is not None:
            parser.error("run: --device is for unsupervised runs; "
                         "with --supervised use --platform")
        if not args.supervised and (args.platform, args.deadline) != (None, None):
            parser.error("run: --platform and --deadline need --supervised")
        distributed = os.environ.get("DRAGG_DISTRIBUTED") == "1"
        if args.supervised and distributed:
            parser.error("run: --supervised runs one process; a sharded run "
                         "($DRAGG_DISTRIBUTED=1) is not supervised")
    if args.cmd == "run" and args.supervised:
        return run_supervised_cli(args)
    if args.cmd == "run":
        device = args.device or "cuda"
        if distributed:
            # One rank of a sharded run: every rank runs this command.
            from dragg_tpu_torch.parallel import world

            missing = world.missing_env()
            if missing:
                print(world.missing_env_message(missing), file=sys.stderr)
                return 2
            if world.init_from_env().size > 1 and device == "cuda":
                device = None  # the rank's card, cuda:$LOCAL_RANK
        from dragg_tpu_torch.aggregator import Aggregator

        try:
            agg = Aggregator(config=args.config, data_dir=args.data_dir,
                             outputs_dir=args.outputs_dir, device=device)
            agg.run()
        finally:
            if distributed:
                world.shutdown()
        print(agg.run_dir)
        return 0
    if args.cmd == "reformat":
        from dragg_tpu_torch.reformat import Reformat

        r = Reformat(config=args.config, outputs_dir=args.outputs_dir)
        if args.home:
            r.sample_home = args.home
        r.main(save=not args.no_save)
        return 0
    if args.cmd == "sweep":
        return run_sweep(args)
    if args.cmd == "dashboard":
        from dragg_tpu_torch.dashboard import serve

        serve(config=args.config, outputs_dir=args.outputs_dir,
              port=args.port, host=args.host)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
