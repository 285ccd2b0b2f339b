"""CLI entry point of the PyTorch port (the counterpart of
``dragg_tpu/__main__.py``).

    python -m dragg_tpu_torch run --outputs-dir D [--config F] [--device cuda|cpu]
    python -m dragg_tpu_torch run --supervised [--platform auto|cuda|cpu] [--deadline S]
    python -m dragg_tpu_torch reformat [--outputs-dir D] [--home NAME] [--no-save]
    python -m dragg_tpu_torch sweep [--horizons 2,4,8] [--no-figures]
    python -m dragg_tpu_torch dashboard [--outputs-dir D] [--port 8050]
    python -m dragg_tpu_torch serve [--serve-dir D] [--platform auto|cuda|cpu] [--port P] [--stub]
    python -m dragg_tpu_torch doctor [--outputs-dir D] [--backend-timeout S] [--classify]
                                     [--compile-check] [--shard-check] [--telemetry]
    python -m dragg_tpu_torch bench [--homes N] [--solver ipm|reluqp|admm|auto]
                                    [--platform auto|cuda|cpu] [--smoke] [...]

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
(:mod:`dragg_tpu_torch.parallel`): it joins the gloo group of the
ranks ``parallel.world.detect`` finds (``$DRAGG_COORDINATOR_ADDRESS``
with ``$DRAGG_NUM_PROCESSES`` and ``$DRAGG_PROCESS_ID``, torchrun, Open
MPI or SLURM, in that order; exit 2 with one line when none is there),
says on stderr what it found, and runs on the card of its local id
unless ``--device`` says otherwise.  The deployment files (an image,
an sbatch script) are in ``dragg_tpu_torch/deploy/``.  ``reformat``,
``sweep`` and ``dashboard`` read run trees (:mod:`~dragg_tpu_torch.reformat`,
:mod:`~dragg_tpu_torch.dashboard`); their figures need matplotlib.
``serve`` runs the MPC serving daemon (:mod:`dragg_tpu_torch.serve`):
this process stays free of torch and answers requests over HTTP from
warm engines in supervised worker children, on the card
(``--platform cuda``; ``auto`` degrades to the CPU when the CUDA probe
finds no card and ``serve.degrade_to_cpu`` allows it; ``cpu`` never
probes); ``--stub`` runs the protocol with arithmetic workers that
import no torch.  ``doctor`` diagnoses the environment
(:mod:`dragg_tpu_torch.doctor`: the CUDA probe, the CPU torch, the four
CUDA kernels against their plain versions when a card is up, the native
host runtime, data files, outputs, telemetry, the serve and shard
journals) without importing torch here.  ``bench`` runs the bench
harness (:mod:`dragg_tpu_torch.bench`, one JSON line: sim timesteps a
second of the 10,000-home community by default, measured in a supervised
child on the card) with every argument after ``bench`` passed on to it.
The shard coordinator is ``python -m dragg_tpu_torch.shard`` and its
reshard tool ``python -m dragg_tpu_torch.reshard_checkpoint``, as in the
JAX package; the tools ``fallback_forensics``, ``soak``, ``trace_view``
and ``bench_rl_fleet`` are ``python -m dragg_tpu_torch.<tool>``.
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

    srv = sub.add_parser(
        "serve",
        help="run the fault-tolerant MPC serving daemon (crash-safe request "
             "journal, supervised warm-engine worker pool, probe-gated "
             "admission with CUDA→CPU degradation)")
    srv.add_argument("--config", default=None, help="TOML config path")
    srv.add_argument("--serve-dir", default=os.path.join("outputs", "serve"),
                     help="journal + spool + telemetry directory (the "
                          "daemon's durable state; survives restarts)")
    srv.add_argument("--host", default=None, help="bind host (default: serve.host)")
    srv.add_argument("--port", type=int, default=None,
                     help="bind port (default: serve.port; 0 = ephemeral)")
    srv.add_argument("--platform", choices=["auto", "cuda", "cpu"], default="auto",
                     help="auto probes the card and degrades to the CPU when "
                          "it is gone; cuda is strict (429s while the probe "
                          "says no, unless serve.degrade_to_cpu); cpu skips "
                          "probing")
    srv.add_argument("--stub", action="store_true",
                     help="arithmetic workers that import no torch (the "
                          "protocol without the MPC)")

    doc = sub.add_parser("doctor", help="diagnose the environment (CUDA probe, "
                                        "kernels, native runtime, data files, "
                                        "outputs)")
    doc.add_argument("--outputs-dir", default="outputs")
    doc.add_argument("--backend-timeout", type=float, default=60.0)
    doc.add_argument("--classify", action="store_true",
                     help="one classified liveness verdict as a JSON line "
                          "(names the failure: TUNNEL_DOWN / WEDGED) "
                          "instead of the full check table")
    doc.add_argument("--compile-check", action="store_true",
                     help="additionally run a tiny engine's STAGED warm-up "
                          "(lower/compile/first-execute stage timings + the "
                          "kernel library's hit/miss verdict) in a "
                          "hard-timeouted subprocess")
    doc.add_argument("--shard-check", action="store_true",
                     help="additionally self-test the shard coordinator's "
                          "crash-safety substrate: journal torn-tail "
                          "truncation at every byte boundary, duplicate-"
                          "epoch refusal, and the wire's torn frames, "
                          "dedup and fence against a live loopback server")
    doc.add_argument("--telemetry", action="store_true",
                     help="additionally self-test the trace plane: a traced "
                          "run in a subprocess must assemble to one complete "
                          "causal tree, live-flush metrics.json mid-run, and "
                          "fold a rollup with Prometheus exposition")

    # ``bench`` takes its own parser's arguments (dragg_tpu_torch.bench),
    # which ``main`` passes on before this parser sees them.
    bench = sub.add_parser("bench", add_help=False,
                           help="the bench harness: one JSON line (python -m "
                                "dragg_tpu_torch bench --help for its options)")
    bench.add_argument("bench_args", nargs=argparse.REMAINDER)

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
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["bench"]:
        # Only the arguments after ``bench`` reach the harness's parser.
        from dragg_tpu_torch.bench import main as bench_main

        return bench_main(argv[1:])
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

            try:
                found = world.detect()
            except ValueError as e:
                print(e, file=sys.stderr)
                return 2
            if found is None:
                print(world.NO_CLUSTER, file=sys.stderr)
                return 2
            w = world.init_from_env()
            print(f"[run] {found.name}: rank {w.rank} of {w.size}, local id "
                  f"{w.local_rank}, coordinator {found.address or 'env://'}",
                  file=sys.stderr, flush=True)
            if device == "cuda":
                device = w.card()  # the rank's card, never another
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
    if args.cmd == "serve":
        # The serving parent stays torch-free for its whole life: every
        # device step runs in the worker pool's children, so a lost card
        # cannot hang the daemon that must classify and survive it.
        from dragg_tpu_torch.config import load_config
        from dragg_tpu_torch.resilience.supervisor import assert_parent_has_no_torch
        from dragg_tpu_torch.serve import run_serve

        assert_parent_has_no_torch()
        return run_serve(
            load_config(args.config), args.serve_dir, platform=args.platform,
            host=args.host, port=args.port, stub=args.stub,
            log=lambda m: print(f"[serve] {m}", file=sys.stderr, flush=True))
    if args.cmd == "doctor":
        # Torch-free here: every check that touches torch or the card runs
        # in a subprocess with a hard timeout.
        if args.classify:
            from dragg_tpu_torch.doctor import run_classify

            return run_classify(backend_timeout=args.backend_timeout)
        from dragg_tpu_torch.doctor import run_doctor

        return run_doctor(outputs_dir=args.outputs_dir,
                          backend_timeout=args.backend_timeout,
                          compile_check=args.compile_check,
                          shard_check=args.shard_check,
                          telemetry_check=args.telemetry)
    if args.cmd == "dashboard":
        from dragg_tpu_torch.dashboard import serve

        serve(config=args.config, outputs_dir=args.outputs_dir,
              port=args.port, host=args.host)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
