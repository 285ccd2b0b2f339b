"""The port's engine under scenario events with ReLU-QP on the lax route,
against the JAX engine: tests/test_torch_scenario_runs.py's 12-home event
run at H = 4 over the 6 steps that reach the outage, flags equal and
every series within 1e-4 on every home-step.  36 of the port's 72
home-steps stop below the banked loop's 250-iteration cap, the rest in
the exact tail (where the two packages' buckets part by up to 25
iterations, and their homes agree within 4.7e-5 all the same)."""

import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from test_torch_scenario_runs import check_event_run


def test_event_run_matches_jax_reluqp():
    iters = check_event_run("reluqp", 4, 6)
    assert (iters < 250).sum() >= 36
