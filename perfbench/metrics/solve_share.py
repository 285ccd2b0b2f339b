"""The solve phase's share of one step, in percent: the step split by the
engine's phases (assemble, solve, merge and collect), each queued alone
and synchronized, timed by the host's clock."""


def read(run):
    phases = {k: v for k, v in run.spans.items() if k.startswith("phase.")}
    total = sum(phases.values())
    if "phase.solve" not in phases or total <= 0:
        return None
    return 100.0 * phases["phase.solve"] / total
