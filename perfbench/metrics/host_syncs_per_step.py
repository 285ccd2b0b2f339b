"""Host syncs a step: the program's waits for the card over the traced
episode, as it counts them at each site (``ipm.host_syncs``: two an
interior-point iteration, one before each straggler tail and the solve's
index copies; ``engine.host_syncs``: the step path's other copies from
the host), over its steps (the program's ``engine.step_s`` spans).  An
exact count."""

from perfbench.metrics import _program

COUNTERS = ("ipm.host_syncs", "engine.host_syncs")


def instrument(run):
    return _program.recorded(run)


def read(run):
    rec = _program.recording(run)
    if rec is None:
        return None
    steps = _program.spans(rec, "engine.step_s")
    counted = [rec.counters[k] for k in COUNTERS if k in rec.counters]
    if not steps or not counted:
        return None
    return sum(counted) / len(steps)
