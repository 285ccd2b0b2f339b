"""The card's idle milliseconds inside the interior point, a step: the
idle stretches of the traced episode's device trace (between its kernels,
copies and sets) cut to the program's ``ipm.*`` spans on the shared
clock, over the episode's steps (``engine.step_s`` spans).  None without
device activity in the trace."""

import numpy as np

from perfbench.harness.trace import busy_and_gaps
from perfbench.metrics import _program


def instrument(run):
    return _program.recorded(run)


def idle_inside(g0, glen, starts, ends) -> float:
    """Seconds of the idle stretches (``g0``, ``glen``: sorted, disjoint)
    that lie inside the disjoint intervals [``starts``, ``ends``]."""
    if not len(g0):
        return 0.0
    before = np.concatenate([[0.0], np.cumsum(glen)])

    def idle_until(t):
        j = np.searchsorted(g0, t, side="right") - 1
        k = np.maximum(j, 0)
        part = np.clip(t - g0[k], 0.0, glen[k])
        return np.where(j >= 0, before[k] + part, 0.0)

    return float(np.sum(idle_until(ends) - idle_until(starts)))


def read(run):
    rec, tr = _program.recording(run), run.trace
    if rec is None or tr is None:
        return None
    steps = _program.spans(rec, "engine.step_s")
    ipm = _program.spans(rec, "ipm.")
    _, g0, glen = busy_and_gaps(tr)
    if not steps or not ipm or not len(glen):
        return None
    starts = np.array([r["start_ns"] for r in ipm], dtype=np.float64) * 1e-9
    ends = np.array([r["end_ns"] for r in ipm], dtype=np.float64) * 1e-9
    return 1e3 * idle_inside(g0, glen, starts, ends) / len(steps)
