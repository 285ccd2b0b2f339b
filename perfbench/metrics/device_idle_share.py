"""The share of an episode's wall time in which no operation ran on the
card, in percent: one less the card's busy seconds over the traced
episode (the union of kernel, copy and set intervals from a trace of the
card's activity alone) over the mean wall time of the window's untraced
whole episodes, which run the same hours and the same kernels.  The
traced episode's own span is longer by the profiler's cost on the host,
so it is not the denominator."""

import numpy as np

from perfbench.harness.trace import busy_and_gaps


def read(run):
    tr = run.trace
    n = sum(1 for r in run.records if r["traced"] == 1)
    if tr is None or not n:
        return None
    busy, _, _ = busy_and_gaps(tr)
    episodes: dict = {}
    for r in run.records:
        episodes.setdefault(r["episode"], []).append(r)
    walls = [sum(r["seconds"] for r in rs) for rs in episodes.values()
             if len(rs) == n and not any(r["traced"] for r in rs)]
    if busy <= 0 or not walls:
        return None
    return 100.0 * (1.0 - busy / float(np.mean(walls)))
