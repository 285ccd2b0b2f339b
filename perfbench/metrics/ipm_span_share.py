"""The interior point's share of a step, in percent: the host seconds of
the program's ``ipm.*`` spans (its full-batch loop and straggler tail, in
every bucket) over those of its ``engine.step_s`` spans, over every step
of the traced episode.  No sync is forced: each loop's iterations wait
for the card on their own."""

from perfbench.metrics import _program


def instrument(run):
    return _program.recorded(run)


def read(run):
    rec = _program.recording(run)
    if rec is None:
        return None
    step = _program.seconds(_program.spans(rec, "engine.step_s"))
    ipm = _program.spans(rec, "ipm.")
    if step <= 0 or not ipm:
        return None
    return 100.0 * _program.seconds(ipm) / step
