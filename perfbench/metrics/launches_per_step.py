"""Kernel launches a step: the kernels the profiler saw run on the card
over the traced episode, over its steps (engine step, host dispatch).
An exact count."""


def read(run):
    tr = run.trace
    if tr is None or not run.steps_traced:
        return None
    n = int(tr.is_kernel.sum())
    return n / run.steps_traced if n else None
