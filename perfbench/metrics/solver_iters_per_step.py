"""Interior-point iterations a step: the mean over the window's steps of
the step's solver iterations as the program reports them (the binding
bucket's count, ``StepOutputs.admm_iters``)."""

import numpy as np


def read(run):
    iters = [np.asarray(r["host"]["admm_iters"], dtype=np.float64) for r in run.records]
    if not iters:
        return None
    return float(np.concatenate(iters).mean())
