"""The port's ADMM band backend (``tpu.admm_solve_backend = "band"``: the
band Cholesky factor and the refined band solve, the CUDA kernels' route
"auto"/"pallas" and the plain "xla" route) on the CPU against the JAX
engine's band run, and the two routes bit for bit.  Tolerances: those of
tests/test_torch_engine_admm.py (its module docstring)."""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu_torch import engine as te  # noqa: E402
from tests.test_torch_engine_admm import (  # noqa: E402
    _compare,
    _config,
    _port_engine,
    _stepwise,
    jax_steps,
)


@pytest.mark.parametrize("band_kernel", ["auto", "xla"])
def test_band_backend_matches_jax(band_kernel):
    """``admm_solve_backend = "band"``: no dense inverse, the band factor
    carried (transposed under the kernels' route, "auto" here the plain
    versions on the CPU), four steps from the JAX state against the JAX
    engine's band run."""
    et = _port_engine(_config(admm_solve_backend="band", band_kernel=band_kernel))
    assert et.solve_backends == ["band"] * len(et.bucket_info())
    assert et.admm_band_kernel == band_kernel
    for f, ctx in zip(et.init_factor(), et._buckets):
        bw1 = et.bucket_info()[ctx.ordinal]["band_bw"] + 1
        want = (ctx.n, ctx.lay.m_eq, bw1) if band_kernel != "auto" else (ctx.lay.m_eq, bw1, ctx.n)
        assert tuple(f.Sinv.shape) == want
    j, t = _stepwise(et, jax_steps(4, admm_solve_backend="band"))
    _compare(j, t)


def test_band_kernel_route_bit_equal_to_plain():
    """The kernels' route ("pallas", the plain versions on the CPU in the
    transposed layout) and the "xla" route give the same bits through a
    chunk of a refresh and a stale-factor step."""
    outs = []
    for kern in ("pallas", "xla"):
        et = _port_engine(_config(admm_solve_backend="band", band_kernel=kern))
        outs.append(et.run_chunk(et.init_state(), 6, np.zeros((2, 4), np.float32))[1])
    for f in te.StepOutputs._fields:
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), f

