"""The port's mixed-precision policy (dragg_tpu_torch/ops/precision.py)
against the JAX package's (dragg_tpu/ops/precision.py) on the same numpy
inputs, for the three einsum specs the ReLU-QP solver contracts with.

Tolerances: the bf16 split is bit for bit (both round to nearest even);
the contractions agree to 1e-5 relative + 1e-5 absolute on O(1) operands
with 48-long sums (the two frameworks sum float32 products in another
order; bf16x3's products are exact in float32, so the same bound holds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one CPU thread per test process: xdist workers share the cores

from dragg_tpu.ops import precision as jp
from dragg_tpu_torch.ops import precision as tp

# (spec, shape of a, shape of b): the solver's matvec, transposed matvec
# and Gram product of the bank build.
SPECS = [
    ("bmn,bn->bm", (5, 33, 48), (5, 48)),
    ("bmn,bm->bn", (5, 48, 33), (5, 48)),
    ("bkm,bkn->bmn", (5, 48, 17), (5, 48, 17)),
]


@pytest.mark.parametrize("precision", ["f32", "bf16x3"])
@pytest.mark.parametrize("spec,sa,sb", SPECS)
def test_mxu_einsum_matches_jax(spec, sa, sb, precision):
    rng = np.random.RandomState(3)
    a = rng.randn(*sa).astype(np.float32)
    b = rng.randn(*sb).astype(np.float32)
    ref = np.asarray(jp.mxu_einsum(spec, jnp.asarray(a), jnp.asarray(b),
                                   precision=precision))
    out = tp.mxu_einsum(spec, torch.from_numpy(a), torch.from_numpy(b),
                        precision=precision)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_bf16x3_is_closer_to_f32_than_one_bf16_pass():
    """The split product recovers float32 accuracy that a single bf16
    product loses (the point of the three passes)."""
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.randn(8, 33, 48).astype(np.float32))
    b = torch.from_numpy(rng.randn(8, 48).astype(np.float32))
    exact = torch.einsum("bmn,bn->bm", a.double(), b.double())
    x3 = tp.mxu_einsum("bmn,bn->bm", a, b, precision="bf16x3").double()
    one = torch.einsum("bmn,bn->bm", a.bfloat16().float(), b.bfloat16().float()).double()
    assert (x3 - exact).abs().max() < 1e-2 * (one - exact).abs().max()


def test_split_bf16_bit_equal():
    rng = np.random.RandomState(5)
    x = (rng.randn(64, 48) * 10.0 ** rng.randint(-6, 6, (64, 48))).astype(np.float32)
    hj, lj = jp._split_bf16(jnp.asarray(x))
    ht, lt = tp._split_bf16(torch.from_numpy(x))
    assert ht.dtype == lt.dtype == torch.bfloat16
    np.testing.assert_array_equal(ht.float().numpy(), np.asarray(hj, np.float32))
    np.testing.assert_array_equal(lt.float().numpy(), np.asarray(lj, np.float32))


def test_f32_guard_and_registry():
    x = torch.zeros(3)
    assert tp.f32_guard(x, "x") is x
    for dtype in (torch.bfloat16, torch.float64, torch.float16):
        with pytest.raises(TypeError, match="float32"):
            tp.f32_guard(x.to(dtype), "x")
    assert tp.PRECISIONS == jp.PRECISIONS
    assert tp.validate_precision("bf16x3") == "bf16x3"
    with pytest.raises(ValueError, match="tpu.precision"):
        tp.validate_precision("fp8")
