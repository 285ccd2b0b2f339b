"""The port's CUDA band kernels on the card against their plain PyTorch
versions (bit for bit: both round every multiply and add separately).
Marked ``cuda``: they skip without a CUDA device; run them on the GPU with
``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import pytest
import torch

from dragg_tpu_torch.ops import band_kernels as bk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("bw", [1, 4, 12])
def test_kernels_match_plain_versions(card, bw):
    g = torch.Generator(device=card).manual_seed(bw)
    m, B = 29, 1001
    S = torch.zeros((B, m, bw + 1), device=card)
    S[:, :, 0] = 10.0 + torch.rand((B, m), device=card, generator=g)
    for k in range(1, bw + 1):
        S[:, k:, k] = 0.5 * torch.randn((B, m - k), device=card, generator=g)
    St = S.permute(1, 2, 0).contiguous()
    r = torch.randn((m, B), device=card, generator=g)
    bk.reset_launches()
    L = bk.banded_cholesky_t(St, bw)
    assert torch.equal(L, bk.cholesky_t_plain(St, bw))
    for refine in (0, 1):
        x = bk.refined_banded_solve_t(L, St, r, bw, refine)
        assert torch.equal(x, bk.refined_solve_t_plain(L, St, r, bw, refine))
        L2, x2 = bk.factor_refined_solve_t(St, r, bw, refine)
        assert torch.equal(L2, L) and torch.equal(x2, x)
    torch.cuda.synchronize()
    assert bk.LAUNCHES == {"banded_cholesky_t": 1, "refined_banded_solve_t": 2,
                           "factor_refined_solve_t": 2}
