"""The port's CUDA kernels on the card against their plain PyTorch
versions: the band kernels bit for bit (both round every multiply and add
separately), the fused ReLU-QP window to float32 sum-order rounding.
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


@pytest.mark.parametrize("m,n,B", [(9, 21, 1001), (77, 221, 64), (52, 148, 300),
                                   (100, 292, 40), (149, 437, 37)])
def test_fused_window_matches_plain_version(card, m, n, B):
    """The fused ReLU-QP window against its plain version on a consistent
    fixture (S⁻¹ the inverse of Â D⁻¹ Âᵀ): rtol 1e-3 / atol 1e-4, the sums
    being taken in another order; any slice of homes reproduces the full
    batch bit for bit.  The shapes cover Â held in registers (m = 52 and
    77, the H = 24 buckets), in shared memory (the H = 48 pv_only bucket)
    and split over a cluster of two blocks (the H = 48 pv_battery
    bucket)."""
    from dragg_tpu_torch.ops import iter_kernels as ik

    g = torch.Generator(device=card).manual_seed(m)
    rnd = lambda *s: torch.rand(s, device=card, generator=g)  # noqa: E731
    A = (torch.randn((B, m, n), device=card, generator=g) * 0.5)
    w = 0.5 + rnd(B, n)
    rho = torch.full((B,), 0.4, device=card)
    pd = torch.full((B, n), 1e-3, device=card)
    Dinv = 1.0 / (pd + 1e-6 + rho[:, None] * w * w)
    S = torch.einsum("bmn,bn,bkn->bmk", A.double(), Dinv.double(), A.double())
    Sinv = torch.linalg.inv(S + 1e-4 * torch.eye(m, device=card, dtype=torch.float64))
    Sinv = Sinv.float().contiguous()
    ls, us = -1.0 - rnd(B, n), 1.0 + rnd(B, n)
    args = (A, Sinv, Dinv, w, torch.randn((B, n), device=card, generator=g),
            torch.randn((B, m), device=card, generator=g), ls, us, rho,
            0.1 * torch.randn((B, n), device=card, generator=g),
            torch.minimum(torch.maximum(torch.randn((B, n), device=card, generator=g), ls), us),
            0.1 * torch.randn((B, m), device=card, generator=g),
            0.1 * torch.randn((B, n), device=card, generator=g),
            0.5 + rnd(B, m), 0.5 + rnd(B, n), 0.5 + rnd(B, n), pd)
    ik.reset_launches()
    for k in (1, 25):
        out = ik.fused_window(*args, k=k, sigma=1e-6, alpha=1.6)
        ref = ik.fused_window_plain(*args, k=k, sigma=1e-6, alpha=1.6)
        for a, b in zip(out[0] + out[1], ref[0] + ref[1]):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)
            assert torch.isfinite(a).all()
        part = ik.fused_window(*(a[3:17].contiguous() for a in args), k=k,
                               sigma=1e-6, alpha=1.6)
        for a, b in zip(part[0] + part[1], out[0] + out[1]):
            assert torch.equal(a, b[3:17])
    torch.cuda.synchronize()
    assert ik.LAUNCHES == {"fused_window": 4}
