"""Block cyclic reduction for the banded Schur systems (counterpart of
``dragg_tpu/ops/block_cr.py``; ``tpu.band_kernel = "cr"``).

The RCM-permuted band matrix of bandwidth ``bw`` is read as a
block-tridiagonal matrix of (bw, bw) blocks, and each level eliminates the
odd blocks: the serial chain shrinks from ``m`` dependent rows to
``ceil(log2(m/bw))`` levels of batched (bw, bw) products and Cholesky
solves.  With A_t = U_{2t} and B_t = U_{2t+1} (hats: odd-block
quantities),

    D'_t = D_t − A_t D̂_t⁻¹ A_tᵀ − B_{t−1}ᵀ D̂_{t−1}⁻¹ B_{t−1}
    U'_t = −A_t D̂_t⁻¹ B_t
    r'_t = r_t − A_t D̂_t⁻¹ r̂_t − B_{t−1}ᵀ D̂_{t−1}⁻¹ r̂_{t−1}
    x̂_t  = D̂_t⁻¹ (r̂_t − A_tᵀ x'_t − B_t x'_{t+1})

recursing on the even half until one block remains.  The reduction is
exact; in float32 its elimination order differs from the sequential band
Cholesky, so results agree to rounding.  Plain PyTorch in the JAX
package's ``(B, m, bw+1)`` band layout; ``band_kernels.make_band_ops``
hands it views of the transposed band, with no copy.

A block that is not positive definite gives a NaN factor, as
``jnp.linalg.cholesky`` does (``cholesky_ex`` would leave a finite partial
factor).
"""

from __future__ import annotations

import torch


def _cholesky(X: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky factor, NaN where a block is not positive definite."""
    L, info = torch.linalg.cholesky_ex(X)
    return torch.where((info != 0)[..., None, None], float("nan"), L)


def _tri_solve(L: torch.Tensor, X: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """L⁻¹X, or L⁻ᵀX with ``trans``, for a batched Cholesky factor L."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, X, upper=True)
    return torch.linalg.solve_triangular(L, X, upper=False)


def _spd_solve(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ X for batched blocks."""
    return _tri_solve(L, _tri_solve(L, X), trans=True)


def band_to_blocktri(Sb: torch.Tensor, bw: int):
    """Band storage (B, m, bw+1), ``Sb[:, i, d] = S[i, i−d]`` →
    block-tridiagonal ``(D, U, N, mp)``: D (B, N, s, s) diagonal blocks, U
    (B, N−1, s, s) upper couplings, s = bw, N = ceil(m/s), mp = N·s.  Rows
    beyond m are identity (decoupled)."""
    B, m, _ = Sb.shape
    s = bw
    N = -(-m // s)
    mp = N * s
    padded = Sb.new_zeros((B, mp, bw + 1))
    padded[:, :m] = Sb
    padded[:, m:, 0] = 1.0
    # D_k[a, b] = S[ks+a, ks+b], read symmetrically from the lower band.
    D = Sb.new_zeros((B, N, s, s))
    for a in range(s):
        for b in range(s):
            D[:, :, a, b] = padded[:, a::s, a - b] if a >= b else padded[:, b::s, b - a]
    # U_k[a, b] = S[ks+a, (k+1)s+b]: in the band iff b ≤ a.
    U = Sb.new_zeros((B, max(N - 1, 0), s, s))
    for a in range(s):
        for b in range(a + 1):
            U[:, :, a, b] = padded[:, (s + b)::s, s + b - a][:, :N - 1]
    return D, U, N, mp


def cr_factor(Sb: torch.Tensor, bw: int) -> dict:
    """The multilevel cyclic-reduction factor of the SPD band matrix: an
    opaque dict read by :func:`cr_solve`."""
    D, U, N, mp = band_to_blocktri(Sb, bw)
    levels = []
    while N > 1:
        n_odd = N // 2            # odd blocks 1, 3, …
        n_b = (N - 1) // 2        # odd blocks with an even block to the right
        A = U[:, 0::2]                                    # (B, n_odd, s, s)
        Bc = U[:, 1::2]                                   # (B, n_b, s, s)
        Lod = _cholesky(D[:, 1::2])
        DinvAT = _spd_solve(Lod, A.mT)
        DinvB = _spd_solve(Lod[:, :n_b], Bc)
        Dev = D[:, 0::2].clone()
        Dev[:, :n_odd] += -torch.einsum("bnij,bnjk->bnik", A, DinvAT)
        Dev[:, 1:1 + n_b] += -torch.einsum("bnji,bnjk->bnik", Bc, DinvB)
        levels.append(dict(Lod=Lod, A=A, B=Bc,
                           GA=DinvAT.mT,      # A D̂⁻¹
                           GBT=DinvB.mT))     # Bᵀ D̂⁻¹
        U = -torch.einsum("bnij,bnjk->bnik", A[:, :n_b], DinvB)
        D = Dev
        N = D.shape[1]
    levels.append(_cholesky(D[:, 0]))
    return dict(levels=levels, mp=mp, bw=bw)


def cr_solve(factor: dict, r: torch.Tensor) -> torch.Tensor:
    """S x = r with a CR factor; r is (B, m) in the band storage's
    (permuted) row order."""
    levels, mp, s = factor["levels"], factor["mp"], factor["bw"]
    B, m = r.shape
    rb = r.new_zeros((B, mp))
    rb[:, :m] = r
    rb = rb.reshape(B, mp // s, s)

    stack = []
    for lv in levels[:-1]:
        n_odd, n_b = lv["A"].shape[1], lv["B"].shape[1]
        rod = rb[:, 1::2]
        rev = rb[:, 0::2].clone()
        rev[:, :n_odd] += -torch.einsum("bnij,bnj->bni", lv["GA"], rod)
        rev[:, 1:1 + n_b] += -torch.einsum("bnij,bnj->bni", lv["GBT"], rod[:, :n_b])
        stack.append(rod)
        rb = rev

    x = _spd_solve(levels[-1], rb[:, 0, :, None])[:, :, 0][:, None]
    for lv, rod in zip(reversed(levels[:-1]), reversed(stack)):
        n_odd, n_b = lv["A"].shape[1], lv["B"].shape[1]
        t = rod - torch.einsum("bnji,bnj->bni", lv["A"], x[:, :n_odd])
        t[:, :n_b] += -torch.einsum("bnij,bnj->bni", lv["B"], x[:, 1:1 + n_b])
        xod = _spd_solve(lv["Lod"], t[..., None])[..., 0]
        out = x.new_zeros((B, x.shape[1] + xod.shape[1], s))
        out[:, 0::2] = x
        out[:, 1::2] = xod
        x = out
    return x.reshape(B, mp)[:, :m]
