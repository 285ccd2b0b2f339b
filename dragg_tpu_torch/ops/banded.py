"""Banded Cholesky machinery for the Schur complement (counterpart of
``dragg_tpu/ops/banded.py``).

S = Â Θ⁻¹ Âᵀ of the MPC equality block is, after a reverse Cuthill–McKee
permutation, a banded SPD matrix with bandwidth ~4-7 independent of the
horizon.  ``rcm_order``/``BandPlan``/``plan_for`` are numpy and identical
to the JAX package's, so the permutation is the same.  The band
operations below are the plain PyTorch spelling in ``(B, m, bw+1)`` lower
band storage (``Sb[:, i, k] = S_perm[i, i-k]``): a Python loop over the m
rows with the JAX scans' exact operation order.  They are the CPU path,
and (in the transposed layout, ``ops/band_kernels.py``) the plain versions
the CUDA kernels are held against.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from dragg_tpu_torch.ops.precision import mxu_einsum

MAX_BAND = 12  # plan_for gives up beyond this bandwidth (the IPM then raises)


def rcm_order(rows: np.ndarray, cols: np.ndarray, m: int) -> np.ndarray:
    """Reverse Cuthill–McKee ordering of a symmetric sparsity pattern.
    Returns ``perm`` with ``perm[p] = original index placed at position p``."""
    adj: list[set] = [set() for _ in range(m)]
    for i, j in zip(rows, cols):
        if i != j:
            adj[int(i)].add(int(j))
            adj[int(j)].add(int(i))
    deg = np.asarray([len(a) for a in adj])
    nbrs = [sorted(a, key=lambda v: deg[v]) for a in adj]
    visited = np.zeros(m, dtype=bool)
    order: list[int] = []
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        visited[start] = True
        queue = [int(start)]
        while queue:
            v = queue.pop(0)
            order.append(v)
            for u in nbrs[v]:
                if not visited[u]:
                    visited[u] = True
                    queue.append(u)
    return np.asarray(order[::-1], dtype=np.int32)


class BandPlan(NamedTuple):
    """Static plan: permutation + scatter of Schur entries into lower-band
    storage ``Sb[:, i, k] = S_perm[i, i-k]``.  All numpy; hashable via id —
    built once per (pattern) by :func:`plan_for`."""

    m: int
    bw: int
    perm: np.ndarray      # (m,) original index at permuted position
    inv: np.ndarray       # (m,) permuted position of original index
    ent_row: np.ndarray   # (n_low,) band row of each kept S entry
    ent_off: np.ndarray   # (n_low,) band offset (0 = diagonal)
    ent_src: np.ndarray   # (n_low,) index into the contrib vector


@lru_cache(maxsize=32)
def _plan_cached(s_rows: tuple, s_cols: tuple, m: int) -> BandPlan | None:
    rows = np.asarray(s_rows, dtype=np.int64)
    cols = np.asarray(s_cols, dtype=np.int64)
    perm = rcm_order(rows, cols, m)
    inv = np.empty(m, dtype=np.int32)
    inv[perm] = np.arange(m, dtype=np.int32)
    bw = int(np.max(np.abs(inv[rows] - inv[cols]))) if len(rows) else 0
    if bw > MAX_BAND:
        return None
    if bw == 0:
        # A diagonal Schur complement needs no banded machinery (and the
        # scan carries below would be zero-length) — use the dense path.
        return None
    pi = inv[rows]
    pj = inv[cols]
    keep = pi >= pj  # lower triangle (S symmetric; each pair stored once)
    return BandPlan(
        m=m, bw=bw, perm=perm, inv=inv,
        ent_row=pi[keep].astype(np.int32),
        ent_off=(pi[keep] - pj[keep]).astype(np.int32),
        ent_src=np.nonzero(keep)[0].astype(np.int32),
    )


def plan_for(ss, m: int) -> BandPlan | None:
    """Band plan for a SchurStructure over m rows, or None when the RCM
    bandwidth is too large for the banded path to pay off."""
    if ss is None or ss.n_s == 0:
        return None
    return _plan_cached(ss.s_rows, ss.s_cols, m)


def plan_index(plan: BandPlan, device) -> tuple[torch.Tensor, ...]:
    """(ent_row, ent_off, ent_src) of a plan as index tensors on ``device``."""
    return tuple(torch.as_tensor(a, dtype=torch.long, device=device)
                 for a in (plan.ent_row, plan.ent_off, plan.ent_src))


def band_scatter(plan: BandPlan, contrib: torch.Tensor) -> torch.Tensor:
    """Schur entry values (B, n_s) → lower-band storage (B, m, bw+1)."""
    B = contrib.shape[0]
    Sb = contrib.new_zeros((B, plan.m, plan.bw + 1))
    row, off, src = plan_index(plan, contrib.device)
    Sb[:, row, off] = contrib[:, src]
    return Sb


def _unit_rows(B: int, bw: int, like: torch.Tensor) -> torch.Tensor:
    """(B, bw+1) virtual identity L row: diagonal 1, off-band 0."""
    row = like.new_zeros((B, bw + 1))
    row[:, 0] = 1.0
    return row


def banded_cholesky(Sb: torch.Tensor, bw: int) -> torch.Tensor:
    """Batched Cholesky of band-stored SPD matrices: (B, m, bw+1) lower-band
    S → same-layout L with S = L Lᵀ.  Rows above the top are virtual unit
    rows, so the zero-padded entries for i<k produce L[i,k]=0."""
    B, m, _ = Sb.shape
    prev = [_unit_rows(B, bw, Sb)] * bw      # prev[d-1] = L row (i-d)
    rows = []
    for i in range(m):
        srow = Sb[:, i]
        row = [None] * (bw + 1)
        for k in range(bw, 0, -1):
            s = srow[:, k]
            for j in range(1, bw - k + 1):
                s = s - row[k + j] * prev[k - 1][:, j]
            row[k] = s / prev[k - 1][:, 0]
        diag = srow[:, 0]
        for j in range(1, bw + 1):
            diag = diag - row[j] * row[j]
        # maximum (not clamp): a NaN diagonal stays NaN, as jnp.maximum.
        row[0] = torch.sqrt(torch.maximum(diag, diag.new_tensor(1e-20)))
        row_arr = torch.stack(row, dim=1)
        prev = [row_arr] + prev[:-1]
        rows.append(row_arr)
    return torch.stack(rows, dim=1)


def banded_forward_solve(Lb: torch.Tensor, R: torch.Tensor, bw: int) -> torch.Tensor:
    """Solve L Y = R for band-stored lower-triangular L; R is (B, m, r)."""
    B, m, r = R.shape
    prev = [R.new_zeros((B, r))] * bw        # prev[k-1] = y row (i-k)
    ys = []
    for i in range(m):
        lrow = Lb[:, i]
        acc = R[:, i]
        for k in range(1, bw + 1):
            acc = acc - lrow[:, k, None] * prev[k - 1]
        y = acc / lrow[:, 0, None]
        prev = [y] + prev[:-1]
        ys.append(y)
    return torch.stack(ys, dim=1)


def banded_backward_solve(Lb: torch.Tensor, Y: torch.Tensor, bw: int) -> torch.Tensor:
    """Solve Lᵀ X = Y for band-stored lower-triangular L; Y is (B, m, r).
    Row i of Lᵀ couples x_i to x_{i+k} via L[i+k, k]: a reverse loop
    carrying the last bw (x, L-row) pairs below the current row."""
    B, m, r = Y.shape
    xs = [Y.new_zeros((B, r))] * bw                 # xs[k-1] = x row (i+k)
    lbelow = [_unit_rows(B, bw, Lb)] * bw           # lbelow[k-1] = L row (i+k)
    out = [None] * m
    for i in range(m - 1, -1, -1):
        lrow = Lb[:, i]
        acc = Y[:, i]
        for k in range(1, bw + 1):
            acc = acc - lbelow[k - 1][:, k, None] * xs[k - 1]
        x = acc / lrow[:, 0, None]
        xs = [x] + xs[:-1]
        lbelow = [lrow] + lbelow[:-1]
        out[i] = x
    return torch.stack(out, dim=1)


def band_matvec(Sb: torch.Tensor, v: torch.Tensor, bw: int) -> torch.Tensor:
    """S v for lower-band-stored symmetric S: (B, m, bw+1) × (B, m)."""
    out = Sb[:, :, 0] * v
    for k in range(1, bw + 1):
        lo = Sb[:, k:, k]          # S[i, i-k] for i >= k
        out[:, k:] += lo * v[:, :-k]   # lower-triangle term
        out[:, :-k] += lo * v[:, k:]   # symmetric upper term
    return out


def banded_solve(Lb: torch.Tensor, r: torch.Tensor, bw: int) -> torch.Tensor:
    """S⁻¹ r (band-space) via forward + backward substitution; r is (B, m)."""
    y = banded_forward_solve(Lb, r[..., None], bw)
    return banded_backward_solve(Lb, y, bw)[..., 0]


def refined_banded_solve(Lb: torch.Tensor, Sb: torch.Tensor, r: torch.Tensor, bw: int,
                         refine: int) -> torch.Tensor:
    """S⁻¹ r by :func:`banded_solve`, then ``refine`` passes of
    x += (L Lᵀ)⁻¹ (r − S x) against the band S (the JAX package's scan
    path of ``pallas_band.make_band_ops``)."""
    x = banded_solve(Lb, r, bw)
    for _ in range(refine):
        x = x + banded_solve(Lb, r - band_matvec(Sb, x, bw), bw)
    return x


def banded_explicit_inverse(plan: BandPlan, contrib: torch.Tensor) -> torch.Tensor:
    """S⁻¹ in the original row order, dense (B, m, m), from the Schur
    entry values: the band Cholesky of the permuted S, one banded
    forward solve against I for L⁻¹, the Gram product S⁻¹ = L⁻ᵀL⁻¹ (one
    batched GEMM, pinned float32) and the inverse permutation.  The two
    band loops run about 2m rows of a few operations each."""
    m, bw = plan.m, plan.bw
    B = contrib.shape[0]
    Lb = banded_cholesky(band_scatter(plan, contrib), bw)
    eye = torch.eye(m, dtype=contrib.dtype, device=contrib.device).expand(B, m, m)
    Linv = banded_forward_solve(Lb, eye, bw)            # (B, m, m), permuted
    Sinv_p = mxu_einsum("bkm,bkn->bmn", Linv, Linv)
    inv = torch.as_tensor(plan.inv, dtype=torch.long, device=contrib.device)
    return Sinv_p[:, inv][:, :, inv]
