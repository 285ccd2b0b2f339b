"""The pieces of ``dragg_tpu/ops/admm.py`` that the interior point uses:
the solution record, the cached Schur triple lists, the padded gather and
the Ruiz equilibration, shared by the interior point and ReLU-QP.  The
ADMM solver itself is not in this package yet (``hems.solver = "admm"``
raises)."""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from dragg_tpu_torch.ops.qp import SparsePattern, build_schur_structure


@lru_cache(maxsize=32)
def _schur_structure_for(pat: SparsePattern):
    """Schur triple lists for a pattern, or None when the triple count
    says dense S formation is cheaper (checked from the column counts
    before building anything)."""
    col_counts = np.bincount(np.asarray(pat.cols), minlength=pat.n)
    if int(np.sum(col_counts.astype(np.int64) ** 2)) > pat.m * pat.n:
        return None
    ss = build_schur_structure(pat)
    if ss.n_s * ss.P > pat.m * pat.n:
        return None
    return ss


class ADMMSolution(NamedTuple):
    x: torch.Tensor        # (B, n) primal solution (unscaled, box-projected)
    y_eq: torch.Tensor     # (B, m_eq) duals on equality rows (unscaled)
    y_box: torch.Tensor    # (B, n) duals on box rows (unscaled)
    r_prim: torch.Tensor   # (B,) inf-norm primal residual (unscaled)
    r_dual: torch.Tensor   # (B,) inf-norm dual residual (unscaled, cost-descaled)
    solved: torch.Tensor   # (B,) bool
    infeasible: torch.Tensor  # (B,) bool
    iters: int             # iterations executed
    rho: torch.Tensor      # (B,) (ones for the interior point)
    conv_iters: torch.Tensor | None = None  # (B,) int32 live iterations per home
    diverged: torch.Tensor | None = None    # (B,) bool certified divergence
    bank_fallback: torch.Tensor | None = None  # (B,) bool: the ReLU-QP home needed
                                               # the exact-refactorization tail


def _pad_gather(vals: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(B, nnz) values → padded (B, *src.shape) with -1 slots zeroed."""
    out = vals[:, src.clamp(min=0)]
    return torch.where(src[None] >= 0, out, torch.zeros((), dtype=vals.dtype,
                                                        device=vals.device))


def ruiz_equilibrate_sparse(pat: SparsePattern, vals, q, iters: int = 10):
    """Modified Ruiz equilibration of the stacked constraint matrix
    [A_eq; I] plus cost normalization, on the sparse values.

    Returns (d, e_eq, e_box, c): per-home column scaling d (n,), row
    scalings for the equality and box blocks, and the cost scaling (B, 1).
    Degenerate (all-zero) rows keep their scaling."""
    B, dev, dtype = vals.shape[0], vals.device, vals.dtype
    rows = torch.as_tensor(pat.rows, device=dev)
    cols = torch.as_tensor(pat.cols, device=dev)
    row_src = torch.as_tensor(pat.row_src, device=dev)
    col_src = torch.as_tensor(pat.col_src, device=dev)
    d = torch.ones((B, pat.n), dtype=dtype, device=dev)
    e_eq = torch.ones((B, pat.m), dtype=dtype, device=dev)
    e_box = torch.ones((B, pat.n), dtype=dtype, device=dev)

    def scaled_abs(d, e_eq):
        return torch.abs(e_eq[:, rows] * vals * d[:, cols])

    def rescale(e, r):
        return torch.where(r > 1e-8, e / torch.sqrt(torch.clamp(r, min=1e-8)), e)

    for _ in range(iters):
        r_eq = torch.amax(_pad_gather(scaled_abs(d, e_eq), row_src), dim=2)
        r_box = torch.abs(e_box * d)
        e_eq = rescale(e_eq, r_eq)
        e_box = rescale(e_box, r_box)
        c_eq = torch.amax(_pad_gather(scaled_abs(d, e_eq), col_src), dim=2)
        cn = torch.maximum(c_eq, torch.abs(e_box * d))
        d = rescale(d, cn)
    qn = torch.amax(torch.abs(d * q), dim=1, keepdim=True)
    c = 1.0 / torch.clamp(qn, min=1e-8)
    return d, e_eq, e_box, c
