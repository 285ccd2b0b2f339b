"""The least time of a band kernel call, frozen from the port's kernel
table (PERF.md's "bound ms (by)" column, computed by
``dragg_tpu_torch/bench_band.py:band_bounds``): each input read
once and each output written once from HBM, against the float32
operations of the recurrence; the larger of the two bounds the call.
Kept here so that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

from perfbench.harness.peaks import H100_F32_FLOPS, H100_HBM_BYTES_S


def work(kernel: str, m: int, bw: int, B: int) -> tuple[float, float]:
    """(bytes, float32 operations) of one call of ``kernel`` over B homes'
    (m, bw) bands: ``banded_cholesky_t`` reads S and writes L; the refined
    solve (one refinement) reads L, S and r and writes x; the fused factor
    and solve reads S and r and writes L and x."""
    band, vec = m * (bw + 1) * B * 4, m * B * 4
    chol_ops = (bw * bw + 2 * bw + 2) * m * B
    solve_ops = 2 * (2 * bw + 1) * m * B
    refine_ops = (4 * bw + 2 + 1) * m * B + solve_ops
    return {
        "banded_cholesky_t": (2 * band, chol_ops),
        "refined_banded_solve_t": (2 * band + 2 * vec, solve_ops + refine_ops),
        "factor_refined_solve_t": (2 * band + 2 * vec, chol_ops + solve_ops),
    }[kernel]


def least_seconds(kernel: str, m: int, bw: int, B: int) -> float:
    nbytes, ops = work(kernel, m, bw, B)
    return max(nbytes / H100_HBM_BYTES_S, ops / H100_F32_FLOPS)
