"""One ReLU-QP check window as a CUDA kernel (counterpart of
``dragg_tpu/ops/pallas_iter.py``).

``fused_window`` ← ``pallas_iter.fused_window`` / ``_fused_window_t``:
k solver iterations and the four residual maxima of the convergence
check in one launch of kernel ``fused_window`` (``csrc/iter.cu``), the
home's operators held in shared memory across the window.

The wrapper takes the batch-first arrays as ``ops/reluqp.py`` holds them
— Â ``(B, m, n)``, the selected S⁻¹ slab ``(B, m, m)``, vectors
``(B, n|m)``, ``rho`` ``(B,)``, ``cd`` the combined ``c * d`` scaling —
all contiguous float32 on one device.  On a CUDA tensor it launches the
kernel (or raises); on a CPU tensor it runs :func:`fused_window_plain`,
a port of ``pallas_iter.reference_window``, which is also the
``iter_kernel = "lax"`` route of ``ops/reluqp.py``.  ``LAUNCHES`` counts kernel
launches.  The TPU kernel's tiling arguments (``lane_block``,
``b_chunk``) and its pad-to-128 homes have no counterpart: the kernel
runs one block per home, or a cluster of blocks for a home too big for
one SM, as :func:`window_plan` decides from (m, n) alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dragg_tpu_torch.ops.cuda_lib import launch, lib, ptr
from dragg_tpu_torch.ops.dual import has_tangent, primal, with_zero_tangents
from dragg_tpu_torch.ops.precision import f32_guard, mxu_einsum

# Kernel launches since the last reset: the wrapper adds one exactly where
# it launches its kernel, never on the CPU path.
LAUNCHES = {"fused_window": 0}

_ARG_NAMES = ("A", "Sinv", "Dinv", "w", "qs", "bs", "ls", "us", "rho", "x", "z",
              "nu", "y", "e_eq", "e_box", "cd", "p_diag")


# The kernel's instantiations (csrc/iter.cu WINDOW_KERNELS, same order):
# (threads, rows of Â and S⁻¹ per warp, column groups of 32 of Â, column
# groups of S⁻¹, cluster size, Â held in registers, blocks per SM).  The
# first four hold Â in registers (the H = 4 buckets, then the H = 24 base,
# pv_only and m = 77 buckets); then Â in shared memory for homes up to
# m = 112, n = 320 (the H = 48 pv_only and base buckets), and split over a
# cluster of two blocks for homes up to m = 160, n = 448 (the H = 48
# pv_battery and battery_only buckets).
KERNELS = (
    (256, 4, 2, 1, 1, True, 4),
    (256, 7, 4, 2, 1, True, 4),
    (256, 7, 5, 2, 1, True, 4),
    (256, 10, 7, 3, 1, True, 2),
    (512, 7, 10, 4, 1, False, 1),
    (256, 10, 14, 5, 2, False, 1),
)
MAX_SMEM = 232_448  # dynamic shared memory of one block on sm_90 (227 KB)


class WindowPlan(NamedTuple):
    """How one window runs at a home shape: ``threads`` per block,
    ``rows`` of Â and S⁻¹ per warp, ``cols`` / ``scols`` column groups of
    32 of Â / S⁻¹, ``cluster`` blocks per home, Â held in registers
    (``regs``), ``blocks_per_sm`` (the kernel's occupancy bound) and
    ``smem`` dynamic shared-memory bytes per block."""

    threads: int
    rows: int
    cols: int
    scols: int
    cluster: int
    regs: bool
    blocks_per_sm: int
    smem: int


def window_smem(threads: int, rows: int, cols: int, scols: int, regs: bool,
                m: int, n: int) -> int:
    """Dynamic shared-memory bytes of one block (csrc/iter.cu smem_bytes):
    the block's rows of S⁻¹ (and of Â, zero-padded to 32·cols columns,
    unless in registers), the warps' column partials, ten zero-padded
    n-vectors, t, b̂, ν and the maxima."""
    warps = threads // 32
    slab = min(warps * rows, m)
    npc = 32 * cols
    return 4 * (slab * m + (0 if regs else slab * npc) + warps * npc + 10 * npc
                + 32 * scols + 2 * m + 5 * warps + 5)


def window_plans(m: int, n: int) -> list[WindowPlan]:
    """Every instantiation of :data:`KERNELS` that covers a home of ``m``
    equality rows and ``n`` variables within one block's shared memory,
    in the table's order of preference."""
    plans = []
    for threads, rows, cols, scols, cluster, regs, per_sm in KERNELS:
        if threads // 32 * rows * cluster >= m and 32 * cols >= n and 32 * scols >= m:
            smem = window_smem(threads, rows, cols, scols, regs, m, n)
            if smem <= MAX_SMEM:
                plans.append(WindowPlan(threads, rows, cols, scols, cluster, regs, per_sm,
                                        smem))
    return plans


def window_plan(m: int, n: int) -> WindowPlan:
    """How the kernel runs a home of ``m`` equality rows and ``n``
    variables: the first of :func:`window_plans` (Â in registers where the
    tile fits, measured the faster on the H100; a cluster only where no
    single block can hold the home).  Raises ``ValueError`` for a home no
    instantiation can run.  Depends on the shape only, never on the
    batch, so any slice of homes runs the same arithmetic."""
    plans = window_plans(m, n)
    if plans:
        return plans[0]
    raise ValueError(f"fused_window: no kernel for a home of m={m}, n={n}: the "
                     f"window runs homes up to m = 160 and n = 448 whose operators "
                     f"fit a cluster of two blocks of {MAX_SMEM} bytes")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def iterate(A, Sinv, Dinv, w, qs, bs, ls, us, rho, state, *, k: int, sigma: float,
            alpha: float, precision: str = "f32"):
    """k solver iterations from ``state = (x, z, nu, y)``: the three
    contractions at the hot-loop ``precision``, everything elementwise
    float32.  Under forward-mode AD every operand carries a tangent, zero
    where it had none (``ops/dual.py``)."""
    x, z, nu, y = state
    rho_c = rho[:, None]
    beta = 1.0 - alpha
    if has_tangent(A, Sinv, Dinv, w, qs, bs, ls, us, rho_c, *state):
        (A, Sinv, Dinv, w, qs, bs, ls, us, rho_c, x, z, nu, y, sigma, alpha,
         beta) = with_zero_tangents(A, Sinv, Dinv, w, qs, bs, ls, us, rho_c, x, z, nu, y,
                                    sigma, alpha, beta, like=qs)
    for _ in range(k):
        rhs = sigma * x - qs + w * (rho_c * z - y)
        t = mxu_einsum("bmn,bn->bm", A, Dinv * rhs, precision=precision) - bs
        nu = mxu_einsum("bmn,bn->bm", Sinv, t, precision=precision)
        x_t = Dinv * (rhs - mxu_einsum("bmn,bm->bn", A, nu, precision=precision))
        z_t = w * x_t
        x = alpha * x_t + beta * x
        zc = alpha * z_t + beta * z
        z_new = torch.minimum(torch.maximum(zc + y / rho_c, ls), us)
        y = y + rho_c * (zc - z_new)
        z = z_new
    return x, z, nu, y


def residual_maxima(A, w, qs, bs, e_eq, e_box, cd, p_diag, state):
    """Unscaled residuals and relative scalings (OSQP §3.4, §5.1):
    (r_prim, r_dual, p_sc, d_sc), always float32."""
    x, z, nu, y = state
    x = f32_guard(x, "reluqp residual iterate x")
    y = f32_guard(y, "reluqp residual dual y_box")
    Ax = mxu_einsum("bmn,bn->bm", A, x)
    At_nu = mxu_einsum("bmn,bm->bn", A, nu)
    wx = w * x
    amax = lambda a: torch.amax(torch.abs(a), dim=1)  # noqa: E731
    r_prim = torch.maximum(amax((Ax - bs) / e_eq), amax((wx - z) / e_box))
    r_dual = amax((p_diag * x + qs + At_nu + w * y) / cd)
    p_sc = torch.maximum(torch.maximum(amax(Ax / e_eq), amax(bs / e_eq)),
                         torch.maximum(amax(wx / e_box), amax(z / e_box)))
    d_sc = torch.maximum(amax(At_nu / cd), torch.maximum(amax(w * y / cd), amax(qs / cd)))
    return r_prim, r_dual, p_sc, d_sc


def fused_window_plain(A, Sinv, Dinv, w, qs, bs, ls, us, rho, x, z, nu, y,
                       e_eq, e_box, cd, p_diag, *, k: int, sigma: float,
                       alpha: float, precision: str = "f32"):
    """Plain version of :func:`fused_window` (a port of
    ``reference_window``): the same iteration and residual maxima as
    float32 einsums and elementwise ops in the kernel's operation order.
    With the hot-loop ``precision`` it is also ReLU-QP's
    ``iter_kernel = "lax"`` route."""
    state = iterate(A, Sinv, Dinv, w, qs, bs, ls, us, rho, (x, z, nu, y), k=k,
                    sigma=sigma, alpha=alpha, precision=precision)
    # The residuals decide control flow only: no tangent.
    return state, residual_maxima(*map(primal, (A, w, qs, bs, e_eq, e_box, cd, p_diag)),
                                  tuple(map(primal, state)))


def _check(args) -> tuple[int, int, int]:
    """Validate the window's inputs; returns (B, m, n)."""
    B, m, n = args[0].shape
    want = {"A": (B, m, n), "Sinv": (B, m, m), "rho": (B,)}
    for name in ("bs", "nu", "e_eq"):
        want[name] = (B, m)
    dev = args[0].device
    for name, a in zip(_ARG_NAMES, args):
        shape = want.get(name, (B, n))
        if a.dtype != torch.float32:
            raise ValueError(f"fused_window: {name} is {a.dtype}; the window is "
                             f"float32 only (tpu.iter_kernel='pallas' requires "
                             f"tpu.precision='f32')")
        if tuple(a.shape) != shape:
            raise ValueError(f"fused_window: {name} {tuple(a.shape)} != {shape}")
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"fused_window: {name} must be contiguous on {dev}, "
                             f"got {a.device}")
    return B, m, n


def fused_window(A, Sinv, Dinv, w, qs, bs, ls, us, rho, x, z, nu, y,
                 e_eq, e_box, cd, p_diag, *, k: int, sigma: float,
                 alpha: float):
    """One fused check window.  Returns ``((x, z, nu, y), (r_prim, r_dual,
    p_sc, d_sc))``, the state batch-first and the maxima ``(B,)``."""
    args = (A, Sinv, Dinv, w, qs, bs, ls, us, rho, x, z, nu, y,
            e_eq, e_box, cd, p_diag)
    B, m, n = _check(args)
    if A.device.type == "cpu":
        return fused_window_plain(*args, k=k, sigma=sigma, alpha=alpha)
    if A.device.type != "cuda":
        raise ValueError(f"fused_window: no kernel for device {A.device}")
    return _launch(args, window_plan(m, n), k=k, sigma=sigma, alpha=alpha)


def _launch(args, plan: WindowPlan, *, k: int, sigma: float, alpha: float):
    """Launch the kernel on ``args`` (checked CUDA tensors) with ``plan``."""
    A, x, z, nu, y, rho = args[0], args[9], args[10], args[11], args[12], args[8]
    B, m, n = A.shape
    outs = (torch.empty_like(x), torch.empty_like(z), torch.empty_like(nu),
            torch.empty_like(y), *(torch.empty_like(rho) for _ in range(4)))
    if B > 0:
        launch(LAUNCHES, "fused_window", lib().fused_window, A.device,
               *(ptr(a) for a in args), *(ptr(o) for o in outs),
               B, m, n, int(k), float(sigma), float(alpha),
               *(int(v) for v in plan))
    return outs[:4], outs[4:]
