"""The band factor and refined band solves as CUDA kernels (counterpart of
``dragg_tpu/ops/pallas_band.py``).

Three kernels, written by hand for Hopper in ``csrc/band.cu``:

* ``banded_cholesky_t``      ← ``pallas_band.banded_cholesky_t``
* ``refined_banded_solve_t`` ← ``pallas_band.refined_banded_solve_t``
* ``factor_refined_solve_t`` ← ``pallas_band.factor_refined_solve_t``

All take the transposed, homes-last band storage ``(m, bw+1, B)`` with
``St[i, k, b] = S_perm[i, i-k]`` of home b, and ``(m, B)`` vectors.  Each
wrapper launches its kernel on a CUDA tensor (or raises), and on a CPU
tensor runs the kernel's plain PyTorch version — the module-7 band path of
``ops/banded.py`` in the transposed layout, the same recurrences and
operation order.  ``LAUNCHES`` counts kernel launches per wrapper.

Each kernel stages a block's rows in shared memory (whole, or streamed
through a ring of chunks) as :func:`band_plan` decides from (m, bw),
refine, the batch and the card's SM count; the C entry points refuse any
plan not in :data:`BAND_KERNELS` or whose bytes do not match
:data:`SMEM_TERMS`.  Every plan gives the same bits, so the choice never
changes a result.  The kernels are built and bound by
``ops/cuda_lib.py`` on first use.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from dragg_tpu_torch.ops import banded as bd
from dragg_tpu_torch.ops.cuda_lib import launch, lib, ptr

# Kernel launches per wrapper since the last reset: a wrapper adds one
# exactly where it launches its kernel, never on the CPU path.
LAUNCHES = {"banded_cholesky_t": 0, "refined_banded_solve_t": 0,
            "factor_refined_solve_t": 0}


# The staged kernels' instantiations (csrc/band.cu BAND_KERNELS, same
# order): (homes per block, ring depth), depth 0 staging the whole band.
# On the H100 one wave of blocks takes the chain's time whatever the block
# size, and the ring's in-line copies make a wave ≈ 1.1-1.4× slower than
# the whole band's (PERF.md), so band_plan takes the plan needing
# the fewest waves, then the whole band, then the larger block.  8-home
# blocks were measured too and never won.
BAND_KERNELS = ((32, 0), (32, 4), (16, 0), (16, 4))
BLOCK_HOMES = 32    # the largest block
RING_ROWS = 16      # rows per ring chunk
MAX_SMEM = 232_448  # dynamic shared memory of one block on sm_90 (227 KB)
SM_SMEM = 233_472   # shared memory of one SM on sm_90, 1 KB of it reserved per block
MAX_BLOCKS_PER_SM = 32
H100_SMS = 132
KERNEL_NAMES = ("cholesky", "solve", "factor_solve")
# What a block holds (csrc/band.cu BAND_SMEM), per (kernel, refine > 0):
# band arrays staged whole, vectors of m floats and single words, each per
# home.  The factor: S.  The solve: L and S (S filled only when refining);
# r, x and y/t.  The fused factor and solve: S, turning into L row by row,
# one vector (r, then y, then x) and the factor's progress word; refining,
# L and S apart, r, x and y/t, and the word.  A ring holds depth · rows
# rows of one array in place of the whole arrays.
SMEM_TERMS = {
    ("cholesky", False): (1, 0, 0), ("cholesky", True): (1, 0, 0),
    ("solve", False): (2, 3, 0), ("solve", True): (2, 3, 0),
    ("factor_solve", False): (1, 1, 1), ("factor_solve", True): (2, 3, 1),
}


class BandPlan(NamedTuple):
    """How a staged band kernel runs at one (m, bw): ``hb`` homes per
    block, ring ``depth`` (0: the whole band staged at launch), ``rows``
    per ring chunk (m for the whole band) and ``smem`` dynamic
    shared-memory bytes per block."""

    hb: int
    depth: int
    rows: int
    smem: int


def band_smem(kernel: str, m: int, bw: int, hb: int, depth: int, rows: int,
              refine: int = 0) -> int:
    """Dynamic shared-memory bytes of one block (csrc/band.cu plan_smem):
    the band rows held — :data:`SMEM_TERMS`' whole arrays of m rows, or the
    ring's depth · rows — plus its vectors and words."""
    arrays, vecs, words = SMEM_TERMS[kernel, refine > 0]
    band_rows = arrays * m if depth == 0 else depth * rows
    return 4 * hb * (band_rows * (bw + 1) + vecs * m + words)


def band_plans(m: int, bw: int, kernel: str, refine: int = 0) -> list[BandPlan]:
    """Every instantiation of :data:`BAND_KERNELS` that runs ``kernel``
    (one of :data:`KERNEL_NAMES`) at (m, bw) and ``refine`` within one
    block's shared memory, in the table's order."""
    if kernel not in KERNEL_NAMES:
        raise ValueError(f"band_plans: kernel {kernel!r} not in {KERNEL_NAMES}")
    plans = []
    for hb, depth in BAND_KERNELS:
        rows = m if depth == 0 else min(RING_ROWS, m)
        smem = band_smem(kernel, m, bw, hb, depth, rows, refine)
        if smem <= MAX_SMEM:
            plans.append(BandPlan(hb, depth, rows, smem))
    return plans


def band_waves(plan: BandPlan, B: int, sms: int = H100_SMS) -> int:
    """Waves of blocks ``plan`` takes over B homes on a card of ``sms`` SMs,
    as many blocks sharing an SM as its shared memory allows."""
    per_sm = min(MAX_BLOCKS_PER_SM, SM_SMEM // (plan.smem + 1024))
    blocks = -(-B // plan.hb)
    return -(-blocks // (sms * per_sm))


@lru_cache(maxsize=4096)
def band_plan(m: int, bw: int, kernel: str, B: int, sms: int = H100_SMS,
              refine: int = 0) -> BandPlan:
    """The plan ``kernel`` runs at (m, bw) and ``refine`` over B homes on a
    card of ``sms`` SMs: of :func:`band_plans`, the one needing the fewest
    waves of blocks (:func:`band_waves`), then the whole band before the
    ring, then the larger block.  Raises ``ValueError`` where no block can
    hold the kernel's rows."""
    if m < 1 or not 1 <= bw <= bd.MAX_BAND:
        raise ValueError(f"band_plan: no kernel for m={m}, bw={bw}")
    plans = band_plans(m, bw, kernel, refine)
    if not plans:
        raise ValueError(f"band_plan: no {kernel} kernel for m={m}, bw={bw}: its "
                         f"vectors of {min(hb for hb, _ in BAND_KERNELS)} homes exceed "
                         f"{MAX_SMEM} bytes of shared memory")
    return min(plans, key=lambda p: (band_waves(p, B, sms), p.depth > 0, -p.hb))


@lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, bw: int, bands=(), vecs=()) -> tuple[int, int]:
    """Validate the kernel's inputs; returns (m, B)."""
    if not 1 <= bw <= bd.MAX_BAND:
        raise ValueError(f"{name}: bandwidth {bw} outside 1..{bd.MAX_BAND}")
    m, B = bands[0].shape[0], bands[0].shape[2]
    dev = bands[0].device
    for a in bands:
        if a.shape != (m, bw + 1, B):
            raise ValueError(f"{name}: band array {tuple(a.shape)} != {(m, bw + 1, B)}")
    for a in vecs:
        if a.shape != (m, B):
            raise ValueError(f"{name}: vector {tuple(a.shape)} != {(m, B)}")
    for a in (*bands, *vecs):
        if a.dtype != torch.float32 or a.device != dev or not a.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous float32 on one "
                             f"device, got {a.dtype} on {a.device}")
    return m, B


# ------------------------------------------------------ plain versions
def _to_b(a: torch.Tensor) -> torch.Tensor:
    """(m, bw+1, B) → (B, m, bw+1), or (m, B) → (B, m)."""
    return a.permute(2, 0, 1) if a.ndim == 3 else a.T


def _from_b(a: torch.Tensor) -> torch.Tensor:
    return (a.permute(1, 2, 0) if a.ndim == 3 else a.T).contiguous()


def cholesky_t_plain(St: torch.Tensor, bw: int) -> torch.Tensor:
    """Plain version of :func:`banded_cholesky_t`."""
    return _from_b(bd.banded_cholesky(_to_b(St), bw))


def refined_solve_t_plain(Lt, St, rt, bw: int, refine: int) -> torch.Tensor:
    """Plain version of :func:`refined_banded_solve_t`."""
    return _from_b(bd.refined_banded_solve(_to_b(Lt), _to_b(St), _to_b(rt), bw, refine))


def factor_solve_t_plain(St, rt, bw: int, refine: int):
    """Plain version of :func:`factor_refined_solve_t`."""
    Lt = cholesky_t_plain(St, bw)
    return Lt, refined_solve_t_plain(Lt, St, rt, bw, refine)


# ------------------------------------------------------------- kernels
def banded_cholesky_t(St: torch.Tensor, bw: int) -> torch.Tensor:
    """Batched band Cholesky in transposed storage: (m, bw+1, B) → L, same
    layout, S = L Lᵀ per home.  Kernel ``band_cholesky_t``."""
    m, B = _check("banded_cholesky_t", bw, bands=(St,))
    if St.device.type == "cpu":
        return cholesky_t_plain(St, bw)
    return cholesky_launch(St, bw, band_plan(m, bw, "cholesky", B, _sms(St.device)))


def cholesky_launch(St, bw: int, plan: BandPlan) -> torch.Tensor:
    """Launch ``band_cholesky_t`` with ``plan`` on checked CUDA tensors."""
    m, _, B = St.shape
    L = torch.empty_like(St)
    launch(LAUNCHES, "banded_cholesky_t", lib().band_cholesky_t, St.device,
           ptr(St), ptr(L), m, bw, B, *plan)
    return L


def refined_banded_solve_t(Lt, St, rt, bw: int, refine: int = 1) -> torch.Tensor:
    """x ≈ S⁻¹ r via forward + backward substitution on the band factor,
    then ``refine`` passes of x += (L Lᵀ)⁻¹ (r − S x), in one launch of
    kernel ``band_refined_solve_t``.  Lt/St (m, bw+1, B), rt (m, B)."""
    m, B = _check("refined_banded_solve_t", bw, bands=(Lt, St), vecs=(rt,))
    if Lt.device.type == "cpu":
        return refined_solve_t_plain(Lt, St, rt, bw, refine)
    return solve_launch(Lt, St, rt, bw, refine, band_plan(m, bw, "solve", B, _sms(Lt.device)))


def solve_launch(Lt, St, rt, bw: int, refine: int, plan: BandPlan) -> torch.Tensor:
    """Launch ``band_refined_solve_t`` with ``plan`` on checked CUDA
    tensors; x is the only array it writes."""
    m, B = rt.shape
    x = torch.empty_like(rt)
    launch(LAUNCHES, "refined_banded_solve_t", lib().band_refined_solve_t,
           Lt.device, ptr(Lt), ptr(St), ptr(rt), ptr(x), m, bw, B, int(refine), *plan)
    return x


def factor_refined_solve_t(St, rt, bw: int, refine: int = 0):
    """(L, x ≈ S⁻¹ r): the factor, the forward substitution a row behind
    it, the backward substitution and ``refine`` refinement passes, in one
    launch of kernel ``band_factor_solve_t``.  St (m, bw+1, B), rt
    (m, B)."""
    m, B = _check("factor_refined_solve_t", bw, bands=(St,), vecs=(rt,))
    if St.device.type == "cpu":
        return factor_solve_t_plain(St, rt, bw, refine)
    plan = band_plan(m, bw, "factor_solve", B, _sms(St.device), refine)
    return factor_solve_launch(St, rt, bw, refine, plan)


def factor_solve_launch(St, rt, bw: int, refine: int, plan: BandPlan):
    """Launch ``band_factor_solve_t`` with ``plan`` on checked CUDA
    tensors; L and x are the only arrays it writes."""
    m, B = rt.shape
    L, x = torch.empty_like(St), torch.empty_like(rt)
    launch(LAUNCHES, "factor_refined_solve_t", lib().band_factor_solve_t,
           St.device, ptr(St), ptr(rt), ptr(L), ptr(x), m, bw, B, int(refine), *plan)
    return L, x


# ------------------------------------------------------ shared dispatch
def band_scatter_t(plan, contrib: torch.Tensor, index=None) -> torch.Tensor:
    """Schur entry values (B, n_s) → transposed band storage (m, bw+1, B).
    ``index`` is ``banded.plan_index(plan, contrib.device)``, if already
    built."""
    B = contrib.shape[0]
    St = contrib.new_zeros((plan.m, plan.bw + 1, B))
    row, off, src = index or bd.plan_index(plan, contrib.device)
    St[row, off, :] = contrib[:, src].T
    return St


def make_band_ops(plan, device, fused: bool = False, kernel: str = "auto"):
    """The band operations the interior point runs on ``device``, in the
    transposed layout: ``(scatter_fn, chol_fn, solve_fn, add_diag_fn,
    factor_solve_fn)`` as ``pallas_band.make_band_ops`` returns them.

    ``solve_fn(Lb, Sb, rp, refine)`` and ``factor_solve_fn(Sb, rp,
    refine)`` take ``rp`` as (B, m) in permuted row order.  ``fused``
    picks the one-launch factor + first solve for ``factor_solve_fn``;
    the split route (factor kernel, then solve kernel) is the one the TPU
    ran.  ``kernel`` is ``tpu.band_kernel``: "auto" and "pallas" call the
    kernels' wrappers (which launch on a CUDA tensor), "xla" the plain
    versions on any device, as the JAX package's scan path, and "cr"
    block cyclic reduction (``ops/block_cr.py``, plain PyTorch on any
    device): its factor is an opaque dict, and it reads the transposed
    band through a ``(B, m, bw+1)`` view, converted once per call, never
    per row.  "cr" has no fused route."""
    if kernel not in ("auto", "pallas", "xla", "cr"):
        raise ValueError(f"make_band_ops: band kernel {kernel!r} not in auto|pallas|xla|cr")
    bw = plan.bw
    index = bd.plan_index(plan, device)

    def add_diag_fn(Sb, rel):
        Sb = Sb.clone()
        Sb[:, 0, :] += rel * torch.amax(Sb[:, 0, :], dim=0, keepdim=True)
        return Sb

    def scatter_fn(c):
        return band_scatter_t(plan, c, index)

    if kernel == "cr":
        from dragg_tpu_torch.ops import block_cr

        def cr_chol(St):
            return block_cr.cr_factor(_to_b(St), bw)

        def cr_solve(Lf, St, rp, refine):
            v = block_cr.cr_solve(Lf, rp)
            for _ in range(refine):
                v = v + block_cr.cr_solve(Lf, rp - bd.band_matvec(_to_b(St), v, bw))
            return v

        def cr_factor_solve(St, rp, refine):
            Lf = cr_chol(St)
            return Lf, cr_solve(Lf, St, rp, refine)

        return scatter_fn, cr_chol, cr_solve, add_diag_fn, cr_factor_solve

    plain = kernel == "xla"
    chol = cholesky_t_plain if plain else banded_cholesky_t
    solve = refined_solve_t_plain if plain else refined_banded_solve_t
    factor_solve = factor_solve_t_plain if plain else factor_refined_solve_t

    def chol_fn(Sb):
        return chol(Sb, bw)

    def solve_fn(Lb, Sb, rp, refine):
        return solve(Lb, Sb, rp.T.contiguous(), bw, refine).T

    if fused:
        def factor_solve_fn(Sb, rp, refine):
            Lb, x = factor_solve(Sb, rp.T.contiguous(), bw, refine)
            return Lb, x.T
    else:
        def factor_solve_fn(Sb, rp, refine):
            Lb = chol_fn(Sb)
            return Lb, solve_fn(Lb, Sb, rp, refine)

    return scatter_fn, chol_fn, solve_fn, add_diag_fn, factor_solve_fn
