"""Time the fused ReLU-QP window kernel at the engine's bucket shapes.

    python -m dragg_tpu_torch.bench_window [--horizons 24,48] [--reps 20]
                                           [--parent-src OLD/iter.cu]

For each horizon, builds the 10,000-home mixed community (the legacy bench
mix, as ``chip_smoke.py``), takes its four type buckets' shapes (m, n) and
home counts B, and on a consistent random window input (:func:`window_fixture`)
holds every plan the shape admits (``iter_kernels.window_plans``: Â in
registers or in shared memory, threads per block, cluster size) against the plain version (rtol 1e-3 / atol 1e-4, k = 25 and 1; a slice
of homes bit for bit against the full batch), then times one k = 25 window
of each with CUDA events, beside the plain version and both bounds.  With
``--parent-src``, also builds that source of the kernel (an older
``csrc/iter.cu`` with the earlier C interface: no plan arguments) and
times it on the same inputs, in turns: older, this, this, older.

Prints one JSON object with the card's name and power limit; the same
goes to ``chiprun_out/bench_window.json``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

H100_BYTES_PER_S = 3.35e12     # HBM3 (H100 SXM data sheet)
H100_F32_FLOP_PER_S = 67e12    # float32 outside the tensor cores
W_RTOL, W_ATOL = 1e-3, 1e-4
KW = dict(sigma=1e-6, alpha=1.6)   # the engine's admm_sigma / admm_alpha
CHECK_EVERY = 25
# Long enough (≈ 10 ms at the H100's clock) for the host to queue a timed
# run of launches before the device reaches them.
QUEUE_SLEEP_CYCLES = 20_000_000


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Median milliseconds of ``fn`` over ``reps`` calls, each between two
    CUDA events (the host's launch time included), after one warm-up call.
    With ``queued``, the mean over ``reps`` calls queued back to back behind
    a device-side sleep, so that the device never waits on the host: the
    device's own time per call."""
    import torch

    fn()
    if queued:
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def window_bounds(m: int, n: int, B: int, k: int) -> tuple[float, float]:
    """(seconds by bytes, seconds by operations) of one fused window: every
    input read once (Â, S⁻¹, eleven n-vectors, three m-vectors, ρ), every
    output written once (three n-vectors, one m-vector, four scalars), and
    k(4mn + 2m²) + 4mn float32 operations per home."""
    nbytes = 4 * B * (m * n + m * m + 14 * n + 4 * m + 5)
    ops = B * (k * (4 * m * n + 2 * m * m) + 4 * m * n)
    return nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOP_PER_S


def window_fixture(m: int, n: int, B: int, seed: int) -> tuple:
    """A consistent window input on the card (tests/test_pallas_iter.py):
    S⁻¹ is the inverse of Â D⁻¹ Âᵀ at the given rho, so the window is the
    real contractive solver map; a random S⁻¹ diverges over 25 iterations
    and a comparison then measures only noise."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.rand(s, device="cuda", generator=g)  # noqa: E731
    nrm = lambda *s: torch.randn(s, device="cuda", generator=g)  # noqa: E731
    A = 0.5 * nrm(B, m, n)
    w = 0.5 + rnd(B, n)
    rho = torch.full((B,), 0.4, device="cuda")
    p_diag = torch.full((B, n), 1e-3, device="cuda")
    Dinv = 1.0 / (p_diag + 1e-6 + rho[:, None] * w * w)
    Ad = A.double()
    S = torch.einsum("bmn,bn,bkn->bmk", Ad, Dinv.double(), Ad)
    Sinv = torch.linalg.inv(S + 1e-4 * torch.eye(m, device="cuda", dtype=torch.float64))
    del Ad, S
    ls, us = -1.0 - rnd(B, n), 1.0 + rnd(B, n)
    z = torch.minimum(torch.maximum(nrm(B, n), ls), us)
    return (A, Sinv.float().contiguous(), Dinv, w, nrm(B, n), nrm(B, m), ls, us, rho,
            0.1 * nrm(B, n), z, 0.1 * nrm(B, m), 0.1 * nrm(B, n),
            0.5 + rnd(B, m), 0.5 + rnd(B, n), 0.5 + rnd(B, n), p_diag)


def check_window(run, args, k: int, what: str) -> float:
    """``run(args, k)`` against the plain version (rtol 1e-3 / atol 1e-4)
    and a slice of homes against the full batch bit for bit; returns the
    largest absolute difference from the plain version."""
    import torch

    from dragg_tpu_torch.ops import iter_kernels as ik

    st, res = run(args, k)
    st_p, res_p = ik.fused_window_plain(*args, k=k, **KW)
    torch.cuda.synchronize()
    err = 0.0
    for a, b, name in zip(st + res, st_p + res_p,
                          ("x", "z", "nu", "y", "r_prim", "r_dual", "p_sc", "d_sc")):
        # NaN where the plain version is finite counts as a difference.
        bad = (~((a - b).abs() <= W_ATOL + W_RTOL * b.abs())).sum().item()
        if bad:
            raise AssertionError(f"fused_window {what} k={k}: {name} differs from its "
                                 f"plain version at {bad} entries")
        err = max(err, (a - b).abs().max().item())
    B = args[0].shape[0]
    lo = B // 3
    hi = min(B, lo + 257)
    part = run(tuple(a[lo:hi].contiguous() for a in args), k)
    for a, b, name in zip(part[0] + part[1], st + res,
                          ("x", "z", "nu", "y", "r_prim", "r_dual", "p_sc", "d_sc")):
        if not torch.equal(a, b[lo:hi]):
            d = (a != b[lo:hi]).reshape(hi - lo, -1).any(dim=1).nonzero().flatten().tolist()
            raise AssertionError(
                f"fused_window {what} k={k}: homes {lo}:{hi} alone differ from the full "
                f"batch in {name} at {len(d)} homes (first {[lo + i for i in d[:8]]}), "
                f"max |difference| {(a - b[lo:hi]).abs().max().item():.3g}")
    return err


def bucket_shapes(horizon: int, n_homes: int = 10_000, fields=("m_eq", "n_var")) -> list:
    """(name, *fields, B) of each type bucket of the mixed community: by
    default (name, m, n, B); ``fields=("m_eq", "band_bw")`` gives the band
    shapes."""
    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.config import mixed_community_config

    with tempfile.TemporaryDirectory() as d:
        agg = Aggregator(mixed_community_config(n_homes, horizon, "2015-01-01 01",
                                                bucketed="auto"),
                         outputs_dir=d, device="cuda")
        agg.get_homes()
        agg._build_engine()
        return [(b["name"], *(b[f] for f in fields), b["n_real"])
                for b in agg.engine.bucket_info()]


def parent_window(src: str):
    """The fused window of an older ``iter.cu`` (the C interface without
    plan arguments), built with this checkout's nvcc flags; returns
    ``run(args, k)``."""
    import torch

    from dragg_tpu_torch.ops.cuda_lib import build_source, ptr

    fn = ctypes.CDLL(build_source(src, "libparentwindow")).fused_window
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.argtypes = [P] * 25 + [I, I, I, I, D, D, P]
    fn.restype = I

    def run(args, k):
        A, x, z, nu, y, rho = args[0], args[9], args[10], args[11], args[12], args[8]
        B, m, n = A.shape
        outs = (torch.empty_like(x), torch.empty_like(z), torch.empty_like(nu),
                torch.empty_like(y), *(torch.empty_like(rho) for _ in range(4)))
        err = fn(*(ptr(a) for a in args), *(ptr(o) for o in outs), B, m, n, k,
                 KW["sigma"], KW["alpha"],
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"older fused_window: CUDA error {err}")
        return outs[:4], outs[4:]

    return run


def plan_name(plan) -> str:
    """Where Â is held (``registers`` or ``shared``), threads per block,
    rows per warp and, for a cluster, its size: ``registers-512-r5``,
    ``shared-256-r10-c2``."""
    name = (f"{'registers' if plan.regs else 'shared'}-{plan.threads}-r{plan.rows}"
            f"-b{plan.blocks_per_sm}")
    return name + (f"-c{plan.cluster}" if plan.cluster > 1 else "")


def bench_shape(bucket: str, m: int, n: int, B: int, reps: int, parent, seed: int) -> dict:
    from dragg_tpu_torch.ops import iter_kernels as ik

    args = window_fixture(m, n, B, seed)
    plans = {plan_name(p): p for p in ik.window_plans(m, n)}
    row = dict(bucket=bucket, m=m, n=n, B=B, k=CHECK_EVERY,
               plan=ik.window_plan(m, n)._asdict(), variants={})
    err = 0.0
    runs = {}
    for name, plan in plans.items():
        runs[name] = (lambda p: lambda a, k: ik._launch(a, p, k=k, **KW))(plan)
        for k in (CHECK_EVERY, 1):
            err = max(err, check_window(runs[name], args, k, f"{bucket} {name}"))
    if parent is not None:
        try:
            for k in (CHECK_EVERY, 1):
                check_window(parent, args, k, f"{bucket} older kernel")
        except RuntimeError as e:   # the older kernel refuses the shape
            row["parent_refused"] = str(e)
            parent = None
    row["max_abs_err"] = err

    def timed(run):
        return cuda_ms(lambda: run(args, CHECK_EVERY), reps)

    if parent is not None:
        first = timed(parent)
    for name, run in runs.items():
        row["variants"][name] = dict(plans[name]._asdict(), ms=timed(run))
    if parent is not None:
        row["parent_ms"] = [first] + [timed(parent)]
        # This kernel timed again between the two timings of the older one.
        row["ms_again"] = timed(lambda a, k: ik.fused_window(*a, k=k, **KW))
    row["ms"] = timed(lambda a, k: ik.fused_window(*a, k=k, **KW))
    row["plain_ms"] = cuda_ms(lambda: ik.fused_window_plain(*args, k=CHECK_EVERY, **KW), 3)
    t_b, t_o = window_bounds(m, n, B, CHECK_EVERY)
    row.update(bound_bytes_ms=1e3 * t_b, bound_ops_ms=1e3 * t_o)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dragg_tpu_torch.bench_window")
    p.add_argument("--horizons", default="24,48")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--parent-src", default=None)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_window: needs a CUDA card", file=sys.stderr)
        return 1
    from dragg_tpu_torch.ops.cuda_lib import build_library

    build_library()
    parent = parent_window(args.parent_src) if args.parent_src else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    out = dict(card=smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else None,
               horizons={})
    for h in (int(v) for v in args.horizons.split(",")):
        rows = [bench_shape(b, m, n, B, args.reps, parent, seed=1000 + 100 * i + h)
                for i, (b, m, n, B) in enumerate(bucket_shapes(h))]
        summary = dict(ms=sum(r["ms"] for r in rows),
                       plain_ms=sum(r["plain_ms"] for r in rows),
                       bound_bytes_ms=sum(r["bound_bytes_ms"] for r in rows),
                       bound_ops_ms=sum(r["bound_ops_ms"] for r in rows))
        # The fastest plan of each storage of Â, summed over the buckets.
        for store in ("registers", "shared"):
            best = [min((v["ms"] for name, v in r["variants"].items()
                         if name.startswith(store)), default=None) for r in rows]
            if None not in best:
                summary[f"{store}_ms"] = sum(best)
        if all("parent_ms" in r for r in rows):
            summary["parent_ms"] = [sum(r["parent_ms"][i] for r in rows) for i in (0, 1)]
            summary["ms_again"] = sum(r["ms_again"] for r in rows)
        out["horizons"][h] = dict(summary=summary, shapes=rows)
        print(f"[bench_window] H = {h}: {json.dumps(summary)}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "bench_window.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
