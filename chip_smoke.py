#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dragg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code on failure:

1. device: a CUDA card must be visible; prints its name and power limit;
2. build: compiles the band kernels from dragg_tpu_torch/csrc/ with nvcc;
3. kernels: holds each band kernel against its plain PyTorch version on
   the card at every bucket shape of the main path (H = 24), plus
   B = 10,000 and a ragged B = 1,001, refine 0 and 1, fused against split;
   times kernel, plain version and the dense library yardstick
   (torch.linalg.cholesky_ex / torch.cholesky_solve) with CUDA events;
4. correctness on small inputs: interior-point objectives within 1 % of
   HiGHS on a 16-home, 24 h community QP; an 8-home engine run on the card
   against the same run on the CPU;
5. main path: ``Aggregator(config, device="cuda").run()`` on a 10,000-home
   mixed community (legacy bench mix), 24 h horizon, 24 sim steps, through
   the split route (kernels 1 and 2), then again through the fused route
   (kernel 3), whose series must equal the split run's bit for bit;

then prints the kernels JSON line, the card line and, last, the result
line.  Per-shape details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

H100_BYTES_PER_S = 3.35e12     # HBM3 (H100 SXM data sheet)
H100_F32_FLOP_PER_S = 67e12    # float32 outside the tensor cores
N_HOMES = 10_000
SOURCE = "dragg_tpu_torch/csrc/band.cu"
REPLACES = {
    "banded_cholesky_t": "dragg_tpu/ops/pallas_band.py:346",
    "refined_banded_solve_t": "dragg_tpu/ops/pallas_band.py:446",
    "factor_refined_solve_t": "dragg_tpu/ops/pallas_band.py:514",
}
L_TOL, X_TOL = 1e-5, 1e-4   # pallas_band's self-test bounds (pallas_band.py:270-276)


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def community_config(n_homes: int, horizon: int, end: str, **tpu):
    # Imported here: main() first checks that the port is this checkout's.
    from dragg_tpu_torch.config import mixed_community_config

    return mixed_community_config(n_homes, horizon, end, **tpu)


# ------------------------------------------------------------ kernels
def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def random_band(m: int, bw: int, B: int, seed: int):
    """A diagonally dominant band SPD system: (m, bw+1, B) S and (m, B) r."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    S = torch.zeros((B, m, bw + 1), device="cuda")
    S[:, :, 0] = 10.0 + torch.rand((B, m), device="cuda", generator=g)
    for k in range(1, bw + 1):
        S[:, k:, k] = 0.5 * torch.randn((B, m - k), device="cuda", generator=g)
    r = torch.randn((m, B), device="cuda", generator=g)
    return S.permute(1, 2, 0).contiguous(), r


def dense_from_band(St):
    """(m, bw+1, B) lower band → dense symmetric (B, m, m)."""
    import torch

    m, bwp1, B = St.shape
    D = torch.zeros((B, m, m), device=St.device)
    i = torch.arange(m, device=St.device)
    for k in range(bwp1):
        rows = i[k:]
        D[:, rows, rows - k] = St[k:, k, :].T
        D[:, rows - k, rows] = St[k:, k, :].T
    return D


def bounds(m: int, bw: int, B: int) -> dict:
    """Least time (ms) per kernel at one shape: the larger of its bytes over
    the memory rate (each input read once, each output written once) and
    its float32 operations over the card's rate."""
    band, vec = m * (bw + 1) * B * 4, m * B * 4
    chol_ops = (bw * bw + 2 * bw + 2) * m * B
    solve_ops = 2 * (2 * bw + 1) * m * B
    refine_ops = (4 * bw + 2 + 1) * m * B + solve_ops
    work = {
        "banded_cholesky_t": (2 * band, chol_ops),
        "refined_banded_solve_t": (2 * band + 2 * vec, solve_ops + refine_ops),
        "factor_refined_solve_t": (2 * band + 2 * vec, chol_ops + solve_ops),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_b, t_o = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOP_PER_S
        out[name] = (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")
    return out


def kernel_phase(shapes) -> dict:
    """Parity of every kernel against its plain version at every shape, and
    timings at the main path's (bucket) shapes.  ``shapes`` is a list of
    (bucket, m, bw, B_bucket)."""
    import torch

    from dragg_tpu_torch.ops import band_kernels as bk

    err = {k: 0.0 for k in REPLACES}
    per_shape = []
    for si, (bucket, m, bw, nb) in enumerate(shapes):
        for B in dict.fromkeys((nb, N_HOMES, 1001)):
            St, r = random_band(m, bw, B, seed=100 * si + B % 97)
            L = bk.banded_cholesky_t(St, bw)
            Lp = bk.cholesky_t_plain(St, bw)
            torch.cuda.synchronize()
            e_l = (L - Lp).abs().max().item()
            check(e_l <= L_TOL, f"cholesky {bucket} B={B}: |L - plain| = {e_l}")
            err["banded_cholesky_t"] = max(err["banded_cholesky_t"], e_l)
            for refine in (0, 1):
                x = bk.refined_banded_solve_t(L, St, r, bw, refine)
                xp = bk.refined_solve_t_plain(Lp, St, r, bw, refine)
                L2, x2 = bk.factor_refined_solve_t(St, r, bw, refine)
                torch.cuda.synchronize()
                e_x = (x - xp).abs().max().item()
                check(e_x <= X_TOL, f"solve {bucket} B={B} refine={refine}: {e_x}")
                e_f = max((L2 - L).abs().max().item(), (x2 - x).abs().max().item())
                check(e_f <= 1e-6, f"fused vs split {bucket} B={B} refine={refine}: {e_f}")
                err["refined_banded_solve_t"] = max(err["refined_banded_solve_t"], e_x)
                err["factor_refined_solve_t"] = max(
                    err["factor_refined_solve_t"], e_f,
                    (L2 - Lp).abs().max().item(), (x2 - xp).abs().max().item())
            if B != nb:
                continue
            # Timings at the main path's shape: the IPM's calls are the
            # factor, the corrector solve (refine 1) and, fused, the
            # factor + predictor solve (refine 0).
            D = dense_from_band(St)
            Ld, _ = torch.linalg.cholesky_ex(D)
            rd = r.T.contiguous()[..., None]
            lib_chol = cuda_ms(lambda: torch.linalg.cholesky_ex(D), 10)
            lib_solve = cuda_ms(lambda: torch.cholesky_solve(rd, Ld), 10)
            row = {"bucket": bucket, "m": m, "bw": bw, "B": B, "kernels": {}}
            timed = {
                "banded_cholesky_t": (lambda: bk.banded_cholesky_t(St, bw),
                                      lambda: bk.cholesky_t_plain(St, bw), lib_chol),
                "refined_banded_solve_t": (
                    lambda: bk.refined_banded_solve_t(L, St, r, bw, 1),
                    lambda: bk.refined_solve_t_plain(L, St, r, bw, 1), lib_solve),
                "factor_refined_solve_t": (
                    lambda: bk.factor_refined_solve_t(St, r, bw, 0),
                    lambda: bk.factor_solve_t_plain(St, r, bw, 0),
                    lib_chol + lib_solve),
            }
            for name, (kern, plain, lib) in timed.items():
                bound_ms, bound_by = bounds(m, bw, B)[name]
                row["kernels"][name] = dict(
                    ms=cuda_ms(kern, 20), plain_ms=cuda_ms(plain, 3),
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=lib)
            per_shape.append(row)
            log(f"kernels at {bucket} (m={m}, bw={bw}, B={B}): " + json.dumps(row["kernels"]))
    return {"max_abs_err": err, "per_shape": per_shape}


# ------------------------------------------------ small-input checks
def highs_check() -> None:
    """IPM solutions on the card within 1 % of HiGHS, home by home, on the
    t = 0 QP of a 16-home mixed community at a 24 h horizon."""
    import numpy as np
    import torch
    from scipy.optimize import linprog

    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.ops.ipm import ipm_solve_qp

    with tempfile.TemporaryDirectory() as d:
        agg = Aggregator(community_config(16, 24, "2015-01-01 01", bucketed="false"),
                         outputs_dir=d, device="cuda")
        agg.get_homes()
        agg._build_engine()
    eng = agg.engine
    ctx = eng._buckets[0]
    qp, _ = eng._prepare(ctx, eng.init_state(), 0,
                         torch.zeros(eng.params.horizon, device="cuda"))
    sol = ipm_solve_qp(ctx.static.pattern, qp.vals, qp.b_eq, qp.l_box, qp.u_box,
                       qp.q, iters=eng.params.ipm_iters, eps_abs=2e-4, eps_rel=2e-4)
    pat = ctx.static.pattern
    vals, beq, lo, hi, q, x = (np.asarray(a.cpu(), np.float64) for a in
                               (qp.vals, qp.b_eq, qp.l_box, qp.u_box, qp.q, sol.x))
    solved = sol.solved.cpu().numpy()
    n_checked = 0
    for i in range(vals.shape[0]):
        A = np.zeros((pat.m, pat.n))
        np.add.at(A, (np.asarray(pat.rows), np.asarray(pat.cols)), vals[i])
        bnds = [(a if np.isfinite(a) else None, b if np.isfinite(b) else None)
                for a, b in zip(lo[i], hi[i])]
        ref = linprog(q[i], A_eq=A, b_eq=beq[i], bounds=bnds, method="highs")
        if not ref.success:
            check(not solved[i], f"home {i}: HiGHS infeasible but IPM solved")
            continue
        check(bool(solved[i]), f"home {i}: IPM unsolved where HiGHS solves")
        gap = (q[i] @ x[i] - ref.fun) / max(abs(ref.fun), 1e-3)
        check(abs(gap) < 0.01, f"home {i}: objective gap {gap:.4%} vs HiGHS")
        n_checked += 1
    check(n_checked >= 8, f"only {n_checked} homes comparable with HiGHS")
    log(f"HiGHS check: {n_checked}/{vals.shape[0]} homes within 1 %")


def cpu_vs_cuda_check() -> None:
    """An 8-home, 4 h-horizon, 6-step bucketed engine run on the card
    against the same run on the CPU (plain band versions)."""
    import numpy as np

    from dragg_tpu_torch.aggregator import Aggregator

    res = {}
    for dev in ("cpu", "cuda"):
        with tempfile.TemporaryDirectory() as d:
            agg = Aggregator(community_config(8, 4, "2015-01-01 06", bucketed="true"),
                             outputs_dir=d, device=dev)
            agg.run()
            with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
                res[dev] = json.load(f)
    worst = 0.0
    for name, series in res["cpu"].items():
        if name == "Summary":
            continue
        check(series["correct_solve"] == res["cuda"][name]["correct_solve"],
              f"{name}: solved flags differ between CPU and CUDA")
        for key, v in series.items():
            if isinstance(v, list):
                worst = max(worst, float(np.max(np.abs(
                    np.asarray(v) - np.asarray(res["cuda"][name][key])))))
    check(worst < 1e-2, f"CPU vs CUDA engine series differ by {worst}")
    log(f"CPU vs CUDA engine check: max |difference| {worst:.3g}")


# ------------------------------------------------------- main path
def drive(fused: bool, outputs_dir: str):
    """One Aggregator run of the 10,000-home community (24 steps) through
    the public entry point, with the launch counts reset just before it;
    returns (aggregator, results, launch counts, seconds)."""
    from dragg_tpu_torch.aggregator import Aggregator
    from dragg_tpu_torch.ops import band_kernels as bk

    cfg = community_config(N_HOMES, 24, "2015-01-02 00", bucketed="auto",
                           band_fused=fused)
    agg = Aggregator(cfg, outputs_dir=outputs_dir, device="cuda")
    bk.reset_launches()
    t0 = time.perf_counter()
    agg.run()
    seconds = time.perf_counter() - t0
    launches = dict(bk.LAUNCHES)
    with open(os.path.join(agg.run_dir, "baseline", "results.json")) as f:
        results = json.load(f)
    return agg, results, launches, seconds


def main_path(outputs_dir: str) -> dict:
    import numpy as np

    agg, res, launches, seconds = drive(False, os.path.join(outputs_dir, "split"))
    summary = res.pop("Summary")
    check(len(res) == N_HOMES, f"results.json holds {len(res)} homes")
    solved = []
    for name, series in res.items():
        for key, v in series.items():
            if isinstance(v, list):
                a = np.asarray(v, dtype=np.float64)
                want = 25 if key in ("temp_in_opt", "temp_wh_opt", "e_batt_opt") else 24
                check(a.shape == (want,) and np.all(np.isfinite(a)),
                      f"{name}.{key}: shape {a.shape} or non-finite values")
        solved.append(series["correct_solve"])
    check(launches["banded_cholesky_t"] > 0 and launches["refined_banded_solve_t"] > 0,
          f"main path did not launch the split-route kernels: {launches}")
    check(launches["factor_refined_solve_t"] == 0, f"split route launched fused: {launches}")
    iters = summary["solver_iterations"]
    phase = summary["phase_times"]
    stats = dict(
        homes=N_HOMES, steps=24, buckets=agg.engine.bucket_info(),
        solve_rate=float(np.mean(solved)), mean_ipm_iterations=float(np.mean(iters)),
        # One daily chunk: the engine steps' wall time over the 24 steps;
        # run_s adds home synthesis, the engine build and results.json.
        s_per_step=(phase["device_chunks"] + phase["collect"]) / 24,
        first_chunk_s_per_step=phase["device_chunks"] / 24,
        run_s=seconds, launches_split=launches,
    )
    log("main path (split): " + json.dumps(stats))

    # The fused route: the same run, series equal to the split run's.
    _, res2, launches2, seconds2 = drive(True, os.path.join(outputs_dir, "fused"))
    phase2 = res2.pop("Summary")["phase_times"]
    check(launches2["factor_refined_solve_t"] > 0 and launches2["banded_cholesky_t"] == 0,
          f"fused route launches: {launches2}")
    for name, series in res2.items():
        for key, v in series.items():
            if isinstance(v, list):
                check(v == res[name][key], f"fused route differs from split at {name}.{key}")
    stats.update(launches_fused=launches2, run_s_fused=seconds2,
                 s_per_step_fused=(phase2["device_chunks"] + phase2["collect"]) / 24)
    log(f"main path (fused): launches {launches2}, series equal to the split run's")
    return stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device visible")
    try:
        from dragg_tpu_torch.ops import band_kernels as bk
    except ImportError as e:
        return fail(f"the dragg_tpu_torch package is not importable here ({e})")
    # The run checks this checkout's port and kernel sources, never an
    # installed copy found elsewhere on the path.
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.abspath(bk.__file__).startswith(os.path.join(here, "dragg_tpu_torch", "")):
        return fail(f"dragg_tpu_torch comes from {bk.__file__}, not from {here}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "", f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({card}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    bk.build_library()
    log(f"build: {time.perf_counter() - t0:.1f} s")

    from dragg_tpu_torch.aggregator import Aggregator

    with tempfile.TemporaryDirectory() as d:
        agg = Aggregator(community_config(N_HOMES, 24, "2015-01-01 01", bucketed="auto"),
                         outputs_dir=d, device="cuda")
        agg.get_homes()
        agg._build_engine()
        shapes = [(b["name"], b["m_eq"], b["band_bw"], b["n_real"])
                  for b in agg.engine.bucket_info()]
        log(f"main-path bucket shapes (name, m, bw, B): {shapes}")
        kern = kernel_phase(shapes)
        highs_check()
        cpu_vs_cuda_check()
        stats = main_path(d)

    launches = {"banded_cholesky_t": stats["launches_split"]["banded_cholesky_t"],
                "refined_banded_solve_t": stats["launches_split"]["refined_banded_solve_t"],
                "factor_refined_solve_t": stats["launches_fused"]["factor_refined_solve_t"]}
    entries = []
    for name in REPLACES:
        rows = [r["kernels"][name] for r in kern["per_shape"]]
        entries.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name], max_abs_err=kern["max_abs_err"][name],
            # One call at every bucket's main-path shape, summed.
            ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by=rows[0]["bound_by"],
            library_ms=sum(r["library_ms"] for r in rows),
            shapes=[[r["bucket"], r["m"], r["bw"], r["B"]] for r in kern["per_shape"]],
        ))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kern, "main_path": stats}, f, indent=1)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except AssertionError as e:
        sys.exit(fail(str(e)))
