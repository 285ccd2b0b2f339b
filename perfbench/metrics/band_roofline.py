"""The band kernels' share of their roofline, in percent: the least time
of every band call of the traced chunks (``harness/band_bytes.py``: bytes
over 3.35 TB/s against float32 operations over 67 TFLOP/s, from each
call's (kernel, m, bw, B)), over the device time the profiler gives the
band kernels.  The shapes come from a record of the program's band
launches, kept while the traced chunks run."""

import contextlib

from perfbench.harness import band_bytes

# The profiler's names of the band kernels (dragg_tpu_torch/csrc/band.cu)
# and the launch wrapper each belongs to.
KERNELS = {"chol_kernel": "banded_cholesky_t",
           "refined_solve_kernel": "refined_banded_solve_t",
           "factor_solve_kernel": "factor_refined_solve_t"}


@contextlib.contextmanager
def instrument(run):
    """Record (wrapper, m, bw, B) of each band launch: the launch wrapper
    passes the pointers, then m, bw and B."""
    from dragg_tpu_torch.ops import band_kernels

    calls = run.counters.setdefault("band_calls", [])
    orig = band_kernels.launch
    n_ptrs = {"banded_cholesky_t": 2, "refined_banded_solve_t": 4, "factor_refined_solve_t": 4}

    def recording(counts, name, fn, device, *args):
        k = n_ptrs.get(name)
        if k is not None:
            calls.append((name, int(args[k]), int(args[k + 1]), int(args[k + 2])))
        return orig(counts, name, fn, device, *args)

    band_kernels.launch = recording
    try:
        yield
    finally:
        band_kernels.launch = orig


def read(run):
    tr = run.trace
    calls = run.counters.get("band_calls")
    if tr is None or not calls:
        return None
    dev = sum(float(d) for name, d in zip(tr.dev_name, tr.dev_dur)
              if any(k in name for k in KERNELS))
    if dev <= 0:
        return None
    least = sum(band_bytes.least_seconds(*c) for c in calls)
    return 100.0 * least / dev
