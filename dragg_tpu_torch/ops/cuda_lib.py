"""Build and bind the port's CUDA kernels.

Every source under ``csrc/`` is compiled by nvcc, once per content of the
sources and flags, and linked into one shared library with a plain C
interface in ``_build/`` beside the package, loaded with ctypes.  Nothing
is built when a module is imported: the first kernel launch (or
:func:`build_library`) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG, "csrc", f) for f in ("band.cu", "iter.cu"))
_BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# argtypes of each C entry point, the stream last.
_SIGNATURES = {
    # S, L, m, bw, B, the plan's hb, depth, rows, smem, stream
    "band_cholesky_t": [_P, _P] + [_I] * 7 + [_P],
    # L, S, r, x, m, bw, B, refine, the plan's hb, depth, rows, smem, stream
    "band_refined_solve_t": [_P] * 4 + [_I] * 8 + [_P],
    # S, r, L, x, m, bw, B, refine, the plan's hb, depth, rows, smem, stream
    "band_factor_solve_t": [_P] * 4 + [_I] * 8 + [_P],
    # 17 inputs, 8 outputs, B, m, n, k, sigma, alpha, the plan's threads,
    # rows, cols, scols, cluster, regs, blocks_per_sm, smem, stream
    "fused_window": [_P] * 25 + [_I, _I, _I, _I, _D, _D] + [_I] * 8 + [_P],
}

_LIB = None
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels build with the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def build_library() -> str:
    """Compile the kernel sources (once per content), one nvcc per source,
    all started together, link them into one shared library and return
    its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"libdraggkernels-{tag}.so")
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [os.path.join(_BUILD_DIR, f"{os.path.basename(src)}-{tag}.{pid}.o")
            for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(SOURCES, objs)]
    errors = []
    for src, proc in zip(SOURCES, procs):
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            errors.append(f"nvcc failed building {src}:\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = f"{path}.{pid}.tmp"
    proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed linking {path}:\n{proc.stderr}")
    os.replace(tmp, path)
    for obj in objs:
        os.remove(obj)
    return path


def build_source(src: str, stem: str) -> str:
    """Compile one kernel source on its own (an older ``csrc/*.cu``, to time
    beside this checkout's) into ``_build/<stem>-<hash>.so`` with this
    checkout's flags, once per content; returns its path."""
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f"{stem}-{tag}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", so, src],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src}:\n{proc.stderr}")
    return so


def lib():
    """The loaded library, built on first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            so = ctypes.CDLL(build_library())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = _I
            _LIB = so
        return _LIB


def launch(counts: dict, name: str, fn, device: torch.device, *args) -> None:
    """Call C entry point ``fn`` on the device's current stream, raise if
    it reports a CUDA error (a refused launch never runs), then add one
    to ``counts[name]``."""
    stream = torch.cuda.current_stream(device)
    err = fn(*args, ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    counts[name] += 1


def ptr(a: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.data_ptr())
