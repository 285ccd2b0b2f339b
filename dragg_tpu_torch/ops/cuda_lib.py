"""Build and bind the port's CUDA kernels.

Every source under ``csrc/`` is compiled by nvcc, once per content of the
sources, the flags and ``nvcc --version``, and linked into one shared
library with a plain C interface in the library directory
(``kernel_cache.build_dir()``: ``tpu.compile_cache_dir``, else
``$DRAGG_COMPILE_CACHE_DIR``, else ``_build/`` beside the package),
loaded with ctypes.  A directory shared over a cluster's file system
thus never hands a library to another toolkit, and concurrent ranks
run one build under the directory's lock.
``band.cu`` is compiled as five units (``DRAGG_BAND_PART``: the factor;
the refined solve's and the fused kernel's whole-band and ring variants
apart), all started together with ``iter.cu``'s: its 72 instantiations
take nvcc 101.1 s in one unit and at most 32.7 s a unit (``python -m
dragg_tpu_torch.bench_build`` on the machine of an NVIDIA H100 80GB
HBM3, 700.00 W, 8 cores; ``iter.cu`` 11.1 s).  Nothing
is built when a module is imported: the first kernel launch (or
:func:`build_library`) builds.  Building imports no torch (an image
builds with no card visible); the launch wrappers' modules do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from dragg_tpu_torch import kernel_cache

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG, "csrc", f) for f in ("band.cu", "iter.cu"))
# The compilation units: (source, its extra nvcc flags).
UNITS = (*((SOURCES[0], (f"-DDRAGG_BAND_PART={k}",)) for k in range(5)),
         (SOURCES[1], ()))
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
_LOADED: dict | None = None
_LIB_LOCK = threading.Lock()
_NVCC_VERSION: dict[str, str] = {}
# The libraries this process compiled (the others it found built).
_BUILT: set[str] = set()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels build with the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _nvcc_version(nvcc: str) -> str:
    """``nvcc --version``'s output, once a process."""
    if nvcc not in _NVCC_VERSION:
        proc = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
        if proc.returncode != 0:
            raise RuntimeError(f"{nvcc} --version failed:\n{proc.stderr}")
        _NVCC_VERSION[nvcc] = proc.stdout
    return _NVCC_VERSION[nvcc]


def library_path() -> str:
    """Where the library of this checkout's sources and flags, built by
    this toolkit, lives (``<library directory>/libdraggkernels-<content
    hash>.so``), built or not."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(_nvcc_version(_nvcc()).encode())
    for src, flags in UNITS:
        h.update(" ".join(flags).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(kernel_cache.build_dir(), f"libdraggkernels-{h.hexdigest()[:16]}.so")


def built_here() -> bool:
    """Whether this process compiled the library (a ``miss``), rather than
    finding it built (a ``hit``)."""
    return library_path() in _BUILT


def build_library() -> str:
    """Compile the kernel sources (once per content), one nvcc per unit
    (:data:`UNITS`), all started together, link them into one shared
    library and return its path.  Under the directory's lock, so that
    concurrent processes run one build."""
    path = library_path()
    if os.path.exists(path):
        return path
    with kernel_cache.build_lock(path):
        if os.path.exists(path):  # another process built it meanwhile
            return path
        nvcc, pid = _nvcc(), os.getpid()
        stem = os.path.splitext(path)[0]
        objs = [f"{stem}-{os.path.basename(src)}-{i}.{pid}.o"
                for i, (src, _) in enumerate(UNITS)]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for (src, flags), obj in zip(UNITS, objs)]
        errors = []
        for (src, _), proc in zip(UNITS, procs):
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
        _BUILT.add(path)
    return path


def build_source(src: str, stem: str) -> str:
    """Compile one kernel source on its own (an older ``csrc/*.cu``, to time
    beside this checkout's) into ``<library directory>/<stem>-<hash>.so``
    with this checkout's flags, once per content and toolkit, under the
    directory's lock; returns its path."""
    nvcc = _nvcc()
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                             + _nvcc_version(nvcc).encode()).hexdigest()[:16]
    so = os.path.join(kernel_cache.build_dir(), f"{stem}-{tag}.so")
    if os.path.exists(so):
        return so
    with kernel_cache.build_lock(so):
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, src],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {src}:\n{proc.stderr}")
            os.replace(tmp, so)
    return so


def lib():
    """The loaded library, built on first use."""
    global _LIB, _LOADED
    with _LIB_LOCK:
        if _LIB is None:
            path = build_library()
            so = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = _I
            _LIB = so
            _LOADED = {"path": path, "cache": "miss" if path in _BUILT else "hit"}
        return _LIB


def loaded() -> dict | None:
    """The library this process loaded: its path and ``cache``, ``hit``
    when it was found built, ``miss`` when this process compiled it;
    None before the first launch."""
    return _LOADED


def launch(counts: dict, name: str, fn, device, *args) -> None:
    """Call C entry point ``fn`` on the device's current stream, raise if
    it reports a CUDA error (a refused launch never runs), then add one
    to ``counts[name]``."""
    import torch

    stream = torch.cuda.current_stream(device)
    err = fn(*args, ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    counts[name] += 1


def ptr(a) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.data_ptr())
