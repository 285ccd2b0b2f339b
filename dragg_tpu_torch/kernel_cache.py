"""Where the port's compiled libraries live: the CUDA kernel library
(``ops/cuda_lib.py``) and the native host library (``native.py``).

The directory resolves as the JAX package resolves its compile cache
(``dragg_tpu/utils/compile_cache.py``):

1. ``tpu.compile_cache_dir`` of the config an engine is built from;
2. ``$DRAGG_COMPILE_CACHE_DIR``;
3. ``dragg_tpu_torch/_build/`` beside the package.

``tpu.compile_cache = false`` builds into a fresh temporary directory of
the process's own, removed at exit, so nothing built earlier is reused
(JAX compiles afresh).  The first resolution holds for the process's
life, as JAX's first ``enable_compile_cache`` does: a loaded library
cannot be swapped, so a later request for another directory keeps the
first and logs it.

A build holds an exclusive ``fcntl`` lock on ``<library>.lock`` in the
directory and looks for the library again under it, so the ranks of a
job that share one directory run one build and load its result.  A
directory that cannot be written and holds no library raises and names
itself; nothing falls back to the package's directory.

    python -m dragg_tpu_torch.kernel_cache

builds both libraries into the resolved directory and prints one JSON
line.  An image runs it at build time with no card visible
(``CUDA_VISIBLE_DEVICES=``): nvcc needs none.  This module does not
import torch, so a torch-free parent (a serving or shard coordinator)
can load the host library.
"""

from __future__ import annotations

import atexit
import contextlib
import fcntl
import json
import logging
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ENV = "DRAGG_COMPILE_CACHE_DIR"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

_log = logging.getLogger(__name__)
# (source, directory): source "config" | "env" | "default" | "fresh" (the
# directory "" until the fresh one is made).  None until first resolved.
_CHOSEN: tuple[str, str] | None = None
_FRESH: str | None = None


def _requested(config: dict | None = None) -> tuple[str, str]:
    """(source, directory) that ``config`` and the environment ask for,
    in the resolution order of the module docstring; ``("fresh", "")``
    under ``tpu.compile_cache = false``."""
    tpu = (config or {}).get("tpu", {})
    if not tpu.get("compile_cache", True):
        return "fresh", ""
    for source, value in (("config", tpu.get("compile_cache_dir")),
                          ("env", os.environ.get(ENV))):
        if value:
            return source, os.path.abspath(os.path.expanduser(str(value)))
    return "default", DEFAULT_DIR


def configure(config: dict | None = None) -> None:
    """Fix the process's directory from ``config`` and the environment
    unless it is fixed already; a request for another directory then
    keeps the first and logs it.  Engines built from a config call this
    before their first launch."""
    global _CHOSEN
    want = _requested(config)
    if _CHOSEN is None:
        _CHOSEN = want
    elif want[1] != _CHOSEN[1]:
        _log.warning("the library directory is already %s (%s) in this process; "
                     "ignoring the later request for %s (%s): the first holds",
                     build_dir(), _CHOSEN[0], want[1] or "a fresh one", want[0])


def build_dir() -> str:
    """The process's library directory (resolved from the environment
    alone when no config fixed it first); a fresh one is made here."""
    global _CHOSEN, _FRESH
    if _CHOSEN is None:
        _CHOSEN = _requested()
    if _CHOSEN[0] != "fresh":
        return _CHOSEN[1]
    if _FRESH is None:
        _FRESH = tempfile.mkdtemp(prefix="dragg-kernels-")
        atexit.register(shutil.rmtree, _FRESH, True)
    return _FRESH


@contextlib.contextmanager
def build_lock(library: str):
    """Hold an exclusive lock on ``<library>.lock`` for the block (the
    caller looks for ``library`` again inside it).  Raises naming the
    directory when it cannot be created or written."""
    directory = os.path.dirname(library)
    try:
        os.makedirs(directory, exist_ok=True)
        fd = os.open(f"{library}.lock", os.O_RDWR | os.O_CREAT, 0o666)
    except OSError as e:
        raise RuntimeError(
            f"the library directory {directory} cannot be written ({e.strerror}) and "
            f"holds no {os.path.basename(library)}: build it there where it can be "
            f"written (python -m dragg_tpu_torch.kernel_cache), or point "
            f"tpu.compile_cache_dir or ${ENV} at a writable directory") from e
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def main() -> int:
    """Build the kernel and host libraries into the resolved directory (the
    host library beside the nvcc units) and print one JSON line: the
    directory, both paths, whether nvcc ran here, the
    ``$CUDA_VISIBLE_DEVICES`` the build saw, whether torch was imported
    (no: the build touches no card), the seconds."""
    from dragg_tpu_torch import native
    from dragg_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native._build_lib)
        kernels = cuda_lib.build_library()
        host = host.result()
    print(json.dumps({"directory": build_dir(), "kernels": kernels, "host": host,
                      "built": cuda_lib.built_here(),
                      "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                      "torch_imported": "torch" in sys.modules,
                      "seconds": round(time.perf_counter() - t0, 3)}))
    return 0 if host is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
