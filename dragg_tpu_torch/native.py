"""ctypes bindings for the native host runtime (the counterpart of
``dragg_tpu/native.py``): the repo's ``native/statebus.cpp`` and
``native/collector.cpp``, built with g++ into the library directory
(``kernel_cache.build_dir()``, by default this package's ``_build/``).

Two components, both with transparent pure-Python fallbacks so the host
runtime works on machines without a C++ toolchain (host code only: no
device path falls back to anything):

* :class:`StateBus` — the in-process replacement for the reference's Redis
  server (dragg/redis_client.py:13-25): same verbs, same semantics, C++
  shared-memory store instead of a C server over TCP.
* :class:`SeriesCollector` — native per-home series accumulation and the
  streaming results.json writer (replaces the reference's per-timestep
  Redis reads + whole-dict json.dump, dragg/aggregator.py:728-755,831-844).

The shared library is built once on demand with ``g++ -O2 -shared -fPIC``
into the library directory that the kernel library shares
(``tpu.compile_cache_dir``, else ``$DRAGG_COMPILE_CACHE_DIR``, else
``dragg_tpu_torch/_build/``), under its lock (a plain C ABI + ctypes
needs no build-time Python dependency at all).  A directory that cannot
be written and holds no library raises; a missing toolchain takes the
fallback.  ``StateBus().native`` /
``SeriesCollector(n).native`` say which backend runs (the doctor's
``native_runtime`` check reports it as ``native_extension``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from dragg_tpu_torch import kernel_cache

_LIB = None
_LIB_TRIED = False
_LOCK = threading.Lock()

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(os.path.dirname(_PKG), "native")
_BUILD_DIR = kernel_cache.DEFAULT_DIR  # the library directory by default
_SOURCES = ["statebus.cpp", "collector.cpp"]


def _build_lib() -> str | None:
    """Compile the native library if needed; returns its path or None (no
    toolchain).  Raises when the library directory cannot be written."""
    lib_path = os.path.join(kernel_cache.build_dir(), "libdragghost.so")
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    if not all(os.path.isfile(s) for s in srcs):
        return None

    def current() -> bool:
        return os.path.isfile(lib_path) and all(
            os.path.getmtime(lib_path) >= os.path.getmtime(s) for s in srcs)

    if current():
        return lib_path
    with kernel_cache.build_lock(lib_path):
        if current():  # another process built it meanwhile
            return lib_path
        # Compile to a per-process temp name and atomically publish, so a
        # process that loads without the lock never dlopens a half-written
        # library.
        tmp_path = f"{lib_path}.{os.getpid()}.tmp"
        cmd = ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", tmp_path, *srcs]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp_path, lib_path)
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp_path):
                try:
                    os.remove(tmp_path)
                except OSError:
                    pass
            return None
    return lib_path


def load_library():
    """Load (building if necessary) the native library; None if unavailable."""
    global _LIB, _LIB_TRIED
    with _LOCK:
        if _LIB_TRIED:
            return _LIB
        path = _build_lib()  # raises (and stays untried) on an unwritable directory
        _LIB_TRIED = True
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        c = ctypes.c_char_p
        i64 = ctypes.c_int64
        dp = ctypes.POINTER(ctypes.c_double)
        lib.sb_free.argtypes = [ctypes.c_void_p]
        lib.sb_get.restype = ctypes.c_void_p
        lib.sb_get.argtypes = [c]
        lib.sb_set.argtypes = [c, c]
        lib.sb_del.argtypes = [c]
        lib.sb_exists.argtypes = [c]
        lib.sb_hset.argtypes = [c, c, c]
        lib.sb_hget.restype = ctypes.c_void_p
        lib.sb_hget.argtypes = [c, c]
        lib.sb_hgetall.restype = ctypes.c_void_p
        lib.sb_hgetall.argtypes = [c]
        lib.sb_rpush.argtypes = [c, c]
        lib.sb_rpush_n.argtypes = [c, ctypes.POINTER(c), i64]
        lib.sb_llen.restype = i64
        lib.sb_llen.argtypes = [c]
        lib.sb_lrange.restype = ctypes.c_void_p
        lib.sb_lrange.argtypes = [c, i64, i64]
        lib.col_new.restype = i64
        lib.col_new.argtypes = [i64]
        lib.col_free.argtypes = [i64]
        lib.col_add_chunk.argtypes = [i64, c, dp, i64, i64]
        lib.col_import_series.argtypes = [i64, c, i64, dp, i64]
        lib.col_series_len.restype = i64
        lib.col_series_len.argtypes = [i64, c, i64]
        lib.col_get_series.restype = i64
        lib.col_get_series.argtypes = [i64, c, i64, dp, i64]
        lib.col_write_json.restype = ctypes.c_int
        lib.col_write_json.argtypes = [i64, c, ctypes.c_char_p, i64]
        _LIB = lib
        return _LIB


def _take_cstr(lib, ptr) -> bytes | None:
    """Copy + free a heap C string returned by the library."""
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr)
    finally:
        lib.sb_free(ptr)


def _parse_frames(raw: bytes, pairs: bool):
    """Decode the length-prefixed framing produced by statebus.cpp."""
    pos = raw.index(b"\n")
    n = int(raw[:pos])
    pos += 1
    out = []
    for _ in range(n * (2 if pairs else 1)):
        sp = raw.index(b" ", pos)
        ln = int(raw[pos:sp])
        start = sp + 1
        out.append(raw[start:start + ln])
        pos = start + ln + 1  # skip trailing newline
    if pairs:
        return {out[i].decode(): out[i + 1].decode() for i in range(0, len(out), 2)}
    return [b.decode() for b in out]


# --------------------------------------------------------------------------
# StateBus
# --------------------------------------------------------------------------

_FALLBACK_DATA: dict = {}
_FALLBACK_MU = threading.Lock()


def _check_text(v) -> str:
    """Keys/values cross the C-string ABI; embedded NULs would silently
    truncate there, so both backends reject them up front (the store's
    payloads are numeric strings — full binary safety is out of scope)."""
    s = str(v)
    if "\x00" in s:
        raise ValueError("StateBus keys/values must not contain NUL bytes")
    return s


class StateBus:
    """Redis-verb store. Native-backed when the library builds; otherwise a
    threadsafe in-process dict with identical semantics.  Both backends are
    process-global (like a Redis server): every StateBus instance sees the
    same data."""

    def __init__(self):
        self._lib = load_library()
        if self._lib is None:
            self._data = _FALLBACK_DATA
            self._mu = _FALLBACK_MU

    @property
    def native(self) -> bool:
        return self._lib is not None

    def flushall(self):
        if self._lib:
            self._lib.sb_flushall()
        else:
            with self._mu:
                self._data.clear()

    def delete(self, key: str):
        if self._lib:
            self._lib.sb_del(key.encode())
        else:
            with self._mu:
                self._data.pop(key, None)

    def set(self, key: str, val) -> None:
        if self._lib:
            self._lib.sb_set(_check_text(key).encode(), _check_text(val).encode())
        else:
            with self._mu:
                self._data[_check_text(key)] = _check_text(val)

    def get(self, key: str) -> str | None:
        if self._lib:
            raw = _take_cstr(self._lib, self._lib.sb_get(key.encode()))
            return None if raw is None else raw.decode()
        with self._mu:
            v = self._data.get(key)
            return v if isinstance(v, str) else None

    def hset(self, key: str, field: str, val) -> None:
        if self._lib:
            self._lib.sb_hset(_check_text(key).encode(), _check_text(field).encode(), _check_text(val).encode())
        else:
            with self._mu:
                d = self._data.setdefault(key, {})
                if not isinstance(d, dict):
                    d = self._data[key] = {}
                d[_check_text(field)] = _check_text(val)

    def hget(self, key: str, field: str) -> str | None:
        if self._lib:
            raw = _take_cstr(self._lib, self._lib.sb_hget(key.encode(), field.encode()))
            return None if raw is None else raw.decode()
        with self._mu:
            d = self._data.get(key)
            return d.get(field) if isinstance(d, dict) else None

    def hgetall(self, key: str) -> dict:
        if self._lib:
            raw = _take_cstr(self._lib, self._lib.sb_hgetall(key.encode()))
            return {} if raw is None else _parse_frames(raw, pairs=True)
        with self._mu:
            d = self._data.get(key)
            return dict(d) if isinstance(d, dict) else {}

    def rpush(self, key: str, *vals) -> None:
        if self._lib:
            # One batched native call → one lock acquisition, so a
            # multi-value push is atomic like Redis RPUSH (a concurrent
            # lrange/llen can't observe it half-applied).
            enc = [_check_text(v).encode() for v in vals]
            arr = (ctypes.c_char_p * len(enc))(*enc)
            self._lib.sb_rpush_n(key.encode(), arr, len(enc))
        else:
            with self._mu:
                lst = self._data.setdefault(key, [])
                if not isinstance(lst, list):
                    lst = self._data[key] = []
                lst.extend(_check_text(v) for v in vals)

    def llen(self, key: str) -> int:
        if self._lib:
            return int(self._lib.sb_llen(key.encode()))
        with self._mu:
            lst = self._data.get(key)
            return len(lst) if isinstance(lst, list) else 0

    def lrange(self, key: str, start: int, stop: int) -> list[str]:
        if self._lib:
            raw = _take_cstr(self._lib, self._lib.sb_lrange(key.encode(), start, stop))
            return [] if raw is None else _parse_frames(raw, pairs=False)
        with self._mu:
            lst = self._data.get(key)
            if not isinstance(lst, list):
                return []
            n = len(lst)
            if start < 0:
                start += n
            if stop < 0:
                stop += n
            # Redis semantics: indices still negative after conversion clamp
            # to the list edges (stop < 0 → empty range).
            if stop < 0:
                return []
            return lst[max(start, 0):min(stop, n - 1) + 1]


# --------------------------------------------------------------------------
# SeriesCollector
# --------------------------------------------------------------------------

class SeriesCollector:
    """Per-home series store with a streaming JSON writer.

    Falls back to Python lists when the native library is unavailable; the
    API (add_chunk / get / length / import_series / write_json) is identical.
    """

    def __init__(self, n_homes: int):
        import numpy as np

        self._np = np
        self.n_homes = int(n_homes)
        self._lib = load_library()
        if self._lib is not None:
            self._h = self._lib.col_new(self.n_homes)
        else:
            self._h = None
            self._series: dict[str, list[list[float]]] = {}

    @property
    def native(self) -> bool:
        return self._h is not None

    def close(self):
        if self._h is not None:
            self._lib.col_free(self._h)
            self._h = None

    def add_chunk(self, key: str, data) -> None:
        """Append a (n_steps, n_homes) array to series ``key``."""
        np = self._np
        arr = np.ascontiguousarray(np.asarray(data, dtype=np.float64))
        if arr.ndim != 2 or arr.shape[1] != self.n_homes:
            raise ValueError(f"chunk shape {arr.shape} != (*, {self.n_homes})")
        if self._h is not None:
            ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            rc = self._lib.col_add_chunk(self._h, key.encode(), ptr,
                                         arr.shape[0], arr.shape[1])
            if rc != 0:
                raise RuntimeError(f"col_add_chunk failed: {rc}")
        else:
            cols = self._series.setdefault(key, [[] for _ in range(self.n_homes)])
            for i in range(self.n_homes):
                cols[i].extend(float(v) for v in arr[:, i])

    def import_series(self, key: str, home_idx: int, values) -> None:
        np = self._np
        arr = np.ascontiguousarray(np.asarray(values, dtype=np.float64))
        if self._h is not None:
            ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            rc = self._lib.col_import_series(self._h, key.encode(), home_idx, ptr, arr.size)
            if rc != 0:
                raise RuntimeError(f"col_import_series failed: {rc}")
        else:
            cols = self._series.setdefault(key, [[] for _ in range(self.n_homes)])
            cols[home_idx] = [float(v) for v in arr]

    def length(self, key: str, home_idx: int = 0) -> int:
        if self._h is not None:
            return int(self._lib.col_series_len(self._h, key.encode(), home_idx))
        cols = self._series.get(key)
        return len(cols[home_idx]) if cols else 0

    def get(self, key: str, home_idx: int) -> list[float]:
        if self._h is not None:
            n = self.length(key, home_idx)
            buf = (ctypes.c_double * n)()
            got = self._lib.col_get_series(self._h, key.encode(), home_idx, buf, n)
            return list(buf[: max(got, 0)])
        cols = self._series.get(key)
        return list(cols[home_idx]) if cols else []

    def keys(self) -> list[str]:
        if self._h is not None:
            raise NotImplementedError("track keys on the Python side")
        return list(self._series)

    def write_json(self, path: str, plan: list[tuple]) -> None:
        """Execute a write plan.

        ``plan`` is a list of ('raw', str) and ('series', key, home_idx)
        records; raw fragments carry all JSON structure, series records
        expand to JSON arrays of the stored doubles.
        """
        if self._h is not None:
            parts = []
            for rec in plan:
                if rec[0] == "raw":
                    b = rec[1].encode()
                    parts.append(b"R %d\n%s" % (len(b), b))
                else:
                    k = rec[1].encode()
                    parts.append(b"S %d %d\n%s" % (len(k), rec[2], k))
            blob = b"".join(parts)
            rc = self._lib.col_write_json(self._h, path.encode(), blob, len(blob))
            if rc != 0:
                raise RuntimeError(f"col_write_json failed: {rc}")
        else:
            import json as _json

            out = []
            for rec in plan:
                if rec[0] == "raw":
                    out.append(rec[1])
                else:
                    out.append(_json.dumps(self.get(rec[1], rec[2])))
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write("".join(out))
            os.replace(tmp, path)
