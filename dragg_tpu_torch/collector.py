"""Per-home series store and the streaming results.json writer
(counterpart of the pure-Python path of ``dragg_tpu.native.SeriesCollector``;
the port needs no C++ host runtime).  Series are kept as the (n_steps,
n_homes) float64 chunks they arrive in."""

from __future__ import annotations

import json
import os

import numpy as np


class SeriesCollector:
    """Per-home series, appended one chunk at a time."""

    def __init__(self, n_homes: int):
        self.n_homes = int(n_homes)
        self._chunks: dict[str, list[np.ndarray]] = {}

    def add_chunk(self, key: str, data) -> None:
        """Append an (n_steps, n_homes) array to series ``key``."""
        arr = np.array(data, dtype=np.float64)
        if arr.ndim != 2 or arr.shape[1] != self.n_homes:
            raise ValueError(f"chunk shape {arr.shape} != (*, {self.n_homes})")
        self._chunks.setdefault(key, []).append(arr)

    def _series(self, key: str) -> np.ndarray:
        chunks = self._chunks.get(key)
        if not chunks:
            return np.zeros((0, self.n_homes))
        if len(chunks) > 1:
            chunks[:] = [np.concatenate(chunks, axis=0)]
        return chunks[0]

    def import_series(self, key: str, home_idx: int, values) -> None:
        """Replace home ``home_idx``'s series ``key`` with ``values`` (a
        resumed run restoring a checkpoint's per-home lists).  The store
        stays dense: it grows to the longest series imported, and rows a
        home has no value for hold NaN.  A resume imports every home whose
        series reach results.json, all to the same length, so only homes
        whose series are never written keep NaN rows."""
        arr = np.asarray(values, dtype=np.float64).reshape(-1)
        cur = self._series(key)
        if cur.shape[0] < arr.size:
            pad = np.full((arr.size - cur.shape[0], self.n_homes), np.nan)
            cur = np.concatenate([cur, pad], axis=0)
            self._chunks[key] = [cur]
        cur[:, home_idx] = np.nan
        cur[:arr.size, home_idx] = arr

    def length(self, key: str, home_idx: int = 0) -> int:
        return int(self._series(key).shape[0])

    def get(self, key: str, home_idx: int) -> list[float]:
        return self._series(key)[:, home_idx].tolist()

    def write_json(self, path: str, plan: list[tuple]) -> None:
        """Execute a write plan of ('raw', str) and ('series', key,
        home_idx) records: raw fragments carry all JSON structure, series
        records expand to JSON arrays of the stored doubles.  The file is
        replaced atomically."""
        out = []
        for rec in plan:
            if rec[0] == "raw":
                out.append(rec[1])
            else:
                out.append(json.dumps(self.get(rec[1], rec[2])))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("".join(out))
        os.replace(tmp, path)
