"""NumPy oracle for the fused decode / probe ops (pool-pointer form)."""

from __future__ import annotations

import numpy as np


def _rows(pool, ptr, L: int) -> np.ndarray:
    pool = np.asarray(pool, dtype=np.int64)
    at = np.asarray(ptr, dtype=np.int64).reshape(-1, 1) + np.arange(L)[None, :]
    return pool[np.clip(at, 0, len(pool) - 1)]


def decode_rows_ref(pool, ptr, base, lens, L: int):
    """(values (R, L) int32, valid (R, L) bool): row r is
    ``base[r] + pool[ptr[r] : ptr[r] + L]`` (reads clamped to the pool);
    lanes at or beyond ``lens[r]`` are invalid but still hold that sum."""
    r = len(np.asarray(ptr))
    vals = np.asarray(base, dtype=np.int64).reshape(r, 1) + _rows(pool, ptr, L)
    live = np.arange(L)[None, :] < np.asarray(lens).reshape(r, 1)
    return vals.astype(np.int32), live


def probe_rows_ref(pool, ptr, base, lens, targets) -> np.ndarray:
    """Membership of targets[r] in row r's first lens[r] decoded lanes."""
    lens = np.asarray(lens)
    L = max(1, int(lens.max())) if len(lens) else 1
    vals, live = decode_rows_ref(pool, ptr, base, lens, L)
    t = np.asarray(targets).reshape(-1, 1)
    return (live & (vals == t)).any(axis=1)
