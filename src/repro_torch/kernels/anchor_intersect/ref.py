"""NumPy oracles for the anchor probes."""

from __future__ import annotations

import numpy as np


def anchor_probe_sliced_ref(queries, lo, hi, anchors) -> np.ndarray:
    """Per-slice lower bound: first j in [lo, hi) with anchors[j] >= q
    (hi when none; lo for an empty slice)."""
    q, lo, hi, a = (np.asarray(x) for x in (queries, lo, hi, anchors))
    out = np.empty(len(q), np.int32)
    for i in range(len(q)):
        seg = a[lo[i]:max(lo[i], hi[i])]
        out[i] = lo[i] + int(np.searchsorted(seg, q[i], side="left"))
    return out


def anchor_probe_ref(queries, anchors) -> tuple[np.ndarray, np.ndarray]:
    """queries (NQ,), anchors (NA,) sorted.  Returns (idx, found), both
    int32: idx = searchsorted-right, found = 1 on an exact hit."""
    q = np.asarray(queries, dtype=np.int64)
    a = np.asarray(anchors, dtype=np.int64)
    idx = np.searchsorted(a, q, side="right")
    found = (idx > 0) & (a[np.maximum(idx - 1, 0)] == q) if len(a) else np.zeros(len(q), bool)
    return idx.astype(np.int32), found.astype(np.int32)
