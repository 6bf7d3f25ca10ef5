"""NumPy oracle for the sliced anchor probe."""

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
