"""NumPy reference for the MinHash signature kernel."""

from __future__ import annotations

import numpy as np

EMPTY_SIG = np.uint32(0xFFFFFFFF)  # signature of an empty shingle set


def minhash_rows_ref(shingles: np.ndarray, lens: np.ndarray, a: np.ndarray,
                     b: np.ndarray) -> np.ndarray:
    """shingles (D, L) uint32 (garbage beyond lens), lens (D,), a/b (P,)
    uint32 -> (D, P) uint32 signatures.

    ``sig[d, p] = min over live lanes of (a[p] * shingles[d] + b[p])`` in
    wraparound uint32 arithmetic; rows with ``lens == 0`` get
    :data:`EMPTY_SIG`.
    """
    shingles = np.asarray(shingles, dtype=np.uint32)
    d, l = shingles.shape
    lens = np.asarray(lens, dtype=np.int64).reshape(d)
    a = np.asarray(a, dtype=np.uint32)
    b = np.asarray(b, dtype=np.uint32)
    live = np.arange(l)[None, :] < lens[:, None]
    out = np.empty((d, len(a)), dtype=np.uint32)
    for p in range(len(a)):
        with np.errstate(over="ignore"):
            h = a[p] * shingles + b[p]
        h = np.where(live, h, EMPTY_SIG)
        out[:, p] = h.min(axis=1) if l else EMPTY_SIG
    if l == 0:
        out[:] = EMPTY_SIG
    return out
