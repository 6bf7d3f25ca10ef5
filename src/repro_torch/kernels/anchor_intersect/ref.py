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


def dense_probe_window_ref(cand_vals, cand_valid, query_terms, query_lens, c_offsets, anchors,
                           expand, expand_valid, phrase: bool) -> np.ndarray:
    """Per (query, candidate): valid and, for every term t = 1 ..
    min(len, W) - 1, candidate (AND) or candidate + t (phrase, only while
    that stays below 2^31 - 1) is a posting of the term's list in
    cumulative-gap space — the set of the valid lanes of the list's entries
    (ids clamped to the offsets table), with no search at all."""
    cand_vals = np.asarray(cand_vals, np.int64)
    match = np.asarray(cand_valid, bool).copy()
    expand, expand_valid = np.asarray(expand, np.int64), np.asarray(expand_valid, bool)
    c_offsets = np.asarray(c_offsets, np.int64)
    top = len(c_offsets) - 1
    for b in range(cand_vals.shape[0]):
        for t in range(1, min(int(query_lens[b]), query_terms.shape[1])):
            i = int(query_terms[b, t])
            lo, hi = c_offsets[min(max(i, 0), top)], c_offsets[min(max(i + 1, 0), top)]
            members = expand[lo:hi][expand_valid[lo:hi]]
            target = cand_vals[b] + (t if phrase else 0)
            ok = np.isin(target, members)
            if phrase:
                ok &= cand_vals[b] <= 2**31 - 2 - t
            match[b] &= ok
    return match


def anchor_probe_lift_ref(queries, anchors) -> tuple[np.ndarray, np.ndarray]:
    """The lift route of ``anchor_probe`` step by step, for the tests: K
    grows by s = top, top / 2, ..., 1 (top the largest power of two <= NA)
    wherever ``anchors[K + s - 1] <= q``; idx = K, and found compares the
    last anchor the lifting read (``anchors[K - 1]``) with the query."""
    q = np.asarray(queries, dtype=np.int64)
    a = np.asarray(anchors, dtype=np.int64)
    na = len(a)
    top = 1 << (na.bit_length() - 1) if na else 0
    idx = np.zeros(len(q), np.int32)
    found = np.zeros(len(q), np.int32)
    for i, t in enumerate(q):
        k, s, last = 0, top, None
        while s > 0:
            if k + s <= na and a[k + s - 1] <= t:
                k += s
                last = a[k - 1]
            s >>= 1
        idx[i] = k
        found[i] = int(k > 0 and last == t)
    return idx, found
