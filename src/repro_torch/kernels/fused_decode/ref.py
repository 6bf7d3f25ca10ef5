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


def _slice(c_offsets, list_id) -> tuple[int, int]:
    top = len(c_offsets) - 1
    return (int(c_offsets[min(max(int(list_id), 0), top)]),
            int(c_offsets[min(max(int(list_id) + 1, 0), top)]))


def decode_window_ref(pool, c_offsets, anchors, c_ptr, c_len, list_ids, row_start: int,
                      window_rows: int, L: int):
    """(values (B, window_rows * L) int32, valid bool): row k of query b is
    entry ``c_offsets[id] + row_start + k`` of its driving list ``id``
    (clamped into the entry table, live only below ``c_offsets[id + 1]``),
    decoded as :func:`decode_rows_ref`; no entries at all give zeros."""
    b, n = len(list_ids), len(anchors)
    if n == 0:
        z = np.zeros((b, window_rows * L), np.int32)
        return z, z.astype(bool)
    rows, lens = [], []
    for i in list_ids:
        lo, hi = _slice(c_offsets, i)
        for k in range(window_rows):
            r = lo + row_start + k
            rows.append(min(r, n - 1))
            lens.append(int(c_len[rows[-1]]) if r < hi else 0)
    rows = np.asarray(rows, np.int64)
    vals, live = decode_rows_ref(pool, np.asarray(c_ptr)[rows], np.asarray(anchors)[rows],
                                 np.asarray(lens), L)
    return vals.reshape(b, -1), live.reshape(b, -1)


def probe_window_ref(cand_vals, cand_valid, query_terms, query_lens, c_offsets, anchors,
                     c_ptr, c_len, pool, phrase: bool) -> np.ndarray:
    """Per (query, candidate): valid and, for every term t = 1 ..
    min(len, W) - 1, candidate (AND) or candidate + t (phrase, only while
    that stays below 2^31 - 1) is a posting of the term's list in
    cumulative-gap space — the set of every entry's decoded lanes, with no
    search at all."""
    cand_vals = np.asarray(cand_vals, np.int64)
    match = np.asarray(cand_valid, bool).copy()
    pool = np.asarray(pool, np.int64)
    for b in range(cand_vals.shape[0]):
        for t in range(1, min(int(query_lens[b]), query_terms.shape[1])):
            lo, hi = _slice(c_offsets, query_terms[b, t])
            members = [int(anchors[j]) + pool[int(c_ptr[j]):int(c_ptr[j]) + int(c_len[j])]
                       for j in range(lo, hi)]
            members = (np.concatenate(members) if members else np.zeros(0, np.int64))
            target = cand_vals[b] + (t if phrase else 0)
            ok = np.isin(target, members)
            if phrase:
                ok &= cand_vals[b] <= 2**31 - 2 - t
            match[b] &= ok
    return match
