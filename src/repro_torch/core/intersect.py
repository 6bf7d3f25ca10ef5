"""Posting-list intersection algorithms (paper §2.1, §4.3).

Plain-array algorithms (operate on decoded absolute postings):

* ``intersect_merge`` — linear merge, best when lengths are similar.
* ``intersect_svs``   — set-vs-set with exponential (galloping) search.
* ``intersect_bys``   — Baeza-Yates recursive median splitting.
* ``intersect_multi`` — iterative pairwise svs, shortest-first (the winner
  in Barbay et al.'s study, used as the paper's default).

Compressed-domain algorithm (paper §4.3):

* ``intersect_repair_skip`` — candidate list (shortest, decoded) against a
  Re-Pair compressed list, skipping nonterminals by phrase sums, descending
  into R_B only where candidates land.  Optionally seeded by §4.2 samples.
"""

from __future__ import annotations

import numpy as np

from .repair import RePairStore

__all__ = [
    "intersect_merge",
    "intersect_svs",
    "intersect_bys",
    "intersect_multi",
    "intersect_repair_skip",
    "repair_intersect_multi",
]


def intersect_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Linear merge intersection (vectorized via np.intersect1d)."""
    return np.intersect1d(a, b, assume_unique=True)


def _gallop(arr: np.ndarray, x: int, lo: int) -> int:
    """Smallest index >= lo with arr[idx] >= x (exponential + binary)."""
    n = len(arr)
    if lo >= n or arr[lo] >= x:
        return lo
    step = 1
    hi = lo + 1
    while hi < n and arr[hi] < x:
        lo = hi
        step <<= 1
        hi = lo + step
    hi = min(hi, n)
    return int(np.searchsorted(arr[lo:hi], x, side="left")) + lo


def intersect_svs(short: np.ndarray, long: np.ndarray) -> np.ndarray:
    """Set-vs-set with galloping search on the longer list."""
    out = []
    pos = 0
    for x in short.tolist():
        pos = _gallop(long, x, pos)
        if pos >= len(long):
            break
        if long[pos] == x:
            out.append(x)
    return np.asarray(out, dtype=np.int64)


def intersect_bys(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Baeza-Yates: binary search the longer side for the shorter's median."""
    out: list[int] = []
    stack = [(0, len(a) - 1, 0, len(b) - 1)]
    while stack:
        alo, ahi, blo, bhi = stack.pop()
        if alo > ahi or blo > bhi:
            continue
        if ahi - alo <= bhi - blo:
            s, slo, shi, l, llo, lhi = a, alo, ahi, b, blo, bhi
        else:
            s, slo, shi, l, llo, lhi = b, blo, bhi, a, alo, ahi
        m = (slo + shi) // 2
        x = int(s[m])
        r = int(np.searchsorted(l[llo : lhi + 1], x, side="left")) + llo
        found = r <= lhi and l[r] == x
        if found:
            out.append(x)
        # rebuild child ranges in (a, b) orientation
        if s is a:
            stack.append((alo, m - 1, blo, r - 1))
            stack.append((m + 1, ahi, r + (1 if found else 0), bhi))
        else:
            stack.append((alo, r - 1, blo, m - 1))
            stack.append((r + (1 if found else 0), ahi, m + 1, bhi))
    return np.asarray(sorted(out), dtype=np.int64)


def intersect_multi(lists: list[np.ndarray]) -> np.ndarray:
    """Pairwise svs, shortest-first (paper §2.1 / [8])."""
    if not lists:
        return np.zeros(0, dtype=np.int64)
    order = sorted(lists, key=len)
    cand = order[0]
    for nxt in order[1:]:
        if len(cand) == 0:
            break
        cand = intersect_svs(cand, nxt)
    return cand


# ----------------------------------------------------------------------
# compressed-domain intersection over Re-Pair lists (§4.3)
# ----------------------------------------------------------------------
def _descend_collect(store: RePairStore, pos: int, s: int, cand: np.ndarray, ci: int, out: list) -> tuple[int, int]:
    """Search subtree at R_B ``pos`` (cumsum ``s`` on entry) for candidates
    cand[ci:] that fall inside it.  Returns (new ci, cumsum at subtree end).
    """
    p = store.packed
    ones = 0
    zeros = 0
    i = pos
    end_sum = s + int(p.rs[pos])
    while zeros <= ones and ci < len(cand):
        store.op_counter += 1
        if p.rb[i]:
            ones += 1
        else:
            zeros += 1
            v = int(p.rs[i])
            if v <= p.u:
                s += v
                while ci < len(cand) and cand[ci] < s:
                    ci += 1
                if ci < len(cand) and cand[ci] == s:
                    out.append(s)
                    ci += 1
            else:
                ref = v - p.u - 1
                ssum = int(p.rs[ref])
                # skip nested phrase unless a candidate lands inside it
                while ci < len(cand) and cand[ci] <= s:  # pragma: no cover
                    ci += 1
                if ci < len(cand) and cand[ci] <= s + ssum:
                    ci, s2 = _descend_collect(store, ref, s, cand, ci, out)
                    s = s2
                else:
                    s += ssum
        i += 1
    return ci, end_sum


def intersect_repair_skip(store: RePairStore, list_id: int, cand: np.ndarray) -> np.ndarray:
    """Intersect sorted candidate values with compressed list ``list_id``.

    ``cand`` holds absolute postings; comparison happens in cumulative-gap
    space (posting + 1).  Nonterminals whose span contains no candidate are
    skipped via their phrase sums without expansion (§4.1, §4.3).
    """
    if len(cand) == 0:
        return cand
    targets = cand + 1
    out: list[int] = []
    lo, hi = int(store.c_offsets[list_id]), int(store.c_offsets[list_id + 1])
    s = 0
    ci = 0
    start = lo
    if store.sampling is not None:
        start, s = store.sample_seek(list_id, int(targets[0]) - 1)
        # samples give (entry index, cumsum before it); candidates below s
        # cannot occur at/after start — they must be re-checked from list
        # start; to stay exact we only use the seek when it cannot skip a
        # candidate
        if s > 0 and targets[0] <= s:
            start, s = lo, 0
    for cidx in range(start, hi):
        if ci >= len(targets):
            break
        store.op_counter += 1
        sym = int(store.c[cidx])
        if sym <= store.packed.u:
            s += sym
            while ci < len(targets) and targets[ci] < s:
                ci += 1
            if ci < len(targets) and targets[ci] == s:
                out.append(s)
                ci += 1
        else:
            ref = sym - store.packed.u - 1
            ssum = int(store.packed.rs[ref])
            while ci < len(targets) and targets[ci] <= s:
                ci += 1
            if ci < len(targets) and targets[ci] <= s + ssum:
                ci, s = _descend_collect(store, ref, s, targets, ci, out)
            else:
                s += ssum
    return np.asarray(out, dtype=np.int64) - 1


def repair_intersect_multi(store: RePairStore, list_ids: list[int]) -> np.ndarray:
    """Paper §4.3: sort by stored uncompressed length; decode the shortest;
    intersect iteratively against longer lists in compressed form."""
    if not list_ids:
        return np.zeros(0, dtype=np.int64)
    order = sorted(list_ids, key=store.list_length)
    if store.variant != "skip":
        # plain variant: full decompression + merge (paper's RePair method)
        cand = store.get_list(order[0])
        for li in order[1:]:
            cand = intersect_merge(cand, store.get_list(li))
        return cand
    cand = store.get_list(order[0])
    for li in order[1:]:
        if len(cand) == 0:
            break
        cand = intersect_repair_skip(store, li, cand)
    return cand
