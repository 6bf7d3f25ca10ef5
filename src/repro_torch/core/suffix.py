"""Suffix-array machinery over integer sequences (numpy, prefix doubling).

Shared by the LZ parsers (``repro_torch.core.lz``) and the CSA-family self-indexes
(``repro_torch.core.selfindex``).  Works for byte texts and word-id texts alike.
"""

from __future__ import annotations

import numpy as np

__all__ = ["suffix_array", "inverse_permutation", "bwt_from_sa", "RangeMin", "OccRank", "Fenwick"]


def suffix_array(t: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling, O(n log^2 n). ``t`` int array >= 0.

    No sentinel is appended: shorter suffixes sort before extensions
    (handled by rank padding with -1).
    """
    t = np.asarray(t, dtype=np.int64)
    n = len(t)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = np.unique(t, return_inverse=True)[1].astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    k = 1
    while True:
        # key = (rank[i], rank[i+k] or -1)
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        sa = order
        new_rank = np.zeros(n, dtype=np.int64)
        r_prev = rank[sa[:-1]]
        r_next = rank[sa[1:]]
        s_prev = second[sa[:-1]]
        s_next = second[sa[1:]]
        diff = (r_prev != r_next) | (s_prev != s_next)
        new_rank[sa[1:]] = np.cumsum(diff)
        rank = new_rank
        if rank[sa[-1]] == n - 1:
            break
        k <<= 1
    return sa.astype(np.int64)


def inverse_permutation(p: np.ndarray) -> np.ndarray:
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p), dtype=p.dtype)
    return inv


def bwt_from_sa(t: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """BWT over an integer alphabet; position 0 wraps to t[n-1]."""
    n = len(t)
    prev = sa - 1
    prev[prev < 0] = n - 1
    return t[prev]


class RangeMin:
    """Static range-minimum with argmin, block-decomposed sparse table.

    Memory O(n/bs * log(n/bs)); query O(bs).
    """

    def __init__(self, a: np.ndarray, block: int = 16):
        self.a = np.asarray(a, dtype=np.int64)
        self.bs = block
        n = len(self.a)
        nb = (n + block - 1) // block
        pad = np.full(nb * block - n, np.iinfo(np.int64).max, dtype=np.int64)
        blocks = np.concatenate([self.a, pad]).reshape(nb, block)
        bmin = blocks.min(axis=1)
        # sparse table over block minima
        levels = [bmin]
        k = 1
        while (1 << k) <= nb:
            prev = levels[-1]
            m = nb - (1 << k) + 1
            levels.append(np.minimum(prev[:m], prev[(1 << (k - 1)) : (1 << (k - 1)) + m]))
            k += 1
        self.levels = levels
        self.nb = nb

    def min(self, lo: int, hi: int) -> int:
        """min(a[lo..hi]) inclusive."""
        if lo > hi:
            return np.iinfo(np.int64).max
        bs = self.bs
        blo, bhi = lo // bs, hi // bs
        if blo == bhi:
            return int(self.a[lo : hi + 1].min())
        m = min(int(self.a[lo : (blo + 1) * bs].min()), int(self.a[bhi * bs : hi + 1].min()))
        if blo + 1 <= bhi - 1:
            span = bhi - 1 - (blo + 1) + 1
            k = span.bit_length() - 1
            lvl = self.levels[k]
            m = min(m, int(lvl[blo + 1]), int(lvl[bhi - 1 - (1 << k) + 1]))
        return m

    def argmin_below(self, lo: int, hi: int, bound: int) -> int:
        """Index of some a[i] < bound with lo <= i <= hi, or -1."""
        if self.min(lo, hi) >= bound:
            return -1
        # binary descent: narrow to a block then scan
        bs = self.bs
        i = lo
        while hi - i >= bs:
            mid = (i + hi) // 2
            if self.min(i, mid) < bound:
                hi = mid
            else:
                i = mid + 1
        for j in range(i, hi + 1):
            if self.a[j] < bound:
                return j
        return -1


class OccRank:
    """rank_c(i) over an integer sequence via per-symbol position lists."""

    def __init__(self, seq: np.ndarray):
        seq = np.asarray(seq, dtype=np.int64)
        order = np.argsort(seq, kind="stable")
        sorted_syms = seq[order]
        syms, starts = np.unique(sorted_syms, return_index=True)
        self.positions: dict[int, np.ndarray] = {}
        for j, c in enumerate(syms.tolist()):
            lo = starts[j]
            hi = starts[j + 1] if j + 1 < len(starts) else len(seq)
            self.positions[c] = order[lo:hi]
        for c in self.positions:
            self.positions[c].sort()

    def rank(self, c: int, i: int) -> int:
        """# occurrences of c in seq[0..i-1]."""
        pos = self.positions.get(int(c))
        if pos is None:
            return 0
        return int(np.searchsorted(pos, i, side="left"))

    def count(self, c: int) -> int:
        pos = self.positions.get(int(c))
        return 0 if pos is None else len(pos)


class Fenwick:
    """Binary indexed tree over [0, n) with point add / prefix sum /
    find-first-set-at-or-after."""

    def __init__(self, n: int):
        self.n = n
        self.t = np.zeros(n + 1, dtype=np.int64)

    def add(self, i: int, v: int = 1) -> None:
        i += 1
        while i <= self.n:
            self.t[i] += v
            i += i & (-i)

    def prefix(self, i: int) -> int:
        """sum over [0, i)"""
        s = 0
        while i > 0:
            s += int(self.t[i])
            i -= i & (-i)
        return s

    def range_count(self, lo: int, hi: int) -> int:
        """sum over [lo, hi] inclusive."""
        if hi < lo:
            return 0
        return self.prefix(hi + 1) - self.prefix(lo)

    def find_kth(self, k: int) -> int:
        """Smallest index i such that prefix(i+1) >= k (k >= 1)."""
        pos = 0
        rem = k
        log = self.n.bit_length()
        for j in range(log, -1, -1):
            nxt = pos + (1 << j)
            if nxt <= self.n and self.t[nxt] < rem:
                pos = nxt
                rem -= int(self.t[nxt])
        return pos  # 0-based index

    def first_in_range(self, lo: int, hi: int) -> int:
        """Any set index in [lo, hi], or -1 (assumes 0/1 entries)."""
        c = self.prefix(lo)
        if self.prefix(hi + 1) - c < 1:
            return -1
        return self.find_kth(c + 1)
