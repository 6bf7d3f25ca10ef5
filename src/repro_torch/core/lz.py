"""LZ77 and LZ-End parsers + extraction (paper §2.4, §3.3).

LZ77: greedy longest-previous-factor parse via suffix-array range narrowing
with an RMQ over suffix start positions ("is there an occurrence starting
before i?").  Sources may overlap the phrase being formed (classic LZ77).

LZ-End (Kreft & Navarro): phrase sources must *end at a previous phrase
end*.  Construction runs backward search on the FM-index of the reversed
text (with sentinel) while maintaining a Fenwick tree of marked phrase ends
over suffix ranks; the matched length grows until the SA range no longer
contains a marked end.  Containment is monotone under range nesting, so the
greedy-longest phrase is found exactly.

Both parsers guarantee a trailing literal per phrase (the last text symbol
is always a literal).  ``extract`` recovers arbitrary substrings — O(1)
amortized per symbol for a phrase suffix under LZ-End.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .suffix import Fenwick, OccRank, RangeMin, bwt_from_sa, inverse_permutation, suffix_array

__all__ = ["LZ77Parse", "LZEndParse", "lz77_parse", "lzend_parse"]


# ----------------------------------------------------------------------
# LZ77
# ----------------------------------------------------------------------
@dataclass
class LZ77Parse:
    """Phrases (k, l, a): copy text[k : k+l] then append symbol a."""

    src: np.ndarray  # source start position (k); -1 when l == 0
    length: np.ndarray  # copy length l (>= 0)
    trail: np.ndarray  # trailing symbol a
    ends: np.ndarray  # text position of the last symbol of each phrase
    n: int  # text length

    @property
    def n_phrases(self) -> int:
        return len(self.trail)

    def size_in_bits(self) -> int:
        np_ = self.n_phrases
        w_pos = max(1, int(self.n).bit_length())
        w_sym = max(8, int(self.trail.max(initial=1)).bit_length())
        return np_ * (2 * w_pos + w_sym)

    def decode(self) -> np.ndarray:
        out = np.empty(self.n, dtype=np.int64)
        pos = 0
        for k, l, a in zip(self.src.tolist(), self.length.tolist(), self.trail.tolist()):
            for t in range(l):  # may overlap: copy forward one by one
                out[pos + t] = out[k + t]
            pos += l
            out[pos] = a
            pos += 1
        return out[: self.n]

    def extract(self, i: int, j: int) -> np.ndarray:
        """text[i..j] inclusive, by per-symbol source chasing (O((j-i+1)*h))."""
        out = np.empty(j - i + 1, dtype=np.int64)
        for t in range(i, j + 1):
            x = t
            while True:
                p = int(np.searchsorted(self.ends, x, side="left"))
                if self.ends[p] == x:
                    out[t - i] = self.trail[p]
                    break
                b = int(self.ends[p - 1]) + 1 if p else 0
                x = int(self.src[p]) + (x - b)
        return out


def _narrow(sa: np.ndarray, t: np.ndarray, sp: int, ep: int, off: int, c: int) -> tuple[int, int]:
    """Narrow SA range [sp,ep] to suffixes with t[sa[r]+off] == c.

    Within the range the off-th symbols appear in sorted order; suffixes
    shorter than off+1 sort first (treated as -inf).
    """
    n = len(t)

    def char_at(r: int) -> int:
        p = sa[r] + off
        return int(t[p]) if p < n else -(1 << 62)

    lo, hi = sp, ep + 1
    while lo < hi:  # first r with char >= c
        mid = (lo + hi) // 2
        if char_at(mid) < c:
            lo = mid + 1
        else:
            hi = mid
    new_sp = lo
    lo, hi = new_sp, ep + 1
    while lo < hi:  # first r with char > c
        mid = (lo + hi) // 2
        if char_at(mid) <= c:
            lo = mid + 1
        else:
            hi = mid
    return new_sp, lo - 1


def lz77_parse(text: np.ndarray) -> LZ77Parse:
    t = np.asarray(text, dtype=np.int64)
    n = len(t)
    empty = np.zeros(0, np.int64)
    if n == 0:
        return LZ77Parse(empty, empty, empty, empty, 0)
    sa = suffix_array(t)
    rmq = RangeMin(sa)
    srcs: list[int] = []
    lens: list[int] = []
    trail: list[int] = []
    ends: list[int] = []
    i = 0
    while i < n:
        sp, ep = 0, n - 1
        l = 0
        best_src = -1
        # keep a trailing literal: extend only while i + l + 1 <= n - 1
        while i + l < n - 1:
            nsp, nep = _narrow(sa, t, sp, ep, l, int(t[i + l]))
            if nsp > nep:
                break
            j = rmq.argmin_below(nsp, nep, i)
            if j < 0:
                break
            best_src = int(sa[j])
            sp, ep = nsp, nep
            l += 1
        srcs.append(best_src if l > 0 else -1)
        lens.append(l)
        trail.append(int(t[i + l]))
        ends.append(i + l)
        i += l + 1
    return LZ77Parse(
        np.asarray(srcs, dtype=np.int64),
        np.asarray(lens, dtype=np.int64),
        np.asarray(trail, dtype=np.int64),
        np.asarray(ends, dtype=np.int64),
        n,
    )


# ----------------------------------------------------------------------
# LZ-End
# ----------------------------------------------------------------------
@dataclass
class LZEndParse:
    """Phrases (src_phrase, length, trail): copy the ``length``-symbol text
    suffix ending at the end of phrase ``src_phrase``, then append trail."""

    src: np.ndarray  # source phrase id (-1 when length == 0)
    length: np.ndarray  # copy length (>= 0)
    trail: np.ndarray  # trailing symbol
    ends: np.ndarray  # text position of the last symbol of each phrase
    n: int

    @property
    def n_phrases(self) -> int:
        return len(self.trail)

    def size_in_bits(self) -> int:
        np_ = self.n_phrases
        w_ph = max(1, int(max(1, np_)).bit_length())
        w_sym = max(8, int(self.trail.max(initial=1)).bit_length())
        gaps = np.diff(np.concatenate([[-1], self.ends]))
        bbits = int(np.sum(2 * np.floor(np.log2(gaps)) + 1))  # gamma-coded B
        return np_ * (w_ph + w_sym) + bbits

    def phrase_of(self, x: int) -> int:
        return int(np.searchsorted(self.ends, x, side="left"))

    def extract(self, i: int, j: int) -> np.ndarray:
        """text[i..j] inclusive."""
        if j < i:
            return np.zeros(0, dtype=np.int64)
        p = self.phrase_of(j)
        e = int(self.ends[p])
        out: list[int] = []
        self._extract_back(e, e - i + 1, out)
        arr = np.asarray(out[::-1], dtype=np.int64)
        return arr[: j - i + 1]

    def _extract_back(self, e: int, m: int, out: list) -> None:
        """Emit, in reverse text order, the m symbols ending at phrase end e."""
        from collections import deque

        work: deque[tuple[int, int]] = deque([(e, m)])
        while work:
            e, m = work.popleft()
            if m <= 0:
                continue
            p = self.phrase_of(e)
            assert self.ends[p] == e, "extract requires a phrase end"
            b = int(self.ends[p - 1]) + 1 if p else 0
            plen = e - b + 1
            take = min(m, plen)
            out.append(int(self.trail[p]))  # position e
            rest: list[tuple[int, int]] = []
            if take > 1:
                # positions [e-take+1, e-1] = (take-1)-suffix of the copy part
                rest.append((int(self.ends[int(self.src[p])]), take - 1))
            if m > plen:
                rest.append((b - 1, m - plen))
            work.extendleft(reversed(rest))

    def decode(self) -> np.ndarray:
        out = np.empty(self.n, dtype=np.int64)
        pos = 0
        for p in range(self.n_phrases):
            l = int(self.length[p])
            if l:
                e = int(self.ends[int(self.src[p])])
                out[pos : pos + l] = out[e - l + 1 : e + 1]
            out[pos + l] = self.trail[p]
            pos += l + 1
        return out[: self.n]


def lzend_parse(text: np.ndarray) -> LZEndParse:
    t = np.asarray(text, dtype=np.int64)
    n = len(t)
    empty = np.zeros(0, np.int64)
    if n == 0:
        return LZEndParse(empty, empty, empty, empty, 0)
    # FM-index over rev(T) + sentinel
    rev = np.concatenate([t[::-1], np.asarray([-1], dtype=np.int64)])
    ns = len(rev)  # n + 1
    sa_rev = suffix_array(rev)
    isa_rev = inverse_permutation(sa_rev)
    bwt = bwt_from_sa(rev, sa_rev)
    occ = OccRank(bwt)
    syms, cnts = np.unique(rev, return_counts=True)
    cbase = {int(c): int(v) for c, v in zip(syms.tolist(), np.concatenate([[0], np.cumsum(cnts)[:-1]]).tolist())}
    marked = Fenwick(ns)  # over SA ranks of rev
    rank_to_phrase: dict[int, int] = {}

    srcs: list[int] = []
    lens: list[int] = []
    trail: list[int] = []
    ends: list[int] = []
    i = 0
    while i < n:
        sp, ep = 0, ns - 1
        l = 0
        best_src = -1
        while i + l < n - 1:  # keep a trailing literal
            c = int(t[i + l])
            base = cbase.get(c)
            if base is None:
                break
            nsp = base + occ.rank(c, sp)
            nep = base + occ.rank(c, ep + 1) - 1
            if nsp > nep:
                break
            r = marked.first_in_range(nsp, nep)
            if r < 0:
                break
            sp, ep = nsp, nep
            l += 1
            best_src = rank_to_phrase[r]
        srcs.append(best_src if l > 0 else -1)
        lens.append(l)
        trail.append(int(t[i + l]))
        e = i + l
        ends.append(e)
        # mark the new phrase end: suffix of rev starting at n - 1 - e
        rk = int(isa_rev[n - 1 - e])
        marked.add(rk, 1)
        rank_to_phrase[rk] = len(ends) - 1
        i = e + 1
    return LZEndParse(
        np.asarray(srcs, dtype=np.int64),
        np.asarray(lens, dtype=np.int64),
        np.asarray(trail, dtype=np.int64),
        np.asarray(ends, dtype=np.int64),
        n,
    )
