"""LZ77-index and LZend-index (paper Appendix A.3, Conf.#4/5 style).

The index stores only the parse (the self-index property: text is recovered
from it).  Pattern search distinguishes

* primary occurrences — crossing a phrase boundary or ending at one: found
  by trying all m splits P = P< P>, binary-searching the phrases sorted by
  reversed content (rid order) for P< as a phrase suffix and the
  phrase-aligned text suffixes (id order) for P> as a prefix, then
  intersecting the (rev_rank -> suffix_rank) point set R;
* secondary occurrences — copies of primary ones: found by interval
  stabbing over phrase sources, recursively.

Conf.#4/5 of the paper replaces Patricia trees with binary searches over id
and rid, which is exactly what this implementation does (comparisons
extract text on the fly from the parse).
"""

from __future__ import annotations

import numpy as np

from ..lz import LZ77Parse, LZEndParse, lz77_parse, lzend_parse


class LZSelfIndex:
    name = "lz77_index"

    def __init__(self, text: np.ndarray, parse=None, parser=lz77_parse):
        t = np.asarray(text, dtype=np.int64)
        self.n = len(t)
        self.parse = parse if parse is not None else parser(t)
        p = self.parse
        np_ = p.n_phrases
        starts = np.concatenate([[0], p.ends[:-1] + 1])
        self.starts = starts
        # construction-time only: use the text to sort; the index keeps
        # just the orders (the text is NOT retained)
        rev_keys = [tuple(t[starts[i] : p.ends[i] + 1][::-1].tolist()) for i in range(np_)]
        self.rid_order = np.asarray(sorted(range(np_), key=lambda i: rev_keys[i]), dtype=np.int64)
        # phrase-aligned suffixes: suffix starting at starts[i]
        suf_keys = [self._suffix_key(t, int(starts[i])) for i in range(np_)]
        self.id_order = np.asarray(
            sorted(range(np_), key=lambda i: suf_keys[i]), dtype=np.int64
        )  # id_order[r] = phrase whose start-suffix has rank r
        inv_suf = np.empty(np_, dtype=np.int64)
        inv_suf[self.id_order] = np.arange(np_)
        # point set: phrase i (rev rank) -> suffix rank of phrase i+1
        self.rev_rank_of = np.empty(np_, dtype=np.int64)
        self.rev_rank_of[self.rid_order] = np.arange(np_)
        self.R_pts = np.full(np_, -1, dtype=np.int64)
        for i in range(np_ - 1):
            self.R_pts[self.rev_rank_of[i]] = inv_suf[i + 1]
        # source intervals for secondary occurrences
        if isinstance(p, LZEndParse):
            src_end = np.where(p.src >= 0, p.ends[np.maximum(p.src, 0)], -1)
            self.src_lo = np.where(p.length > 0, src_end - p.length + 1, -1)
            self.src_hi = np.where(p.length > 0, src_end, -2)
        else:
            self.src_lo = np.where(p.length > 0, p.src, -1)
            self.src_hi = np.where(p.length > 0, p.src + p.length - 1, -2)

    MAX_PATTERN = 256  # suffix sort keys are capped; ranges stay exact
    # for patterns up to this length (queries here are short phrases)

    @staticmethod
    def _suffix_key(t: np.ndarray, pos: int, cap: int = 256):
        return tuple(t[pos : pos + cap].tolist())

    # ------------------------------------------------------------------
    # extraction-backed comparisons
    # ------------------------------------------------------------------
    def _phrase_suffix(self, i: int, length: int) -> np.ndarray:
        """Last ``length`` symbols of phrase i (clipped to phrase length)."""
        e = int(self.parse.ends[i])
        b = int(self.starts[i])
        lo = max(b, e - length + 1)
        return self.parse.extract(lo, e)

    def _text_at(self, pos: int, length: int) -> np.ndarray:
        hi = min(self.n - 1, pos + length - 1)
        if pos > hi:
            return np.zeros(0, dtype=np.int64)
        return self.parse.extract(pos, hi)

    def _cmp_rev_phrase(self, i: int, rp: np.ndarray) -> int:
        """Compare reversed phrase i against reversed-P< prefix: -1/0/+1."""
        seg = self._phrase_suffix(i, len(rp))[::-1]
        for a, b in zip(seg.tolist(), rp.tolist()):
            if a < b:
                return -1
            if a > b:
                return 1
        if len(seg) < len(rp):
            return -1  # shorter phrase: cannot contain P< as suffix
        return 0

    def _cmp_suffix(self, i: int, pat: np.ndarray) -> int:
        """Compare text suffix at phrase i's start against pat prefix."""
        seg = self._text_at(int(self.starts[i]), len(pat))
        for a, b in zip(seg.tolist(), pat.tolist()):
            if a < b:
                return -1
            if a > b:
                return 1
        if len(seg) < len(pat):
            return -1
        return 0

    def _range(self, order: np.ndarray, cmp) -> tuple[int, int]:
        lo, hi = 0, len(order)
        while lo < hi:
            mid = (lo + hi) // 2
            if cmp(int(order[mid])) < 0:
                lo = mid + 1
            else:
                hi = mid
        sp = lo
        lo, hi = sp, len(order)
        while lo < hi:
            mid = (lo + hi) // 2
            if cmp(int(order[mid])) <= 0:
                lo = mid + 1
            else:
                hi = mid
        return sp, lo - 1

    # ------------------------------------------------------------------
    def locate(self, pat: np.ndarray) -> np.ndarray:
        pat = np.asarray(pat, dtype=np.int64)
        m = len(pat)
        if m == 0 or self.n == 0:
            return np.zeros(0, dtype=np.int64)
        primary: set[int] = set()
        for k in range(1, m + 1):
            p_lt, p_gt = pat[:k], pat[k:]
            rp = p_lt[::-1]
            l1, l2 = self._range(self.rid_order, lambda i: self._cmp_rev_phrase(i, rp))
            if l1 > l2:
                continue
            if len(p_gt) == 0:
                # occurrence ends exactly at phrase end
                for r in range(l1, l2 + 1):
                    ph = int(self.rid_order[r])
                    t0 = int(self.parse.ends[ph]) - m + 1
                    if t0 >= 0:
                        primary.add(t0)
                continue
            r1, r2 = self._range(self.id_order, lambda i: self._cmp_suffix(i, p_gt))
            if r1 > r2:
                continue
            # points with rev rank in [l1,l2] and suffix rank in [r1,r2]
            sel = self.R_pts[l1 : l2 + 1]
            hit = np.flatnonzero((sel >= r1) & (sel <= r2))
            for h in hit:
                ph = int(self.rid_order[l1 + h])
                t0 = int(self.parse.ends[ph]) - k + 1
                if t0 >= 0 and t0 + m <= self.n:
                    primary.add(t0)
        # secondary: copies through phrase sources (recursive stabbing)
        out = set(primary)
        frontier = list(primary)
        while frontier:
            t0 = frontier.pop()
            cover = np.flatnonzero((self.src_lo <= t0) & (self.src_hi >= t0 + m - 1))
            for q in cover.tolist():
                new_pos = int(self.starts[q]) + (t0 - int(self.src_lo[q]))
                if new_pos not in out:
                    out.add(new_pos)
                    frontier.append(new_pos)
        return np.asarray(sorted(out), dtype=np.int64)

    def count(self, pat: np.ndarray) -> int:
        return len(self.locate(pat))

    def extract(self, x: int, y: int) -> np.ndarray:
        return self.parse.extract(x, y)

    @property
    def size_in_bits(self) -> int:
        np_ = self.parse.n_phrases
        w = max(1, int(np_).bit_length())
        return int(self.parse.size_in_bits()) + 3 * np_ * w  # rid, id, R


class LZ77Index(LZSelfIndex):
    name = "lz77_index"

    def __init__(self, text: np.ndarray):
        super().__init__(text, parser=lz77_parse)


class LZEndIndex(LZSelfIndex):
    name = "lzend_index"

    def __init__(self, text: np.ndarray):
        super().__init__(text, parser=lzend_parse)
