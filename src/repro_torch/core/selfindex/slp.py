"""SLP and WSLP grammar self-indexes (paper Appendix A.2).

A Re-Pair grammar over the text (chars for SLP, word ids for WSLP — WSLP is
the variant introduced by this paper).  Rules X -> X_l X_r are indexed as a
labeled binary relation: rows sorted by rev(F(X_l)), columns by F(X_r).
Pattern search finds primary occurrences (a split P = P< P> crossing a rule)
by binary search on both orders, then tracks secondary occurrences through
the rule DAG up to the reduced sequence C, converting C slots to absolute
text positions via prefix expansion lengths.  Extraction decodes from C.

Binary-search string comparisons expand rule prefixes/suffixes lazily.
"""

from __future__ import annotations

import numpy as np

from ..repair import Grammar, repair_compress


class SLPIndex:
    name = "slp"

    def __init__(self, text: np.ndarray, max_rules: int | None = None):
        t = np.asarray(text, dtype=np.int64) + 1  # symbols >= 1
        self.n = len(t)
        u = int(t.max(initial=1))
        self.u = u
        cseq, g = repair_compress(t, u, max_rules=max_rules)
        self.g = g
        self.c = cseq
        nr = g.n_rules()
        # per-rule expansion lengths
        self.rlen = np.ones(u + 1 + nr, dtype=np.int64)
        for k, (a, b) in enumerate(g.rules):
            self.rlen[u + 1 + k] = self.rlen[a] + self.rlen[b]
        self.c_prefix = np.concatenate([[0], np.cumsum(self.rlen[self.c])])
        # rows: rules sorted by rev(F(left)); cols: rules sorted by F(right)
        keys_rev = [self._expand_suffix(g.rules[k][0], 256)[::-1] for k in range(nr)]
        keys_fwd = [self._expand_prefix(g.rules[k][1], 256) for k in range(nr)]
        self.row_order = np.asarray(
            sorted(range(nr), key=lambda k: tuple(keys_rev[k].tolist())), dtype=np.int64)
        self.col_order = np.asarray(
            sorted(range(nr), key=lambda k: tuple(keys_fwd[k].tolist())), dtype=np.int64)
        self.col_rank = np.empty(nr, dtype=np.int64)
        self.col_rank[self.col_order] = np.arange(nr)
        # reverse DAG: for each rule, the rules using it (with side)
        self.parents: list[list[tuple[int, int]]] = [[] for _ in range(nr)]
        for k, (a, b) in enumerate(g.rules):
            if a > u:
                self.parents[a - u - 1].append((k, 0))
            if b > u:
                self.parents[b - u - 1].append((k, 1))
        # occurrences of each symbol in C
        self._c_pos: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------
    # lazy expansion
    # ------------------------------------------------------------------
    def _expand_prefix(self, sym: int, m: int) -> np.ndarray:
        out: list[int] = []
        stack = [sym]
        while stack and len(out) < m:
            s = stack.pop()
            if s <= self.u:
                out.append(s)
            else:
                a, b = self.g.rules[s - self.u - 1]
                stack.append(b)
                stack.append(a)
        return np.asarray(out[:m], dtype=np.int64)

    def _expand_suffix(self, sym: int, m: int) -> np.ndarray:
        out: list[int] = []
        stack = [sym]
        while stack and len(out) < m:
            s = stack.pop()
            if s <= self.u:
                out.append(s)
            else:
                a, b = self.g.rules[s - self.u - 1]
                stack.append(a)
                stack.append(b)
        return np.asarray(out[:m][::-1], dtype=np.int64)

    # ------------------------------------------------------------------
    def _cmp_row(self, k: int, rp: np.ndarray) -> int:
        left = self.g.rules[k][0]
        seg = self._expand_suffix(left, len(rp))[::-1]
        for a, b in zip(seg.tolist(), rp.tolist()):
            if a < b:
                return -1
            if a > b:
                return 1
        return -1 if len(seg) < len(rp) else 0

    def _cmp_col(self, k: int, pat: np.ndarray) -> int:
        right = self.g.rules[k][1]
        seg = self._expand_prefix(right, len(pat))
        for a, b in zip(seg.tolist(), pat.tolist()):
            if a < b:
                return -1
            if a > b:
                return 1
        return -1 if len(seg) < len(pat) else 0

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
    def _c_occurrences(self, sym: int) -> np.ndarray:
        if sym not in self._c_pos:
            self._c_pos[sym] = np.flatnonzero(self.c == sym)
        return self._c_pos[sym]

    def _rule_abs_positions(self, rule_k: int, offset: int, out: set) -> None:
        """All absolute text positions where rule_k's expansion occurs, plus
        ``offset`` into it (recursing through parents and C)."""
        stack = [(rule_k, offset)]
        seen: set[tuple[int, int]] = set()
        while stack:
            k, off = stack.pop()
            if (k, off) in seen:
                continue
            seen.add((k, off))
            sym = self.u + 1 + k
            for cpos in self._c_occurrences(sym).tolist():
                out.add(int(self.c_prefix[cpos]) + off)
            for pk, side in self.parents[k]:
                extra = 0 if side == 0 else int(self.rlen[self.g.rules[pk][0]])
                stack.append((pk, off + extra))

    def locate(self, pat: np.ndarray) -> np.ndarray:
        pat = np.asarray(pat, dtype=np.int64) + 1
        m = len(pat)
        if m == 0:
            return np.zeros(0, dtype=np.int64)
        out: set[int] = set()
        if m == 1:
            # occurrences of a single terminal: C slots + rules containing it
            sym = int(pat[0])
            for cpos in self._c_occurrences(sym).tolist():
                out.add(int(self.c_prefix[cpos]))
            for k, (a, b) in enumerate(self.g.rules):
                if a == sym:
                    self._rule_abs_positions(k, 0, out)
                if b == sym:
                    self._rule_abs_positions(k, int(self.rlen[a]), out)
            return np.asarray(sorted(out), dtype=np.int64)
        # primary occurrences inside rules
        for k in range(1, m):
            p_lt, p_gt = pat[:k], pat[k:]
            rp = p_lt[::-1]
            l1, l2 = self._range(self.row_order, lambda kk: self._cmp_row(kk, rp))
            if l1 > l2:
                continue
            r1, r2 = self._range(self.col_order, lambda kk: self._cmp_col(kk, p_gt))
            if r1 > r2:
                continue
            rows = self.row_order[l1 : l2 + 1]
            in_rect = rows[(self.col_rank[rows] >= r1) & (self.col_rank[rows] <= r2)]
            for kk in in_rect.tolist():
                a, _ = self.g.rules[kk]
                off = int(self.rlen[a]) - k
                self._rule_abs_positions(kk, off, out)
        # occurrences crossing consecutive C symbols
        csyms = self.c
        for k in range(1, m):
            # find C positions where expansion of c[i] ends with P[:k] and
            # following C symbols continue with P[k:]
            for i in range(len(csyms)):
                suf = self._expand_suffix(int(csyms[i]), k)
                if len(suf) < k or not np.array_equal(suf, pat[:k]):
                    continue
                # check continuation across c[i+1:]
                need = pat[k:]
                j = i + 1
                ok = True
                while len(need) and j < len(csyms):
                    seg = self._expand_prefix(int(csyms[j]), len(need))
                    take = min(len(seg), len(need))
                    if not np.array_equal(seg[:take], need[:take]):
                        ok = False
                        break
                    need = need[take:]
                    j += 1
                if ok and len(need) == 0:
                    out.add(int(self.c_prefix[i + 1]) - k)
        return np.asarray(sorted(out), dtype=np.int64)

    def count(self, pat: np.ndarray) -> int:
        return len(self.locate(pat))

    def extract(self, x: int, y: int) -> np.ndarray:
        i = int(np.searchsorted(self.c_prefix, x, side="right")) - 1
        out: list[int] = []
        pos = int(self.c_prefix[i])
        while pos <= y and i < len(self.c):
            seg = self._expand_prefix(int(self.c[i]), int(self.rlen[self.c[i]]))
            out.extend(seg.tolist())
            pos += len(seg)
            i += 1
        arr = np.asarray(out, dtype=np.int64)
        off = x - int(self.c_prefix[int(np.searchsorted(self.c_prefix, x, side='right')) - 1])
        return arr[off : off + (y - x + 1)] - 1

    @property
    def size_in_bits(self) -> int:
        nr = self.g.n_rules()
        w = max(1, int(self.u + nr + 1).bit_length())
        bits = len(self.c) * w  # reduced sequence
        bits += nr * 2 * w  # rules
        bits += 2 * nr * max(1, int(max(1, nr)).bit_length())  # row/col orders
        bits += len(self.c_prefix) * max(1, int(self.n).bit_length()) // 16  # sampled B bitmap
        return bits


class WSLPIndex(SLPIndex):
    """Word-oriented SLP — this paper's contribution (Appendix A.2)."""

    name = "wslp"
