"""CSA-family self-indexes: RLCSA and WCSA (paper Appendix A.1).

Sadakane's CSA encodes the suffix array through Psi (A[Psi[i]] = A[i] + 1)
plus the first-symbol bitmap B.  RLCSA run-length-encodes the Psi
differences — on repetitive collections Psi contains long +1 runs.  WCSA is
the same structure over the *word-id* sequence (spaceless model).

Search: binary search over suffix ranks, recovering suffix symbols on the
fly through Psi (self-index: the text is not stored).  locate() walks Psi to
the next sampled rank; extract() starts from the sampled inverse.

All sizes are accounted in bits from the actual run/sample arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..suffix import inverse_permutation, suffix_array


@dataclass
class _RLPsi:
    """Run-length encoded Psi: runs of consecutive +1 increments."""

    run_start: np.ndarray  # rank where each run begins (sorted)
    run_psi: np.ndarray  # Psi value at the run start

    def __call__(self, i):
        j = np.searchsorted(self.run_start, i, side="right") - 1
        return self.run_psi[j] + (i - self.run_start[j])

    @property
    def n_runs(self) -> int:
        return len(self.run_start)

    def size_in_bits(self, n: int) -> int:
        w = max(1, int(n).bit_length())
        # gap-coded run starts + absolute psi per run (paper stores samples +
        # run-length gaps; this is the same asymptotics, counted exactly)
        return self.n_runs * 2 * w


class RLCSA:
    """Character-level run-length CSA.  ``sample_rate`` = s for A_S/A_S^-1."""

    name = "rlcsa"

    def __init__(self, text: np.ndarray, sample_rate: int = 64):
        t = np.asarray(text, dtype=np.int64) + 1  # reserve 0 for terminator
        t = np.concatenate([t, [0]])
        self.n = len(t)
        sa = suffix_array(t)
        isa = inverse_permutation(sa)
        nxt = sa + 1
        nxt[nxt == self.n] = 0
        psi = isa[nxt]
        # first-symbol boundaries: C[c] = first rank of suffixes starting c
        syms, counts = np.unique(t, return_counts=True)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        self.sym_values = syms
        self.sym_starts = starts
        # run-length encode psi
        diff_is_one = np.zeros(self.n, dtype=bool)
        diff_is_one[1:] = psi[1:] == psi[:-1] + 1
        run_begin = np.flatnonzero(~diff_is_one)
        self.psi = _RLPsi(run_begin.astype(np.int64), psi[run_begin].astype(np.int64))
        # SA samples
        s = sample_rate
        self.sample_rate = s
        sampled_text_pos = sa % s == 0
        # always sample the terminator suffix (rank 0, SA value n-1): Psi
        # wraps there and locate walks must stop before the wrap
        sampled_text_pos[0] = True
        self.s_marks = np.flatnonzero(sampled_text_pos).astype(np.int64)  # ranks
        self.s_vals = sa[self.s_marks].astype(np.int64)
        self.inv_samples = isa[np.arange(0, self.n, s)].astype(np.int64)
        self._psi_cache = psi if self.n < (1 << 22) else None  # build aid only

    # ------------------------------------------------------------------
    def first_symbol(self, rank: int) -> int:
        j = int(np.searchsorted(self.sym_starts, rank, side="right")) - 1
        return int(self.sym_values[j])

    def _psi(self, i: int) -> int:
        return int(self.psi(i))

    def _compare(self, rank: int, pat: np.ndarray) -> int:
        """lexicographic compare of suffix(rank) vs pat: -1, 0 (prefix), +1."""
        i = rank
        for c in pat:
            sym = self.first_symbol(i)
            if sym < c:
                return -1
            if sym > c:
                return 1
            i = self._psi(i)
        return 0

    def count_range(self, pat: np.ndarray) -> tuple[int, int]:
        pat = np.asarray(pat, dtype=np.int64) + 1
        lo, hi = 0, self.n
        while lo < hi:  # first rank with suffix >= pat
            mid = (lo + hi) // 2
            if self._compare(mid, pat) < 0:
                lo = mid + 1
            else:
                hi = mid
        sp = lo
        lo, hi = sp, self.n
        while lo < hi:  # first rank with suffix > pat (not prefixed by it)
            mid = (lo + hi) // 2
            if self._compare(mid, pat) <= 0:
                lo = mid + 1
            else:
                hi = mid
        return sp, lo - 1

    def count(self, pat: np.ndarray) -> int:
        sp, ep = self.count_range(pat)
        return max(0, ep - sp + 1)

    def locate(self, pat: np.ndarray) -> np.ndarray:
        sp, ep = self.count_range(pat)
        out = []
        for r in range(sp, ep + 1):
            cur, k = r, 0
            while True:
                j = int(np.searchsorted(self.s_marks, cur))
                if j < len(self.s_marks) and self.s_marks[j] == cur:
                    out.append(int(self.s_vals[j]) - k)
                    break
                cur = self._psi(cur)
                k += 1
        return np.asarray(sorted(out), dtype=np.int64)

    def extract(self, x: int, y: int) -> np.ndarray:
        """text[x..y] (original symbols)."""
        s = self.sample_rate
        p0 = (x // s) * s
        rank = int(self.inv_samples[x // s])
        out = []
        for pos in range(p0, y + 1):
            if pos >= self.n - 1:
                break
            if pos >= x:
                out.append(self.first_symbol(rank) - 1)
            rank = self._psi(rank)
        return np.asarray(out, dtype=np.int64)

    # ------------------------------------------------------------------
    @property
    def size_in_bits(self) -> int:
        w = max(1, int(self.n).bit_length())
        bits = self.psi.size_in_bits(self.n)
        bits += len(self.sym_values) * w  # C table
        bits += len(self.s_marks) * 2 * w  # SA samples (mark + value)
        bits += len(self.inv_samples) * w  # inverse samples
        return bits


class WCSA(RLCSA):
    """Word-level CSA: same machinery over word ids (paper A.1 / [27])."""

    name = "wcsa"
