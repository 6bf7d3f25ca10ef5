"""Vbyte with intersection sampling (paper §2.2: Culpepper-Moffat [21] and
Transier-Sanders [60]) and the bitmap hybrid for very long lists.

* ``cm``: absolute samples every ``k * ceil(log2(l))`` postings, searched
  with exponential search; only one inter-sample chunk is decoded per probe.
* ``st``: domain sampling — the universe is cut into steps of
  ``2^ceil(log2(u*B/l))``; a direct lookup replaces the search.
* ``bitmaps=True``: lists longer than u/8 are stored as plain bitmaps
  (VbyteB / Vbyte-CMB / Vbyte-STB variants).
"""

from __future__ import annotations

import numpy as np

from .codecs.base import ListStore, register_store
from .codecs.vbyte import vbyte_decode_array, vbyte_encode_array
from .dgaps import to_dgaps
from .registry import CAP_INTERSECT_CANDIDATES, CAP_PERSIST, CAP_SEEK


@register_store("vbyte_sampled")
class SampledVByteStore(ListStore):
    capabilities = frozenset({CAP_SEEK, CAP_INTERSECT_CANDIDATES, CAP_PERSIST})

    def __init__(self, entries: list[dict], universe: int, kind: str, param: int, bitmaps: bool):
        self.entries = entries
        self.universe = universe
        self.kind = kind
        self.param = param
        self.bitmaps = bitmaps

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, lists: list[np.ndarray], kind: str = "cm", param: int = 32,
              bitmaps: bool = False, **kw) -> "SampledVByteStore":
        universe = int(max((int(l[-1]) for l in lists if len(l)), default=0)) + 1
        entries: list[dict] = []
        for l in lists:
            l = np.asarray(l, dtype=np.int64)
            n = len(l)
            if bitmaps and n > universe // 8 and n > 0:
                bm = np.zeros(universe, dtype=bool)
                bm[l] = True
                entries.append({"type": "bitmap", "bm": bm, "n": n})
                continue
            gaps = to_dgaps(l)
            # per-codeword byte offsets (needed to start decode mid-stream)
            blob = vbyte_encode_array(gaps)
            arr = np.frombuffer(blob, dtype=np.uint8)
            ends = np.flatnonzero((arr & 0x80) != 0)
            starts = np.concatenate([[0], ends[:-1] + 1]) if n else np.zeros(0, np.int64)
            if n == 0:
                entries.append({"type": "vbyte", "blob": blob, "n": 0,
                                "s_vals": np.zeros(0, np.int64), "s_idx": np.zeros(0, np.int64),
                                "s_byte": np.zeros(0, np.int64), "step": 1})
                continue
            if kind == "cm":
                step = max(1, param * max(1, int(np.ceil(np.log2(n + 1)))))
                idx = np.arange(0, n, step, dtype=np.int64)
            elif kind == "st":
                stepv = 1 << int(np.ceil(np.log2(max(1.0, universe * param / n))))
                marks = np.arange(0, universe + stepv, stepv, dtype=np.int64)
                idx = np.unique(np.minimum(np.searchsorted(l, marks, side="left"), n - 1))
            else:
                raise ValueError(kind)
            entries.append({
                "type": "vbyte", "blob": blob, "n": n,
                "s_vals": l[idx],  # posting value at each sampled index
                "s_idx": idx, "s_byte": starts[idx],
                "step": (1 << int(np.ceil(np.log2(max(1.0, universe * param / n))))) if kind == "st" else 0,
            })
        return cls(entries, universe, kind, param, bitmaps)

    # ------------------------------------------------------------------
    @property
    def n_lists(self) -> int:
        return len(self.entries)

    def list_length(self, i: int) -> int:
        return int(self.entries[i]["n"])

    def get_list(self, i: int) -> np.ndarray:
        e = self.entries[i]
        if e["type"] == "bitmap":
            return np.flatnonzero(e["bm"]).astype(np.int64)
        if e["n"] == 0:
            return np.zeros(0, dtype=np.int64)
        gaps = vbyte_decode_array(e["blob"], e["n"])
        return np.cumsum(gaps) - 1

    # ------------------------------------------------------------------
    def _chunk(self, e: dict, j: int) -> np.ndarray:
        """Decode postings for sample chunk j (absolute values)."""
        lo_idx = int(e["s_idx"][j])
        hi_idx = int(e["s_idx"][j + 1]) if j + 1 < len(e["s_idx"]) else e["n"]
        lo_b = int(e["s_byte"][j])
        hi_b = int(e["s_byte"][j + 1]) if j + 1 < len(e["s_byte"]) else len(e["blob"])
        gaps = vbyte_decode_array(e["blob"][lo_b:hi_b], hi_idx - lo_idx)
        vals = np.cumsum(gaps)
        # first gap of the chunk is relative to the previous posting value
        base = int(e["s_vals"][j]) - int(vals[0])
        return vals + base

    def intersect_candidates(self, i: int, cand: np.ndarray) -> np.ndarray:
        """Members of sorted ``cand`` that occur in list i."""
        e = self.entries[i]
        if len(cand) == 0 or e["n"] == 0:
            return np.zeros(0, dtype=np.int64)
        if e["type"] == "bitmap":
            valid = cand[(cand >= 0) & (cand < self.universe)]
            return valid[e["bm"][valid]]
        out: list[int] = []
        cur_j = -1
        cur_chunk: np.ndarray | None = None
        for x in cand.tolist():
            j = int(np.searchsorted(e["s_vals"], x, side="right")) - 1
            if j < 0:
                continue
            if j != cur_j:
                cur_j = j
                cur_chunk = self._chunk(e, j)
            k = int(np.searchsorted(cur_chunk, x))
            if k < len(cur_chunk) and cur_chunk[k] == x:
                out.append(x)
        return np.asarray(out, dtype=np.int64)

    # intersect_multi: inherited — the ListStore default is exactly this
    # store's loop (decode shortest, probe the rest via sampled chunks).

    # ------------------------------------------------------------------
    @property
    def size_in_bits(self) -> int:
        bits = 0
        for e in self.entries:
            if e["type"] == "bitmap":
                bits += self.universe
            else:
                bits += 8 * len(e["blob"])
                bits += len(e["s_vals"]) * 64  # (value, byte offset) pairs
        bits += 32 * len(self.entries)
        return bits
