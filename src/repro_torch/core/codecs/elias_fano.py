"""Elias-Fano and a partitioned variant (Ottaviano & Venturini's EF-opt idea).

EF encodes the *absolute* monotone sequence: low ``l = floor(log2(u/n))``
bits verbatim; high bits as a unary-gap bitmap.  ``next_geq`` (the successor
operator used by their intersection algorithm) is supported directly.

The partitioned variant splits the list into chunks of 128 and picks, per
chunk, the cheapest of three encodings (the three cases of partitioned EF):
  * implicit run  — chunk is a dense integer range: 0 payload bits;
  * bitmap        — chunk range small: (range) bits;
  * plain EF      — otherwise.
"""

from __future__ import annotations

import numpy as np

from .base import Codec, EncodedList, register_codec
from ..dgaps import from_dgaps, to_dgaps

CHUNK = 128


def _ef_encode(absolute: np.ndarray, u: int) -> dict:
    n = len(absolute)
    assert n > 0
    l = max(0, int(np.floor(np.log2(max(1.0, u / n)))))
    low = absolute & ((1 << l) - 1) if l else np.zeros(n, dtype=np.int64)
    high = absolute >> l
    # unary-gap bitmap positions: bit (high[i] + i) is set
    pos = high + np.arange(n, dtype=np.int64)
    nbits_hi = int(pos[-1]) + 1
    bitmap = np.zeros(nbits_hi, dtype=np.uint8)
    bitmap[pos] = 1
    return {"l": l, "low": low, "hi_pos": pos, "nbits": n * l + nbits_hi, "n": n}


def _ef_decode(ef: dict) -> np.ndarray:
    ones = ef["hi_pos"]
    n = ef["n"]
    high = ones - np.arange(n, dtype=np.int64)
    return (high << ef["l"]) | ef["low"]


@register_codec("elias_fano")
class EliasFano(Codec):
    def encode(self, gaps: np.ndarray) -> EncodedList:
        absolute = from_dgaps(gaps) + 1  # EF needs values >= 0; shift by +1 for safety
        u = int(absolute[-1]) + 1 if len(absolute) else 1
        if len(absolute) == 0:
            return EncodedList(n=0, nbits=0, data=b"", meta={"ef": None})
        ef = _ef_encode(absolute, u)
        return EncodedList(n=len(gaps), nbits=ef["nbits"] + 64, data=b"", meta={"ef": ef})

    def decode(self, enc: EncodedList) -> np.ndarray:
        if enc.n == 0:
            return np.zeros(0, dtype=np.int64)
        absolute = _ef_decode(enc.meta["ef"]) - 1
        return to_dgaps(absolute)

    def decode_absolute(self, enc: EncodedList) -> np.ndarray:
        if enc.n == 0:
            return np.zeros(0, dtype=np.int64)
        return _ef_decode(enc.meta["ef"]) - 1


@register_codec("ef_opt")
class PartitionedEF(Codec):
    """Uniform-partitioned EF with per-chunk best-of-three encoding."""

    def encode(self, gaps: np.ndarray) -> EncodedList:
        absolute = from_dgaps(gaps)
        n = len(absolute)
        chunks = []
        nbits = 0
        for s in range(0, n, CHUNK):
            c = absolute[s : s + CHUNK] + 1
            cnt = len(c)
            lo, hi = int(c[0]), int(c[-1])
            span = hi - lo + 1
            if span == cnt:  # implicit dense run
                chunks.append(("run", lo, cnt, None))
                cost = 0
            else:
                ef = _ef_encode(c - lo, span)
                bitmap_cost = span
                if bitmap_cost <= ef["nbits"]:
                    rel = (c - lo).astype(np.int64)
                    chunks.append(("bitmap", lo, cnt, rel))
                    cost = bitmap_cost
                else:
                    chunks.append(("ef", lo, cnt, ef))
                    cost = ef["nbits"]
            # chunk header: first value (delta to prev chunk, ~32b), count, type
            nbits += cost + 32 + 8 + 2
        return EncodedList(n=n, nbits=nbits, data=b"", meta={"chunks": chunks})

    def decode(self, enc: EncodedList) -> np.ndarray:
        return to_dgaps(self.decode_absolute(enc))

    def decode_absolute(self, enc: EncodedList) -> np.ndarray:
        out = []
        for kind, lo, cnt, payload in enc.meta["chunks"]:
            if kind == "run":
                out.append(np.arange(lo, lo + cnt, dtype=np.int64))
            elif kind == "bitmap":
                out.append(lo + payload)
            else:
                out.append(lo + _ef_decode(payload))
        if not out:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(out) - 1


def ef_next_geq(enc: EncodedList, x: int) -> int:
    """Successor: smallest posting >= x, or -1 if none (plain EF lists)."""
    absolute = EliasFano().decode_absolute(enc)
    i = int(np.searchsorted(absolute, x, side="left"))
    return int(absolute[i]) if i < len(absolute) else -1
