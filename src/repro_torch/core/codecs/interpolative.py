"""Binary Interpolative Coding (Moffat & Stuiver).

Encodes the absolute monotone list recursively: the middle element is written
with a minimal binary code within its feasible range, then left/right halves
recurse.  Exceptionally good on clustered/dense lists (runs cost ~0 bits).

Implementation is stack-based (no Python recursion limits).
"""

from __future__ import annotations

import numpy as np

from .base import Codec, EncodedList, register_codec
from .bitio import BitReader, BitWriter
from ..dgaps import from_dgaps, to_dgaps


def _write_minimal_binary(w: BitWriter, x: int, r: int) -> None:
    """Write x in [0, r] using ceil(log2(r+1)) bits (0 bits when r == 0)."""
    if r <= 0:
        return
    width = int(r).bit_length()
    # simple fixed-width minimal code (not the phase-in refinement; sizes
    # differ by < 1 bit/value and decode stays branch-free)
    w.write_bits(x, width)


def _read_minimal_binary(rd: BitReader, r: int) -> int:
    if r <= 0:
        return 0
    return rd.read_bits(int(r).bit_length())


@register_codec("interpolative")
class Interpolative(Codec):
    def encode(self, gaps: np.ndarray) -> EncodedList:
        absolute = from_dgaps(gaps)
        n = len(absolute)
        if n == 0:
            return EncodedList(n=0, nbits=0, data=b"")
        lo, hi = int(absolute[0]), int(absolute[-1])
        w = BitWriter()
        # stack of (i, j, lo, hi): encode absolute[i..j] with values in [lo, hi]
        stack = [(0, n - 1, lo, hi)]
        while stack:
            i, j, a, b = stack.pop()
            if i > j:
                continue
            m = (i + j) // 2
            v = int(absolute[m])
            # v is constrained to [a + (m - i), b - (j - m)]
            vlo = a + (m - i)
            vhi = b - (j - m)
            _write_minimal_binary(w, v - vlo, vhi - vlo)
            stack.append((i, m - 1, a, v - 1))
            stack.append((m + 1, j, v + 1, b))
        # header: first/last values (2 x 32 bits)
        return EncodedList(
            n=n, nbits=w.nbits + 64, data=w.getvalue(),
            meta={"lo": lo, "hi": hi, "payload_bits": w.nbits},
        )

    def decode(self, enc: EncodedList) -> np.ndarray:
        return to_dgaps(self.decode_absolute(enc))

    def decode_absolute(self, enc: EncodedList) -> np.ndarray:
        n = enc.n
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        rd = BitReader(enc.data, enc.meta["payload_bits"])
        out = np.empty(n, dtype=np.int64)
        # must replay in the exact encode order (LIFO with right pushed last)
        stack = [(0, n - 1, enc.meta["lo"], enc.meta["hi"])]
        while stack:
            i, j, a, b = stack.pop()
            if i > j:
                continue
            m = (i + j) // 2
            vlo = a + (m - i)
            vhi = b - (j - m)
            v = vlo + _read_minimal_binary(rd, vhi - vlo)
            out[m] = v
            stack.append((i, m - 1, a, v - 1))
            stack.append((m + 1, j, v + 1, b))
        return out
