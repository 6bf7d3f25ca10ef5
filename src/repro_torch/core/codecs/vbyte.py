"""Vbyte (Williams & Zobel) — 7-bit groups, high bit terminates a codeword.

Encoding is little-endian by 7-bit group; the *last* byte of each codeword has
its high bit set (paper §2.2).  Decode is fully vectorized with numpy.
"""

from __future__ import annotations

import numpy as np

from .base import Codec, EncodedList, register_codec

__all__ = ["VByte", "vbyte_encode_array", "vbyte_decode_array"]


def vbyte_encode_array(values: np.ndarray) -> bytes:
    """Vectorized Vbyte encoding of a non-negative int array."""
    v = np.asarray(values, dtype=np.uint64)
    if v.size == 0:
        return b""
    # number of 7-bit groups per value (at least 1)
    nbytes = np.ones(v.shape, dtype=np.int64)
    tmp = v >> np.uint64(7)
    while np.any(tmp):
        nbytes += (tmp > 0).astype(np.int64)
        tmp >>= np.uint64(7)
    total = int(nbytes.sum())
    out = np.zeros(total, dtype=np.uint8)
    ends = np.cumsum(nbytes) - 1  # index of last byte of each codeword
    starts = ends - (nbytes - 1)
    # fill groups: group g of value i goes to position starts[i] + g
    maxb = int(nbytes.max())
    for g in range(maxb):
        mask = nbytes > g
        pos = starts[mask] + g
        out[pos] = ((v[mask] >> np.uint64(7 * g)) & np.uint64(0x7F)).astype(np.uint8)
    out[ends] |= 0x80
    return out.tobytes()


def vbyte_decode_array(data: bytes, n: int | None = None) -> np.ndarray:
    """Vectorized Vbyte decode.  ``n`` (if given) checks the value count."""
    arr = np.frombuffer(data, dtype=np.uint8)
    if arr.size == 0:
        return np.zeros(0, dtype=np.int64)
    is_end = (arr & 0x80) != 0
    ends = np.flatnonzero(is_end)
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    # group offset of each byte within its codeword
    group_id = np.cumsum(is_end) - is_end  # codeword index per byte
    offset = np.arange(arr.size, dtype=np.int64) - starts[group_id]
    contrib = (arr & 0x7F).astype(np.int64) << (7 * offset)
    vals = np.add.reduceat(contrib, starts)
    if n is not None and len(vals) != n:
        raise ValueError(f"vbyte: expected {n} values, decoded {len(vals)}")
    return vals


@register_codec("vbyte")
class VByte(Codec):
    def encode(self, gaps: np.ndarray) -> EncodedList:
        data = vbyte_encode_array(gaps)
        return EncodedList(n=len(gaps), nbits=8 * len(data), data=data)

    def decode(self, enc: EncodedList) -> np.ndarray:
        return vbyte_decode_array(enc.data, enc.n)
