"""Vbyte-LZend list store (paper §3.3).

All d-gap lists are Vbyte-encoded, concatenated into one byte stream, and
LZ-End-parsed *globally* — phrases cross list boundaries, capturing
inter-list regularities (words that appear in almost the same documents).
Per-list pointers reference byte offsets in the original stream; LZ-End's
random access extracts any list without decompressing the rest.
"""

from __future__ import annotations

import numpy as np

from .codecs.base import ListStore, register_store
from .codecs.vbyte import vbyte_decode_array, vbyte_encode_array
from .dgaps import to_dgaps
from .lz import LZEndParse, lzend_parse


@register_store("vbyte_lzend")
class VbyteLZendStore(ListStore):
    def __init__(self, parse: LZEndParse, byte_offsets: np.ndarray, lengths: np.ndarray):
        self.parse = parse
        self.byte_offsets = byte_offsets  # len n_lists + 1
        self.lengths = lengths

    @classmethod
    def build(cls, lists: list[np.ndarray], **kw) -> "VbyteLZendStore":
        lengths = np.asarray([len(l) for l in lists], dtype=np.int64)
        blobs = [vbyte_encode_array(to_dgaps(np.asarray(l, dtype=np.int64))) for l in lists]
        offsets = np.zeros(len(lists) + 1, dtype=np.int64)
        for i, b in enumerate(blobs):
            offsets[i + 1] = offsets[i] + len(b)
        stream = np.frombuffer(b"".join(blobs), dtype=np.uint8).astype(np.int64)
        parse = lzend_parse(stream)
        return cls(parse, offsets, lengths)

    @property
    def n_lists(self) -> int:
        return len(self.lengths)

    def list_length(self, i: int) -> int:
        return int(self.lengths[i])

    def get_gaps(self, i: int) -> np.ndarray:
        lo, hi = int(self.byte_offsets[i]), int(self.byte_offsets[i + 1])
        if hi == lo:
            return np.zeros(0, dtype=np.int64)
        raw = self.parse.extract(lo, hi - 1).astype(np.uint8).tobytes()
        return vbyte_decode_array(raw, int(self.lengths[i]))

    def get_list(self, i: int) -> np.ndarray:
        g = self.get_gaps(i)
        return np.cumsum(g) - 1

    @property
    def size_in_bits(self) -> int:
        # parse triplets + per-list byte pointers
        return self.parse.size_in_bits() + 32 * self.n_lists
