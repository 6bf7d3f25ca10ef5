"""Vbyte-LZMA (paper §3.2): per-list Vbyte, then LZMA where it helps.

A flag per list records whether LZMA actually reduced space; otherwise the
raw Vbyte bytes are kept (the paper's bitmap of compressed lists).
"""

from __future__ import annotations

import lzma

import numpy as np

from .base import Codec, EncodedList, register_codec
from .vbyte import vbyte_decode_array, vbyte_encode_array

_FILTERS = [{"id": lzma.FILTER_LZMA2, "preset": 6}]


def _lzma_compress(raw: bytes) -> bytes:
    return lzma.compress(raw, format=lzma.FORMAT_RAW, filters=_FILTERS)


def _lzma_decompress(blob: bytes) -> bytes:
    return lzma.decompress(blob, format=lzma.FORMAT_RAW, filters=_FILTERS)


@register_codec("vbyte_lzma")
class VbyteLZMA(Codec):
    def encode(self, gaps: np.ndarray) -> EncodedList:
        raw = vbyte_encode_array(gaps)
        blob = _lzma_compress(raw)
        if len(blob) < len(raw):
            return EncodedList(n=len(gaps), nbits=8 * len(blob) + 1, data=blob, meta={"lzma": True})
        return EncodedList(n=len(gaps), nbits=8 * len(raw) + 1, data=raw, meta={"lzma": False})

    def decode(self, enc: EncodedList) -> np.ndarray:
        raw = _lzma_decompress(enc.data) if enc.meta["lzma"] else enc.data
        return vbyte_decode_array(raw, enc.n)
