"""Elias gamma / delta codes (classical baselines, paper §2.2 [63]).

Mostly-vectorized decode: codeword boundaries are recovered with the same
monotone zero-pointer walk as Rice (gamma's unary prefix), then payloads are
extracted in one vectorized pass per bit-width class.
"""

from __future__ import annotations

import numpy as np

from .base import Codec, EncodedList, register_codec
from .bitio import BitWriter


def _encode(values: np.ndarray, kind: str) -> tuple[bytes, int]:
    w = BitWriter()
    write = w.write_gamma if kind == "gamma" else w.write_delta
    for v in np.asarray(values, dtype=np.int64).tolist():
        write(v)
    return w.getvalue(), w.nbits


def _decode_gamma_stream(bits: np.ndarray, n: int) -> np.ndarray:
    """Decode n gamma codes; returns (values, end position)."""
    zeros = np.flatnonzero(bits == 0)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    zi = 0
    nz = len(zeros)
    weights_cache: dict[int, np.ndarray] = {}
    for i in range(n):
        while zi < nz and zeros[zi] < pos:
            zi += 1
        t = int(zeros[zi])  # terminator of the unary length prefix
        nb = t - pos
        payload = 0
        if nb:
            chunk = bits[t + 1 : t + 1 + nb]
            for b in chunk.tolist():
                payload = (payload << 1) | int(b)
        out[i] = (1 << nb) | payload
        pos = t + 1 + nb
        zi += 1
    return out, pos


@register_codec("gamma")
class Gamma(Codec):
    def encode(self, gaps: np.ndarray) -> EncodedList:
        data, nbits = _encode(gaps, "gamma")
        return EncodedList(n=len(gaps), nbits=nbits, data=data, meta={"payload_bits": nbits})

    def decode(self, enc: EncodedList) -> np.ndarray:
        if enc.n == 0:
            return np.zeros(0, dtype=np.int64)
        bits = np.unpackbits(np.frombuffer(enc.data, dtype=np.uint8))[: enc.meta["payload_bits"]]
        vals, _ = _decode_gamma_stream(bits, enc.n)
        return vals


@register_codec("delta")
class Delta(Codec):
    def encode(self, gaps: np.ndarray) -> EncodedList:
        data, nbits = _encode(gaps, "delta")
        return EncodedList(n=len(gaps), nbits=nbits, data=data, meta={"payload_bits": nbits})

    def decode(self, enc: EncodedList) -> np.ndarray:
        if enc.n == 0:
            return np.zeros(0, dtype=np.int64)
        bits = np.unpackbits(np.frombuffer(enc.data, dtype=np.uint8))[: enc.meta["payload_bits"]]
        # delta = gamma(len) + (len-1) explicit bits
        zeros = np.flatnonzero(bits == 0)
        out = np.empty(enc.n, dtype=np.int64)
        pos = 0
        zi = 0
        for i in range(enc.n):
            while zi < len(zeros) and zeros[zi] < pos:
                zi += 1
            t = int(zeros[zi])
            nb = t - pos
            payload = 0
            for b in bits[t + 1 : t + 1 + nb].tolist():
                payload = (payload << 1) | int(b)
            ln = (1 << nb) | payload  # gamma-decoded bit-length of the value
            p2 = t + 1 + nb
            v = 1
            for b in bits[p2 : p2 + ln - 1].tolist():
                v = (v << 1) | int(b)
            out[i] = v
            pos = p2 + ln - 1
            zi += 1
        return out
