"""Rice codes + the paper's Rice-Runs (run-length of gap=1, §3.1).

Rice decode uses a mostly-vectorized path: terminator zeros are located with a
monotone pointer into the precomputed zero-position array; the fixed-width
remainders are then extracted in one vectorized pass.
"""

from __future__ import annotations

import numpy as np

from .base import Codec, EncodedList, register_codec
from .bitio import BitReader, BitWriter

__all__ = ["Rice", "RiceRuns", "rice_parameter"]


def rice_parameter(gaps: np.ndarray) -> int:
    """Standard choice: b = floor(log2(mean gap)), clamped to >= 0."""
    if len(gaps) == 0:
        return 0
    mean = float(np.mean(gaps))
    if mean < 1.0:
        return 0
    return max(0, int(np.floor(np.log2(mean))))


def _rice_encode(values: np.ndarray, b: int) -> tuple[bytes, int]:
    w = BitWriter()
    for v in np.asarray(values, dtype=np.int64).tolist():
        w.write_rice(v, b)
    return w.getvalue(), w.nbits


def _rice_decode(data: bytes, n: int, b: int, nbits: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))[:nbits]
    zeros = np.flatnonzero(bits == 0)
    # walk codewords: terminator of value i is the first zero at/after pos
    terms = np.empty(n, dtype=np.int64)
    pos = 0
    j = 0
    zl = zeros  # local ref
    nz = len(zl)
    for i in range(n):
        # advance j to first zero >= pos (monotone -> amortized O(#zeros))
        while j < nz and zl[j] < pos:
            j += 1
        t = zl[j]
        terms[i] = t
        pos = t + 1 + b
        j += 1
    starts = np.empty(n, dtype=np.int64)
    starts[0] = 0
    starts[1:] = terms[:-1] + 1 + b
    q = terms - starts
    if b == 0:
        return q + 1
    # vectorized remainder extraction
    idx = terms[:, None] + 1 + np.arange(b, dtype=np.int64)[None, :]
    rem_bits = bits[idx].astype(np.int64)
    weights = (1 << np.arange(b - 1, -1, -1)).astype(np.int64)
    r = rem_bits @ weights
    return ((q << b) | r) + 1


@register_codec("rice")
class Rice(Codec):
    def encode(self, gaps: np.ndarray) -> EncodedList:
        b = rice_parameter(gaps)
        data, nbits = _rice_encode(gaps, b)
        # b is stored per list in 5 bits (values < 2^32 -> b < 32)
        return EncodedList(n=len(gaps), nbits=nbits + 5, data=data, meta={"b": b, "payload_bits": nbits})

    def decode(self, enc: EncodedList) -> np.ndarray:
        return _rice_decode(enc.data, enc.n, enc.meta["b"], enc.meta["payload_bits"])


@register_codec("rice_runs")
class RiceRuns(Codec):
    """Rice + run-length of 1-runs (paper §3.1).

    A gap of 1 is followed by the encoded run length (the number of
    consecutive 1-gaps, itself Rice-coded with the same parameter).
    """

    def encode(self, gaps: np.ndarray) -> EncodedList:
        g = np.asarray(gaps, dtype=np.int64)
        # build the token stream: gap, and after each 1-gap token, a run length
        tokens: list[int] = []
        i = 0
        n = len(g)
        while i < n:
            if g[i] == 1:
                j = i
                while j < n and g[j] == 1:
                    j += 1
                tokens.append(1)
                tokens.append(j - i)  # run length >= 1
                i = j
            else:
                tokens.append(int(g[i]))
                i += 1
        tok = np.asarray(tokens, dtype=np.int64)
        b = rice_parameter(g)
        data, nbits = _rice_encode(tok, b) if len(tok) else (b"", 0)
        return EncodedList(
            n=len(gaps),
            nbits=nbits + 5,
            data=data,
            meta={"b": b, "payload_bits": nbits, "n_tokens": len(tok)},
        )

    def decode(self, enc: EncodedList) -> np.ndarray:
        tok = _rice_decode(enc.data, enc.meta["n_tokens"], enc.meta["b"], enc.meta["payload_bits"])
        out = np.empty(enc.n, dtype=np.int64)
        oi = 0
        i = 0
        while i < len(tok):
            v = tok[i]
            if v == 1:
                run = int(tok[i + 1])
                out[oi : oi + run] = 1
                oi += run
                i += 2
            else:
                out[oi] = v
                oi += 1
                i += 1
        assert oi == enc.n, f"rice_runs: decoded {oi} values, expected {enc.n}"
        return out
