"""Bit-level I/O used by the bit-granular codecs (Rice, interpolative, EF).

Writer: append-oriented, MSB-first within the stream.
Reader: wraps a ``np.unpackbits`` bit array; supports both sequential reads
and vectorized bulk extraction of fixed-width fields.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BitWriter", "BitReader", "bits_to_bytes", "minimal_binary_len"]


def bits_to_bytes(nbits: int) -> int:
    return (nbits + 7) // 8


def minimal_binary_len(r: int) -> int:
    """Number of bits needed to write a value in [0, r] (0 if r == 0)."""
    if r <= 0:
        return 0
    return int(r).bit_length()


class BitWriter:
    """MSB-first bit appender."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0  # bit accumulator (int)
        self._nacc = 0  # bits currently in accumulator
        self.nbits = 0

    def write_bits(self, value: int, width: int) -> None:
        """Append ``width`` low bits of ``value`` (MSB of the field first)."""
        if width < 0:
            raise ValueError("negative width")
        if width == 0:
            return
        value &= (1 << width) - 1
        self._acc = (self._acc << width) | value
        self._nacc += width
        self.nbits += width
        while self._nacc >= 8:
            self._nacc -= 8
            self._buf.append((self._acc >> self._nacc) & 0xFF)
        self._acc &= (1 << self._nacc) - 1

    def write_unary(self, q: int) -> None:
        """q ones followed by a terminating zero."""
        while q >= 32:
            self.write_bits((1 << 32) - 1, 32)
            q -= 32
        self.write_bits(((1 << q) - 1) << 1, q + 1)

    def write_gamma(self, v: int) -> None:
        """Elias gamma for v >= 1."""
        if v < 1:
            raise ValueError("gamma requires v >= 1")
        nb = int(v).bit_length() - 1
        self.write_unary(nb)
        self.write_bits(v & ((1 << nb) - 1), nb)

    def write_delta(self, v: int) -> None:
        """Elias delta for v >= 1."""
        if v < 1:
            raise ValueError("delta requires v >= 1")
        nb = int(v).bit_length()
        self.write_gamma(nb)
        self.write_bits(v & ((1 << (nb - 1)) - 1), nb - 1)

    def write_rice(self, v: int, b: int) -> None:
        """Rice code for v >= 1 with parameter b."""
        if v < 1:
            raise ValueError("rice requires v >= 1")
        x = v - 1
        self.write_unary(x >> b)
        if b:
            self.write_bits(x & ((1 << b) - 1), b)

    def getvalue(self) -> bytes:
        """Flush (zero-padded to a byte boundary) and return the bytes."""
        out = bytearray(self._buf)
        if self._nacc:
            out.append((self._acc << (8 - self._nacc)) & 0xFF)
        return bytes(out)


class BitReader:
    """MSB-first bit reader over a bytes object, backed by a uint8 bit array."""

    def __init__(self, data: bytes, nbits: int | None = None) -> None:
        self.bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self.nbits = len(self.bits) if nbits is None else nbits
        self.pos = 0

    def read_bits(self, width: int) -> int:
        if width == 0:
            return 0
        chunk = self.bits[self.pos : self.pos + width]
        self.pos += width
        v = 0
        for b in chunk.tolist():
            v = (v << 1) | b
        return v

    def read_unary(self) -> int:
        """Count ones until the terminating zero."""
        start = self.pos
        # fast path: find next zero with numpy
        rel = np.argmax(self.bits[start : self.nbits] == 0)
        if self.bits[start + rel] != 0:  # no zero found
            raise EOFError("unterminated unary code")
        self.pos = start + rel + 1
        return int(rel)

    def read_gamma(self) -> int:
        nb = self.read_unary()
        return (1 << nb) | self.read_bits(nb)

    def read_delta(self) -> int:
        nb = self.read_gamma()
        return (1 << (nb - 1)) | self.read_bits(nb - 1)

    def read_rice(self, b: int) -> int:
        q = self.read_unary()
        r = self.read_bits(b) if b else 0
        return ((q << b) | r) + 1

    # ------------------------------------------------------------------
    # vectorized helpers
    # ------------------------------------------------------------------
    def read_fixed_array(self, n: int, width: int) -> np.ndarray:
        """Read ``n`` consecutive ``width``-bit fields, vectorized."""
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        if width == 0:
            return np.zeros(n, dtype=np.int64)
        total = n * width
        chunk = self.bits[self.pos : self.pos + total].astype(np.int64)
        self.pos += total
        chunk = chunk.reshape(n, width)
        weights = (1 << np.arange(width - 1, -1, -1)).astype(np.int64)
        return chunk @ weights


def next_zero_table(bits: np.ndarray) -> np.ndarray:
    """next_zero[p] = smallest q >= p with bits[q] == 0 (len(bits) if none).

    Used by the vectorized Rice decoder.
    """
    n = len(bits)
    idx = np.arange(n, dtype=np.int64)
    zero_pos = np.where(bits == 0, idx, n)
    # suffix minimum
    return np.minimum.accumulate(zero_pos[::-1])[::-1]
