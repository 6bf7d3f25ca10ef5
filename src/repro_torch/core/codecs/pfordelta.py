"""PForDelta (Zukowski et al.; NewPFD-style exception patching).

Blocks of 128 values.  Per block: width b chosen as the smallest such that
>= 90% of values fit in b bits; values are stored b-bit packed (exceptions
store their low b bits in place), and exceptions' positions + high bits are
Vbyte-coded in a per-block patch area.

Bit-packing / unpacking is vectorized via ``np.unpackbits``-style reshapes.
"""

from __future__ import annotations

import numpy as np

from .base import Codec, EncodedList, register_codec
from .vbyte import vbyte_decode_array, vbyte_encode_array

BLOCK = 128


def _pack_fixed(values: np.ndarray, width: int) -> bytes:
    """Pack int64 values (< 2^width) into a dense MSB-first bitstream."""
    if width == 0 or len(values) == 0:
        return b""
    n = len(values)
    shifts = np.arange(width - 1, -1, -1, dtype=np.int64)
    bits = ((values[:, None] >> shifts[None, :]) & 1).astype(np.uint8).reshape(-1)
    return np.packbits(bits).tobytes()


def _unpack_fixed(data: bytes, n: int, width: int) -> np.ndarray:
    if width == 0 or n == 0:
        return np.zeros(n, dtype=np.int64)
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))[: n * width]
    bits = bits.reshape(n, width).astype(np.int64)
    weights = (1 << np.arange(width - 1, -1, -1)).astype(np.int64)
    return bits @ weights


def _choose_width(block: np.ndarray, opt: bool = False) -> int:
    """Width selection: classic = smallest covering >= 90% (exceptions
    <= 10%); opt (OPT-PFD, Yan et al. [65]) = minimize the actual encoded
    bits over all candidate widths."""
    # exact bit lengths: values < 2^53 so the +1 is float64-exact
    nbits = np.maximum(1, np.ceil(np.log2(block.astype(np.float64) + 1.0)).astype(np.int64))
    order = np.sort(nbits)
    if not opt:
        limit = int(np.ceil(0.9 * len(block)))
        return int(order[limit - 1])
    best_b, best_cost = int(order[-1]), None
    n = len(block)
    for b in range(1, int(order[-1]) + 1):
        n_exc = int(np.sum(nbits > b))
        # packed low bits + ~16 bits per exception (vbyte idx + high bits)
        cost = n * b + 16 * n_exc
        if best_cost is None or cost < best_cost:
            best_b, best_cost = b, cost
    return best_b


@register_codec("pfordelta")
class PForDelta(Codec):
    opt = False  # OPT-PFD width selection (see OptPFD below)

    def encode(self, gaps: np.ndarray) -> EncodedList:
        v = np.asarray(gaps, dtype=np.int64)
        chunks: list[bytes] = []
        headers: list[tuple[int, int, int, int]] = []  # (count, width, packed_bytes, patch_bytes)
        nbits = 0
        for s in range(0, len(v), BLOCK):
            block = v[s : s + BLOCK]
            b = _choose_width(block, opt=self.opt)
            low = block & ((1 << b) - 1) if b else np.zeros_like(block)
            packed = _pack_fixed(low, b)
            exc_idx = np.flatnonzero(block >= (1 << b))
            exc_hi = block[exc_idx] >> b
            patch = vbyte_encode_array(exc_idx) + vbyte_encode_array(exc_hi)
            headers.append((len(block), b, len(packed), len(vbyte_encode_array(exc_idx))))
            chunks.append(packed + patch)
            # header cost: width (5 bits) + exception count (8) + patch length (16)
            nbits += 8 * len(packed) + 8 * len(patch) + 5 + 8 + 16
        meta = {"headers": headers}
        return EncodedList(n=len(v), nbits=nbits, data=b"".join(chunks), meta=meta)

    def decode(self, enc: EncodedList) -> np.ndarray:
        out = np.empty(enc.n, dtype=np.int64)
        pos = 0
        oi = 0
        for count, b, packed_len, idx_len in enc.meta["headers"]:
            packed = enc.data[pos : pos + packed_len]
            pos += packed_len
            vals = _unpack_fixed(packed, count, b)
            # patch area: exception indices then high bits
            # (lengths recovered from idx_len and codeword structure)
            idx_bytes = enc.data[pos : pos + idx_len]
            pos += idx_len
            exc_idx = vbyte_decode_array(idx_bytes) if idx_len else np.zeros(0, dtype=np.int64)
            n_exc = len(exc_idx)
            if n_exc:
                # high-bit area: read n_exc vbyte codewords
                arr = np.frombuffer(enc.data[pos:], dtype=np.uint8)
                ends = np.flatnonzero((arr & 0x80) != 0)
                hi_len = int(ends[n_exc - 1]) + 1
                exc_hi = vbyte_decode_array(enc.data[pos : pos + hi_len], n_exc)
                pos += hi_len
                vals[exc_idx] |= exc_hi << b
            out[oi : oi + count] = vals
            oi += count
        return out


@register_codec("opt_pfd")
class OptPFD(PForDelta):
    """OPT-PFD (Yan et al. [65]): per-block width chosen to minimize bits."""

    opt = True
