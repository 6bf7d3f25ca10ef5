"""Simple9 (Anh & Moffat) with the paper's 2^28 escape for positional gaps.

Each 32-bit word: 4-bit selector + 28-bit payload holding k equal-width
values.  Gap values >= 2^28 - 1 are escaped: a 1x28 word holding the marker
2^28 - 1, followed by one raw 32-bit word with the true value (paper §5.2).

Decode is vectorized per selector class.
"""

from __future__ import annotations

import numpy as np

from .base import Codec, EncodedList, register_codec

# (count, width) for the 9 selectors; count*width <= 28
S9_MODES: list[tuple[int, int]] = [
    (28, 1),
    (14, 2),
    (9, 3),
    (7, 4),
    (5, 5),
    (4, 7),
    (3, 9),
    (2, 14),
    (1, 28),
]
ESCAPE = (1 << 28) - 1


def _encode_words(values: np.ndarray) -> np.ndarray:
    v = np.asarray(values, dtype=np.int64)
    words: list[int] = []
    i = 0
    n = len(v)
    while i < n:
        if v[i] >= ESCAPE:
            words.append((8 << 28) | ESCAPE)  # selector 8 = (1, 28) marker
            words.append(int(v[i]))  # raw 32-bit word
            i += 1
            continue
        for sel, (cnt, width) in enumerate(S9_MODES):
            take = min(cnt, n - i)
            if take < cnt:
                continue  # try to fill the word fully first
            chunk = v[i : i + cnt]
            if int(chunk.max()) < (1 << width):
                word = sel << 28
                for j, x in enumerate(chunk.tolist()):
                    word |= x << (width * (cnt - 1 - j))
                words.append(word)
                i += cnt
                break
        else:
            # tail: pick the densest mode that fits the remaining values
            for sel, (cnt, width) in enumerate(S9_MODES):
                take = min(cnt, n - i)
                chunk = v[i : i + take]
                if int(chunk.max()) < (1 << width):
                    word = sel << 28
                    for j, x in enumerate(chunk.tolist()):
                        word |= x << (width * (cnt - 1 - j))
                    words.append(word)
                    i += take
                    break
            else:  # pragma: no cover - value < 2^28 always fits (1,28)
                raise AssertionError("unreachable")
    return np.asarray(words, dtype=np.uint32)


def _decode_words(words: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    w = words.astype(np.int64)
    sel = w >> 28
    payload = w & ((1 << 28) - 1)

    # identify escapes: selector-8 words whose payload is the marker; the word
    # after each escape is raw data, to be excluded from normal decoding
    esc = (sel == 8) & (payload == ESCAPE)
    raw = np.zeros(len(w), dtype=bool)
    raw[1:] = esc[:-1]
    normal = ~raw

    counts = np.zeros(len(w), dtype=np.int64)
    for s, (cnt, _) in enumerate(S9_MODES):
        counts[normal & (sel == s)] = cnt
    counts[esc] = 1  # escape word expands to exactly 1 value
    counts[raw] = 0

    # output offset of each word's first value
    offs = np.cumsum(counts) - counts
    total = int(offs[-1] + counts[-1]) if len(w) else 0
    out = np.zeros(max(total, n), dtype=np.int64)

    for s, (cnt, width) in enumerate(S9_MODES):
        m = normal & (sel == s) & ~esc
        if not np.any(m):
            continue
        pw = payload[m]
        base = offs[m]
        mask = (1 << width) - 1
        for j in range(cnt):
            shift = width * (cnt - 1 - j)
            out_idx = base + j
            valid = out_idx < n  # tail word may be partially filled
            out[out_idx[valid]] = (pw[valid] >> shift) & mask
        # note: partially-filled tail words decode trailing zeros; they fall
        # beyond n and are dropped by the slice below
    if np.any(esc):
        out[offs[esc]] = w[raw]
    return out[:n]


@register_codec("simple9")
class Simple9(Codec):
    def encode(self, gaps: np.ndarray) -> EncodedList:
        words = _encode_words(gaps)
        return EncodedList(n=len(gaps), nbits=32 * len(words), data=words.tobytes())

    def decode(self, enc: EncodedList) -> np.ndarray:
        words = np.frombuffer(enc.data, dtype=np.uint32)
        return _decode_words(words, enc.n)
