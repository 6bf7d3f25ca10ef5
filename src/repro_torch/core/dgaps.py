"""d-gap transforms and posting-list primitives (paper §2.2, §3).

Posting lists are strictly increasing sequences of non-negative integers
(document identifiers for non-positional indexes, global word offsets for
positional indexes).  All compression methods in this repo operate on the
*d-gap* transform:

    <p1, p2, ..., pl>  ->  <p1 + 1, p2 - p1, ..., pl - p_{l-1}>

We store the first element as ``p1 + 1`` so that every gap is >= 1 (doc ids
may start at 0); codecs can then assume strictly positive integers, which is
what Rice/Simple9/PForDelta/interpolative expect.

This module is the NumPy storage/build tier; the query path reads the
anchored device arrays of ``repro_torch.core.anchors``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "to_dgaps",
    "from_dgaps",
    "concat_lists",
    "split_lists",
    "validate_posting_list",
]


def validate_posting_list(postings: np.ndarray) -> None:
    """Raise ValueError unless ``postings`` is strictly increasing and >= 0."""
    p = np.asarray(postings)
    if p.ndim != 1:
        raise ValueError(f"posting list must be 1-D, got shape {p.shape}")
    if p.size == 0:
        return
    if p[0] < 0:
        raise ValueError("posting list values must be non-negative")
    if p.size > 1 and not np.all(p[1:] > p[:-1]):
        raise ValueError("posting list must be strictly increasing")


def to_dgaps(postings: np.ndarray) -> np.ndarray:
    """Strictly increasing postings -> gaps, first element stored as p1+1."""
    p = np.asarray(postings, dtype=np.int64)
    if p.size == 0:
        return p.copy()
    g = np.empty_like(p)
    g[0] = p[0] + 1
    np.subtract(p[1:], p[:-1], out=g[1:])
    return g


def from_dgaps(gaps: np.ndarray) -> np.ndarray:
    """Inverse of :func:`to_dgaps`."""
    g = np.asarray(gaps, dtype=np.int64)
    if g.size == 0:
        return g.copy()
    p = np.cumsum(g)
    p -= 1
    return p


def concat_lists(lists: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate lists into one flat array + offsets (len(lists)+1)."""
    offsets = np.zeros(len(lists) + 1, dtype=np.int64)
    for i, l in enumerate(lists):
        offsets[i + 1] = offsets[i] + len(l)
    if lists:
        flat = np.concatenate([np.asarray(l, dtype=np.int64) for l in lists])
    else:
        flat = np.zeros(0, dtype=np.int64)
    return flat, offsets


def split_lists(flat: np.ndarray, offsets: np.ndarray) -> list[np.ndarray]:
    """Inverse of :func:`concat_lists`."""
    return [flat[offsets[i] : offsets[i + 1]] for i in range(len(offsets) - 1)]
