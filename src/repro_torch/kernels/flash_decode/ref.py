"""NumPy oracle for flash decoding."""

from __future__ import annotations

import numpy as np


def flash_decode_ref(lengths, q, k, v) -> np.ndarray:
    """lengths (BK,) live cache rows per row; q (BK, G, hd); k, v (BK, S, hd),
    the TPU kernel's layout -> (BK, G, hd) float64: softmax over the keys
    ``s < lengths[row]`` of the scaled scores, in float64."""
    q, k, v = (np.asarray(x, dtype=np.float64) for x in (q, k, v))
    hd, s = q.shape[2], k.shape[1]
    scores = np.einsum("bgd,bsd->bgs", q, k) / np.sqrt(hd)
    live = np.arange(s)[None, None, :] < np.asarray(lengths)[:, None, None]
    scores = np.where(live, scores, -np.inf)
    scores = scores - scores.max(axis=-1, keepdims=True)
    p = np.exp(scores)
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bgs,bsd->bgd", p, v)
