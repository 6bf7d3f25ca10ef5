"""NumPy oracle for the flash attention kernel."""

from __future__ import annotations

import numpy as np


def flash_fwd_ref(q, k, v, causal: bool = True) -> np.ndarray:
    """q (BK, G, T, hd); k, v (BK, S, hd), the TPU kernel's layout ->
    (BK, G, T, hd) float64: softmax over the keys (``s <= t`` under causal)
    of the scaled scores, in float64."""
    q, k, v = (np.asarray(x, dtype=np.float64) for x in (q, k, v))
    t, hd = q.shape[2], q.shape[3]
    s = k.shape[1]
    scores = np.einsum("bgtd,bsd->bgts", q, k) / np.sqrt(hd)
    if causal:
        mask = np.arange(s)[None, :] <= np.arange(t)[:, None]
        scores = np.where(mask[None, None], scores, -np.inf)
    scores = scores - scores.max(axis=-1, keepdims=True)
    p = np.exp(scores)
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bgts,bsd->bgtd", p, v)
