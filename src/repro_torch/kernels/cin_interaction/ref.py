"""NumPy oracle for the CIN layer."""

from __future__ import annotations

import numpy as np


def cin_layer_ref(x0, xk, w) -> np.ndarray:
    """x0 (B, m, D), xk (B, Hk, D), w (m * Hk, H) -> (B, H, D) float64:
    ``out[b, h, d] = sum_{i, j} w[i * Hk + j, h] * x0[b, i, d] * xk[b, j, d]``."""
    x0, xk, w = (np.asarray(a, dtype=np.float64) for a in (x0, xk, w))
    m, hk = x0.shape[1], xk.shape[1]
    return np.einsum("bid,bjd,ijh->bhd", x0, xk, w.reshape(m, hk, -1))
