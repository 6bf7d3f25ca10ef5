"""NumPy oracle for the grouped expert product."""

from __future__ import annotations

import numpy as np


def moe_gemm_ref(buf, w) -> np.ndarray:
    """buf (E, C, D), w (E, D, F) -> (E, C, F) float64, one product per expert."""
    return np.einsum("ecd,edf->ecf", np.asarray(buf, dtype=np.float64),
                     np.asarray(w, dtype=np.float64))
