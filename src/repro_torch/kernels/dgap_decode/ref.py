"""NumPy oracle for the d-gap decode."""

from __future__ import annotations

import numpy as np


def dgap_decode_ref(gaps) -> np.ndarray:
    """Inclusive prefix sum over the row-major flat order of ``gaps`` (any
    shape), returned in the same shape as int32 with wraparound: the sums
    are taken in int64 and cut to their low 32 bits."""
    g = np.asarray(gaps)
    return np.cumsum(g.reshape(-1), dtype=np.int64).astype(np.int32).reshape(g.shape)
