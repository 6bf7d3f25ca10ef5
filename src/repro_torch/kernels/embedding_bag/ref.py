"""NumPy oracle for the bag sums."""

from __future__ import annotations

import numpy as np


def embedding_bag_ref(indices, table, bag_size: int) -> np.ndarray:
    """indices (n_bags * bag_size,) row ids; table (V, D) -> (n_bags, D)
    float64 sums of each bag's rows; a bag holding a row outside [0, V) is
    NaN."""
    idx = np.asarray(indices, dtype=np.int64).reshape(-1, bag_size)
    tab = np.asarray(table, dtype=np.float64)
    live = (idx >= 0) & (idx < tab.shape[0])
    rows = tab[np.where(live, idx, 0)] if tab.shape[0] else np.zeros(idx.shape + tab.shape[1:])
    rows[~live] = np.nan
    return rows.sum(axis=1)
