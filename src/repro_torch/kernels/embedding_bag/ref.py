"""NumPy oracle for the bag sums."""

from __future__ import annotations

import numpy as np


def embedding_bag_ref(indices, table, bag_size: int, row_start: int = 0,
                      n_rows: int | None = None) -> np.ndarray:
    """indices (n_bags * bag_size,) row ids; table (V, D) -> (n_bags, D)
    float64 sums of each bag's rows; a bag holding a row outside [0, V) is
    NaN.  With ``row_start`` / ``n_rows`` the table is rows ``[row_start,
    row_start + V)`` of a table of ``n_rows`` rows: another shard's row adds
    0, a row outside ``[0, n_rows)`` makes the bag NaN."""
    idx = np.asarray(indices, dtype=np.int64).reshape(-1, bag_size)
    tab = np.asarray(table, dtype=np.float64)
    n = tab.shape[0] if n_rows is None else n_rows
    live = (idx >= 0) & (idx < n)
    local = idx - row_start
    inside = live & (local >= 0) & (local < tab.shape[0])
    rows = (tab[np.where(inside, local, 0)] if tab.shape[0]
            else np.zeros(idx.shape + tab.shape[1:]))
    rows[live & ~inside] = 0.0
    rows[~live] = np.nan
    return rows.sum(axis=1)
