"""Least time of the serving windows: the operations and bytes that a
window's own inputs need, and the card's peaks.

The arithmetic is ``chip_smoke.py``'s (``bound``, ``_search_steps``,
``_distinct_words`` and the probe accounting of ``decode_window_bound``,
``probe_window_bound`` and ``dense_probe_window_bound``), copied and
restated over what a window is given: the host index's lists (taken from
the reference, by term), the group's query terms as the server encodes them,
the window's first row, and the device layout's entry structure (entry
offsets and lanes).  It never reads a kernel's launch arguments, so the same
window counts the same work whether one kernel or fifteen implement it.

Per window, with B queries of W padded terms, C output lanes a query:

* bytes: the step's outputs, 5 B a lane (postings and match flags); the
  query matrix and lengths, 4 B (W + 1) a query; the window's candidates
  (fused: 12 B an entry for its pointer, anchor and length and 4 B a pool
  word under its lanes; dense: 5 B a live lane, value and flag); the probes'
  reads, 4 B an anchor word under the distinct slices probed and 4 (fused) or
  5 (dense) B a live lane of the distinct rows probed, or 4 B a load where
  that is fewer;
* operations: 2 a live candidate lane (read and re-base), and for each probe
  that runs (a candidate's loop stops at its first miss) its anchor slice's
  bisection steps, its row's (two loads a step on the dense layout: value
  and flag) and one compare.  Integer operations are counted against the
  float32 rate, as in ``chip_smoke.py``; the H100 has no separate int32 peak
  on its data sheet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM3 bytes/s and
#: the float32 rate outside the tensor cores, taken too for int32 ALU work
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
#: candidate entries a window takes from the driving list
WINDOW_ROWS = 64


def bound(bytes_moved: float, ops: float, peak_ops: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    """Least time (s) the card could take: the larger of bytes over the memory
    rate and operations over the peak rate, and which one it is."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S
    by_ops = ops / peak_ops
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def search_steps(n: np.ndarray) -> int:
    """Compares a bisection over slices of the given lengths needs:
    ceil(log2(n + 1)) a slice, summed."""
    n = np.maximum(np.asarray(n, dtype=np.float64), 0)
    return int(np.ceil(np.log2(n + 1)).sum())


@dataclass
class Layout:
    """A device layout's entry structure over one index's lists, and the
    lists themselves by term id."""

    c_offsets: np.ndarray  # (n_lists + 1,) entry slice of each list
    lanes: np.ndarray  # (n_entries,) postings of each entry
    lane_width: int  # lanes a candidate entry occupies in the step's output
    fused: bool
    lists: list  # term id -> sorted postings (the reference's)

    def entries(self, tid: int) -> tuple[np.ndarray, np.ndarray]:
        """(first posting of each entry, lanes of each entry) of one list."""
        lo, hi = int(self.c_offsets[tid]), int(self.c_offsets[tid + 1])
        lanes = self.lanes[lo:hi]
        starts = np.concatenate([[0], np.cumsum(lanes)[:-1]]).astype(np.int64)
        vals = self.lists[tid]
        return vals[np.minimum(starts, max(len(vals) - 1, 0))], lanes


def group_least_seconds(layout: Layout, qt: np.ndarray, ql: np.ndarray, ok: np.ndarray,
                        phrase: bool) -> tuple[float, int]:
    """Least seconds of every window the server sweeps for one encoded group,
    summed, and the number of windows."""
    b, w = qt.shape
    c_off = layout.c_offsets
    n_entries = (c_off[qt[:, 0] + 1] - c_off[qt[:, 0]]).astype(np.int64)
    live = n_entries[ok] if ok.any() else n_entries[:1]
    n_windows = max(1, -(-int(live.max()) // WINDOW_ROWS))
    cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def entries(tid):
        if tid not in cache:
            cache[tid] = layout.entries(tid)
        return cache[tid]

    acc = [{"bytes": 0, "ops": 0, "loads": 0, "slices": set(), "rows": []}
           for _ in range(n_windows)]
    row_bytes = 4 if layout.fused else 5
    for i in np.flatnonzero(ok):
        t0 = int(qt[i, 0])
        first0, lanes0 = entries(t0)
        vals0 = layout.lists[t0]
        starts0 = np.concatenate([[0], np.cumsum(lanes0)]).astype(np.int64)
        for win in range(-(-int(n_entries[i]) // WINDOW_ROWS)):
            a_e = win * WINDOW_ROWS
            b_e = min(int(n_entries[i]), a_e + WINDOW_ROWS)
            cand = vals0[starts0[a_e]:starts0[b_e]]
            n_lanes = len(cand)
            a = acc[win]
            a["bytes"] += (12 * (b_e - a_e) + 4 * n_lanes) if layout.fused else 5 * n_lanes
            a["ops"] += 2 * n_lanes
            alive = np.ones(n_lanes, dtype=bool)
            for t in range(1, int(ql[i])):
                if not alive.any():
                    break
                tid = int(qt[i, t])
                first, lanes = entries(tid)
                target = cand[alive] + t if phrase else cand[alive]
                if len(first) == 0:
                    alive[:] = False
                    break
                j = np.clip(np.searchsorted(first, target, side="right") - 1, 0, len(first) - 1)
                a["loads"] += (len(target) * (1 + search_steps([len(first)]))
                               + (1 if layout.fused else 2) * search_steps(lanes[j]))
                a["slices"].add(tid)
                a["rows"].append((np.full(len(j), tid, dtype=np.int64) << 32) | j)
                vals = layout.lists[tid]
                pos = np.searchsorted(vals, target)
                hit = (pos < len(vals)) & (vals[np.minimum(pos, max(len(vals) - 1, 0))] == target)
                alive[np.flatnonzero(alive)] = hit
    total = 0.0
    out_bytes = 5 * b * WINDOW_ROWS * layout.lane_width + 4 * b * (w + 1)
    for a in acc:
        words = 4 * sum(int(c_off[t + 1] - c_off[t]) for t in a["slices"])
        if a["rows"]:
            keys = np.unique(np.concatenate(a["rows"]))
            tids, js = keys >> 32, keys & 0xFFFFFFFF
            words += row_bytes * int(layout.lanes[c_off[tids].astype(np.int64) + js].sum())
        moved = out_bytes + a["bytes"] + min(words, 4 * a["loads"])
        total += bound(moved, a["ops"] + a["loads"])[0]
    return total, n_windows
