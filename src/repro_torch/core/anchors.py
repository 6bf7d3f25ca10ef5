"""Anchored device representation of Re-Pair compressed lists.

The paper's skipping intersection walks C sequentially, accumulating phrase
sums.  On a batch machine the same information is precomputed once:

    anchor[j] = cumulative d-gap BEFORE C entry j   (prefix sum of phrase sums)

Membership of x in a list becomes: binary-search the list's anchor slice for
x (batched over all probes of a query batch), then verify inside at most ONE
phrase via a bounded expansion (depth is O(log n), paper §4.4).  Work per
probe is O(log n' + expand), identical to the paper's sampled bound (Cor. 1),
with full query-batch parallelism.

``AnchoredIndex`` (dense expand tables) and ``CompressedAnchoredIndex``
(anchors + shared prefix-summed rule pool) are the device-resident forms
consumed by ``repro_torch.serving.engine``.  Every device array is **int32**
(bool for masks), so ``device_bytes()`` is the sum of what the tensors hold;
indices are widened with ``.long()`` only at a gather site.  The builders
put their arrays on the GPU (``device="cuda"``, which raises without one)
unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from .device import resolve_device
from .repair import RePairStore

#: elements one chunk of a row gather may hold (bounds the (rows, width)
#: staging tensor of the dense row compare to 256 MiB of int32)
ROW_CHUNK_ELEMS = 1 << 26


@contextmanager
def _local_expansion_cache(store: RePairStore):
    """Memoized symbol expansion for the duration of a build, without
    mutating the caller's store: the cache lives in a build-local dict and
    the store's prior ``memoize``/``_memo`` state is restored on exit.
    (If the caller already opted into memoization, their cache keeps
    accumulating as usual.)"""
    prev_memoize = store.memoize
    prev_memo = store._memo
    store.memoize = True
    if not prev_memoize:
        store._memo = {}
    try:
        yield
    finally:
        store.memoize = prev_memoize
        store._memo = prev_memo


def _i32(a, device) -> torch.Tensor:
    """NumPy (any integer dtype) -> contiguous int32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.int32))).to(device)


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclass
class AnchoredIndex:
    """Flat device arrays for batched query execution (dense layout)."""

    anchors: torch.Tensor  # (n_c,) int32 — cumulative gap before each C entry
    c_offsets: torch.Tensor  # (n_lists+1,) int32 — list slices into anchors/expand
    expand: torch.Tensor  # (n_c, expand_len) int32 — per-entry absolute values
    expand_valid: torch.Tensor  # (n_c, expand_len) bool
    lengths: torch.Tensor  # (n_lists,) int32
    expand_len: int

    @classmethod
    def from_store(cls, store: RePairStore, expand_len: int = 32,
                   device="cuda") -> "AnchoredIndex":
        device = resolve_device(device)
        n_lists = store.n_lists
        # widen the table to the longest phrase so probes are exact
        max_len = 1
        for s in np.unique(store.c):
            max_len = max(max_len, store.symbol_len(int(s)))
        if max_len > expand_len:
            expand_len = int(2 ** np.ceil(np.log2(max_len)))
        offsets = store.c_offsets.astype(np.int64)
        n_c = int(offsets[-1]) if len(offsets) else 0
        anchors_np = np.zeros(n_c, dtype=np.int64)
        expand_np = np.zeros((n_c, expand_len), dtype=np.int32)
        valid_np = np.zeros((n_c, expand_len), dtype=bool)
        with _local_expansion_cache(store):
            for i in range(n_lists):
                lo, hi = int(offsets[i]), int(offsets[i + 1])
                run = 0
                for j in range(lo, hi):
                    sym = int(store.c[j])
                    anchors_np[j] = run
                    acc = np.cumsum(store.expand_symbol(sym)) + run
                    expand_np[j, : len(acc)] = acc
                    valid_np[j, : len(acc)] = True
                    run += int(store.symbol_sum(sym))
        return cls(
            anchors=_i32(anchors_np, device),
            c_offsets=_i32(offsets, device),
            expand=torch.from_numpy(expand_np).to(device),
            expand_valid=torch.from_numpy(valid_np).to(device),
            lengths=_i32(store.lengths, device),
            expand_len=expand_len,
        )

    @classmethod
    def from_numpy(cls, arrays: dict, device="cuda") -> "AnchoredIndex":
        """From a dict of NumPy arrays keyed like the fields (state carried
        across from another build of the same structure)."""
        device = resolve_device(device)
        expand = np.asarray(arrays["expand"])
        return cls(
            anchors=_i32(arrays["anchors"], device),
            c_offsets=_i32(arrays["c_offsets"], device),
            expand=_i32(expand, device),
            expand_valid=torch.from_numpy(
                np.array(arrays["expand_valid"], dtype=bool, order="C")).to(device),
            lengths=_i32(arrays["lengths"], device),
            expand_len=int(arrays.get("expand_len", expand.shape[-1])),
        )

    def device_bytes(self) -> int:
        return _nbytes(self.anchors, self.c_offsets, self.expand,
                       self.expand_valid, self.lengths)


def build_anchored(lists: list[np.ndarray], expand_len: int = 32, device="cuda",
                   **kw) -> AnchoredIndex:
    """Re-Pair compress, then anchor (expand table widened to the longest
    phrase so probes are exact)."""
    device = resolve_device(device)
    store = RePairStore.build(lists, variant="skip", **kw)
    return AnchoredIndex.from_store(store, expand_len=expand_len, device=device)


@dataclass
class CompressedAnchoredIndex:
    """Compressed device form: anchors plus a shared d-gap *pool*.

    Instead of a dense ``(n_c, expand_len)`` expand table (one padded row
    per C entry, widened to the longest phrase in the whole collection),
    each distinct Re-Pair symbol stores its leaf d-gaps ONCE in ``pool``
    and every C entry holds a ``(ptr, len)`` pointer into it.  On
    repetitive collections the same rules recur across lists, so the pool
    stays near the grammar size while the dense table grows with n_c —
    this is the paper's compression premise carried through to device
    memory.

    The pool rows are stored *prefix-summed*: the within-symbol scan runs
    once per distinct rule at build time, amortized across every
    occurrence, so the in-sweep decode (``kernels/fused_decode``) is one
    read plus an anchor re-base — element ``l`` of entry ``j`` is
    ``anchors[j] + pool[c_ptr[j] + l]``, identical in cumulative-gap space
    to the dense expand rows, so serve results are byte-identical to the
    dense layout.
    """

    anchors: torch.Tensor  # (n_c,) int32 — cumulative gap before each C entry
    c_offsets: torch.Tensor  # (n_lists+1,) int32 — list slices into anchors
    c_ptr: torch.Tensor  # (n_c,) int32 — entry's d-gap slice start in pool
    c_len: torch.Tensor  # (n_c,) int32 — entry's d-gap count
    pool: torch.Tensor  # (pool_size,) int32 — per-symbol leaf d-gap prefix sums, deduped
    lengths: torch.Tensor  # (n_lists,) int32
    max_phrase: int  # longest rule expansion (static decode bound)

    @classmethod
    def from_store(cls, store: RePairStore, device="cuda") -> "CompressedAnchoredIndex":
        device = resolve_device(device)
        n_lists = store.n_lists
        offsets = store.c_offsets.astype(np.int64)
        sym_ptr: dict[int, tuple[int, int]] = {}  # symbol -> (ptr, len) in pool
        pool_parts: list[np.ndarray] = []
        pool_size = 0
        anchors_np: list[int] = []
        ptr_np: list[int] = []
        len_np: list[int] = []
        max_phrase = 1
        with _local_expansion_cache(store):
            for i in range(n_lists):
                lo, hi = int(offsets[i]), int(offsets[i + 1])
                run = 0
                for j in range(lo, hi):
                    sym = int(store.c[j])
                    if sym not in sym_ptr:
                        # prefix-sum once per distinct rule; every
                        # occurrence then decodes with a read + add
                        psum = np.cumsum(
                            np.asarray(store.expand_symbol(sym), dtype=np.int64))
                        sym_ptr[sym] = (pool_size, len(psum))
                        pool_parts.append(psum)
                        pool_size += len(psum)
                    ptr, ln = sym_ptr[sym]
                    anchors_np.append(run)
                    ptr_np.append(ptr)
                    len_np.append(ln)
                    max_phrase = max(max_phrase, ln)
                    run += int(store.symbol_sum(sym))
        # one decode window of zero padding: a row read of max_phrase lanes
        # from any entry's pointer stays inside the pool
        pool_parts.append(np.zeros(max_phrase, dtype=np.int64))
        pool = np.concatenate(pool_parts)
        return cls(
            anchors=_i32(np.asarray(anchors_np, dtype=np.int64), device),
            c_offsets=_i32(offsets, device),
            c_ptr=_i32(np.asarray(ptr_np, dtype=np.int64), device),
            c_len=_i32(np.asarray(len_np, dtype=np.int64), device),
            pool=_i32(pool, device),
            lengths=_i32(store.lengths, device),
            max_phrase=int(max_phrase),
        )

    @classmethod
    def from_numpy(cls, arrays: dict, device="cuda") -> "CompressedAnchoredIndex":
        """From a dict of NumPy arrays keyed like the fields, plus the int
        ``max_phrase`` (state carried across from another build)."""
        device = resolve_device(device)
        return cls(
            anchors=_i32(arrays["anchors"], device),
            c_offsets=_i32(arrays["c_offsets"], device),
            c_ptr=_i32(arrays["c_ptr"], device),
            c_len=_i32(arrays["c_len"], device),
            pool=_i32(arrays["pool"], device),
            lengths=_i32(arrays["lengths"], device),
            max_phrase=int(arrays["max_phrase"]),
        )

    def device_bytes(self) -> int:
        return _nbytes(self.anchors, self.c_offsets, self.c_ptr, self.c_len,
                       self.pool, self.lengths)


def build_compressed_anchored(lists: list[np.ndarray], device="cuda",
                              **kw) -> CompressedAnchoredIndex:
    """Re-Pair compress, then anchor without expanding: the fused-layout
    counterpart of :func:`build_anchored`."""
    device = resolve_device(device)
    store = RePairStore.build(lists, variant="skip", **kw)
    return CompressedAnchoredIndex.from_store(store, device=device)


# ----------------------------------------------------------------------
# batched membership (plain tensor code; the CUDA kernels of
# ``repro_torch.kernels`` are the other implementation of the same probes)
# ----------------------------------------------------------------------
def lower_bound_sliced(table: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                       targets: torch.Tensor, depth: int = 32) -> torch.Tensor:
    """Per probe, the first position in ``[lo, hi)`` whose ``table`` value is
    ``>= target`` (``hi`` when none): a bounded binary search of ``depth``
    steps, batched over all probes.  A probe freezes once converged, so the
    loop may stop as soon as every probe has (same answer, fewer steps)."""
    l, h = lo.clone(), hi.clone()
    if table.numel() == 0:
        return l
    top = table.numel() - 1
    for _ in range(depth):
        active = l < h
        if not bool(active.any()):
            break
        mid = (l + h) // 2
        below = table[mid.clamp(0, top).long()] < targets
        go_right = active & below
        l = torch.where(go_right, mid + 1, l)
        h = torch.where(active & ~go_right, mid, h)
    return l


def rows_contain(expand: torch.Tensor, expand_valid: torch.Tensor,
                 j: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``any(expand_valid[j] & (expand[j] == target))`` per probe — the dense
    layout's row compare.  The ``(probes, expand_len)`` row gather is staged
    in chunks of at most ``ROW_CHUNK_ELEMS`` elements."""
    n = j.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=j.device)
    step = max(1, ROW_CHUNK_ELEMS // max(1, expand.shape[-1]))
    for s in range(0, n, step):
        jj = j[s:s + step].long()
        out[s:s + step] = (expand_valid[jj]
                           & (expand[jj] == targets[s:s + step, None])).any(dim=1)
    return out


def member_batch(idx: AnchoredIndex, list_ids: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """For each (list_id, value) pair: is value in that list?  Fully batched.

    values are absolute postings; comparison in cumulative-gap space (+1).
    Anchors are per-list cumulative sums, so the binary search runs within
    the list's [lo, hi) slice: find the first entry whose anchor >= t, then
    step back — entry j covers targets in (anchor[j], anchor[j] + phrase_sum].
    """
    targets = values.to(torch.int32) + 1
    ids = list_ids.long()
    lo = idx.c_offsets[ids]
    hi = idx.c_offsets[ids + 1]
    n = idx.anchors.shape[0]
    if n == 0:
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    l = lower_bound_sliced(idx.anchors, lo, hi, targets)
    # an empty last list has lo == hi == n: its entry reads the last row
    # (masked by lo < hi), as the reference's clamped gather does
    j = torch.maximum(l - 1, lo).clamp(max=n - 1)
    return rows_contain(idx.expand, idx.expand_valid, j, targets) & (lo < hi)


def rows_are_sorted_prefixes(expand: torch.Tensor, expand_valid: torch.Tensor) -> bool:
    """Whether every row's valid lanes are a prefix of the row and their
    values strictly increase (signed int32): the precondition of the dense
    window kernel's row bisection (``kernels.anchor_intersect.ops.
    dense_probe_window``).  Every builder here gives such rows; the tests
    hold each dense table to it."""
    if expand.numel() == 0:
        return True
    prefix = bool((expand_valid[:, 1:] <= expand_valid[:, :-1]).all())
    rising = (expand[:, 1:].long() > expand[:, :-1].long()) | ~expand_valid[:, 1:]
    return prefix and bool(rising.all())


def member_batch_compressed(idx: CompressedAnchoredIndex, list_ids: torch.Tensor,
                            values: torch.Tensor) -> torch.Tensor:
    """Fused-layout membership: binary-search the anchors exactly as
    :func:`member_batch`, then — because the covering entry's pool row is
    prefix-summed, hence strictly increasing — a second bounded binary
    search *inside* the row.  Membership touches ``log2(max_phrase)`` pool
    lanes instead of reading a ``max_phrase``-wide expand row; the decoded
    postings never materialize anywhere."""
    if int(idx.anchors.shape[0]) == 0:
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    targets = values.to(torch.int32) + 1
    ids = list_ids.long()
    lo = idx.c_offsets[ids]
    hi = idx.c_offsets[ids + 1]
    pool_top = int(idx.pool.shape[0]) - 1
    depth = max(int(idx.max_phrase), 1).bit_length() + 1
    l = lower_bound_sliced(idx.anchors, lo, hi, targets)
    j = torch.maximum(l - 1, lo).long()
    # membership of t in entry j == membership of t - anchors[j] in its
    # sorted prefix-sum row [c_ptr[j], c_ptr[j] + c_len[j])
    tt = targets - idx.anchors[j]
    p_lo = idx.c_ptr[j]
    p_hi = p_lo + idx.c_len[j]
    l2 = lower_bound_sliced(idx.pool, p_lo, p_hi, tt, depth=depth)
    hit = (l2 < p_hi) & (idx.pool[l2.clamp(0, pool_top).long()] == tt)
    return hit & (lo < hi)
