"""Batched membership probes against anchor arrays.

``anchor_probe_sliced`` is the per-(term, candidate) lower bound of the
reference's probe loop; ``member_batch_kernel`` is the dense layout's
membership built on it, the counterpart of the reference's
``member_batch_tpu``.  ``dense_probe_window`` is the dense serving step's
whole probe loop of a window in one launch (every term's anchor search and
row compare, the AND of the terms).  ``anchor_probe`` is the public op over
one whole sorted array (searchsorted-right and an exact-hit flag), on two
routes picked from the array's length (``anchor_probe_route``).  On a CUDA
tensor each wrapper launches its kernel of ``csrc/anchor_intersect.cu`` (or
raises); on a CPU tensor it runs the plain PyTorch version of the same
function (``anchor_probe_sliced_torch``, ``dense_probe_window_torch``,
``anchor_probe_torch``).
"""

from __future__ import annotations

import torch

from ...core.anchors import lower_bound_sliced, rows_contain
from .. import cuda_build
from ..fused_decode.ops import INT32_MAX, MAX_WINDOW_TERMS, _check_on, _list_slices

#: anchor_probe's routes by the code the launch function takes
ROUTE_CODES = {"bisect": 0, "lift": 1}
#: the most anchors the lift route takes (4 MB of int32: the array stays in
#: the 50 MB L2); past it the bisection
LIFT_MAX_ANCHORS = 1 << 20


def anchor_probe_sliced_torch(queries: torch.Tensor, lo: torch.Tensor,
                              hi: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a batched bounded binary search (32 steps at
    most) over each query's ``[lo, hi)`` slice of ``anchors``."""
    return lower_bound_sliced(anchors, lo, hi, queries)


def anchor_probe_sliced(queries: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                        anchors: torch.Tensor) -> torch.Tensor:
    """Lower bound of each query within its [lo, hi) anchor slice.

    queries/lo/hi (NQ,) int32, anchors (NA,) int32, strictly increasing
    inside every slice.  Returns l (NQ,) int32: first j in [lo, hi) with
    anchors[j] >= q (hi if none, lo for an empty slice).  ``0 <= lo`` and
    ``hi <= NA`` are the caller's to guarantee (list slices do).
    """
    if not queries.is_cuda:
        return anchor_probe_sliced_torch(queries, lo, hi, anchors)
    for name, t in (("queries", queries), ("lo", lo), ("hi", hi), ("anchors", anchors)):
        cuda_build.require_int32(name, t)
        if t.device != queries.device:
            raise ValueError(f"{name} lies on {t.device}, queries on {queries.device}")
    nq = queries.shape[0]
    if lo.shape[0] != nq or hi.shape[0] != nq:
        raise ValueError(f"queries/lo/hi lengths differ: {nq}, {lo.shape[0]}, {hi.shape[0]}")
    out = torch.empty(nq, dtype=torch.int32, device=queries.device)
    if nq == 0:
        return out
    lib = cuda_build.load()
    with torch.cuda.device(queries.device):
        code = lib.anchor_probe_sliced_launch(
            queries.data_ptr(), lo.data_ptr(), hi.data_ptr(), anchors.data_ptr(),
            out.data_ptr(), nq, cuda_build.stream_ptr())
    cuda_build.check(code, "anchor_probe_sliced")
    anchor_probe_sliced.launches += 1
    return out


#: kernel launches made by the wrapper (never raised by the plain version)
anchor_probe_sliced.launches = 0


def member_batch_kernel(anchors: torch.Tensor, c_offsets: torch.Tensor,
                        expand: torch.Tensor, expand_valid: torch.Tensor,
                        list_ids: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Kernel-backed drop-in for ``core.anchors.member_batch`` (the
    reference's ``member_batch_tpu``): the anchor lower bound runs in the
    CUDA kernel, the ``expand[j] == target`` row compare stays plain tensor
    code.  No serving step calls it: the dense kernel step runs the whole
    probe loop as :func:`dense_probe_window`."""
    targets = (values.to(torch.int32) + 1).contiguous()
    ids = list_ids.long()
    lo = c_offsets[ids]
    hi = c_offsets[ids + 1]
    n = anchors.shape[0]
    if n == 0:
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    l = anchor_probe_sliced(targets, lo, hi, anchors)
    j = torch.maximum(l - 1, lo).clamp(max=n - 1)
    return rows_contain(expand, expand_valid, j, targets) & (lo < hi)


# ----------------------------------------------------------------------
# the dense serving step's probe loop, one launch a window
# ----------------------------------------------------------------------
def dense_probe_window_torch(cand_vals, cand_valid, query_terms, query_lens, c_offsets,
                             anchors, expand, expand_valid, phrase: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`dense_probe_window`: term by term,
    the covering entry from :func:`lower_bound_sliced`, then membership by
    comparing every lane of its row (:func:`rows_contain`) — the function
    of ``serving.engine._probe_terms`` with the dense member, clamped as the
    kernel clamps (list ids to the offsets table, entries to the table), and
    without the kernel's bisection inside the row."""
    b, nc = cand_vals.shape
    n = anchors.shape[0]
    match = cand_valid.clone()
    for t in range(1, query_terms.shape[1]):
        active = (t < query_lens)[:, None]
        if phrase:
            safe = cand_vals <= INT32_MAX - 1 - t
            targets = torch.where(safe, cand_vals, torch.zeros_like(cand_vals)) + t
        else:
            safe, targets = None, cand_vals
        targets = targets.reshape(-1)
        if n == 0:
            hit = torch.zeros(b * nc, dtype=torch.bool, device=cand_vals.device)
        else:
            lo, hi = (x.repeat_interleave(nc) for x in _list_slices(c_offsets, query_terms[:, t]))
            l = lower_bound_sliced(anchors, lo, hi, targets)
            j = torch.maximum(l - 1, lo).clamp(0, n - 1)
            hit = rows_contain(expand, expand_valid, j, targets) & (lo < hi)
        hit = hit.reshape(b, nc)
        if safe is not None:
            hit = hit & safe
        match = match & (hit | ~active)
    return match


def _check_dense_table(c_offsets, anchors, expand, expand_valid) -> None:
    """The dense table a window kernel reads: 1-D contiguous int32 offsets
    (non-empty) and anchors, an (n_entries, expand_len) contiguous int32
    expand table and a bool one of the same shape, all on one CUDA device."""
    cuda_build.require_cuda("anchors", anchors)
    for name, t in (("c_offsets", c_offsets), ("anchors", anchors)):
        cuda_build.require_int32(name, t)
        _check_on(name, t, anchors.device)
    if c_offsets.shape[0] == 0:
        raise ValueError("c_offsets is empty (it holds n_lists + 1 offsets)")
    cuda_build.require_int32("expand", expand, 2)
    _check_on("expand", expand, anchors.device, anchors.shape[0])
    if (expand_valid.dtype != torch.bool or expand_valid.shape != expand.shape
            or not expand_valid.is_contiguous() or expand_valid.device != anchors.device):
        raise ValueError(f"expand_valid: expected a contiguous bool tensor of shape "
                         f"{tuple(expand.shape)} on {anchors.device}, got {expand_valid.dtype} "
                         f"{tuple(expand_valid.shape)} on {expand_valid.device}")


def dense_probe_window(cand_vals, cand_valid, query_terms, query_lens, c_offsets, anchors,
                       expand, expand_valid, phrase: bool) -> torch.Tensor:
    """The dense step's whole probe loop in one launch: (B, C) bool, True
    where candidate ``cand_vals[b, c]`` (cumulative-gap space) is valid and
    every active term ``t = 1 .. min(query_lens[b], W) - 1`` of
    ``query_terms[b]`` holds it (AND) or holds it + t (phrase; a candidate
    whose shift would pass 2^31 - 2 matches nothing) — exactly
    ``serving.engine._probe_terms`` with the dense member.  ``query_terms``
    (B, W) may have a row stride.

    Precondition (holds for every table ``AnchoredIndex`` builds, and for
    the partitioned server's padded stacks): each list's anchor slice is
    strictly increasing, and in every row of ``expand`` the lanes that
    ``expand_valid`` marks are a prefix whose values strictly increase as
    signed int32.  The kernel bisects the anchor slice for the covering
    entry and then that entry's row (``valid and < target`` holds on a
    prefix of its lanes), so a table that breaks it gets undefined answers;
    the plain version compares every lane and does not need it."""
    if cand_vals.device.type == "cpu":
        return dense_probe_window_torch(cand_vals, cand_valid, query_terms, query_lens,
                                        c_offsets, anchors, expand, expand_valid, phrase)
    _check_dense_table(c_offsets, anchors, expand, expand_valid)
    dev = anchors.device
    cuda_build.require_int32("cand_vals", cand_vals, 2)
    _check_on("cand_vals", cand_vals, dev)
    b, nc = cand_vals.shape
    if (cand_valid.dtype != torch.bool or cand_valid.shape != cand_vals.shape
            or not cand_valid.is_contiguous() or cand_valid.device != dev):
        raise ValueError(f"cand_valid: expected a contiguous bool tensor of shape {(b, nc)} "
                         f"on {dev}, got {cand_valid.dtype} {tuple(cand_valid.shape)} "
                         f"on {cand_valid.device}")
    cuda_build.require_int32("query_terms", query_terms, 2, row_stride=True)
    _check_on("query_terms", query_terms, dev, b)
    cuda_build.require_int32("query_lens", query_lens)
    _check_on("query_lens", query_lens, dev, b)
    w = query_terms.shape[1]
    if w > MAX_WINDOW_TERMS:
        raise ValueError(f"dense_probe_window takes at most {MAX_WINDOW_TERMS} terms a query, "
                         f"got {w}")
    hit = torch.empty((b, nc), dtype=torch.bool, device=dev)
    if b == 0 or nc == 0:
        return hit
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        code = lib.dense_probe_window_launch(
            cand_vals.data_ptr(), cand_valid.data_ptr(), nc, query_terms.data_ptr(),
            query_terms.stride(0), w, query_lens.data_ptr(), c_offsets.data_ptr(),
            c_offsets.shape[0], anchors.data_ptr(), anchors.shape[0], expand.data_ptr(),
            expand_valid.data_ptr(), expand.shape[1], int(bool(phrase)), hit.data_ptr(), b,
            cuda_build.stream_ptr())
    cuda_build.check(code, "dense_probe_window")
    dense_probe_window.launches += 1
    return hit


#: kernel launches made by the wrapper (never raised by the plain version)
dense_probe_window.launches = 0


def anchor_probe_torch(queries: torch.Tensor, anchors: torch.Tensor):
    """Plain PyTorch version of :func:`anchor_probe`: ``torch.searchsorted``
    (right) and the ``found`` gather, both returned as int32."""
    q = queries.to(torch.int32)
    a = anchors.to(torch.int32)
    if a.shape[0] == 0:
        zero = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
        return zero, zero.clone()
    idx = torch.searchsorted(a, q, right=True)
    found = (idx > 0) & (a[(idx - 1).clamp_(min=0)] == q)
    return idx.to(torch.int32), found.to(torch.int32)


def anchor_probe_route(anchors: torch.Tensor) -> str:
    """``"lift"`` (two queries a thread, binary lifting) for at most
    ``LIFT_MAX_ANCHORS`` anchors, else ``"bisect"`` (one query a thread)."""
    return "lift" if anchors.shape[0] <= LIFT_MAX_ANCHORS else "bisect"


def anchor_probe(queries: torch.Tensor, anchors: torch.Tensor):
    """Searchsorted-right over one sorted anchor array.

    queries (NQ,) int32 in any order, anchors (NA,) int32 sorted
    non-decreasingly (duplicates allowed).  Returns ``(idx, found)``, both
    (NQ,) int32: ``idx[i]`` counts the anchors ``<= queries[i]``,
    ``found[i]`` is 1 where some anchor equals ``queries[i]``.  Both routes
    search (``lift``: binary lifting, two queries a thread; ``bisect``: a
    bisection, one query a thread), so unsorted anchors give undefined
    answers; the sort is the caller's to guarantee and is not checked.
    Queries are expected below ``2^31 - 1``, as in the reference.
    """
    if queries.device.type == "cpu":
        return anchor_probe_torch(queries, anchors)
    cuda_build.require_cuda("queries", queries)
    for name, t in (("queries", queries), ("anchors", anchors)):
        cuda_build.require_int32(name, t)
        if t.device != queries.device:
            raise ValueError(f"{name} lies on {t.device}, queries on {queries.device}")
    nq, na = queries.shape[0], anchors.shape[0]
    idx = torch.empty(nq, dtype=torch.int32, device=queries.device)
    found = torch.empty(nq, dtype=torch.int32, device=queries.device)
    if nq == 0:
        return idx, found
    route = anchor_probe_route(anchors)
    lib = cuda_build.load()
    with torch.cuda.device(queries.device):
        code = lib.anchor_probe_launch(queries.data_ptr(), anchors.data_ptr(),
                                       idx.data_ptr(), found.data_ptr(), nq, na,
                                       ROUTE_CODES[route], cuda_build.stream_ptr())
    cuda_build.check(code, "anchor_probe")
    anchor_probe.launches += 1
    anchor_probe.launches_by_route[route] += 1
    return idx, found


#: kernel launches made by the wrapper (never raised by the plain version),
#: in all and by route
anchor_probe.launches = 0
anchor_probe.launches_by_route = dict.fromkeys(ROUTE_CODES, 0)
