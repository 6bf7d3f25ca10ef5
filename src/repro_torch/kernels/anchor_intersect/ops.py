"""Batched membership probes against anchor arrays.

``anchor_probe_sliced`` is the per-(term, candidate) lower bound of the serve
step's probe loop; ``member_batch_kernel`` is the dense layout's membership
built on it.  ``anchor_probe`` is the public op over one whole sorted array
(searchsorted-right and an exact-hit flag).  On a CUDA tensor each wrapper
launches its kernel of ``csrc/anchor_intersect.cu`` (or raises); on a CPU
tensor it runs the plain PyTorch version of the same function
(``anchor_probe_sliced_torch``, ``anchor_probe_torch``).
"""

from __future__ import annotations

import torch

from ...core.anchors import lower_bound_sliced, rows_contain
from .. import cuda_build


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
    """Kernel-backed drop-in for ``core.anchors.member_batch``: the anchor
    lower bound runs in the CUDA kernel, the ``expand[j] == target`` row
    compare stays plain tensor code."""
    targets = (values.to(torch.int32) + 1).contiguous()
    ids = list_ids.long()
    lo = c_offsets[ids]
    hi = c_offsets[ids + 1]
    if anchors.shape[0] == 0:
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    l = anchor_probe_sliced(targets, lo, hi, anchors)
    j = torch.maximum(l - 1, lo)
    return rows_contain(expand, expand_valid, j, targets) & (lo < hi)


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


def anchor_probe(queries: torch.Tensor, anchors: torch.Tensor):
    """Searchsorted-right over one sorted anchor array.

    queries (NQ,) int32, anchors (NA,) int32 sorted non-decreasingly
    (duplicates allowed).  Returns ``(idx, found)``, both (NQ,) int32:
    ``idx[i]`` counts the anchors ``<= queries[i]``, ``found[i]`` is 1 where
    some anchor equals ``queries[i]``.  The kernel bisects, so unsorted
    anchors give undefined answers; the sort is the caller's to guarantee
    and is not checked.  Queries are expected below ``2^31 - 1``, as in the
    reference.
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
    lib = cuda_build.load()
    with torch.cuda.device(queries.device):
        code = lib.anchor_probe_launch(queries.data_ptr(), anchors.data_ptr(),
                                       idx.data_ptr(), found.data_ptr(), nq, na,
                                       cuda_build.stream_ptr())
    cuda_build.check(code, "anchor_probe")
    anchor_probe.launches += 1
    return idx, found


#: kernel launches made by the wrapper (never raised by the plain version)
anchor_probe.launches = 0
