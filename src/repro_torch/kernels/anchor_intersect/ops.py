"""Batched membership probes against anchor arrays.

``anchor_probe_sliced`` is the per-(term, candidate) lower bound of the serve
step's probe loop; ``member_batch_kernel`` is the dense layout's membership
built on it.  On a CUDA tensor the wrapper launches the kernel of
``csrc/anchor_intersect.cu`` (or raises); on a CPU tensor it runs
``anchor_probe_sliced_torch``, the plain PyTorch version of the same
function.
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
