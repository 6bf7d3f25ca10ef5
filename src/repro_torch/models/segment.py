"""Ordered scatter-adds: sums of rows by id whose float32 adds follow a
fixed order, so that the same inputs give the same bits on the CPU and on a
card (``index_add_`` / ``scatter_add_`` on CUDA add with atomics in
whatever order the threads arrive).

:func:`ordered_segment_sum` sorts the rows stably by id and sums each run
of one id by a segmented doubling scan: round r adds to each row the row
2^r before it when both hold the same id.  Each row of the result is
therefore a fixed tree of float32 adds over its rows in their original
order; every operation is a gather, a compare or one elementwise add, which
round the same way on any device.  ``log2(n)`` rounds, no host wait.

:class:`SegmentSum` and :class:`GatherRows` are the two halves of a
message-passing step under autograd, each the other's backward: the sum by
``dst`` (backward: a gather) and the gather by ``src`` (backward: an
ordered sum by ``src``).  The training path's table gradients
(``kernels.embedding_bag.ops.EmbeddingBag``) and the GIN's aggregation
(``models.gnn``) go through them.
"""

from __future__ import annotations

import torch


def ordered_segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``out[r] = sum of values[i] over i with ids[i] == r`` (out (n, ...)),
    in ``values``' dtype, by the fixed order above; ids outside ``[0, n)``
    are dropped."""
    ids = ids.reshape(-1).long()
    if ids.numel() != values.shape[0]:
        raise ValueError(f"{ids.numel()} ids for {values.shape[0]} rows")
    out_shape = (n, *values.shape[1:])
    if ids.numel() == 0:
        return values.new_zeros(out_shape)
    # ids outside [0, n) go to a scratch row n, which is cut off
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    order = torch.argsort(ids, stable=True)
    rows = ids[order]
    c = values[order]
    step = 1
    while step < rows.numel():
        same = (rows[step:] == rows[:-step]).reshape(-1, *([1] * (c.dim() - 1)))
        c = torch.cat([c[:step], torch.where(same, c[step:] + c[:-step], c[step:])])
        step *= 2
    # the last row of each run holds its sum; every other row writes to the
    # scratch row n + 1 (no boolean mask: that would wait for the device)
    last = torch.ones_like(rows, dtype=torch.bool)
    last[:-1] = rows[1:] != rows[:-1]
    out = values.new_zeros((n + 2, *values.shape[1:]))
    out[torch.where(last, rows, n + 1)] = c
    return out[:n]


class SegmentSum(torch.autograd.Function):
    """``SegmentSum.apply(values, ids, n)``: :func:`ordered_segment_sum`;
    its backward gathers the output gradient by ``ids``."""

    @staticmethod
    def forward(ctx, values, ids, n: int):
        ctx.save_for_backward(ids)
        return ordered_segment_sum(values, ids, n)

    @staticmethod
    def backward(ctx, dout):
        ids, = ctx.saved_tensors
        return dout[ids.long()], None, None


class GatherRows(torch.autograd.Function):
    """``GatherRows.apply(table, ids)`` = ``table[ids]``; its backward sums
    the row gradients into the table by :func:`ordered_segment_sum`."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n = table.shape[0]
        return table[ids.long()]

    @staticmethod
    def backward(ctx, dout):
        ids, = ctx.saved_tensors
        return ordered_segment_sum(dout, ids, ctx.n), None
