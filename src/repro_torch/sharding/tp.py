"""Collectives that autograd sees, and the groups of a mesh that split an
LM's compute (the port's own; the reference leaves both to GSPMD).

Each collective is a ``torch.autograd.Function`` whose backward is the
transpose of its forward, for a loss that is the sum of every rank's own
loss (each rank runs ``backward`` on its own part):

* :func:`gather` — all-gather along a dimension; backward reduce-scatters
  the gradient along it (every rank's copy fed some rank's loss);
* :func:`scatter` — reduce-scatter (sum) along a dimension; backward
  all-gathers the gradient;
* :func:`all_reduce` — sum over a group; backward sums the gradient over it;
* :func:`sum_partials` — sum over a group whose ranks then compute the same
  thing (the model ranks of a recsys data slice, each holding a partial
  lookup of its table shard); backward passes the gradient through
  unchanged, since each rank's copy of the downstream loss is the whole;
* :func:`fetch` — one weight's operand from the rank's shard of it: gathered
  along each dimension the plan names (the per-layer FSDP gather over
  ``"data"``, a gather over ``"model"`` where the rank's compute needs more
  than its shard); the backward reduce-scatters the float32 gradient over
  the same groups, in the reverse order, and adds it into the rank's float32
  gradient shard (``sink``) instead of handing it to autograd, so that a
  bf16 model's gradients are summed across layers, ranks and micro-batches
  in float32 (autograd would cast them back to the weight's dtype).

Outside autograd (serving): :func:`fetch_nograd` (a weight's gathers
without a gradient sink), :func:`gather_nograd` / :func:`scatter_nograd`,
:func:`max_into` / :func:`sum_into` (in-place all-reduces) and
:func:`all_to_all` (the prefill's cache from heads to T).

A group of one rank is the identity: no collective is issued, so a world of
one computes what the unsharded step computes, bit for bit.  The
collectives are ``torch.ops._c10d_functional``'s (gloo on the CPU, NCCL on
the card; on the ``fake`` backend with ``meta`` tensors they move nothing,
which is how the dry-run counts them).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_ops = None


def _c10d():
    global _ops
    if _ops is None:
        _ops = torch.ops._c10d_functional
    return _ops


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _gather_raw(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    ops = _c10d()
    out = ops.wait_tensor(ops.all_gather_into_tensor(x.contiguous(), n, group.group_name))
    if dim == 0:
        return out
    # (n * a, ...) rank-major -> concatenated along ``dim``
    return torch.cat(out.chunk(n, dim=0), dim=dim)


def _scatter_raw(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split into {n}")
    ops = _c10d()
    if dim != 0:
        x = torch.cat(x.chunk(n, dim=dim), dim=0)
    return ops.wait_tensor(ops.reduce_scatter_tensor(x.contiguous(), "sum", n, group.group_name))


def _all_reduce_raw(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    ops = _c10d()
    return ops.wait_tensor(ops.all_reduce(x.contiguous(), "sum", group.group_name))


def max_into(x: torch.Tensor, groups) -> torch.Tensor:
    """``x``'s elementwise maximum over each group in turn, outside autograd,
    in place."""
    for g in groups:
        if group_size(g) > 1:
            ops = _c10d()
            x.copy_(ops.wait_tensor(ops.all_reduce(x.contiguous(), "max", g.group_name)))
    return x


def all_to_all(x: torch.Tensor, out_splits: list[int], in_splits: list[int],
               group) -> torch.Tensor:
    """All-to-all of the flat ``x`` over ``group``, outside autograd: rank
    j receives the ``in_splits[j]`` elements of ``x`` that follow the
    pieces for ranks before it, and the result holds, in rank order, the
    ``out_splits[s]`` elements that rank s sent here."""
    if group_size(group) == 1:
        return x
    ops = _c10d()
    return ops.wait_tensor(ops.all_to_all_single(x.contiguous(), list(out_splits),
                                                 list(in_splits), group.group_name))


def fetch_nograd(shard: torch.Tensor, gathers: tuple = ()) -> torch.Tensor:
    """A weight's operand from the rank's shard, gathered along ``(dim,
    group)`` of ``gathers`` in order, outside autograd (serving)."""
    w = shard
    for dim, group in gathers:
        w = _gather_raw(w, dim, group)
    return w


def gather_nograd(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` outside autograd (integer tensors)."""
    return _gather_raw(x, dim, group)


def scatter_nograd(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Reduce-scatter (sum) along ``dim`` outside autograd."""
    return _scatter_raw(x, dim, group)


def sum_into(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed over each group in turn, outside autograd, in place."""
    for g in groups:
        if group_size(g) > 1:
            x.copy_(_all_reduce_raw(x, g))
    return x


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_raw(g, ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g, ctx.group), None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group``; the backward is the identity (module
    docstring)."""
    return x if group_size(group) == 1 else _SumPartials.apply(x, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``group`` (rank order)."""
    return x if group_size(group) == 1 else _Gather.apply(x, dim, group)


def scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` and keep this rank's slice along ``dim``."""
    return x if group_size(group) == 1 else _Scatter.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group``."""
    return x if group_size(group) == 1 else _AllReduce.apply(x, group)


def shard_grad(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """A gathered weight's float32 gradient summed over ``group`` and cut to
    this rank's shard along ``dim`` (the backward of a weight's gather)."""
    return _scatter_raw(g, dim, group)


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, shard, sink, gathers):
        ctx.sink, ctx.gathers = sink, gathers
        w = shard
        for dim, group in gathers:
            w = _gather_raw(w, dim, group)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.float()
        for dim, group in reversed(ctx.gathers):
            g = shard_grad(g, dim, group)
        ctx.sink.add_(g)
        return None, None, None, None


def fetch(anchor: torch.Tensor, shard: torch.Tensor, sink: torch.Tensor,
          gathers: tuple = ()) -> torch.Tensor:
    """The operand that a rank computes with, from its ``shard`` of a
    weight: gathered along ``(dim, group)`` of ``gathers`` in order; its
    gradient goes into ``sink`` (float32, ``shard``'s shape) as described in
    the module docstring.  ``anchor`` is a tensor that requires grad, so that
    autograd reaches the backward; it receives nothing."""
    return _Fetch.apply(anchor, shard, sink, tuple(gathers))
