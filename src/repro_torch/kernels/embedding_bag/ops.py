"""EmbeddingBag: ``out[b] = sum_{s < bag} table[indices[b * bag + s]]``, in
float32, for a table of any float dtype.

On a CUDA tensor ``embedding_bag`` launches ``csrc/embedding_bag.cu`` (or
raises), by the load route :func:`embedding_bag_route` picks from the
table's dtype, width, row stride and alignment before the launch:
``vec16`` (16 bytes a load), ``vec8`` (8) or ``scalar`` (one element).  On a
CPU tensor it runs ``embedding_bag_torch``, the plain PyTorch version of the
same function.  Both sum each bag from 0 in the order of its
indices, one float32 add at a time, so they agree bit for bit.  A row
outside ``[0, V)`` is never read: its bag comes out NaN, as the reference's
``jnp.take`` fills such rows with NaN (callers that want an error check
their indices first, as ``models.recsys`` does).  Unlike the reference's
op, the table is not padded to 128 columns.

Shard mode (``row_start``, ``n_rows``): ``table`` holds rows ``[row_start,
row_start + V)`` of a table of ``n_rows`` rows, as a rank holds its shard of
a table row-sharded over a mesh axis (``sharding.recsys_split``).  An id in
the shard reads its row; an id in ``[0, n_rows)`` outside the shard adds
exactly 0.0 and is never read; an id outside ``[0, n_rows)`` makes its bag
NaN on every shard.  The defaults (``row_start=0``, ``n_rows=V``) are the
whole table, bit for bit as before.  A call that passes ``n_rows`` or a
non-zero ``row_start`` is a shard-mode launch (``launches_shard``).

Training goes through :class:`EmbeddingBag`: its forward is the kernel (or
whatever lookup the caller passes), its backward
:func:`embedding_bag_backward`, the table gradient summed by
``models.segment.ordered_segment_sum`` (a fixed order of float32 adds, the
same bits on the CPU and the card: no float atomics).
"""

from __future__ import annotations

import torch

from ...models.segment import ordered_segment_sum
from .. import cuda_build


def _flat(indices: torch.Tensor, table: torch.Tensor, bag_size: int):
    """(flat indices, n_bags, bag) from the reference op's two forms:
    (n_bags, bag) indices, or flat indices with ``bag_size``."""
    if indices.is_floating_point() or indices.is_complex() or indices.dtype == torch.bool:
        raise TypeError(f"indices: expected an integer tensor, got {indices.dtype}")
    if table.dim() != 2:
        raise ValueError(f"table: expected (V, D), got shape {tuple(table.shape)}")
    if indices.dim() == 2:
        return indices.reshape(-1), indices.shape[0], indices.shape[1]
    if indices.dim() != 1:
        raise ValueError(f"indices: expected 1 or 2 dimensions, got {tuple(indices.shape)}")
    if bag_size < 1 or indices.shape[0] % bag_size:
        raise ValueError(f"{indices.shape[0]} indices do not make bags of {bag_size}")
    return indices, indices.shape[0] // bag_size, bag_size


def _shard(table: torch.Tensor, row_start: int, n_rows: int | None) -> int:
    """The whole table's row count, once the shard ``[row_start, row_start +
    V)`` is checked to lie inside it."""
    v = table.shape[0]
    n = v if n_rows is None else int(n_rows)
    if row_start < 0 or row_start + v > n:
        raise ValueError(f"a shard of {v} rows at row {row_start} does not lie inside a table "
                         f"of {n} rows")
    return n


def embedding_bag_torch(indices: torch.Tensor, table: torch.Tensor, bag_size: int = 1,
                        row_start: int = 0, n_rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`embedding_bag`: the bag's rows
    gathered at once, then added to a float32 zero one position at a time
    (another shard's row as 0.0, an id outside the table as NaN)."""
    idx, n_bags, bag = _flat(indices, table, bag_size)
    n = _shard(table, row_start, n_rows)
    v, d = table.shape
    idx = idx.long().reshape(n_bags, bag)
    live = (idx >= 0) & (idx < n)
    local = idx - row_start
    inside = live & (local >= 0) & (local < v)
    safe = table if v else table.new_zeros((1, d))
    rows = safe[torch.where(inside, local, 0)]
    out = torch.zeros((n_bags, d), dtype=torch.float32, device=table.device)
    nan = torch.tensor(float("nan"), device=table.device)
    zero = torch.tensor(0.0, device=table.device)
    for s in range(bag):
        fill = torch.where(live[:, s, None], zero, nan)
        out = out + torch.where(inside[:, s, None], rows[:, s].float(), fill)
    return out


#: the kernel's load routes and the codes its launch function takes
ROUTE_CODES = {"scalar": 0, "vec8": 1, "vec16": 2}


def embedding_bag_route(table: torch.Tensor) -> str:
    """The load route of a launch on ``table`` (V, D): ``"vec16"`` when a
    row's D elements, the row stride and the table's first element are all
    whole 16-byte words, else ``"vec8"`` when they are whole 8-byte words,
    else ``"scalar"`` (an odd float32 D, a bf16 D not a multiple of 4, a
    view one element in, ``linear[:, None]``)."""
    size = table.element_size()
    spans = (table.shape[1] * size, table.stride(0) * size, table.data_ptr())
    for width, route in ((16, "vec16"), (8, "vec8")):
        if all(x % width == 0 for x in spans):
            return route
    return "scalar"


def embedding_bag(indices: torch.Tensor, table: torch.Tensor, bag_size: int = 1,
                  row_start: int = 0, n_rows: int | None = None) -> torch.Tensor:
    """indices (n_bags, bag) — or flat, with ``bag_size`` — of any integer
    dtype (cast to int32, as the reference's op does); table (V, D) ->
    (n_bags, D) float32 bag sums; ``row_start`` / ``n_rows``: the shard mode
    (module docstring).

    The kernel takes a float32 or bfloat16 table whose columns are
    contiguous (its rows may lie any stride apart: ``linear[:, None]`` is
    read in place) and indices on the table's device.  It has no backward:
    a call that would need one is refused.  A shard that does not lie
    inside ``[0, n_rows)`` is refused before the launch.
    """
    if table.device.type == "cpu":
        return embedding_bag_torch(indices, table, bag_size, row_start, n_rows)
    cuda_build.require_cuda("table", table)
    dtype = cuda_build.require_float("table", table, 2)
    idx, n_bags, bag = _flat(indices, table, bag_size)
    if idx.device != table.device:
        raise ValueError(f"indices lie on {idx.device}, the table on {table.device}")
    cuda_build.require_no_grad("embedding_bag", table)
    n = _shard(table, row_start, n_rows)
    shard = n_rows is not None or row_start != 0
    idx = idx.to(torch.int32).contiguous()
    v, d = table.shape
    out = torch.empty((n_bags, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    route = embedding_bag_route(table)
    lib = cuda_build.load()
    with torch.cuda.device(table.device):
        code = lib.embedding_bag_launch(idx.data_ptr(), table.data_ptr(), out.data_ptr(),
                                        n_bags, bag, d, v, table.stride(0), row_start, n,
                                        dtype, ROUTE_CODES[route], cuda_build.stream_ptr())
    cuda_build.check(code, f"embedding_bag ({route})")
    embedding_bag.launches += 1
    embedding_bag.launches_by_route[route] += 1
    if shard:
        embedding_bag.launches_shard[route] += 1
    return out


#: kernel launches made by the wrapper, in all, by load route, and those of
#: the shard mode by load route (never raised by the plain version)
embedding_bag.launches = 0
embedding_bag.launches_by_route = dict.fromkeys(ROUTE_CODES, 0)
embedding_bag.launches_shard = dict.fromkeys(ROUTE_CODES, 0)


def embedding_bag_backward(indices: torch.Tensor, dout: torch.Tensor, n_rows: int,
                           bag_size: int = 1) -> torch.Tensor:
    """The table gradient (n_rows, D) float32 of ``embedding_bag(indices,
    table, bag_size)`` for the output gradient ``dout`` (n_bags, D): row r
    sums ``dout[j // bag]`` over the flat positions j with ``indices[j] ==
    r``, by :func:`~repro_torch.models.segment.ordered_segment_sum`; ids
    outside ``[0, n_rows)`` add nothing."""
    idx = indices.reshape(-1)
    bag = indices.shape[1] if indices.dim() == 2 else bag_size
    per_index = dout.float()[torch.arange(idx.numel(), device=dout.device) // bag]
    return ordered_segment_sum(per_index, idx, n_rows)


class EmbeddingBag(torch.autograd.Function):
    """``EmbeddingBag.apply(indices, table, bag_size, lookup, row_start,
    n_rows)``: ``lookup(indices, table, bag_size, row_start, n_rows)``
    (default :func:`embedding_bag`: the kernel on CUDA) as the forward,
    float32 (n_bags, D);
    the table gradient by :func:`embedding_bag_backward`, in the table's
    dtype: for a shard, into its own rows only (the ids shifted by
    ``row_start``, those outside the shard dropped)."""

    @staticmethod
    def forward(ctx, indices, table, bag_size: int = 1, lookup=None, row_start: int = 0,
                n_rows: int | None = None):
        ctx.save_for_backward(indices)
        ctx.n_rows, ctx.bag, ctx.dtype = table.shape[0], bag_size, table.dtype
        ctx.row_start = row_start
        return (lookup or embedding_bag)(indices, table, bag_size, row_start, n_rows)

    @staticmethod
    def backward(ctx, dout):
        indices, = ctx.saved_tensors
        if ctx.row_start:
            indices = indices.long() - ctx.row_start
        grad = embedding_bag_backward(indices, dout, ctx.n_rows, ctx.bag)
        return None, grad.to(ctx.dtype), None, None, None, None
