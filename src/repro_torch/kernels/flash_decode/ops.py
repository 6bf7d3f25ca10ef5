"""One-token GQA attention over a KV cache in model layout: q (B, 1, H, hd),
caches (B, S, K, hd), row ``b`` attending to the cache rows
``[0, positions[b]]``.

On a CUDA tensor ``flash_decode`` launches ``csrc/flash_decode.cu`` (or
raises): a split pass over (B*K, n_splits) cache chunks, planned by
:func:`flash_decode_plan` from the shapes and the card's SM count, then a
combine pass that writes q's dtype.  The split pass reads the caches by the
route :func:`flash_decode_route` picks before the launch: ``vec16`` (16-byte
copies) or ``scalar`` (element loads).  On a CPU tensor it runs
``flash_decode_torch``, the plain PyTorch version of the same function.  Both
follow the TPU kernel: q and the cache are cast to float32 each on its own
(an f32 model's q meets a bf16 cache), q is then scaled by ``1/sqrt(hd)``,
masked scores take the sentinel ``NEG_INF`` and their probabilities 0, and
the float32 result ``acc / max(l, 1e-30)`` is rounded to q's dtype.

``flash_decode_split_torch`` repeats the split and combine arithmetic in
plain PyTorch; tests and ``chip_smoke.py`` hold it against the reference,
the model never calls it.

``flash_decode_partial`` is the same two launches on one rank's slice
``[start, start + S)`` of a cache split over T (the decode on a mesh,
``repro_torch.sharding.decode_split``): row ``b`` sees the slice's rows
``s`` with ``start + s <= positions[b]``, and the call returns the slice's
partial ``(o, lse)`` in float32 — ``o`` normalised over the slice's live
rows, ``lse`` the natural log of the sum of their ``e^score`` (scores
scaled by ``1/sqrt(hd)``), ``NEG_INF`` with ``o = 0`` where the slice has
none — so that the ranks' partials combine with one rounding at the end.
``flash_decode_partial_torch`` is its plain version.
"""

from __future__ import annotations

import math

import torch

from ...models.flash import NEG_INF
from .. import cuda_build
from ..flash_attention.ops import HEAD_DIMS
#: most query heads per KV head the kernel holds (``kMaxGroup`` of the source)
MAX_GROUP = 16
#: the split pass's load routes and the codes its launch function takes
ROUTE_CODES = {"scalar": 0, "vec16": 1}
#: chunks of the cache axis are whole multiples of this many rows
SPLIT_GRANULE = 64
#: split-pass blocks the planner aims at per SM: one wave (a block streams
#: its chunk through a ring, so a few long blocks beat many short ones)
BLOCKS_PER_SM = 2
#: most splits the combine pass takes (``kMaxSplits`` of the source)
MAX_SPLITS = 4096


def _check_shapes(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  positions: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4:
        raise ValueError(f"expected q (B, 1, H, hd) and caches (B, S, K, hd), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    b, _, h, hd = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != b
            or k_cache.shape[3] != hd):
        raise ValueError(f"caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if k_cache.shape[2] == 0 or h % k_cache.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of {k_cache.shape[2]} KV heads")
    if k_cache.shape[1] == 0:
        raise ValueError("an empty cache (S == 0)")
    if tuple(positions.shape) != (b,):
        raise ValueError(f"positions has shape {tuple(positions.shape)}, expected ({b},)")


def _live(positions: torch.Tensor, s: int) -> torch.Tensor:
    """(B, S) bool: cache row ``s`` is seen by row ``b`` (``s <= positions[b]``)."""
    return (torch.arange(s, device=positions.device)[None, :]
            < (positions.long() + 1)[:, None])


def flash_decode_torch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_decode`: one softmax over the
    whole (B, K, G, S) score tensor in float32."""
    _check_shapes(q, k_cache, v_cache, positions)
    b, _, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    qg = q[:, 0].float().reshape(b, kh, h // kh, hd) * (1.0 / math.sqrt(hd))
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    live = _live(positions, s)[:, None, None, :]
    scores = scores.masked_fill(~live, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)).masked_fill(~live, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float()) / l
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _partial_live(positions: torch.Tensor, s: int, start: int) -> torch.Tensor:
    """(B, S) bool: row ``s`` of the slice starting at ``start`` is seen by
    row ``b`` (``start + s <= positions[b]``)."""
    return ((torch.arange(s, device=positions.device) + start)[None, :]
            <= positions.long()[:, None])


def flash_decode_partial_torch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                               positions: torch.Tensor, start: int):
    """Plain PyTorch version of :func:`flash_decode_partial`: one softmax over
    the slice's (B, K, G, S) scores in float32; ``(o (B, 1, H, hd), lse (B,
    H))``, both float32."""
    _check_shapes(q, k_cache, v_cache, positions)
    if start < 0:
        raise ValueError(f"a slice cannot start at {start} < 0")
    b, _, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    qg = q[:, 0].float().reshape(b, kh, h // kh, hd) * (1.0 / math.sqrt(hd))
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    live = _partial_live(positions, s, start)[:, None, None, :]
    scores = scores.masked_fill(~live, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m).masked_fill(~live, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float()) / l.clamp(min=1e-30)
    lse = torch.where(l > 0, m + torch.log(l.clamp(min=1e-30)), torch.full_like(l, NEG_INF))
    return o.reshape(b, 1, h, hd), lse.reshape(b, h)


def flash_decode_split_torch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             positions: torch.Tensor, n_splits: int) -> torch.Tensor:
    """Plain PyTorch copy of the kernel's split and combine arithmetic, for
    tests and ``chip_smoke.py`` only: the cache axis cut into ``n_splits``
    chunks of ``ceil(S / n_splits)`` rows; per chunk the float32 partial
    ``m`` (the largest live score, ``NEG_INF`` where none is live), ``l`` and
    ``acc`` (sums of ``p = exp(score - m)`` and ``p v`` over its live rows);
    then ``M = max m``, ``out = sum e^(m - M) acc / max(sum e^(m - M) l,
    1e-30)`` in q's dtype.  A chunk with no live row adds nothing; a row with
    none at all is 0."""
    _check_shapes(q, k_cache, v_cache, positions)
    if n_splits < 1:
        raise ValueError(f"n_splits {n_splits} < 1")
    b, _, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    chunk = -(-s // n_splits)
    pad = chunk * n_splits - s
    qg = q[:, 0].float().reshape(b, kh, h // kh, hd) * (1.0 / math.sqrt(hd))
    k, v = (torch.nn.functional.pad(c.float(), (0, 0, 0, 0, 0, pad)) for c in (k_cache, v_cache))
    live = torch.nn.functional.pad(_live(positions, s), (0, pad)).reshape(
        b, 1, 1, n_splits, chunk)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k).reshape(b, kh, h // kh, n_splits, chunk)
    scores = scores.masked_fill(~live, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None]).masked_fill(~live, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgzc,bzckd->bkgzd", p, v.reshape(b, n_splits, chunk, kh, hd))
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    out = (w[..., None] * acc).sum(dim=-2) / (w * l).sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def flash_decode_plan(b: int, kh: int, s: int, sm_count: int) -> tuple[int, int]:
    """``(chunk, n_splits)`` of the split pass, from the batch, the KV heads,
    the cache capacity S and the card's SM count alone (never the positions,
    which lie on the card): about :data:`BLOCKS_PER_SM` blocks per SM over
    the ``B*K`` rows, chunks whole multiples of :data:`SPLIT_GRANULE` rows,
    and ``n_splits = ceil(S / chunk)``, so the chunks cover ``[0, S)`` and
    none starts at or past S."""
    if min(b, kh, s, sm_count) < 1:
        raise ValueError(f"no split plan for B {b}, K {kh}, S {s}, {sm_count} SMs")
    want = min(-(-BLOCKS_PER_SM * sm_count // (b * kh)), MAX_SPLITS)
    chunk = -(-(-(-s // want)) // SPLIT_GRANULE) * SPLIT_GRANULE
    return chunk, -(-s // chunk)


def _vec16_ready(t: torch.Tensor) -> bool:
    """16-byte copies read the cache in place: 16-byte aligned base, strides
    of whole 16-byte units (8 bf16, 4 f32) but the last, which is 1 (a
    dimension of size 1 has no stride to keep)."""
    unit = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[3] % unit == 0
            and (t.stride(3) == 1 or t.shape[3] == 1)
            and all(t.stride(i) % unit == 0 or t.shape[i] == 1 for i in range(3)))


def flash_decode_route(k_cache: torch.Tensor, v_cache: torch.Tensor) -> str:
    """The load route of a launch on these caches, from alignment and strides
    alone: ``"vec16"`` when both can be read by 16-byte copies, else
    ``"scalar"``."""
    return "vec16" if _vec16_ready(k_cache) and _vec16_ready(v_cache) else "scalar"


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_checks(q, k_cache, v_cache, positions) -> tuple[int, int]:
    """The kernel's refusals (dtypes, devices, shapes, head dims, group);
    ``(q dtype code, cache dtype code)``."""
    q_dtype = cuda_build.require_float("q", q, 4)
    kv_dtype = cuda_build.require_float("k_cache", k_cache, 4)
    if cuda_build.require_float("v_cache", v_cache, 4) != kv_dtype:
        raise TypeError(f"v_cache is {v_cache.dtype}, k_cache {k_cache.dtype}: the kernel "
                        f"takes one cache dtype")
    cuda_build.require_int32("positions", positions)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    _check_shapes(q, k_cache, v_cache, positions)
    h, hd, kh = q.shape[2], q.shape[3], k_cache.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel is built for {HEAD_DIMS}")
    if h // kh > MAX_GROUP:
        raise ValueError(f"{h // kh} query heads per KV head; the kernel holds at most "
                         f"{MAX_GROUP}")
    cuda_build.require_cuda("q", q)
    return q_dtype, kv_dtype


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, hd); caches (B, S, K, hd); positions (B,) int32, the
    current index (attends to ``[0, position]``; a position at or past S
    sees the whole cache).  Returns (B, 1, H, hd) in q's dtype.

    The kernel takes q in float32 or bfloat16 and the caches (k and v of one
    dtype) in float32 or bfloat16, independently; head dims
    :data:`HEAD_DIMS`, at most :data:`MAX_GROUP` query heads per KV head, and
    any strides whose last one is 1 (a layer's slice of the stacked cache is
    read in place).
    """
    if q.device.type == "cpu":
        return flash_decode_torch(q, k_cache, v_cache, positions)
    q_dtype, kv_dtype = _launch_checks(q, k_cache, v_cache, positions)
    b, _, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    if b == 0 or h == 0:
        return out
    chunk, n_splits = flash_decode_plan(b, kh, s, _sm_count(q.device))
    part = torch.empty(b * h * n_splits * (hd + 2), dtype=torch.float32, device=q.device)
    route = flash_decode_route(k_cache, v_cache)
    lib = cuda_build.load()
    with torch.cuda.device(q.device):
        code = lib.flash_decode_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), positions.data_ptr(),
            part.data_ptr(), out.data_ptr(), b, s, h, kh, hd, q_dtype, kv_dtype,
            1.0 / math.sqrt(hd), chunk, n_splits, ROUTE_CODES[route],
            q.stride(0), q.stride(2), k_cache.stride(0), k_cache.stride(1),
            k_cache.stride(2), v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            cuda_build.stream_ptr())
    cuda_build.check(code, f"flash_decode ({route})")
    flash_decode.launches += 1
    flash_decode.launches_by_route[route] += 1
    return out


def flash_decode_partial(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         positions: torch.Tensor, start: int):
    """One rank's partial of :func:`flash_decode` over its slice ``[start,
    start + S)`` of a cache split over T: caches (B, S, K, hd) the slice,
    positions (B,) int32 in the whole cache (row ``b`` sees the slice's rows
    ``s`` with ``start + s <= positions[b]``; a position before ``start``
    sees none).  Returns ``(o (B, 1, H, hd), lse (B, H))``, both float32 (see
    the module docstring); q, caches, routes and plan as :func:`flash_decode`
    takes them.  ``sharding.decode_split.combine_partials`` joins the ranks'
    partials."""
    if q.device.type == "cpu":
        return flash_decode_partial_torch(q, k_cache, v_cache, positions, start)
    q_dtype, kv_dtype = _launch_checks(q, k_cache, v_cache, positions)
    if start < 0:
        raise ValueError(f"a slice cannot start at {start} < 0")
    b, _, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty((b, 1, h, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    if b == 0 or h == 0:
        return out, lse
    chunk, n_splits = flash_decode_plan(b, kh, s, _sm_count(q.device))
    part = torch.empty(b * h * n_splits * (hd + 2), dtype=torch.float32, device=q.device)
    route = flash_decode_route(k_cache, v_cache)
    lib = cuda_build.load()
    with torch.cuda.device(q.device):
        code = lib.flash_decode_partial_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), positions.data_ptr(),
            int(start), part.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, h, kh, hd,
            q_dtype, kv_dtype, 1.0 / math.sqrt(hd), chunk, n_splits, ROUTE_CODES[route],
            q.stride(0), q.stride(2), k_cache.stride(0), k_cache.stride(1),
            k_cache.stride(2), v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            cuda_build.stream_ptr())
    cuda_build.check(code, f"flash_decode_partial ({route})")
    flash_decode_partial.launches += 1
    flash_decode_partial.launches_by_route[route] += 1
    return out, lse


#: wrapper calls that launched the kernels (each call is two launches: the
#: split and the combine pass), in all and by load route; never raised by the
#: plain version
flash_decode.launches = 0
flash_decode.launches_by_route = dict.fromkeys(ROUTE_CODES, 0)
#: kernel launches one call makes (split pass, combine pass)
KERNELS_PER_CALL = 2
#: the partial mode's calls that launched the kernels (two launches each, as
#: ``flash_decode``'s), in all and by load route
flash_decode_partial.launches = 0
flash_decode_partial.launches_by_route = dict.fromkeys(ROUTE_CODES, 0)
