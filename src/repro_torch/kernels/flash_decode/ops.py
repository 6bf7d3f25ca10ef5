"""One-token GQA attention over a KV cache in model layout: q (B, 1, H, hd),
caches (B, S, K, hd), row ``b`` attending to the cache rows
``[0, positions[b]]``.

On a CUDA tensor ``flash_decode`` launches ``csrc/flash_decode.cu`` (or
raises); on a CPU tensor it runs ``flash_decode_torch``, the plain PyTorch
version of the same function.  Both follow the TPU kernel: q and the cache
are cast to float32 each on its own (an f32 model's q meets a bf16 cache),
q is then scaled by ``1/sqrt(hd)``, masked scores take the sentinel
``NEG_INF`` and their probabilities 0, and the float32 result
``acc / max(l, 1e-30)`` is cast to q's dtype.
"""

from __future__ import annotations

import math

import torch

from ...models.flash import NEG_INF
from .. import cuda_build
from ..flash_attention.ops import HEAD_DIMS
#: most query heads per KV head the kernel holds (``kMaxGroup`` of the source)
MAX_GROUP = 16


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


def flash_decode_torch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_decode`: one softmax over the
    whole (B, K, G, S) score tensor in float32."""
    _check_shapes(q, k_cache, v_cache, positions)
    b, _, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    qg = q[:, 0].float().reshape(b, kh, h // kh, hd) * (1.0 / math.sqrt(hd))
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    live = (torch.arange(s, device=q.device)[None, :]
            < (positions.long() + 1)[:, None])[:, None, None, :]
    scores = scores.masked_fill(~live, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)).masked_fill(~live, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float()) / l
    return out.reshape(b, 1, h, hd).to(q.dtype)


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
    b, _, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel is built for {HEAD_DIMS}")
    if h // kh > MAX_GROUP:
        raise ValueError(f"{h // kh} query heads per KV head; the kernel holds at most "
                         f"{MAX_GROUP}")
    cuda_build.require_cuda("q", q)
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    if b == 0 or h == 0:
        return out.reshape(b, 1, h, hd).to(q.dtype)
    lib = cuda_build.load()
    with torch.cuda.device(q.device):
        code = lib.flash_decode_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), positions.data_ptr(),
            out.data_ptr(), b, s, h, kh, hd, q_dtype, kv_dtype, 1.0 / math.sqrt(hd),
            q.stride(0), q.stride(2), k_cache.stride(0), k_cache.stride(1),
            k_cache.stride(2), v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            cuda_build.stream_ptr())
    cuda_build.check(code, "flash_decode")
    flash_decode.launches += 1
    return out.reshape(b, 1, h, hd).to(q.dtype)


#: kernel launches made by the wrapper (never raised by the plain version)
flash_decode.launches = 0
