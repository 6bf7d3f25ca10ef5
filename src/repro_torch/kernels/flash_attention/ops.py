"""GQA flash attention forward in model layout: q (B, T, H, hd), k / v
(B, S, K, hd), head ``h`` reading KV head ``h // (H // K)``.

On a CUDA tensor ``flash_attention_tpu`` launches ``csrc/flash_attention.cu``
(or raises); on a CPU tensor it runs ``flash_attention_torch``, the plain
PyTorch version of the same function: the model's plain attention
(``models.flash.flash_attention``) over one KV block of all S keys.  Both
follow the TPU kernel's order of operations: cast to float32 first, then
scale q by ``1/sqrt(hd)``; masked scores take the sentinel ``NEG_INF`` and
their probabilities 0; the output is ``acc / max(l, 1e-30)`` in q's dtype.
"""

from __future__ import annotations

import math

import torch

from ...models.flash import flash_attention
from .. import cuda_build

#: head dims the kernel is built for (one template instance each)
HEAD_DIMS = (16, 32, 64, 128)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q (B, T, H, hd) and k, v (B, S, K, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} KV heads")
    if k.shape[1] == 0:
        raise ValueError("no keys (S == 0)")


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention_tpu`: one block of all
    S keys, so the whole (B, T, K, G, S) score tensor in float32 at once (a
    softmax over every key, which is what the kernel's online recurrence
    computes)."""
    _check_shapes(q, k, v)
    return flash_attention(q, k, v, causal, block_kv=k.shape[1])


def flash_attention_tpu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q (B, T, H, hd); k, v (B, S, K, hd), GQA with H a multiple of K.
    Returns (B, T, H, hd) in q's dtype.

    The kernel takes float32 or bfloat16 (q, k and v of one dtype), head dims
    :data:`HEAD_DIMS`, and any strides whose last one is 1 (the model layout
    is read in place).  Under ``causal`` key ``s`` is seen by query ``t`` when
    ``s <= t``, both counted from 0.  It has no backward: a call that would
    need one is refused.
    """
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal)
    dtype = cuda_build.require_float("q", q, 4)
    for name, t in (("k", k), ("v", v)):
        if cuda_build.require_float(name, t, 4) != dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}: the kernel takes one dtype")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    _check_shapes(q, k, v)
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel is built for {HEAD_DIMS}")
    cuda_build.require_cuda("q", q)
    cuda_build.require_no_grad("flash_attention_tpu", q, k, v)
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    if b == 0 or t == 0 or h == 0:
        return out
    lib = cuda_build.load()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, s, h, kh, hd, dtype, int(causal), 1.0 / math.sqrt(hd),
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), cuda_build.stream_ptr())
    cuda_build.check(code, "flash_attention_tpu")
    flash_attention_tpu.launches += 1
    return out


#: kernel launches made by the wrapper (never raised by the plain version)
flash_attention_tpu.launches = 0
