"""Flash attention forward as plain tensor code (O(T) memory per KV block).

Layout: q (B, T, H, hd); k, v (B, S, K, hd); H = K * G (GQA groups).  The
same recurrence as the reference's XLA forward (``repro.models.flash``):
KV blocks of ``block_kv`` keys, running (m, s, acc) in float32 with the
``NEG_INF`` sentinel, q cast to float32 and then scaled (the reference's
``q * scale`` promotes to float32 the same way).  The hand-written kernel
``repro_torch.kernels.flash_attention`` is the GPU fast path for the same
math.

Training: :class:`FlashAttention` is the reference's custom VJP as a
``torch.autograd.Function`` with the same ``(q, k, v, out, lse)`` residuals:
its forward is :func:`flash_attention_fwd` (the recurrence above, also
returning ``lse = m + log(max(s, 1e-30))`` (B, T, K, G) in float32), its
backward :func:`flash_attention_bwd`, the reference's ``_flash_bwd`` line
for line: per KV block the probabilities recomputed from ``lse``, and for a
bf16 model p, dO and dS rounded to bf16 before their products, which sum in
float32 (the reference's ``preferred_element_type``; a product of two bf16
values is exact in float32).  ``models.transformer`` trains through it on the
CPU, and on CUDA through the same Function with the kernel's forward
(``kernels.flash_attention.ops.flash_attention_tpu_fwd``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """(B, S, K, hd) -> (nb, B, block, K, hd), zero-padded."""
    b, s, k, hd = x.shape
    nb = (s + block - 1) // block
    pad = nb * block - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
    return x.reshape(b, nb, block, k, hd).movedim(1, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_kv: int = 1024) -> torch.Tensor:
    """q (B, T, H, hd), k / v (B, S, K, hd) -> (B, T, H, hd) in q's dtype."""
    return flash_attention_fwd(q, k, v, causal, block_kv)[0]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, block_kv: int = 1024):
    """``(out (B, T, H, hd) in q's dtype, lse (B, T, K, G) float32)``."""
    b, tq, h, hd = q.shape
    _, tk, kh, _ = k.shape
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    qg = (q.float() * scale).reshape(b, tq, kh, g, hd)
    kb = _blocks(k, block_kv)
    vb = _blocks(v, block_kv)
    qpos = torch.arange(tq, device=q.device)
    m = torch.full((b, tq, kh, g), NEG_INF, dtype=torch.float32, device=q.device)
    s = torch.zeros((b, tq, kh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, tq, kh, g, hd), dtype=torch.float32, device=q.device)
    for bidx in range(kb.shape[0]):
        kpos = bidx * block_kv + torch.arange(block_kv, device=q.device)
        scores = torch.einsum("btkgd,bckd->btkgc", qg, kb[bidx].float())
        valid = (kpos < tk)[None, None, None, None, :]
        if causal:
            valid = valid & (kpos[None, :] <= qpos[:, None])[None, :, None, None, :]
        scores = scores.masked_fill(~valid, NEG_INF)
        new_m = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - new_m[..., None]).masked_fill(~valid, 0.0)
        corr = torch.exp(m - new_m)
        s = s * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("btkgc,bckd->btkgd", p, vb[bidx].float())
        m = new_m
    s_safe = torch.clamp(s, min=1e-30)
    out = (acc / s_safe[..., None]).reshape(b, tq, h, hd).to(q.dtype)
    return out, m + torch.log(s_safe)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                        causal: bool = True, block_kv: int = 1024):
    """``(dq, dk, dv)`` in the dtypes of q, k, v from the residuals of the
    forward (``lse`` (B, T, K, G) float32, or (B, T, H), the same memory)."""
    b, tq, h, hd = q.shape
    _, tk, kh, _ = k.shape
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    # the reference's mm_dtype: operands of the products rounded to it, the
    # products summed in float32
    mm = (lambda x: x.to(torch.bfloat16).float()) if q.dtype == torch.bfloat16 \
        else (lambda x: x)  # noqa: E731
    qg = q.float().reshape(b, tq, kh, g, hd)
    do = dout.float().reshape(b, tq, kh, g, hd)
    og = out.float().reshape(b, tq, kh, g, hd)
    lse = lse.reshape(b, tq, kh, g)
    delta = torch.sum(do * og, dim=-1)  # (B, T, K, G)
    do16, q16 = mm(do), mm(qg)
    kb = _blocks(k, block_kv)
    vb = _blocks(v, block_kv)
    nb = kb.shape[0]
    qpos = torch.arange(tq, device=q.device)
    dq = torch.zeros((b, tq, kh, g, hd), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, nb * block_kv, kh, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for bidx in range(nb):
        kblk = kb[bidx].float()
        kpos = bidx * block_kv + torch.arange(block_kv, device=q.device)
        scores = torch.einsum("btkgd,bckd->btkgc", qg * scale, kblk)
        valid = (kpos < tk)[None, None, None, None, :]
        if causal:
            valid = valid & (kpos[None, :] <= qpos[:, None])[None, :, None, None, :]
        p = torch.exp(scores.masked_fill(~valid, NEG_INF) - lse[..., None])
        p = p.masked_fill(~valid, 0.0)  # (B, T, K, G, C)
        del scores
        rows = slice(bidx * block_kv, (bidx + 1) * block_kv)
        dv[:, rows] = torch.einsum("btkgc,btkgd->bckd", mm(p), do16)
        dp = torch.einsum("btkgd,bckd->btkgc", do16, mm(vb[bidx].float()))
        ds = mm(p * (dp - delta[..., None]))
        del p, dp
        dq = dq + torch.einsum("btkgc,bckd->btkgd", ds, mm(kblk)) * scale
        dk[:, rows] = torch.einsum("btkgc,btkgd->bckd", ds, q16) * scale
        del ds
    return (dq.reshape(b, tq, h, hd).to(q.dtype), dk[:, :tk].to(k.dtype),
            dv[:, :tk].to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, causal, block_kv, fwd)``: ``fwd(q, k,
    v, causal, block_kv) -> (out, lse)`` (default the plain
    :func:`flash_attention_fwd`; the kernel's is
    ``kernels.flash_attention.ops.flash_attention_tpu_fwd``) with the
    reference's custom VJP as the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, block_kv: int = 1024, fwd=None):
        out, lse = (fwd or flash_attention_fwd)(q, k, v, causal, block_kv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block_kv = causal, block_kv
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal, ctx.block_kv)
        return dq, dk, dv, None, None, None
