"""Flash attention forward as plain tensor code (O(T) memory per KV block).

Layout: q (B, T, H, hd); k, v (B, S, K, hd); H = K * G (GQA groups).  The
same recurrence as the reference's XLA forward (``repro.models.flash``):
KV blocks of ``block_kv`` keys, running (m, s, acc) in float32 with the
``NEG_INF`` sentinel, q cast to float32 and then scaled (the reference's
``q * scale`` promotes to float32 the same way).  The hand-written kernel
``repro_torch.kernels.flash_attention`` is the GPU fast path for the same
math.  The reference's custom VJP (the backward recurrence) comes with the
training slice; this module is forward only.
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
    return (acc / s_safe[..., None]).reshape(b, tq, h, hd).to(q.dtype)
