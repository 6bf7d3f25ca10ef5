"""Transformer building blocks: RMSNorm, RoPE, GQA attention (+ qk-norm)
and the SwiGLU MLP, as plain tensor code.

This is the model's plain path (the reference's XLA path); the hand-written
kernels in ``repro_torch.kernels.flash_attention`` and ``flash_decode`` are
the GPU fast path for the same math, chosen by ``transformer.forward(...,
attention=)``.  Dtypes follow the reference's promotions, which differ from
PyTorch's defaults in two places, both made explicit here:

* ``q * (1 / np.sqrt(hd))`` in JAX promotes a bf16 ``q`` to float32 (the
  numpy scalar is strongly typed), where PyTorch would keep bf16: q is cast
  to float32 before it is scaled;
* ``rms_norm`` multiplies its float32 normalised input by a scale of the
  model's dtype, which promotes to float32 in both frameworks.

The reference's sort-based MoE (``MoEDims`` / ``moe_block``) belongs to a
later slice of the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    # float32 times the scale's dtype (bf16 or f32) is float32, as in JAX
    return ((x * torch.rsqrt(var + eps)) * scale).to(dtype)


# ----------------------------------------------------------------------
# rotary position embeddings
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates the
    two halves of the head dim against each other (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def blocked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             block_kv: int = 1024) -> torch.Tensor:
    """Online-softmax causal attention.

    q, k, v: (B, T, H, hd) / (B, T, K, hd) with H a multiple of K (GQA).
    Never materializes the (T, T) score matrix: loops over KV blocks carrying
    running (max, sum, acc), with ``-inf`` masking and the reference's
    guards for fully-masked blocks.
    """
    b, tq, h, hd = q.shape
    _, tk, kh, _ = k.shape
    groups = h // kh
    scale = 1.0 / math.sqrt(hd)
    nb = max(1, (tk + block_kv - 1) // block_kv)
    pad = nb * block_kv - tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = (q.float() * scale).reshape(b, tq, kh, groups, hd)
    qpos = torch.arange(tq, device=q.device)
    neg_inf = torch.tensor(-math.inf, device=q.device)
    m = torch.full((b, tq, kh, groups), -math.inf, dtype=torch.float32, device=q.device)
    s = torch.zeros((b, tq, kh, groups), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, tq, kh, groups, hd), dtype=torch.float32, device=q.device)
    for bidx in range(nb):
        kblk = k[:, bidx * block_kv:(bidx + 1) * block_kv].float()
        vblk = v[:, bidx * block_kv:(bidx + 1) * block_kv].float()
        kpos = bidx * block_kv + torch.arange(block_kv, device=q.device)
        scores = torch.einsum("btkgd,bckd->btkgc", qg, kblk)
        keep = ((kpos[None, :] <= qpos[:, None])[None, :, None, None, :]
                & (kpos < tk)[None, None, None, None, :])
        scores = torch.where(keep, scores, neg_inf)
        new_m = torch.maximum(m, scores.amax(dim=-1))
        safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
        p = torch.where(keep, torch.exp(scores - safe_m[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        s = s * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("btkgc,bckd->btkgd", p, vblk)
        m = new_m
    out = acc / torch.clamp(s[..., None], min=1e-30)
    return out.reshape(b, tq, h, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention against a KV cache.

    q: (B, 1, H, hd); caches: (B, T, K, hd); positions: (B,) current index.
    """
    b, _, h, hd = q.shape
    _, t, kh, _ = k_cache.shape
    groups = h // kh
    scale = 1.0 / math.sqrt(hd)
    qg = (q[:, 0].float() * scale).reshape(b, kh, groups, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float())
    tpos = torch.arange(t, device=q.device)
    mask = tpos[None, :] <= positions.long()[:, None]  # attend to past incl. current
    scores = scores.masked_fill(~mask[:, None, None, :], -math.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


def moe_block(*args, **kwargs):
    raise NotImplementedError(
        "moe_block (the reference's sort-based MoE dispatch) is not ported yet: it "
        "comes with the MoE slice (ROADMAP Queue A item 7, with the moe_gemm kernel, "
        "Queue B row 11)")
