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

The reference's sort-based MoE (``MoEDims`` / ``moe_block``) runs its three
expert products through ``kernels.moe_gemm`` (or its plain version, as the
caller chooses); its routing and dispatch are plain tensor code here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

from ..kernels.moe_gemm.ops import moe_gemm


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


# ----------------------------------------------------------------------
# MoE: sort-based dispatch with static capacity (dropless up to capacity)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@contextlib.contextmanager
def _float32_matmuls():
    """CUDA float32 products in full float32 for the time of the block,
    whatever the caller set: under TF32 the router's near-ties would flip."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def moe_router(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """The float32 router: ``(probs (N, E), gates (N, k), experts (N, k))``.

    Top-k by a stable descending sort, so that tied probabilities pick the
    lower expert first, as ``jax.lax.top_k`` does (``torch.topk`` promises
    no order for ties, and a zero row or router ties every expert); the k
    gates are normalised to sum to 1."""
    with _float32_matmuls():
        logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :top_k], experts[:, :top_k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gates, experts


def moe_dispatch(experts: torch.Tensor, dims: MoEDims, n_groups: int = 1) -> dict:
    """The group-local capacity plan of (token, slot) choices ``experts``
    (N, k): ``order`` (G, S*k) sorts each group's choices by expert, stably
    (which token a full expert drops depends on it); ``expert``, ``token``
    the sorted choices' expert and token (within its group); ``pos`` their
    place in their expert's queue; ``keep`` = ``pos < cap``; ``cap`` =
    ``ceil(S * k / E * capacity_factor)``."""
    n, k = experts.shape
    if n % n_groups:
        raise ValueError(f"{n} tokens do not split into {n_groups} groups")
    s = n // n_groups
    ge = experts.reshape(n_groups, s * k)
    order = torch.argsort(ge, dim=1, stable=True)
    se = torch.gather(ge, 1, order)
    st = order // k  # token of each sorted choice (choices are token-major)
    first = torch.searchsorted(se.contiguous(), se.contiguous(), right=False)
    pos = torch.arange(s * k, device=experts.device)[None, :] - first
    cap = int(math.ceil(s * k / dims.n_experts * dims.capacity_factor))
    return {"order": order, "expert": se, "token": st, "pos": pos, "keep": pos < cap,
            "cap": cap}


def moe_block(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor, dims: MoEDims, n_groups: int = 1,
              gemm=None, with_aux: bool = True,
              count_sum=None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Top-k MoE with grouped sort-based capacity dispatch, as the
    reference's ``moe_block`` (its ``dp_axes`` / ``ep_axis`` are sharding
    constraints on activations, which the port does not shard).

    x: (N, D) tokens; router_w (D, E); w_gate, w_up (E, D, F); w_down
    (E, F, D).  ``gemm(buf, w)`` computes the three expert products over the
    (E, G * C, D) buffer (default ``kernels.moe_gemm``); each product comes
    back in float32 and is cast to ``x.dtype``, as the reference's einsum
    output is.  Each token's k weighted expert outputs are summed in slot
    order (no float atomics).  No step waits for the device: every index
    is a tensor, and a dropped choice writes to a scratch slot.  Returns
    (out (N, D) in ``x.dtype``, the Switch-style aux loss, or None without
    ``with_aux``).  ``count_sum``, given where x is one rank's slice of the
    batch, sums the (E + 1,) float32 choice and token counts over the ranks
    (in place) so that the aux loss's load fractions are the whole batch's."""
    gemm = gemm or moe_gemm
    n, d = x.shape
    e, k, g = dims.n_experts, dims.top_k, n_groups
    probs, gates, experts = moe_router(x, router_w, k)

    aux = None
    if with_aux:  # Switch-style load balancing
        me = probs.mean(dim=0)
        chosen = experts.reshape(-1, 1) == torch.arange(e, device=x.device)
        if count_sum is None:
            ce = chosen.sum(dim=0).float() / (n * k)
        else:
            counts = count_sum(torch.cat([chosen.sum(dim=0).float(), me.new_full((1,), n)]))
            ce = counts[:e] / (counts[e] * k)
        aux = e * torch.sum(me * ce)

    plan = moe_dispatch(experts, dims, g)
    s, cap = n // g, plan["cap"]
    keep, se, st = plan["keep"], plan["expert"], plan["token"]
    slot = torch.clamp(plan["pos"], max=cap - 1)
    gi = torch.arange(g, device=x.device)[:, None].expand(g, s * k)
    # dispatch buffer (G, E * C + 1, D): each kept choice owns its row, every
    # dropped one writes to the scratch row E * C, which is then cut off
    buf = torch.zeros((g, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[gi, torch.where(keep, se * cap + slot, e * cap)] = x.reshape(g, s, d)[gi, st]
    buf = buf[:, :e * cap].reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    gate = gemm(buf, w_gate).to(x.dtype)
    up = gemm(buf, w_up).to(x.dtype)
    y = gemm(F.silu(gate) * up, w_down).to(x.dtype)
    y = y.reshape(e, g, cap, d).transpose(0, 1)  # (G, E, C, D)
    # combine: each choice's output back in (token, slot) order
    tok_out = torch.where(keep[..., None], y[gi, se, slot], 0).float()  # sorted order
    by_choice = torch.empty_like(tok_out)
    by_choice[gi, plan["order"]] = tok_out
    weighted = by_choice.reshape(n, k, d) * gates[..., None]
    out = weighted[:, 0]
    for r in range(1, k):
        out = out + weighted[:, r]
    return out.to(x.dtype), aux
