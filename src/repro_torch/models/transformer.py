"""Decoder-only transformer (dense + MoE), the LM serving path.

* parameters in the reference's orientation — ``(in, out)`` matrices with a
  leading ``n_layers`` axis (``repro.models.transformer.init_params``) — held
  as ``nn.Parameter``s of a :class:`Transformer`, so that carrying the
  reference's weights across is a copy (:func:`params_from_reference`);
* GQA with optional qk-norm (Qwen3), RoPE, SwiGLU; MoE layers through the
  sort-based capacity dispatch of ``layers.moe_block``'s pieces; a Python
  loop over the layers where the reference scans;
* ``forward`` — prefill path, returning the (L, 2, B, T, K, hd) bf16 cache;
* ``decode_step`` — single-token serve path against that cache, padded by the
  caller; it writes the new token's K/V into the cache **in place** (the
  reference returns a new cache: copying a 1.2 GB cache every step would
  cost more than the step).

``attention`` selects the kernels of a layer, as ``probe=`` does in the
serving engine: ``"kernel"`` the hand-written CUDA kernels
(``kernels.flash_attention_tpu`` in prefill, ``kernels.flash_decode`` in
decode, and ``kernels.moe_gemm`` for the expert products of MoE layers),
``"torch"`` the plain path (``models.flash.flash_attention``,
``layers.decode_attention``, ``moe_gemm_torch``), ``None`` the kernels for
CUDA tensors and the plain path for CPU tensors.  ``"kernel"`` on the CPU
raises.  The MoE layers' mesh sharding hints (``moe_dp_axes``) are refused:
on a mesh, ``sharding.spmd.make_sharded_train_step`` splits the MoE layers
over the model axis itself.

``loss_fn`` — the training loss, through the same layer code with autograd
on: attention through ``models.flash.FlashAttention`` (the reference's
custom VJP) over the kernel's forward, which also writes the log-sum-exp,
or, on the plain path, over the plain forward; the MoE expert products
through ``MoeGemm`` (forward and both backward products on the kernel) or
through ``moe_gemm_torch`` under autograd.  ``cfg.remat`` is the
reference's: ``"block"`` (every LM's default) and ``"full"`` wrap each layer
(:func:`_layer`: norms, q/k/v, attention, ``wo``, the FFN or MoE block with
its ``count_sum``) in ``torch.utils.checkpoint.checkpoint``, so the backward
keeps each layer's input and recomputes the rest; ``"none"`` keeps every
activation.  The recompute repeats the forward bit for bit: every op of a
layer is deterministic on CUDA but the dispatch buffer's scratch row, which
several dropped choices write and nothing reads, so the MoE routing of the
recompute is the forward's.

A layer reads its weights and moves its activations through a *view*
(:class:`WholeModel` here; ``repro_torch.sharding.lm_split.RankView`` for
one rank of a mesh): the weights a rank computes with, the gather of the
residual stream along T before the column-parallel products and the
reduce-scatter after the row-parallel ones, the rank's attention heads and
experts.  In the whole view each of those is the identity, so the unsharded
step and a mesh of one rank run the same operations.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from ..core.device import resolve_device
from ..kernels.flash_attention.ops import flash_attention_tpu, flash_attention_tpu_fwd
from ..kernels.flash_decode.ops import flash_decode
from ..kernels.moe_gemm.ops import MoeGemm, moe_gemm, moe_gemm_torch
from .flash import FlashAttention, flash_attention
from . import layers
from .layers import (MoEDims, apply_rope, decode_attention, moe_aux, moe_experts, rms_norm,
                     swiglu)

ATTENTION = ("kernel", "torch")
REMAT = ("none", "block", "full")


def _dtype(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _layer_shapes(cfg: LMConfig) -> dict[str, tuple[tuple[int, ...], int | None]]:
    """Stacked layer parameters: name -> (shape, fan-in of its draw; None
    for a norm scale, which starts at ones)."""
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    h, kh, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    shapes = {"attn_norm": ((L, d), None), "wq": ((L, d, h * hd), d),
              "wk": ((L, d, kh * hd), d), "wv": ((L, d, kh * hd), d),
              "wo": ((L, h * hd, d), h * hd), "ffn_norm": ((L, d), None)}
    if cfg.qk_norm:
        shapes.update(q_norm=((L, hd), None), k_norm=((L, hd), None))
    if cfg.moe:
        e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        shapes.update(router=((L, d, e), d), w_gate=((L, e, d, fe), d),
                      w_up=((L, e, d, fe), d), w_down=((L, e, fe, d), fe))
        if cfg.moe.n_shared_experts:
            fs = cfg.moe.n_shared_experts * fe
            shapes.update(ws_gate=((L, d, fs), d), ws_up=((L, d, fs), d),
                          ws_down=((L, fs, d), fs))
    else:
        shapes.update(w_gate=((L, d, f), d), w_up=((L, d, f), d), w_down=((L, f, d), f))
    return shapes


class Transformer(nn.Module):
    """The parameters of a decoder-only LM: ``embed`` (V, D),
    ``layers`` (stacked, see :func:`_layer_shapes`), ``final_norm`` (D,) and,
    unless the embeddings are tied, ``lm_head`` (D, V).  Uninitialised: use
    :func:`init_params` or :func:`params_from_reference`."""

    def __init__(self, cfg: LMConfig, device: torch.device):
        super().__init__()
        if cfg.moe_dp_axes is not None:
            raise NotImplementedError(
                f"{cfg.name}: moe_dp_axes={cfg.moe_dp_axes!r} asks for the reference's mesh "
                f"sharding constraints on the MoE layers' activations; the port takes no mesh "
                f"hint here: repro_torch.sharding.spmd.make_sharded_train_step splits the "
                f"MoE layers over a mesh's model axis (expert-parallel)")
        self.cfg = cfg
        dt = _dtype(cfg)
        empty = lambda *shape: nn.Parameter(  # noqa: E731
            torch.empty(shape, dtype=dt, device=device))
        self.embed = empty(cfg.vocab_size, cfg.d_model)
        self.layers = nn.ParameterDict(
            {name: empty(*shape) for name, (shape, _) in _layer_shapes(cfg).items()})
        self.final_norm = empty(cfg.d_model)
        self.lm_head = None if cfg.tie_embeddings else empty(cfg.d_model, cfg.vocab_size)

    def layer(self, i: int) -> dict[str, torch.Tensor]:
        return {name: p[i] for name, p in self.layers.items()}

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
@torch.no_grad()
def init_params(cfg: LMConfig, generator: torch.Generator, device="cuda") -> Transformer:
    """Random weights drawn with ``generator`` on ``device`` (the generator
    must live there): each matrix N(0, 1) / sqrt(fan-in) drawn in float32,
    layer by layer, then cast to the model's dtype; norm scales are ones.
    The numbers differ from ``jax.random``'s for the same seed."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev)

    def draw(param: torch.Tensor, fan: int) -> None:
        for part in (param if param.dim() >= 3 else [param]):
            part.copy_(torch.randn(part.shape, generator=generator, device=dev,
                                   dtype=torch.float32) / math.sqrt(fan))

    for name, (_, fan) in _layer_shapes(cfg).items():
        if fan is None:
            model.layers[name].fill_(1)
        else:
            draw(model.layers[name], fan)
    draw(model.embed, cfg.d_model)
    model.final_norm.fill_(1)
    if model.lm_head is not None:
        draw(model.lm_head, cfg.d_model)
    return model


@torch.no_grad()
def params_from_reference(cfg: LMConfig, params: dict, device="cuda") -> Transformer:
    """The reference's ``init_params`` output, as a nested dict of NumPy
    arrays (``jax.tree.map(np.asarray, params)``), as the port's model, key
    for key and value for value (bf16 arrays pass through float32, which
    holds them exactly)."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev)
    want = {"embed", "layers", "final_norm"} | ({"lm_head"} if model.lm_head is not None
                                                  else set())
    if set(params) != want or set(params["layers"]) != set(model.layers):
        raise KeyError(f"reference params hold {sorted(params)} / "
                       f"{sorted(params.get('layers', {}))}, expected {sorted(want)} / "
                       f"{sorted(model.layers)}")
    pairs = [(model.embed, params["embed"]), (model.final_norm, params["final_norm"])]
    pairs += [(model.layers[n], params["layers"][n]) for n in model.layers]
    if model.lm_head is not None:
        pairs.append((model.lm_head, params["lm_head"]))
    for dst, src in pairs:
        a = np.array(src, dtype=np.float32)
        if a.shape != tuple(dst.shape):
            raise ValueError(f"reference array of shape {a.shape} for a parameter of "
                             f"shape {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(a))
    return model


# ----------------------------------------------------------------------
# layer application
# ----------------------------------------------------------------------
def resolve_attention(attention: str | None, device: torch.device) -> str:
    """``None`` -> the kernels for CUDA tensors, the plain path otherwise."""
    if attention is None:
        return "kernel" if device.type == "cuda" else "torch"
    if attention not in ATTENTION:
        raise ValueError(f"attention={attention!r}; expected one of {ATTENTION} or None")
    if attention == "kernel" and device.type != "cuda":
        raise ValueError(f"attention='kernel' runs the CUDA kernels and the tensors lie "
                         f"on {device}; pass attention='torch' (or None)")
    return attention


def _qkv(cfg: LMConfig, lp: dict, xn: torch.Tensor, positions: torch.Tensor, hq: int,
         hk: int):
    """q (B, t, hq, hd), k and v (B, t, hk, hd) of the normed input ``xn``,
    qk-normed and rotated; ``hq`` / ``hk`` the heads that ``lp``'s columns
    hold (the config's, or a rank's share)."""
    b, t, _ = xn.shape
    hd = cfg.head_dim
    q = (xn @ lp["wq"]).reshape(b, t, hq, hd)
    k = (xn @ lp["wk"]).reshape(b, t, hk, hd)
    v = (xn @ lp["wv"]).reshape(b, t, hk, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


class WholeModel:
    """The unsharded view of a model that :func:`_layer` reads: every weight
    whole, the residual stream whole (its gather and reduce-scatter along T
    the identity), every head and expert on this process."""

    def __init__(self, cfg: LMConfig, params: Transformer):
        self.cfg, self.params = cfg, params
        self.seq_parts = 1
        self.heads = (cfg.n_heads, cfg.n_kv_heads, None)
        self.experts = None
        self.ffn_split = self.shared_split = True

    def embed(self) -> torch.Tensor:
        return self.params.embed

    def head(self) -> torch.Tensor:
        return self.params.head()

    def final_norm(self) -> torch.Tensor:
        return self.params.final_norm

    def layer(self, i: int) -> dict:
        return self.params.layer(i)

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        return x

    scatter_seq = gather_seq

    def gather_seq_nograd(self, x: torch.Tensor) -> torch.Tensor:
        return x

    #: the whole sequence is here, its last position too
    holds_last = True

    def cache_rows(self, k: torch.Tensor, v: torch.Tensor):
        return k, v

    def decode_heads(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        return q, k, v

    def own_heads(self, o: torch.Tensor) -> torch.Tensor:
        return o

    def decode_write(self, cache: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
                     new: torch.Tensor) -> None:
        cache[rows, pos] = new

    def decode_attend(self, q, k_cache, v_cache, pos32, pos, att: str) -> torch.Tensor:
        if att == "kernel":
            return flash_decode(q, k_cache, v_cache, pos32)
        return decode_attention(q, k_cache, v_cache, pos)


def _split_ffn(view, split: bool, xn: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """A SwiGLU MLP on the rank's tokens: column- / row-parallel between a
    gather and a reduce-scatter along T where the view splits its width,
    else on the rank's own tokens with the whole weights."""
    if split:
        return view.scatter_seq(swiglu(view.gather_seq(xn), wg, wu, wd))
    return swiglu(xn, wg, wu, wd)


def _moe(cfg: LMConfig, view, lp: dict, xn: torch.Tensor, att: str, with_aux: bool,
         count_sum):
    """The MoE block of the rank's tokens ``xn`` (B, t, D): routed with the
    whole router; then tokens, gates and expert ids gathered along T over the
    view's model ranks (the whole token groups, so capacity and drops are
    the unsharded step's), the rank's experts computed, and each token's
    float32 sum of its experts' outputs reduce-scattered back along T."""
    b, t, d = xn.shape
    dims = MoEDims(cfg.moe.n_experts, cfg.moe.top_k)
    gemm = moe_gemm if att == "kernel" else moe_gemm_torch
    if att == "kernel" and torch.is_grad_enabled():
        gemm = MoeGemm.apply  # the kernel forward and backward
    flat = xn.reshape(b * t, d)
    # through the module, as ``layers.moe_block`` calls it: one name routes every MoE path
    probs, gates, experts = layers.moe_router(flat, lp["router"], dims.top_k)
    aux = moe_aux(probs, experts, dims.n_experts, count_sum) if with_aux else None
    k = dims.top_k
    group = view.gather_seq(xn).reshape(-1, d)
    gates = view.gather_seq(gates.reshape(b, t, k)).reshape(-1, k)
    experts = view.gather_seq_nograd(experts.reshape(b, t, k)).reshape(-1, k)
    y = moe_experts(group, gates, experts, lp["w_gate"], lp["w_up"], lp["w_down"], dims,
                    cfg.moe_groups, gemm, view.experts)
    y = view.scatter_seq(y.reshape(b, -1, d)).to(xn.dtype)
    if cfg.moe.n_shared_experts:
        y = y + _split_ffn(view, view.shared_split, xn, lp["ws_gate"], lp["ws_up"],
                           lp["ws_down"])
    return y, aux


def _ffn(cfg: LMConfig, view, lp: dict, x: torch.Tensor, att: str, with_aux: bool = True,
         count_sum=None):
    """The feed-forward half of a layer: ``(x + ffn(x), MoE aux loss)`` (the
    loss None without ``with_aux``; ``count_sum`` as ``layers.moe_aux``'s)."""
    xn = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    if cfg.moe:
        y, aux = _moe(cfg, view, lp, xn, att, with_aux, count_sum)
    else:
        y, aux = _split_ffn(view, view.ffn_split, xn, lp["w_gate"], lp["w_up"],
                            lp["w_down"]), 0.0
    return x + y, aux


def _layer(cfg: LMConfig, view, i: int, x: torch.Tensor, positions: torch.Tensor,
           att: str, count_sum=None):
    """Layer ``i`` on the rank's part of the residual stream ``x`` (B, t,
    D): ``(x, aux, k, v)`` (k, v (B, T, K, hd) for a cache).  The weights
    come from ``view.layer(i)`` inside this function, so that a view's
    per-layer gathers run again in a checkpointed layer's recompute and are
    never saved."""
    lp = view.layer(i)
    b = x.shape[0]
    hq, hk, expand = view.heads
    xn = view.gather_seq(rms_norm(x, lp["attn_norm"], cfg.norm_eps))
    t = xn.shape[1]
    q, k, v = _qkv(cfg, lp, xn, positions, hq, hk)
    ka, va = (k, v) if expand is None else (k[:, :, expand], v[:, :, expand])
    o = _attention(q, ka, va, att, t)
    x = x + view.scatter_seq(o.reshape(b, t, hq * cfg.head_dim) @ lp["wo"])
    x, aux = _ffn(cfg, view, lp, x, att, count_sum=count_sum)
    return x, aux, k, v


def _logits(cfg: LMConfig, view, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, view.final_norm(), cfg.norm_eps) @ view.head()


@torch.no_grad()
def forward(cfg: LMConfig, params: Transformer, tokens: torch.Tensor,
            return_cache: bool = False, logits_mode: str = "all",
            attention: str | None = None):
    """tokens (B, T) -> (logits (B, T, V), aux) [+ cache (L, 2, B, T, K, hd)
    bf16].  ``logits_mode="last"`` computes the LM head only for the final
    position (prefill).  ``aux`` is the MoE load-balancing loss summed over
    the layers (0 for a dense model).  Runs without gradients (serving);
    :func:`loss_fn` runs the same layers with them."""
    return _forward(cfg, WholeModel(cfg, params), tokens, return_cache, logits_mode,
                    attention)


def _attention(q, k, v, att: str, t: int):
    """Causal attention of a layer: with autograd on, through the
    ``autograd.Function`` of the kernel or of the plain path."""
    if torch.is_grad_enabled():
        fwd = flash_attention_tpu_fwd if att == "kernel" else None
        return FlashAttention.apply(q, k, v, True, min(1024, t), fwd)
    if att == "kernel":
        return flash_attention_tpu(q, k, v, causal=True)
    return flash_attention(q, k, v, True, min(1024, t))


def _forward(cfg: LMConfig, view, tokens: torch.Tensor, return_cache: bool = False,
             logits_mode: str = "all", attention: str | None = None, count_sum=None):
    """The layers over ``view`` on ``tokens`` (B, t), the rank's part of the
    sequence (its ``view.seq_parts``-th of T); with autograd on, each layer
    checkpointed as ``cfg.remat`` says.  The cache holds, for each layer,
    ``view.cache_rows`` of its k and v (the rank's T rows of every kv head);
    the logits are None on a rank that does not hold the last position
    (``view.holds_last``) under ``logits_mode="last"``."""
    if cfg.remat not in REMAT:
        raise ValueError(f"remat={cfg.remat!r}; expected one of {REMAT}")
    att = resolve_attention(attention, tokens.device)
    b, t = tokens.shape
    dev = tokens.device
    x = view.embed()[tokens.long()].to(_dtype(cfg))
    whole_t = t * view.seq_parts
    positions = torch.arange(whole_t, device=dev).expand(b, whole_t)
    cache = None
    if return_cache:
        cache = torch.empty((cfg.n_layers, 2, b, t, cfg.n_kv_heads, cfg.head_dim),
                            dtype=torch.bfloat16, device=dev)
    remat = torch.is_grad_enabled() and cfg.remat != "none" and not return_cache
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(cfg.n_layers):
        if remat:
            x, layer_aux, _, _ = checkpoint(_layer, cfg, view, i, x, positions, att, count_sum,
                                            use_reentrant=False, preserve_rng_state=False)
        else:
            x, layer_aux, k, v = _layer(cfg, view, i, x, positions, att, count_sum)
            if cache is not None:
                k, v = view.cache_rows(k.to(cache.dtype), v.to(cache.dtype))
                cache[i, 0].copy_(k)
                cache[i, 1].copy_(v)
        aux = aux + layer_aux
    if logits_mode == "last":
        x = x[:, -1:]
    if logits_mode != "last" or view.holds_last:
        logits = _logits(cfg, view, x)
    else:  # the last position lies on another rank: its weights' gathers alone
        view.final_norm(), view.head()
        logits = None
    if return_cache:
        return logits, aux, cache
    return logits, aux


def loss_fn(cfg: LMConfig, params, tokens: torch.Tensor, targets: torch.Tensor,
            attention: str | None = None, count_sum=None):
    """Next-token loss with autograd: ``(loss, {"nll", "aux"})``, the logits
    widened to float32, then log-softmax, the mean NLL of ``targets`` and,
    for MoE, ``router_aux_weight * aux`` (``count_sum``: see
    ``layers.moe_aux``).  ``params`` is a :class:`Transformer` or a view of
    one rank's part of it (``sharding.lm_split.RankView``), in which case
    ``tokens`` and ``targets`` are the rank's part of the batch."""
    view = WholeModel(cfg, params) if isinstance(params, Transformer) else params
    logits, aux = _forward(cfg, view, tokens, attention=attention, count_sum=count_sum)
    logp = torch.log_softmax(logits.float(), dim=-1)
    del logits
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    loss = nll.mean()
    if cfg.moe:
        loss = loss + cfg.moe.router_aux_weight * aux
    return loss, {"nll": nll.mean(), "aux": aux}


# ----------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------
@torch.no_grad()
def decode_step(cfg: LMConfig, params: Transformer, tokens: torch.Tensor,
                positions: torch.Tensor, kv_cache: torch.Tensor,
                attention: str | None = None):
    """One-token decode.

    tokens (B, 1); positions (B,) int, each in ``[0, S)``; kv_cache
    (L, 2, B, S, K, hd).  Writes each row's new K/V at its position into
    ``kv_cache`` in place and returns ``(logits (B, V), kv_cache)``.  A
    position outside ``[0, S)`` raises (JAX would drop that update without a
    word; here it would write out of bounds): at once for CPU positions with
    ``IndexError``, and for CUDA positions as a device-side assertion, so the
    host never waits for the card — the error then surfaces at the caller's
    next synchronisation.
    """
    att = resolve_attention(attention, tokens.device)
    check_positions(positions, kv_cache.shape[3])
    return _decode(cfg, WholeModel(cfg, params), tokens, positions, kv_cache, att), kv_cache


def check_positions(positions: torch.Tensor, s: int) -> None:
    """Every position in ``[0, s)``: checked at once on the CPU
    (``IndexError``), as a device-side assertion on the card (the host waits
    for nothing)."""
    inside = (positions >= 0) & (positions < s)
    if positions.device.type == "cuda":
        torch._assert_async(inside.all(), f"decode_step: a position outside the cache's [0, {s})")
    elif positions.device.type == "cpu" and not bool(inside.all()):  # meta holds none
        raise IndexError(f"positions {positions.tolist()} outside the cache's [0, {s})")


def _decode(cfg: LMConfig, view, tokens: torch.Tensor, positions: torch.Tensor,
            kv_cache: torch.Tensor, att: str) -> torch.Tensor:
    """The layers of one decode step over ``view`` (``WholeModel``, or one
    rank's ``sharding.lm_split.DecodeView``): q, k and v of the view's heads
    made whole (``view.decode_heads``), the new k and v written into the
    cache (``view.decode_write``), attention over it (``view.decode_attend``),
    the view's heads through ``wo`` (``view.own_heads``, ``view.scatter_seq``)
    and the FFN; returns the logits (B, V)."""
    b = tokens.shape[0]
    hq, hk, _ = view.heads
    x = view.embed()[tokens.long()].to(_dtype(cfg))  # (B, 1, D)
    rows = torch.arange(b, device=tokens.device)
    pos = positions.long()
    pos32 = positions.to(torch.int32)
    for i in range(cfg.n_layers):
        lp = view.layer(i)
        q, k, v = _qkv(cfg, lp, rms_norm(x, lp["attn_norm"], cfg.norm_eps), pos[:, None], hq,
                       hk)
        q, k, v = view.decode_heads(q, k, v)
        k_cache, v_cache = kv_cache[i, 0], kv_cache[i, 1]
        view.decode_write(k_cache, rows, pos, k[:, 0].to(kv_cache.dtype))
        view.decode_write(v_cache, rows, pos, v[:, 0].to(kv_cache.dtype))
        o = view.own_heads(view.decode_attend(q, k_cache, v_cache, pos32, pos, att))
        x = x + view.scatter_seq(o.reshape(b, 1, hq * cfg.head_dim) @ lp["wo"])
        x, _ = _ffn(cfg, view, lp, x, att, with_aux=False)
    return _logits(cfg, view, x)[:, 0]
