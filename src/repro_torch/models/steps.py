"""Serve-step factories of the LM and recsys serving paths.

``make_lm_prefill_step(cfg)``, ``make_lm_decode_step(cfg)`` and
``make_recsys_serve_step(cfg)`` return the reference's pure step functions
(``repro.models.steps``), run without autograd; for the LMs ``attention``
chooses the kernels or the plain path (see ``transformer``).  The training
steps and the GNN family come with later slices of the port (ROADMAP Queue
A item 7).
"""

from __future__ import annotations

import torch

from ..configs.base import GNNConfig, LMConfig, RecsysConfig
from . import recsys, transformer


def make_lm_prefill_step(cfg: LMConfig, attention: str | None = None):
    @torch.no_grad()
    def prefill_step(params, tokens):
        """tokens (B, T) -> (last-position logits (B, V), cache (L, 2, B, T, K, hd))."""
        logits, _, cache = transformer.forward(cfg, params, tokens, return_cache=True,
                                               logits_mode="last", attention=attention)
        return logits[:, 0], cache

    return prefill_step


def make_lm_decode_step(cfg: LMConfig, attention: str | None = None):
    def decode_step(params, tokens, positions, kv_cache):
        """One token per row; updates ``kv_cache`` in place (see
        ``transformer.decode_step``) and returns (logits (B, V), kv_cache)."""
        return transformer.decode_step(cfg, params, tokens, positions, kv_cache,
                                       attention=attention)

    return decode_step


# ----------------------------------------------------------------------
# RecSys
# ----------------------------------------------------------------------
def make_recsys_serve_step(cfg: RecsysConfig, retrieval: bool = False,
                           cand_shard_axes=None, cand_pad_multiple: int = 1,
                           serve_dtype=None):
    """``serve(params, **inputs)``: logits of ``fields`` (FM, xDeepFM),
    scores of ``target`` after ``hist`` (SASRec), or user-item cosine
    scores (two-tower); with ``retrieval``, the scores of every row of
    ``candidates`` — against each user for SASRec and two-tower, as a
    logit per candidate row for FM and xDeepFM.  ``serve_dtype`` (retrieval
    only, as in the reference) serves a cast copy of the float32 weights;
    ``cand_pad_multiple`` pads the candidates by repeating the first one and
    slices the scores back.  ``cand_shard_axes`` names mesh axes of the
    reference's sharding, which has no counterpart on one card: it raises."""
    if cand_shard_axes is not None:
        raise NotImplementedError(
            f"cand_shard_axes={cand_shard_axes!r} is a mesh sharding hint of the "
            f"reference; the port serves on one card")
    if retrieval:
        @torch.no_grad()
        def serve(params, **inputs):
            if serve_dtype is not None:
                params = recsys.cast_params(params, serve_dtype)
            cand = inputs["candidates"]
            nc = cand.shape[0]
            pad = (-nc) % cand_pad_multiple if cand_pad_multiple > 1 else 0
            if pad:
                cand = torch.cat([cand, cand[:1].expand(pad, *cand.shape[1:])])
            if cfg.interaction == "self-attn-seq":
                out = recsys.sasrec_retrieval(cfg, params, inputs["hist"], cand)
            elif cfg.interaction == "dot":
                out = recsys.tt_retrieval(cfg, params, inputs["user_feats"], cand)
            elif cfg.interaction in ("fm-2way", "cin"):
                # fm / cin: score the candidate matrix directly (batched)
                fn = recsys.fm_logits if cfg.interaction == "fm-2way" else recsys.xdeepfm_logits
                out = fn(cfg, params, cand)
            else:
                raise ValueError(cfg.interaction)
            # candidate axis is last for (B, NC) scores, first for (NC,) logits
            return out[..., :nc] if out.dim() > 1 else out[:nc]

        return serve

    @torch.no_grad()
    def serve(params, **inputs):
        if cfg.interaction == "fm-2way":
            return recsys.fm_logits(cfg, params, inputs["fields"])
        if cfg.interaction == "cin":
            return recsys.xdeepfm_logits(cfg, params, inputs["fields"])
        if cfg.interaction == "self-attn-seq":
            return recsys.sasrec_serve_scores(cfg, params, inputs["hist"], inputs["target"])
        if cfg.interaction == "dot":
            u = recsys.tt_user_tower(cfg, params, inputs["user_feats"])
            v = recsys.tt_item_tower(cfg, params, inputs["item_ids"])
            return torch.sum(u * v, dim=-1)
        raise ValueError(cfg.interaction)

    return serve


# ----------------------------------------------------------------------
# init dispatch
# ----------------------------------------------------------------------
def init_model_params(cfg, generator: torch.Generator, device="cuda",
                      shape_name: str | None = None):
    """Random weights of ``cfg`` drawn with ``generator`` on ``device``."""
    if isinstance(cfg, LMConfig):
        return transformer.init_params(cfg, generator, device)
    if isinstance(cfg, GNNConfig):
        raise NotImplementedError(
            f"{cfg.name}: the GNN models are not ported yet (ROADMAP Queue A item 7)")
    if isinstance(cfg, RecsysConfig):
        init = {"fm-2way": recsys.init_fm, "cin": recsys.init_xdeepfm,
                "self-attn-seq": recsys.init_sasrec, "dot": recsys.init_two_tower}
        if cfg.interaction not in init:
            raise ValueError(cfg.interaction)
        return init[cfg.interaction](cfg, generator, device)
    raise TypeError(type(cfg))
