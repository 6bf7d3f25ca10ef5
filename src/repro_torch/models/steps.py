"""Serve-step factories of the LM serving path.

``make_lm_prefill_step(cfg)`` and ``make_lm_decode_step(cfg)`` return the
reference's pure step functions (``repro.models.steps``), run without
autograd; ``attention`` chooses the kernels or the plain path (see
``transformer``).  The training steps, and the GNN and recsys families, come
with later slices of the port (ROADMAP Queue A item 7).
"""

from __future__ import annotations

import torch

from ..configs.base import GNNConfig, LMConfig, RecsysConfig
from . import transformer


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


def init_model_params(cfg, generator: torch.Generator, device="cuda",
                      shape_name: str | None = None):
    """Random weights of ``cfg`` drawn with ``generator`` on ``device``."""
    if isinstance(cfg, LMConfig):
        return transformer.init_params(cfg, generator, device)
    if isinstance(cfg, (GNNConfig, RecsysConfig)):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} models are not ported yet (ROADMAP Queue A "
            f"item 7; the recsys kernels are Queue B rows 9-10)")
    raise TypeError(type(cfg))
