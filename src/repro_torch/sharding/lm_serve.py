"""The LM's serving steps on a mesh: the counterparts of the reference's
prefill and decode under its production specs (``repro.launch.dryrun``
builds them with ``act_spec = P(dp, "model", None)``, sharded params and
the cache of ``repro.sharding.specs``: ``(L, 2, B, T, K, hd)``, B over the
data axes and T over ``"model"``, or, when B does not divide, T over every
axis).

Both steps read the rank's shards of the parameters (``{path: DTensor}``
placed by ``specs.lm_param_specs``, or the local tensors) and split the
compute as :mod:`.lm_split` plans it, with the train step's per-layer
gathers over ``"data"`` and ``"model"`` and its ``head_plan``, without
autograd.  No parameter is gathered whole with ``full_tensor``, no stacked
layer weight is gathered, and the cache never moves:

* :func:`make_sharded_prefill_step` — ``prefill(params, tokens)`` with the
  whole ``tokens`` (B, T) on every rank: the rank takes its rows (the data
  axes of the tokens' spec) and its T / m tokens, runs the sequence-parallel
  layers and returns ``(logits, cache)``: the last position's logits (B_r,
  V) on the last model rank (None on the others, which compute none) and
  the rank's cache **in the decode spec's layout**, (L, 2, B_r, T / m, K,
  hd), every kv head over its T slice (one all-to-all a layer, heads to
  T);
* :func:`make_sharded_decode_step` — ``decode(params, tokens, positions,
  kv_cache)`` with the whole ``tokens`` (B, 1) and ``positions`` (B,) and
  the rank's slice of the cache (its DTensor or the local tensor), which it
  updates in place: attention by ``flash_decode_partial`` over the rank's
  slice for every head, joined over the axes that split T
  (``decode_split.combine_partials``); returns ``(logits (B_r, V),
  kv_cache)``, the same logits on every rank of the rows.

An MoE model's token groups are those of the unsharded step
(``cfg.moe_groups`` over the whole batch), so a rank's rows hold
``moe_groups / n`` whole groups for ``n`` row slices, as in the train step.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import Shard

from ..configs.base import LMConfig
from ..models import steps, transformer
from ..train.optimizer import param_tree
from .compat import (NamedSharding, axes_index, flatten_specs, local_shard, mesh_device,
                     require_device_mesh, to_local)
from .lm_split import LMSplit


def _row_slices(mesh, placements, dim: int) -> int:
    """How many slices the mesh cuts dimension ``dim`` into."""
    return math.prod(mesh.size(j) for j, p in enumerate(placements)
                     if isinstance(p, Shard) and p.dim == dim)


def _plan(cfg: LMConfig, mesh, param_specs: dict, rows: int, what: str):
    """The rank's :class:`LMSplit` and its config (an MoE's groups divided
    over the ``rows`` slices of the batch)."""
    require_device_mesh(mesh, what)
    if not isinstance(cfg, LMConfig):
        raise TypeError(f"{what} serves the LMs; got {type(cfg).__name__}")
    param_sh = {k: NamedSharding(mesh, v).placements()
                for k, v in flatten_specs(param_specs).items()}
    shapes = {k: tuple(p.shape) for k, p in
              param_tree(steps.init_model_params(cfg, None, "meta")).items()}
    if set(shapes) != set(param_sh):
        raise KeyError(f"param specs for {sorted(set(param_sh) ^ set(shapes))[:4]} do not "
                       f"match the model's parameters")
    rank_cfg = cfg
    if cfg.moe and rows > 1:
        if cfg.moe_groups % rows:
            raise ValueError(f"moe_groups={cfg.moe_groups} is not a multiple of the {rows} "
                             f"row slices: a rank's rows would not hold whole token groups")
        rank_cfg = dataclasses.replace(cfg, moe_groups=cfg.moe_groups // rows)
    return LMSplit(rank_cfg, mesh, param_sh, shapes), rank_cfg


def make_sharded_prefill_step(cfg: LMConfig, mesh, param_specs: dict, in_specs: dict,
                              attention: str | None = None, device=None):
    """``prefill(params, tokens) -> (logits or None, cache)`` on ``mesh`` (see
    the module docstring); ``in_specs`` from
    ``specs.input_specs_sharding_for(cfg, "prefill_32k", ...)``.  ``device``
    is the rank's compute device (the mesh's by default; the dry-run passes
    ``"meta"``)."""
    tok_sh = NamedSharding(mesh, in_specs["tokens"]).placements()
    if _row_slices(mesh, tok_sh, 1) > 1:
        raise ValueError("the tokens' spec splits T: the prefill splits T over 'model' itself")
    split, rank_cfg = _plan(cfg, mesh, param_specs, _row_slices(mesh, tok_sh, 0),
                            "make_sharded_prefill_step")
    dev = mesh_device(mesh) if device is None else torch.device(device)
    m, r = split.m, split.r

    @torch.no_grad()
    def prefill(params: dict, tokens):
        local = {k: to_local(params[k]) for k in split.plans}
        rows = local_shard(torch.as_tensor(tokens, device=dev), mesh, tok_sh)
        t = rows.shape[1]
        if t % m:
            raise ValueError(f"{t} tokens a row do not split over {m} model ranks")
        mine = rows[:, r * (t // m):(r + 1) * (t // m)]
        logits, _, cache = transformer._forward(rank_cfg, split.view(local), mine, True,
                                                "last", attention)
        return (None if logits is None else logits[:, 0]), cache

    prefill.split = split
    return prefill


def make_sharded_decode_step(cfg: LMConfig, mesh, param_specs: dict, in_specs: dict,
                             attention: str | None = None, device=None):
    """``decode(params, tokens, positions, kv_cache) -> (logits, kv_cache)``
    on ``mesh`` (see the module docstring) for either of the reference's
    cache layouts; ``in_specs`` from ``specs.input_specs_sharding_for(cfg,
    "decode_32k" or "long_500k", ...)``."""
    cache_sh = NamedSharding(mesh, in_specs["kv_cache"]).placements()
    tok_sh = NamedSharding(mesh, in_specs["tokens"]).placements()
    pos_sh = NamedSharding(mesh, in_specs["positions"]).placements()
    rows = _row_slices(mesh, tok_sh, 0)
    if rows != _row_slices(mesh, cache_sh, 2) or rows != _row_slices(mesh, pos_sh, 0):
        raise ValueError("the tokens', positions' and cache's specs split the rows apart")
    split, rank_cfg = _plan(cfg, mesh, param_specs, rows, "make_sharded_decode_step")
    dev = mesh_device(mesh) if device is None else torch.device(device)
    # the axes that split T, major first (a DTensor shards a dimension over
    # its mesh dimensions in order), and the rank's slice among them
    names = tuple(mesh.mesh_dim_names)
    t_dims = [j for j, p in enumerate(cache_sh) if isinstance(p, Shard) and p.dim == 3]
    t_groups, n_t, t_index = axes_index(mesh, [names[j] for j in t_dims])

    @torch.no_grad()
    def decode(params: dict, tokens, positions, kv_cache):
        local = {k: to_local(params[k]) for k in split.plans}
        tok = local_shard(torch.as_tensor(tokens, device=dev), mesh, tok_sh)
        pos = local_shard(torch.as_tensor(positions, device=dev), mesh, pos_sh)
        cache = to_local(kv_cache)
        transformer.check_positions(pos, cache.shape[3] * n_t)
        att = transformer.resolve_attention(attention, tok.device)
        view = split.decode_view(local, t_groups, t_index)
        return transformer._decode(rank_cfg, view, tok, pos, cache, att), kv_cache

    decode.split = split
    decode.t_index, decode.t_slices = t_index, n_t
    return decode
