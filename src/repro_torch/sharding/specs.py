"""Per-architecture partition-spec rules (``repro.sharding.specs``).

The reference's rules, carried over as they are: for the same
configuration and mesh shape every function returns the reference's specs,
as :class:`~repro_torch.sharding.compat.P` tuples.  They read only the
mesh's axis sizes by name (``mesh_shape``), so a ``DeviceMesh`` and an
:class:`~repro_torch.sharding.compat.AbstractMesh` (no process group) serve
alike.

Spec trees follow the port's layout: a model's specs are ``{path: P}`` keyed
by its ``param_tree`` paths (``"layers/wq"``, ``"cin/0"``), an optimiser's
``{"m": {path: P}, "v": ..., "step": P()}`` as ``opt_init`` lays it out.
Parameter shapes come from the port's models on the ``meta`` device
(``steps.init_model_params(cfg, None, "meta")``): nothing is allocated.

Conventions (the reference's):
 * batch-like leading dims        -> data-parallel axes ("pod","data")
 * attention heads / ffn / vocab  -> "model" (tensor parallel)
 * MoE expert dim                 -> "model" (expert parallel)
 * past 2e9 parameters, d_model also over "data" (FSDP-style 2D weights)
 * decode KV caches: batch over dp when divisible, else sequence over dp;
   sequence over "model"

Every rule checks divisibility and falls back to replication.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..configs.base import GNNConfig, LMConfig, RecsysConfig
from ..train.optimizer import param_tree
from .compat import P, mesh_shape


def _div(n: int, mesh, axes) -> bool:
    if axes is None:
        return True
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    size = int(np.prod([shape[a] for a in axes]))
    return n % size == 0


def _spec(mesh, shape: tuple[int, ...], wanted: list) -> P:
    """Build a spec, dropping axes that don't divide."""
    parts = []
    for dim, axes in zip(shape, wanted):
        parts.append(axes if _div(dim, mesh, axes) else None)
    return P(*parts)


def best_div_axes(n: int, mesh, preferred) -> Any:
    """Largest (by device count) subset of ``preferred`` axes dividing n."""
    if isinstance(preferred, str):
        preferred = (preferred,)
    shape = mesh_shape(mesh)
    cands = []
    k = len(preferred)
    for mask in range(1, 1 << k):
        axes = tuple(a for i, a in enumerate(preferred) if mask >> i & 1)
        size = int(np.prod([shape[a] for a in axes]))
        if n % size == 0:
            cands.append((size, axes))
    if not cands:
        return None
    cands.sort()
    axes = cands[-1][1]
    return axes if len(axes) > 1 else axes[0]


def dp(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


# ----------------------------------------------------------------------
# LM
# ----------------------------------------------------------------------
def lm_param_specs(cfg: LMConfig, mesh, multi_pod: bool, fsdp: bool | None = None) -> dict:
    if fsdp is None:
        fsdp = cfg.n_params() > 2e9  # 2D-shard everything past toy scale
    d_axis = "data" if fsdp else None
    L = cfg.n_layers
    d, hd = cfg.d_model, cfg.head_dim
    h, kh = cfg.n_heads, cfg.n_kv_heads

    layers: dict[str, P] = {
        "attn_norm": P(None, None),
        "wq": _spec(mesh, (L, d, h * hd), [None, d_axis, "model"]),
        "wk": _spec(mesh, (L, d, kh * hd), [None, d_axis, "model"]),
        "wv": _spec(mesh, (L, d, kh * hd), [None, d_axis, "model"]),
        "wo": _spec(mesh, (L, h * hd, d), [None, "model", d_axis]),
        "ffn_norm": P(None, None),
    }
    if cfg.qk_norm:
        layers["q_norm"] = P(None, None)
        layers["k_norm"] = P(None, None)
    if cfg.moe:
        e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        layers["router"] = _spec(mesh, (L, d, e), [None, None, "model"])
        layers["w_gate"] = _spec(mesh, (L, e, d, f), [None, "model", d_axis, None])
        layers["w_up"] = _spec(mesh, (L, e, d, f), [None, "model", d_axis, None])
        layers["w_down"] = _spec(mesh, (L, e, f, d), [None, "model", None, d_axis])
        if cfg.moe.n_shared_experts:
            fs = cfg.moe.n_shared_experts * f
            layers["ws_gate"] = _spec(mesh, (L, d, fs), [None, d_axis, "model"])
            layers["ws_up"] = _spec(mesh, (L, d, fs), [None, d_axis, "model"])
            layers["ws_down"] = _spec(mesh, (L, fs, d), [None, "model", d_axis])
    else:
        f = cfg.d_ff
        layers["w_gate"] = _spec(mesh, (L, d, f), [None, d_axis, "model"])
        layers["w_up"] = _spec(mesh, (L, d, f), [None, d_axis, "model"])
        layers["w_down"] = _spec(mesh, (L, f, d), [None, "model", d_axis])

    # embed/head prefer vocab sharding; fall back to d_model when the vocab
    # doesn't divide the axis (e.g. granite's 49155)
    if _div(cfg.vocab_size, mesh, "model"):
        embed = P("model", None)
        head = P(None, "model")
    else:
        embed = _spec(mesh, (cfg.vocab_size, d), [None, "model"])
        head = _spec(mesh, (d, cfg.vocab_size), ["model", None])
    specs = {"embed": embed, **{f"layers/{k}": v for k, v in layers.items()},
             "final_norm": P(None)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = head
    return specs


def lm_input_specs_sharding(cfg: LMConfig, shape_name: str, mesh, multi_pod: bool) -> dict:
    s = cfg.shapes[shape_name]
    b = s.dims["global_batch"]
    t = s.dims["seq_len"]
    dpa = dp(multi_pod)
    if s.kind == "train":
        bspec = _spec(mesh, (b, t), [dpa, None])
        return {"tokens": bspec, "targets": bspec}
    if s.kind == "prefill":
        return {"tokens": _spec(mesh, (b, t), [dpa, None])}
    # decode: cache (L, 2, B, T, K, hd)
    nk = cfg.n_kv_heads
    if _div(b, mesh, dpa):
        cache = _spec(mesh, (cfg.n_layers, 2, b, t, nk, cfg.head_dim),
                      [None, None, dpa, "model", None, None])
        tok = _spec(mesh, (b, 1), [dpa, None])
        pos = _spec(mesh, (b,), [dpa])
    else:
        # tiny batch (long-context): split the sequence over everything
        cache = _spec(mesh, (cfg.n_layers, 2, b, t, nk, cfg.head_dim),
                      [None, None, None, (dpa if isinstance(dpa, tuple) else (dpa,)) + ("model",),
                       None, None])
        tok = P(None, None)
        pos = P(None)
    return {"tokens": tok, "positions": pos, "kv_cache": cache}


# ----------------------------------------------------------------------
# GNN
# ----------------------------------------------------------------------
def gnn_param_specs(cfg: GNNConfig, mesh, multi_pod: bool) -> dict:
    # GIN params are tiny: replicate
    specs = {f"layers/{i}/{k}": P() for i in range(cfg.n_layers)
             for k in ("w1", "b1", "w2", "b2", "eps")}
    return {**specs, "out_w": P(), "out_b": P()}


def gnn_input_specs_sharding(cfg: GNNConfig, shape_name: str, mesh, multi_pod: bool) -> dict:
    s = cfg.shapes[shape_name]
    dpa = dp(multi_pod)
    full = (dpa if isinstance(dpa, tuple) else (dpa,)) + ("model",)
    if s.kind == "graph_batch":
        b = s.dims["batch"]
        ba = best_div_axes(b, mesh, full)
        return {
            "node_feat": P(ba, None, None),
            "edge_src": P(ba, None),
            "edge_dst": P(ba, None),
            "labels": P(ba),
            "train_mask": P(ba),
        }
    d = s.dims
    n = d["n_nodes"] if s.kind == "graph_full" else None
    if s.kind == "graph_mini":
        b = d["batch_nodes"]
        f1, f2 = d["fanout"]
        n = b + b * f1 + b * f1 * f2
        e = b * f1 + b * f1 * f2
    else:
        e = d["n_edges"]
    nl = n if s.kind == "graph_full" else d["batch_nodes"]
    na, ea, la = (best_div_axes(x, mesh, full) for x in (n, e, nl))
    return {
        "node_feat": P(na, None),
        "edge_src": P(ea),
        "edge_dst": P(ea),
        "labels": P(la),
        "train_mask": P(la),
    }


# ----------------------------------------------------------------------
# RecSys
# ----------------------------------------------------------------------
def is_recsys_table(name: str, ndim: int) -> bool:
    """Whether the recsys leaf ``name`` of ``ndim`` dimensions is a table the
    models look rows up in: a ``*table*`` or ``item_emb`` leaf, or the 1-D
    ``linear``."""
    return "table" in name or "item_emb" in name or ("linear" in name and ndim == 1)


def recsys_param_specs(cfg: RecsysConfig, params_shape, mesh, multi_pod: bool) -> dict:
    """Tables row-sharded over 'model' where the rows divide; MLPs
    replicated.  Built from the parameter *shapes* (a model on ``meta``, or
    ``{path: tensor}``)."""

    def rule(name: str, leaf) -> P:
        if is_recsys_table(name, len(leaf.shape)) and _div(leaf.shape[0], mesh, "model"):
            return P("model", *([None] * (len(leaf.shape) - 1)))
        return P(*([None] * len(leaf.shape)))

    return {k: rule(k, v) for k, v in param_tree(params_shape).items()}


def recsys_input_specs_sharding(cfg: RecsysConfig, shape_name: str, mesh, multi_pod: bool) -> dict:
    s = cfg.shapes[shape_name]
    b = s.dims["batch"]
    dpa = dp(multi_pod)
    full = (dpa if isinstance(dpa, tuple) else (dpa,)) + ("model",)
    baxes = dpa if _div(b, mesh, dpa) else None
    out: dict[str, Any] = {}
    specs = cfg.input_specs(shape_name)
    for k, v in specs.items():
        if k == "candidates":
            # candidate set sharded as widely as divisibility allows
            ca = best_div_axes(v.shape[0], mesh, full)
            out[k] = P(ca, *([None] * (len(v.shape) - 1)))
        elif v.shape and v.shape[0] == b:
            out[k] = _spec(mesh, tuple(v.shape), [baxes] + [None] * (len(v.shape) - 1))
        else:
            out[k] = P(*([None] * len(v.shape)))
    return out


# ----------------------------------------------------------------------
# dispatch
# ----------------------------------------------------------------------
def param_specs_for(cfg, params_shape, mesh, multi_pod: bool) -> dict:
    if isinstance(cfg, LMConfig):
        return lm_param_specs(cfg, mesh, multi_pod)
    if isinstance(cfg, GNNConfig):
        return {k: P() for k in param_tree(params_shape)}
    if isinstance(cfg, RecsysConfig):
        return recsys_param_specs(cfg, params_shape, mesh, multi_pod)
    raise TypeError(type(cfg))


def uihrdc_input_specs_sharding(cfg, shape_name: str, mesh, multi_pod: bool) -> dict:
    b = cfg.shapes[shape_name].dims["batch"]
    dpa = dp(multi_pod)
    ba = dpa if _div(b, mesh, dpa) else None
    return {"query_terms": P(ba, None), "query_lens": P(ba)}


def input_specs_sharding_for(cfg, shape_name: str, mesh, multi_pod: bool) -> dict:
    if getattr(cfg, "family", "") == "index":
        return uihrdc_input_specs_sharding(cfg, shape_name, mesh, multi_pod)
    if isinstance(cfg, LMConfig):
        return lm_input_specs_sharding(cfg, shape_name, mesh, multi_pod)
    if isinstance(cfg, GNNConfig):
        return gnn_input_specs_sharding(cfg, shape_name, mesh, multi_pod)
    if isinstance(cfg, RecsysConfig):
        return recsys_input_specs_sharding(cfg, shape_name, mesh, multi_pod)
    raise TypeError(type(cfg))


def opt_state_specs(param_specs: dict, opt_state_shape: dict) -> dict:
    """Optimizer slots share their parameter's spec (Adafactor's factored
    ``vr`` / ``vc`` drop the dimension they average over); scalars
    replicated.  ``opt_state_shape`` is ``opt_init``'s state (or its
    ``meta`` twin)."""
    specs = {}
    for k, v in opt_state_shape.items():
        if k == "step":
            specs[k] = P()
        elif k in ("m", "v"):
            specs[k] = dict(param_specs)
        elif k == "vr":
            specs[k] = {p: P(*_drop_last(ps, v[p])) for p, ps in param_specs.items()}
        elif k == "vc":
            specs[k] = {p: _vc_spec(ps, v[p]) for p, ps in param_specs.items()}
        else:
            specs[k] = {p: P() for p in v} if isinstance(v, dict) else P()
    return specs


def _drop_last(ps: P, shape_leaf) -> tuple:
    ndim = len(shape_leaf.shape)
    parts = list(ps) + [None] * (ndim + 1 - len(list(ps)))
    return tuple(parts[:ndim])


def _vc_spec(ps: P, shape_leaf) -> P:
    ndim = len(shape_leaf.shape)
    parts = list(ps)
    if ndim == 1 and len(parts) == 0:
        return P(None)
    if len(parts) >= 2:
        keep = tuple(parts[:-2]) + (parts[-1],)
        return P(*keep[:ndim])
    return P(*([None] * ndim))
