"""Per-family train-step and serve-step factories (``repro.models.steps``).

``make_lm_train_step``, ``make_gnn_train_step`` and
``make_recsys_train_step`` return ``train_step(state, batch) -> (state,
metrics)`` with ``state = {"params", "opt", "step"}`` (:func:`init_state`):
``params`` the model (an ``nn.Module``), ``opt`` the optimiser state keyed
by the reference's pytree paths, ``step`` an int32 0-d tensor.  The step
takes the gradients with ``torch.autograd.grad`` and updates the
parameters and the optimiser state **in place** (clone a state before
feeding it to two steps); ``metrics`` are 0-d device tensors (the step
never waits for the device).  ``batch`` holds NumPy arrays or tensors,
moved to the parameters' device.  With ``n_micro > 1`` the LM step runs
the micro-batches one after another and sums their float32 gradients,
then divides by ``n_micro``, as the reference's scan does.

``make_lm_prefill_step(cfg)``, ``make_lm_decode_step(cfg)`` and
``make_recsys_serve_step(cfg)`` return the serving steps, run without
autograd.  For the LMs ``attention`` chooses the kernels or the plain path
(see ``transformer``); the recsys models take the kernels for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..checkpoint.checkpointer import flatten
from ..configs.base import GNNConfig, LMConfig, RecsysConfig
from ..core.device import resolve_device
from ..train.optimizer import OptConfig, opt_init, opt_update, param_tree
from . import gnn, recsys, transformer


def init_state(params, opt_cfg: OptConfig) -> dict:
    dev = next(params.parameters()).device
    return {"params": params, "opt": opt_init(opt_cfg, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


_OPT_KINDS = {frozenset({"m", "v", "step"}): "adamw",
              frozenset({"vr", "vc", "step"}): "adafactor"}


def train_state_from_reference(cfg, state: dict, device="cuda") -> dict:
    """A train state of the reference, ``{"params", "opt", "step"}`` as a
    nested dict of NumPy (or JAX) arrays, as the port's (:func:`init_state`'s
    layout), to train on here.  The optimiser is AdamW (``m``, ``v``) or
    Adafactor (``vr``, ``vc``), told apart by its keys; every leaf must have
    the path and shape of the port's own state, and is copied as it is
    (float32 optimiser state, int32 steps; the weights as the family's
    ``*_params_from_reference`` copies them)."""
    dev = resolve_device(device)
    kind = _OPT_KINDS.get(frozenset(state["opt"]))
    if kind is None:
        raise KeyError(f"reference optimiser state holds {sorted(state['opt'])}, expected "
                       f"m / v / step (AdamW) or vr / vc / step (Adafactor)")
    if isinstance(cfg, LMConfig):
        params = transformer.params_from_reference(cfg, state["params"], dev)
    elif isinstance(cfg, GNNConfig):
        params = gnn.gnn_params_from_reference(cfg, state["params"], dev)
    else:
        params = recsys.recsys_params_from_reference(cfg, state["params"], dev)
    out = init_state(params, OptConfig(kind=kind))
    want = {k: t for k, t in flatten(out).items() if not k.startswith("params/")}
    got = flatten({"opt": state["opt"], "step": state["step"]})
    if set(got) != set(want):
        raise KeyError(f"reference state leaves {sorted(set(got) ^ set(want))[:4]} do not "
                       f"match the port's")
    with torch.no_grad():
        for k, t in want.items():
            a = np.array(got[k], dtype=np.float32 if t.is_floating_point() else np.int64)
            if a.shape != tuple(t.shape):
                raise ValueError(f"{k}: reference array of shape {a.shape} for a leaf of "
                                 f"shape {tuple(t.shape)}")
            t.copy_(torch.from_numpy(a))
    return out


def _apply_update(opt_cfg: OptConfig, state: dict, grads: dict, metrics: dict):
    _, opt, extra = opt_update(opt_cfg, state["params"], grads, state["opt"])
    metrics = dict(metrics, **extra)
    return {"params": state["params"], "opt": opt, "step": state["step"] + 1}, metrics


def _on_device(batch: dict, device: torch.device) -> dict:
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                else v).to(device) for k, v in batch.items()}


def _grads(loss_fn, params, batch: dict):
    """``(loss, aux, {path: gradient})`` of one call; a parameter the loss
    does not reach gets zeros."""
    named = param_tree(params)
    loss, aux = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(named.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def _accum_grads(loss_fn, params, batch: dict, n_micro: int):
    """Gradient accumulation over ``n_micro`` slices of the leading batch
    dim: float32 sums, divided by ``n_micro``; the loss is the mean, the aux
    the last slice's."""
    if n_micro <= 1:
        return _grads(loss_fn, params, batch)
    loss_acc, grads_acc, aux = 0.0, None, None
    for i in range(n_micro):
        micro = {k: x[i * (x.shape[0] // n_micro):(i + 1) * (x.shape[0] // n_micro)]
                 for k, x in batch.items()}
        loss, aux, grads = _grads(loss_fn, params, micro)
        loss_acc = loss_acc + loss
        if grads_acc is None:
            grads_acc = {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device) + g
                         for k, g in grads.items()}
        else:
            for k, g in grads.items():
                grads_acc[k] += g
        del grads
    return loss_acc / n_micro, aux, {k: g / n_micro for k, g in grads_acc.items()}


# ----------------------------------------------------------------------
# LM
# ----------------------------------------------------------------------
_MESH_HINT = ("is a sharding constraint of the reference on activations, which the port "
              "does not shard; to train on a mesh, use "
              "repro_torch.sharding.spmd.make_sharded_train_step")


def loss_for(cfg, attention: str | None = None, count_sum=None):
    """``loss(params, batch) -> (loss, aux)``: the train loss of ``cfg``'s
    family, as the train steps take it (``attention`` and, for a rank's
    slice of an MoE batch, ``count_sum`` (``layers.moe_block``) for the
    LMs)."""
    if isinstance(cfg, LMConfig):
        def loss(params, batch):
            return transformer.loss_fn(cfg, params, batch["tokens"], batch["targets"],
                                       attention=attention, count_sum=count_sum)
    elif isinstance(cfg, GNNConfig):
        def loss(params, batch):
            return gnn.loss_fn(cfg, params, batch)
    elif isinstance(cfg, RecsysConfig):
        def loss(params, batch):
            return _recsys_loss(cfg, params, batch)
    else:
        raise TypeError(type(cfg))
    return loss


def make_lm_train_step(cfg: LMConfig, opt_cfg: OptConfig, n_micro: int = 1,
                       act_spec=None, attention: str | None = None):
    """``act_spec`` is a mesh sharding hint of the reference, refused here."""
    if act_spec is not None:
        raise NotImplementedError(f"act_spec={act_spec!r} {_MESH_HINT}")
    loss = loss_for(cfg, attention)

    def train_step(state, batch):
        batch = _on_device(batch, state["step"].device)
        l, aux, grads = _accum_grads(loss, state["params"], batch, n_micro)
        return _apply_update(opt_cfg, state, grads, {"loss": l, **aux})

    return train_step


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
# GNN
# ----------------------------------------------------------------------
def make_gnn_train_step(cfg: GNNConfig, opt_cfg: OptConfig,
                        pad_multiple: int | None = None, shard_axes=None):
    """``pad_multiple`` pads a node-level batch as the reference does
    (``gnn.pad_graph_batch``); ``shard_axes`` is a mesh hint, refused."""
    if shard_axes is not None:
        raise NotImplementedError(f"shard_axes={shard_axes!r} {_MESH_HINT}")
    loss = loss_for(cfg)

    def train_step(state, batch):
        batch = _on_device(batch, state["step"].device)
        if pad_multiple and batch["node_feat"].dim() == 2:
            batch = gnn.pad_graph_batch(batch, pad_multiple)
        l, aux, grads = _grads(loss, state["params"], batch)
        return _apply_update(opt_cfg, state, grads, {"loss": l, **aux})

    return train_step


# ----------------------------------------------------------------------
# RecSys
# ----------------------------------------------------------------------
def _recsys_loss(cfg: RecsysConfig, params, batch: dict):
    if cfg.interaction == "fm-2way":
        logits = recsys.fm_logits(cfg, params, batch["fields"])
    elif cfg.interaction == "cin":
        logits = recsys.xdeepfm_logits(cfg, params, batch["fields"])
    elif cfg.interaction == "self-attn-seq":
        pos, neg = recsys.sasrec_train_logits(cfg, params, batch["hist"], batch["labels"],
                                              batch["negatives"])
        valid = (batch["labels"] > 0).float()
        loss = -(torch.nn.functional.logsigmoid(pos)
                 + torch.nn.functional.logsigmoid(-neg)) * valid
        l = loss.sum() / torch.clamp(valid.sum(), min=1.0)
        return l, {"nll": l}
    elif cfg.interaction == "dot":
        return recsys.tt_train_loss(cfg, params, batch["user_feats"], batch["item_ids"],
                                    batch["labels"])
    else:
        raise ValueError(cfg.interaction)
    # sigmoid binary cross-entropy
    l = torch.mean(torch.nn.functional.softplus(logits) - batch["labels"] * logits)
    return l, {"nll": l}


def make_recsys_train_step(cfg: RecsysConfig, opt_cfg: OptConfig):
    loss = loss_for(cfg)

    def train_step(state, batch):
        batch = _on_device(batch, state["step"].device)
        l, aux, grads = _grads(loss, state["params"], batch)
        return _apply_update(opt_cfg, state, grads, {"loss": l, **aux})

    return train_step


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
def init_model_params(cfg, generator: torch.Generator | None, device="cuda",
                      shape_name: str | None = None):
    """Random weights of ``cfg`` drawn with ``generator`` on ``device``.  On
    ``device="meta"`` the model's shapes and dtypes alone: nothing is drawn
    (``generator`` may be ``None``) and nothing allocated."""
    if torch.device(device).type == "meta":
        return _model_skeleton(cfg, shape_name)
    if isinstance(cfg, LMConfig):
        return transformer.init_params(cfg, generator, device)
    if isinstance(cfg, GNNConfig):
        dims = cfg.shapes[shape_name or "full_graph_sm"].dims
        return gnn.init_params(cfg, generator, dims["d_feat"], dims.get("n_classes", 2),
                               device)
    if isinstance(cfg, RecsysConfig):
        init = {"fm-2way": recsys.init_fm, "cin": recsys.init_xdeepfm,
                "self-attn-seq": recsys.init_sasrec, "dot": recsys.init_two_tower}
        if cfg.interaction not in init:
            raise ValueError(cfg.interaction)
        return init[cfg.interaction](cfg, generator, device)
    raise TypeError(type(cfg))


def _model_skeleton(cfg, shape_name: str | None):
    meta = torch.device("meta")
    if isinstance(cfg, LMConfig):
        return transformer.Transformer(cfg, meta)
    if isinstance(cfg, GNNConfig):
        dims = cfg.shapes[shape_name or "full_graph_sm"].dims
        return gnn.GIN(cfg, dims["d_feat"], dims.get("n_classes", 2), meta)
    if isinstance(cfg, RecsysConfig):
        return recsys._model_class(cfg)(cfg, meta)
    raise TypeError(type(cfg))
