"""The sharded train step: the counterpart of the reference's
``jax.jit(train_step, in_shardings=..., out_shardings=...)``.

A sharded state is ``checkpointer.reshard``'s: the state of
:func:`~repro_torch.models.steps.init_state` with every leaf a DTensor
placed by the reference's specs (:mod:`.specs`), the model as ``{path:
DTensor}``.  :func:`make_sharded_train_step` returns
``train_step(state, batch) -> (state, metrics)``, run by every rank with the
same whole batch.

**LMs** split their compute over the mesh as the reference's GSPMD does
(:mod:`.lm_split`): each rank takes its rows of every micro-batch (the data
axes) and its T / m tokens of them (the model axis), computes its heads,
its FFN columns and its experts between gathers and reduce-scatters along
T, gathers each layer's weights over ``"data"`` where the spec shards them
there (FSDP, inside the checkpointed layer), and never gathers a whole
stacked weight: ``full_tensor`` is called on no parameter.  Each rank's loss
is weighted by its share of the tokens before its backward, so the
collectives' backwards sum the whole batch's gradient; it lands, in float32,
in the rank's shards (the gathers' backwards reduce-scatter it), and a leaf
replicated on an axis is then all-reduced over that axis.  Float32
gradients are held only as those shards plus one layer's transient.

**Recsys models** split their lookups (:mod:`.recsys_split`): each rank
takes its rows of the batch (the data axes), looks them up on its shards
of the tables row-sharded over ``"model"`` (``embedding_bag``'s shard
mode), sums the partials over ``"model"`` and runs the rest of the model on
its rows; two-tower's in-batch softmax scores the rank's users against the
whole batch's items, gathered over the data axes.  Every model rank of a
data slice computes the same loss, so each gradient (a table's shard, or a
replicated leaf) is summed over the data axes only.  **The GIN**
(:mod:`.gnn_split`) splits a node-level graph's nodes and edges over every
mesh axis after the reference's padding (each layer's ``h @ w1`` gathered,
its messages' partial sums reduce-scattered), and a batch of small graphs
by examples; its replicated weights' gradients are summed over the axes
that split the batch.  Both weight each rank's loss by its share of the
loss's normaliser (rows, or the mask's count where the loss masks) before
the backward, so that the collectives' backwards sum the whole batch's
gradient, and call ``full_tensor`` on no parameter.

The update is the same for both, on the rank's shards alone: the global
norm sums each element once (a leaf replicated over ranks counts once, not
once a replica); AdamW updates the shards of the parameters and of its
slots elementwise in place; Adafactor's factored means run over dimensions
a spec may shard, so each is the rank's partial sum all-reduced over the
ranks that shard that dimension (its slots' specs drop the dimension they
average over, so their shards line up with the gradient's): no gradient or
slot is gathered (one kimi-k2 expert leaf's float32 gradient alone is
1.28 TB).

An MoE model keeps the unsharded step's routing.  Its capacity is per token
group (``cfg.moe_groups`` contiguous groups of a micro-batch), so each rank
takes its slice of every micro-batch, which is ``moe_groups / n`` whole
groups of it for ``n`` batch slices, and dispatches them as such (the
model ranks of a slice gather its tokens); the router's auxiliary loss
takes the load fractions of the whole micro-batch (its choice counts summed
over the ranks in the forward).  ``moe_groups`` must be a multiple of ``n``,
as the reference's dry-run makes it (one group a data shard).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import GNNConfig, LMConfig
from ..models import steps
from ..train.optimizer import (
    OptConfig,
    adafactor_decay,
    adafactor_direction,
    adamw_update,
    clip_scale,
    opt_init,
    param_tree,
    schedule,
    sort_paths,
)
from . import gnn_split, recsys_split, tp
from .compat import (NamedSharding, P, flatten_specs, local_shard, mesh_device,
                     require_device_mesh, to_local)
from .lm_split import LMSplit
from .specs import gnn_input_specs_sharding, opt_state_specs, param_specs_for


def state_specs_for(cfg, state: dict, mesh, multi_pod: bool = False) -> dict:
    """``{"params", "opt", "step"}`` specs of ``state`` (an unsharded state,
    or its ``meta`` twin) as the reference builds them."""
    pspecs = param_specs_for(cfg, state["params"], mesh, multi_pod)
    return {"params": pspecs, "opt": opt_state_specs(pspecs, state["opt"]), "step": P()}


def meta_state(cfg, opt_cfg: OptConfig, shape_name: str | None = None) -> dict:
    """An unsharded train state's shapes, on ``meta``."""
    params = steps.init_model_params(cfg, None, "meta", shape_name)
    return {"params": params, "opt": opt_init(opt_cfg, params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def _loss_count(cfg, batch: dict) -> torch.Tensor:
    """The normaliser of the recsys loss on ``batch``, the rank's rows (a
    float32 0-d tensor): its rows, or its labelled positions (SASRec)."""
    if cfg.interaction == "self-attn-seq":
        return (batch["labels"] > 0).float().sum()
    key = "user_feats" if cfg.interaction == "dot" else "labels"
    return torch.tensor(float(batch[key].shape[0]), device=batch[key].device)


def make_sharded_train_step(cfg, opt_cfg: OptConfig, mesh, state_specs: dict,
                            batch_specs: dict, n_micro: int = 1,
                            shape_name: str | None = None, attention: str | None = None,
                            device=None, shard_axes=None, pad_multiple: int | None = None,
                            shapes: dict | None = None):
    """``train_step(state, batch) -> (state, metrics)`` on ``mesh`` for a
    state placed by ``state_specs`` (see the module docstring).  ``batch``
    is the whole batch (NumPy arrays or tensors), the same on every rank;
    ``batch_specs`` holds a spec for each of its leaves.  ``n_micro``
    (LMs) accumulates over the rank's slices of the unsharded step's
    micro-batches; ``shape_name`` picks a GNN's input width (and, for a
    ``graph_mini`` shape, its seed labels' axes); ``shapes`` gives each
    leaf's whole shape instead.  A GIN's node-level graph is padded to
    ``pad_multiple`` (default: the ranks of ``shard_axes``) and split over
    ``shard_axes`` (default: every mesh axis), as the reference's dry-run
    builds its step.  The loss
    takes the kernels on a card (``steps.loss_for``; ``attention`` names
    the LMs' route).  ``device`` is the rank's compute device, the mesh's
    by default; the dry-run passes ``"meta"`` with a ``meta`` state and
    batch, so that nothing is allocated.  The state and the metrics are
    those of the unsharded step: the state is updated in place and returned
    with ``step`` one higher.  ``train_step.grads(state, batch)`` returns
    ``({path: this rank's float32 shard of the whole batch's gradient},
    metrics)`` without updating; ``train_step.split`` is the LM's
    :class:`~.lm_split.LMSplit`, the recsys model's
    :class:`~.recsys_split.RecsysPlan` or the GIN's
    :class:`~.gnn_split.GraphSplit`."""
    require_device_mesh(mesh, "make_sharded_train_step")
    if n_micro > 1 and not isinstance(cfg, LMConfig):
        raise ValueError(f"n_micro={n_micro}: only the LM step accumulates micro-batches")
    dev = mesh_device(mesh) if device is None else torch.device(device)
    flat_specs = flatten_specs(state_specs)
    param_sh = {k[len("params/"):]: NamedSharding(mesh, v).placements()
                for k, v in flat_specs.items() if k.startswith("params/")}
    batch_sh = {k: NamedSharding(mesh, v).placements()
                for k, v in flatten_specs(batch_specs).items()}
    # the mesh dimensions that slice the batch (those of size 1 too: a world
    # of one runs the same reduction, as the identity)
    names = tuple(mesh.mesh_dim_names)
    batch_dims = sorted({m for pl in batch_sh.values() for m, x in enumerate(pl)
                         if not isinstance(x, Replicate)})
    n_slices = math.prod(mesh.size(m) for m in batch_dims)
    if shapes is None:
        shapes = {k: tuple(p.shape) for k, p in
                  param_tree(steps.init_model_params(cfg, None, "meta", shape_name)).items()}
    if set(shapes) != set(param_sh):
        raise KeyError(f"state specs for {sorted(set(param_sh) ^ set(shapes))[:4]} do "
                       f"not match the model's parameters")

    moe = isinstance(cfg, LMConfig) and cfg.moe is not None
    rank_cfg = cfg
    if moe and n_slices > 1:  # see the module docstring
        if cfg.moe_groups % n_slices:
            raise ValueError(f"moe_groups={cfg.moe_groups} is not a multiple of the "
                             f"{n_slices} batch slices: a rank's slice would not hold whole "
                             f"token groups, and its expert capacity would not be the "
                             f"unsharded step's; set moe_groups to the data ranks")
        rank_cfg = dataclasses.replace(cfg, moe_groups=cfg.moe_groups // n_slices)
    if isinstance(cfg, LMConfig):
        grads = _lm_grads(rank_cfg, mesh, param_sh, batch_sh, shapes, n_micro, attention, dev)
    elif isinstance(cfg, GNNConfig):
        label_axes = None
        if shape_name is not None and cfg.shapes[shape_name].kind == "graph_mini":
            label_axes = gnn_input_specs_sharding(cfg, shape_name, mesh, "pod" in names)["labels"]
            label_axes = label_axes[0] if len(label_axes) else None
        axes = names if shard_axes is None else shard_axes
        n = math.prod(mesh.size(names.index(a)) for a in
                      ((axes,) if isinstance(axes, str) else axes))
        grads = gnn_split.make_split_grads(cfg, mesh, axes, pad_multiple or n, batch_sh,
                                           label_axes, dev)
    else:
        grads = _recsys_grads(cfg, mesh, param_sh, batch_sh, dev)
    split = grads.split

    def train_step(state: dict, batch: dict):
        g, metrics = grads(state, batch)
        with torch.no_grad():
            extra = _update(opt_cfg, state, g, sharded_norm(g, param_sh, mesh), param_sh,
                            shapes, mesh)
        del g
        step = state["step"]
        new_step = DTensor.from_local(step.to_local() + 1, mesh, step.placements,
                                      run_check=False)
        return ({"params": state["params"], "opt": state["opt"], "step": new_step},
                {**metrics, **extra})

    train_step.grads = grads
    train_step.split = split
    return train_step


def _recsys_grads(cfg, mesh, param_sh: dict, batch_sh: dict, dev):
    """A recsys model's gradients, split over the mesh (:mod:`.recsys_split`):
    the rank's rows of the batch on its table shards, each gradient summed
    over the data axes."""
    plan = recsys_split.RecsysPlan(cfg, mesh, param_sh)
    row_groups, row_index = recsys_split.row_split(mesh, batch_sh)
    loss_fn = recsys_split.loss_for(cfg, row_groups, row_index)
    groups = plan.data_groups  # the batch's slices (a world of one: the identity)

    def grads(state: dict, batch: dict):
        params = state["params"]
        leaves = {k: to_local(params[k]).detach().requires_grad_() for k in sort_paths(param_sh)}
        rows = _slice(_batch_on(batch, batch_sh, dev), 1, mesh, batch_sh)
        count = _loss_count(cfg, rows)
        total = tp.sum_into(count.clone(), groups)
        w = torch.clamp(count, min=1.0) / torch.clamp(total, min=1.0)
        loss, aux = loss_fn(plan.view(leaves), rows)
        g = torch.autograd.grad(loss * w, list(leaves.values()), allow_unused=True)
        with torch.no_grad():
            g = {k: tp.sum_into(torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                if v is None else v.float(), groups)
                 for (k, p), v in zip(leaves.items(), g)}
            metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
            vals = tp.sum_into(torch.stack([v.float() for v in metrics.values()]) * w, groups)
        return g, dict(zip(metrics, vals.unbind()))

    grads.split = plan
    return grads


def _batch_on(batch: dict, batch_sh: dict, dev) -> dict:
    whole = steps._on_device(batch, dev)
    missing = sorted(set(whole) - set(batch_sh))
    if missing:
        raise KeyError(f"batch leaves {missing} have no spec in batch_specs")
    return whole


def _lm_grads(cfg, mesh, param_sh: dict, batch_sh: dict, shapes: dict, n_micro: int,
              attention, dev):
    """An LM's gradients, split over the mesh (:mod:`.lm_split`)."""
    names = tuple(mesh.mesh_dim_names)
    data_dims = [j for j, a in enumerate(names) if a != "model"]
    for j in data_dims:
        for k, pl in batch_sh.items():
            if not (isinstance(pl[j], Shard) and pl[j].dim == 0):
                raise ValueError(f"batch leaf {k}'s spec does not split its rows over "
                                 f"{names[j]!r}: the LM step splits the batch over every "
                                 f"data axis")
    split = LMSplit(cfg, mesh, param_sh, shapes)
    every = [split.groups[a] for a in names]
    loss_fn = steps.loss_for(cfg, attention,
                             count_sum=lambda t: tp.sum_into(t, split.count_groups))
    m, r = split.m, split.r

    def grads(state: dict, batch: dict):
        params = state["params"]
        # the leaves in the reference's order, which global_norm's sum follows
        local = {k: to_local(params[k]) for k in sort_paths(param_sh)}
        sinks = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                 for k, v in local.items()}
        anchor = torch.zeros((), device=dev, requires_grad=True)
        rows = _slice(_batch_on(batch, batch_sh, dev), n_micro, mesh, batch_sh)
        per = rows["tokens"].shape[0] // n_micro
        t = rows["tokens"].shape[1]
        if t % m:
            raise ValueError(f"{t} tokens a row do not split over {m} model ranks")
        cols = slice(r * (t // m), (r + 1) * (t // m))
        loss_acc, aux, w = 0.0, {}, None
        for i in range(n_micro):
            micro = {k: v[i * per:(i + 1) * per, cols] for k, v in rows.items()}
            count = torch.tensor(float(micro["targets"].numel()), device=dev)
            total = tp.sum_into(count.clone(), every)
            w = torch.clamp(count, min=1.0) / torch.clamp(total, min=1.0)
            loss, aux = loss_fn(split.view(local, sinks, anchor), micro)
            (loss * w).backward()
            loss_acc = loss_acc + loss.detach()
            aux = {k: v.detach() for k, v in aux.items()}
        with torch.no_grad():
            if n_micro > 1:
                sinks = {k: g / n_micro for k, g in sinks.items()}
            for k, g in sinks.items():  # a leaf replicated on an axis: summed over it
                for j, p in enumerate(param_sh[k]):
                    if not isinstance(p, Shard):
                        tp.sum_into(g, [split.groups[names[j]]])
            metrics = {"loss": loss_acc / n_micro if n_micro > 1 else loss_acc, **aux}
            vals = tp.sum_into(torch.stack([v.float() for v in metrics.values()]) * w, every)
        return sinks, dict(zip(metrics, vals.unbind()))

    grads.split = split
    return grads


def sharded_norm(grads: dict, param_sh: dict, mesh) -> torch.Tensor:
    """The global norm of a gradient held as each rank's shards: each leaf's
    sum of squares over its shard, counted on one replica of it (the rank at
    coordinate 0 of every axis the leaf is replicated on), summed over the
    mesh, then the leaves summed in order as ``optimizer.global_norm`` sums
    them."""
    names = tuple(mesh.mesh_dim_names)
    coords = [mesh.get_local_rank(a) for a in names]
    sums = []
    for k, g in grads.items():
        sq = torch.sum(torch.square(g.float()))
        if any(c and not isinstance(p, Shard) for c, p in zip(coords, param_sh[k])):
            sq = torch.zeros_like(sq)
        sums.append(sq)
    sums = tp.sum_into(torch.stack(sums), [mesh.get_group(a) for a in names])
    total = sums[0]
    for i in range(1, len(sums)):
        total = total + sums[i]
    return torch.sqrt(total)


def _slice(batch: dict, n_micro: int, mesh, batch_sh: dict) -> dict:
    """The rank's slice of each of the ``n_micro`` micro-batches, in order:
    its i-th micro-batch is a slice of the unsharded step's i-th."""
    if n_micro == 1:
        return {k: local_shard(v, mesh, batch_sh[k]) for k, v in batch.items()}
    rows = batch["tokens"].shape[0]
    if rows % n_micro:
        raise ValueError(f"{rows} rows do not split into {n_micro} micro-batches")
    m = rows // n_micro
    parts = [{k: local_shard(v[i * m:(i + 1) * m], mesh, batch_sh[k]) for k, v in batch.items()}
             for i in range(n_micro)]
    return {k: torch.cat([p[k] for p in parts]) for k in batch}


def _adafactor_shard(opt_cfg: OptConfig, g32: torch.Tensor, vr: torch.Tensor,
                     vc: torch.Tensor, decay: torch.Tensor, placements, shape: tuple, mesh):
    """``optimizer.adafactor_direction`` of one leaf from this rank's shard of
    its clipped float32 gradient and of its slots (whose specs drop the
    leaf's last / second-to-last dimension, so their shards line up with
    the gradient's): each factored mean over a dimension that ranks shard
    is a local sum all-reduced over them, divided by the whole length."""

    def mean(x, dim: int, leaf_dim: int, keepdim: bool = False):
        groups = [mesh.get_group(j) for j, p in enumerate(placements)
                  if isinstance(p, Shard) and p.dim == leaf_dim]
        if not groups:
            return torch.mean(x, dim=dim, keepdim=keepdim)
        return tp.sum_into(torch.sum(x, dim=dim, keepdim=keepdim), groups) / shape[leaf_dim]

    return adafactor_direction(g32, vr, vc, decay, len(shape) >= 2, opt_cfg.eps, mean)


def _update(opt_cfg: OptConfig, state: dict, grads: dict, gnorm, param_sh: dict,
            shapes: dict, mesh) -> dict:
    """This rank's shards of the parameters and the slots, in place, from its
    float32 gradient shards ``grads`` (``shapes``: each leaf's whole shape)."""
    params, opt = state["params"], state["opt"]
    step_t = opt["step"]
    if opt_cfg.kind == "adamw":
        local_opt = {"m": {k: to_local(v) for k, v in opt["m"].items()},
                     "v": {k: to_local(v) for k, v in opt["v"].items()},
                     "step": to_local(step_t)}
        _, local_opt, extra = adamw_update(opt_cfg, {k: to_local(p) for k, p in params.items()},
                                           grads, local_opt, gnorm=gnorm)
        to_local(step_t).copy_(local_opt["step"])
        return extra
    scale = clip_scale(opt_cfg.clip_norm, gnorm)
    step = to_local(step_t) + 1
    lr = schedule(opt_cfg, step)
    decay = adafactor_decay(step)
    for k, g in grads.items():
        vr, vc = to_local(opt["vr"][k]), to_local(opt["vc"][k])
        u, new_vr, new_vc = _adafactor_shard(opt_cfg, g * scale, vr, vc, decay, param_sh[k],
                                             shapes[k], mesh)
        p = to_local(params[k])
        u = u + opt_cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
        vr.copy_(new_vr)
        vc.copy_(new_vc)
    to_local(step_t).copy_(step.to(step_t.dtype))
    return {"grad_norm": gnorm, "lr": lr}
