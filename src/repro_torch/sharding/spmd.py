"""The sharded train step: the counterpart of the reference's
``jax.jit(train_step, in_shardings=..., out_shardings=...)``.

A sharded state is ``checkpointer.reshard``'s: the state of
:func:`~repro_torch.models.steps.init_state` with every leaf a DTensor
placed by the reference's specs (:mod:`.specs`), the model as ``{path:
DTensor}``.  :func:`make_sharded_train_step` returns
``train_step(state, batch) -> (state, metrics)``, run by every rank with the
same whole batch, which on each rank:

1. gathers the parameters (``full_tensor``) into a working model of plain
   tensors on the rank's device, so that no kernel sees a DTensor;
2. takes the rank's slice of the batch along the axes ``batch_specs`` name;
3. computes the loss and the gradients with the family's own loss
   (``steps.loss_for``, the kernels under autograd on a GPU);
4. sums the float32 gradients over the ranks that hold other slices, each
   rank's weighted by its share of the loss's normaliser (tokens, rows, or
   the mask's count where the loss masks), so the result is the whole
   batch's gradient;
5. updates its own shards of the parameters and of the optimiser slots in
   place, with the global norm and the clip scale of the summed gradient;
   AdamW elementwise on the shards, Adafactor from whole tensors (its
   factored means reduce over dimensions a spec may shard: the slots,
   small, are gathered, the update computed whole and sliced).

Compute is data-parallel over gathered weights: the model axis stores
shards but splits no compute, where the reference's GSPMD also splits the
products along ``"model"``.  A loss that does not split over examples is
computed whole on every rank, the batch not sliced: a node-level GNN batch
(one graph) and the two-tower model's in-batch softmax.

An MoE model keeps the unsharded step's routing.  Its capacity is per token
group (``cfg.moe_groups`` contiguous groups of a micro-batch), so each rank
takes its slice of every micro-batch, which is ``moe_groups / n`` whole
groups of it for ``n`` batch slices, and dispatches them as such; the
router's auxiliary loss takes the load fractions of the whole micro-batch
(its choice counts summed over the ranks in the forward).  ``moe_groups``
must be a multiple of ``n``, as the reference's dry-run makes it (one group
a data shard).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from ..configs.base import GNNConfig, LMConfig
from ..models import steps
from ..train.optimizer import (
    OptConfig,
    adafactor_decay,
    adafactor_leaf,
    adamw_update,
    clip_scale,
    global_norm,
    opt_init,
    param_tree,
    schedule,
)
from .compat import (NamedSharding, P, flatten_specs, local_shard, mesh_device,
                     require_device_mesh)
from .specs import opt_state_specs, param_specs_for


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


def _loss_count(cfg, batch: dict):
    """The normaliser of the family's loss on ``batch`` (a float32 0-d
    tensor), or ``None`` when the loss does not split over examples."""
    if isinstance(cfg, LMConfig):
        t = batch["targets"]
        return torch.tensor(float(t.numel()), device=t.device)  # the mean over tokens
    if isinstance(cfg, GNNConfig):
        if batch["node_feat"].dim() != 3:
            return None  # one graph: its nodes are not independent examples
        return batch["train_mask"].float().sum()
    if cfg.interaction == "dot":
        return None  # in-batch softmax over the whole batch
    if cfg.interaction == "self-attn-seq":
        return (batch["labels"] > 0).float().sum()
    t = batch["labels"]
    return torch.tensor(float(t.shape[0]), device=t.device)  # the mean over rows


def make_sharded_train_step(cfg, opt_cfg: OptConfig, mesh, state_specs: dict,
                            batch_specs: dict, n_micro: int = 1,
                            shape_name: str | None = None, attention: str | None = None,
                            device=None):
    """``train_step(state, batch) -> (state, metrics)`` on ``mesh`` for a
    state placed by ``state_specs`` (see the module docstring).  ``batch``
    is the whole batch (NumPy arrays or tensors), the same on every rank;
    ``batch_specs`` holds a spec for each of its leaves.  ``n_micro``
    (LMs) accumulates over the rank's slices of the unsharded step's
    micro-batches; ``shape_name`` picks a GNN's input width.  The loss
    takes the kernels on a card (``steps.loss_for``; ``attention`` names
    the LMs' route).  ``device`` is the working model's device, the mesh's
    by default; the dry-run passes ``"meta"`` with a ``meta`` state and
    batch, so that nothing is allocated.  The state and the
    metrics are those of the unsharded step: the state is updated in place
    and returned with ``step`` one higher.  ``train_step.grads(state, batch)``
    runs steps 1-4 alone and returns ``(gradients, metrics)``;
    ``train_step.work`` is the working model of step 1."""
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
    groups = [mesh.get_group(names[m]) for m in batch_dims]
    n_slices = math.prod(mesh.size(m) for m in batch_dims)

    def _reduce(t: torch.Tensor) -> torch.Tensor:
        for g in groups:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
        return t

    loss_fn = steps.loss_for(cfg, attention)
    moe = isinstance(cfg, LMConfig) and cfg.moe is not None
    if moe and n_slices > 1:  # see the module docstring
        if cfg.moe_groups % n_slices:
            raise ValueError(f"moe_groups={cfg.moe_groups} is not a multiple of the "
                             f"{n_slices} batch slices: a rank's slice would not hold whole "
                             f"token groups, and its expert capacity would not be the "
                             f"unsharded step's; set moe_groups to the data ranks")
        loss_fn = steps.loss_for(dataclasses.replace(cfg, moe_groups=cfg.moe_groups // n_slices),
                                 attention, count_sum=_reduce)
    work = steps.init_model_params(cfg, None, "meta", shape_name).to_empty(device=dev)
    work_params = param_tree(work)
    if set(work_params) != set(param_sh):
        raise KeyError(f"state specs for {sorted(set(param_sh) ^ set(work_params))[:4]} do "
                       f"not match the model's parameters")

    def grads(state: dict, batch: dict):
        """Steps 1-4: ``({path: float32 gradient of the whole batch},
        metrics)``, the same on every rank."""
        params = state["params"]
        with torch.no_grad():  # 1. the whole parameters, on every rank
            for k, p in work_params.items():
                p.copy_(params[k].full_tensor())
        whole = steps._on_device(batch, dev)
        missing = sorted(set(whole) - set(batch_sh))
        if missing:
            raise KeyError(f"batch leaves {missing} have no spec in batch_specs")
        split = bool(groups) and _loss_count(cfg, whole) is not None
        local = _slice(whole, n_micro, mesh, batch_sh) if split else whole  # 2.
        del whole
        loss, aux, g = steps._accum_grads(loss_fn, work, local, n_micro)  # 3.
        metrics = {"loss": loss, **aux}
        with torch.no_grad():  # 4. the whole batch's gradient on every rank
            if not split:
                return {k: v.float() for k, v in g.items()}, metrics
            count = _loss_count(cfg, local)
            total = _reduce(count.clone())
            w = torch.clamp(count, min=1.0) / torch.clamp(total, min=1.0)
            g = {k: _reduce(v.float() * w) for k, v in g.items()}
            vals = _reduce(torch.stack([v.float() for v in metrics.values()]) * w)
        return g, dict(zip(metrics, vals.unbind()))

    def train_step(state: dict, batch: dict):
        g, metrics = grads(state, batch)
        with torch.no_grad():
            extra = _update(opt_cfg, state, g, global_norm(g), work_params, param_sh, mesh)
        del g
        step = state["step"]
        new_step = DTensor.from_local(step.to_local() + 1, mesh, step.placements,
                                      run_check=False)
        return ({"params": state["params"], "opt": state["opt"], "step": new_step},
                {**metrics, **extra})

    train_step.grads = grads
    train_step.work = work
    return train_step


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


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _update(opt_cfg: OptConfig, state: dict, grads: dict, gnorm, work_params: dict,
            param_sh: dict, mesh) -> dict:
    """5. this rank's shards of the parameters and the slots, in place."""
    params, opt = state["params"], state["opt"]
    step_t = opt["step"]
    if opt_cfg.kind == "adamw":
        local_grads = {k: local_shard(g, mesh, param_sh[k]) for k, g in grads.items()}
        local_opt = {"m": {k: _local(v) for k, v in opt["m"].items()},
                     "v": {k: _local(v) for k, v in opt["v"].items()},
                     "step": _local(step_t)}
        _, local_opt, extra = adamw_update(opt_cfg, {k: _local(p) for k, p in params.items()},
                                           local_grads, local_opt, gnorm=gnorm)
        _local(step_t).copy_(local_opt["step"])
        return extra
    scale = clip_scale(opt_cfg.clip_norm, gnorm)
    step = _local(step_t) + 1
    lr = schedule(opt_cfg, step)
    decay = adafactor_decay(step)
    for k, g in grads.items():
        vr, vc = opt["vr"][k], opt["vc"][k]
        whole_vr = vr.full_tensor() if isinstance(vr, DTensor) else vr
        whole_vc = vc.full_tensor() if isinstance(vc, DTensor) else vc
        u, new_vr, new_vc = adafactor_leaf(opt_cfg, work_params[k], g * scale, whole_vr,
                                           whole_vc, decay)
        p = _local(params[k])
        p.copy_((p.float() - lr * local_shard(u, mesh, param_sh[k])).to(p.dtype))
        for slot, new in ((vr, new_vr), (vc, new_vc)):
            if isinstance(slot, DTensor):
                slot.to_local().copy_(local_shard(new, mesh, slot.placements))
            else:
                slot.copy_(new)
    _local(step_t).copy_(step.to(step_t.dtype))
    return {"grad_norm": gnorm, "lr": lr}
