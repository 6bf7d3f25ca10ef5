"""Optimisers: AdamW and Adafactor, with global-norm clipping and the
warmup-cosine schedule of the reference (``repro.train.optimizer``).

Parameters, gradients and optimiser state are dicts of tensors keyed by the
reference's pytree paths (``"embed"``, ``"layers/wq"``, ``"cin/0"``, ...):
:func:`param_tree` gives that view of a model's ``nn.Parameter``\\ s.  The
arithmetic is the reference's, in float32, one operation at a time in its
order (so the two agree to float32 rounding on the same gradients); the
updated parameter is cast back to its dtype.  The schedule, the global norm
and the clip scale stay 0-d device tensors: an update never waits for the
device.

``opt_update`` writes the new values into the parameter tensors and the
state's tensors **in place** and returns them (the reference returns new
trees; copying a 1.6 B-parameter state every step would double its memory).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _path_key(path: str) -> tuple:
    """jax's leaf order: dict keys sorted, list items by index."""
    return tuple(int(c) if c.isdigit() else c for c in path.split("/"))


def sort_paths(tree: dict) -> dict:
    """``tree`` with its keys in the reference's leaf order."""
    return {k: tree[k] for k in sorted(tree, key=_path_key)}


def param_tree(params) -> dict[str, torch.Tensor]:
    """The parameters of a model (``nn.Module``) as ``{pytree path: tensor}``
    in the reference's leaf order (``layers.wq`` -> ``layers/wq``,
    ``blocks.0.wq`` -> ``blocks/0/wq``); a dict passes through sorted."""
    if isinstance(params, nn.Module):
        params = {name.replace(".", "/"): p for name, p in params.named_parameters()}
    return sort_paths(params)


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an int 0-d tensor) as a float32 0-d tensor."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, leaves in
    order, as a float32 0-d tensor."""
    leaves = list(tree.values())
    total = torch.sum(torch.square(leaves[0].float()))
    for leaf in leaves[1:]:
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def clip_scale(max_norm: float, norm: torch.Tensor) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree: dict, max_norm: float):
    """``({path: float32 g * scale}, norm)``, scale = min(1, max_norm / norm).
    The updates clip one leaf at a time instead (the same values, without a
    float32 copy of every gradient at once)."""
    n = global_norm(tree)
    scale = clip_scale(max_norm, n)
    return {k: g.float() * scale for k, g in tree.items()}, n


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------
def adamw_init(params: dict) -> dict:
    params = param_tree(params)
    dev = next(iter(params.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: dict, grads: dict, state: dict, gnorm=None):
    """``gnorm``: the global norm of the whole gradient when ``grads`` holds
    only this rank's shards of it (the sharded step); by default that of
    ``grads``."""
    params = param_tree(params)
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = clip_scale(cfg.clip_norm, gnorm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    sf = step.float()
    bc1 = 1 - torch.pow(_f32(b1, sf.device), sf)
    bc2 = 1 - torch.pow(_f32(b2, sf.device), sf)
    for k, p in params.items():
        g = grads[k].float() * scale  # clipped, one leaf at a time
        m = b1 * state["m"][k] + (1 - b1) * g
        v = b2 * state["v"][k] + (1 - b2) * g * g
        del g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
        state["m"][k].copy_(m)
        state["v"][k].copy_(v)
        del m, v, u
    state["step"] = step.to(state["step"].dtype)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ----------------------------------------------------------------------
# Adafactor (Shazeer & Stern): factored second moments for >= 2-D params
# ----------------------------------------------------------------------
def _factored(p: torch.Tensor) -> bool:
    return p.dim() >= 2


def adafactor_init(params: dict) -> dict:
    params = param_tree(params)
    dev = next(iter(params.values())).device

    def vrow(p):
        return torch.zeros(p.shape[:-1] if _factored(p) else p.shape, dtype=torch.float32,
                           device=p.device)

    def vcol(p):
        shape = (*p.shape[:-2], p.shape[-1]) if _factored(p) else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return {"vr": {k: vrow(p) for k, p in params.items()},
            "vc": {k: vcol(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adafactor_decay(step: torch.Tensor) -> torch.Tensor:
    """The second-moment decay at the updated ``step``."""
    return 1.0 - step.float() ** -0.8


def adafactor_leaf(cfg: OptConfig, p: torch.Tensor, g32: torch.Tensor, vr: torch.Tensor,
                   vc: torch.Tensor, decay: torch.Tensor):
    """``(u, new_vr, new_vc)`` of one whole leaf: ``g32`` its clipped float32
    gradient; the factored means run over the leaf's last two dimensions."""
    if _factored(p):
        new_vr = decay * vr + (1 - decay) * torch.mean(g32 * g32, dim=-1)
        new_vc = decay * vc + (1 - decay) * torch.mean(g32 * g32, dim=-2)
        r = new_vr / torch.clamp(torch.mean(new_vr, dim=-1, keepdim=True), min=1e-30)
        u = g32 / (torch.sqrt(r)[..., None] * torch.sqrt(new_vc)[..., None, :] + cfg.eps)
    else:
        new_vr = decay * vr + (1 - decay) * g32 * g32
        new_vc = vc
        u = g32 / (torch.sqrt(new_vr) + cfg.eps)
    return u + cfg.weight_decay * p.float(), new_vr, new_vc


@torch.no_grad()
def adafactor_update(cfg: OptConfig, params: dict, grads: dict, state: dict):
    params = param_tree(params)
    gnorm = global_norm(grads)
    scale = clip_scale(cfg.clip_norm, gnorm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    decay = adafactor_decay(step)
    for k, p in params.items():
        vr, vc = state["vr"][k], state["vc"][k]
        u, new_vr, new_vc = adafactor_leaf(cfg, p, grads[k].float() * scale, vr, vc, decay)
        p.copy_((p.float() - lr * u).to(p.dtype))
        vr.copy_(new_vr)
        vc.copy_(new_vc)
    state["step"] = step.to(state["step"].dtype)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def opt_init(cfg: OptConfig, params) -> dict:
    return adamw_init(params) if cfg.kind == "adamw" else adafactor_init(params)


def opt_update(cfg: OptConfig, params, grads: dict, state: dict):
    """One update of ``params`` (a model or a path dict) by ``grads`` (a
    path dict), in place; returns ``(params as a path dict, state,
    {"grad_norm", "lr"})``."""
    fn = adamw_update if cfg.kind == "adamw" else adafactor_update
    return fn(cfg, params, grads, state)
