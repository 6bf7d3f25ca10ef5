"""The LM's split train step (``repro_torch.sharding.{tp, lm_split}`` under
``spmd.make_sharded_train_step``) across eight gloo ranks on the CPU, on the
meshes (4, 2), (2, 4) and (1, 8) of ``("data", "model")``.

One spawned run for the module, as ``tests/test_torch_distributed.py``
runs its ranks (one thread each, through ``tests/torch_ranks.py``).  Each rank runs, on each mesh, reduced configs that hit the
split's traps, every case against the port's unsharded step
(``steps.make_lm_train_step``) on the whole batch, float32, plain path,
remat ``"block"`` (every config's default):

* ``qk_kv`` — qwen3-8b reduced to 8 heads on 2 kv heads (qk-norm): fewer kv
  heads than model ranks on (2, 4) and (1, 8), so a rank's column shard of
  ``wk`` / ``wv`` is part of a kv head and the rank gathers the kv head its
  q heads read;
* ``ragged`` — 6 heads of 16 on 3 kv heads (12 of 8 on 6 on (1, 8)): on
  (4, 2) a rank's q heads share their kv heads unevenly (k and v repeated to
  one kv head a q head), on (2, 4) and (1, 8) 1.5 q heads a model rank;
* ``vocab`` — a vocabulary of 509 rows, which divides no model axis: embed
  and head fall back to sharding ``d_model``;
* ``moe`` — moonshot reduced to E = 8 experts, top-2, in 4 token groups over
  2 micro-batches (on (2, 4): 2 experts a model rank, capacity drops);
* ``fsdp`` / ``nofsdp`` — granite reduced with ``lm_param_specs(fsdp=)``
  forced on (every layer weight gathered over ``"data"`` inside the layer)
  and off, AdamW; ``adafactor`` — the same forced on, Adafactor.

Limits, argued from the order of the sums before any run: the split step
computes every product of the unsharded step on the same operands, but sums
some of them in other groups — a row-parallel product (``wo``, ``w_down``,
the MoE combine) as m partial sums added by the reduce-scatter, a weight's
gradient over data rows and over the ranks of the mesh, the loss over the
ranks' token shares (weights of power-of-two ratios here, so exact) — which
moves each float32 sum by a few units of its last place, relative to the
sum of its terms' magnitudes.  So the loss agrees to a relative 1e-6 and
each leaf's gradient to ||dg|| / ||g|| <= 1e-5, as in
``tests/test_torch_distributed.py``; an optimiser slot is the gradient
(AdamW's m), its square (v) or means of its square (Adafactor's vr, vc), so
twice the gradient's; the second step's loss to the first's 1e-6.

The update is held end to end and stage by stage.  AdamW's first update
of an element, lr (g / (|g| + eps) + wd p) with g the clipped gradient, is
ill-conditioned where g cancels to about eps = 1e-8: its derivative in g,
lr eps / (|g| + eps)^2, reaches lr / (4 eps), so a rounding gap there moves
the element by up to 2 lr however small the gap, and one such element in a
leaf of 8,192 takes its ||du|| / ||u|| past 1e-4 (a permutation of the
batch rows in the unsharded step alone can do as much).  Where |g| >= tau
and the gap |dg| <= tau / 2 an element moves by at most 4 lr eps |dg| /
tau^2, so over n such elements (each |u| about lr) ||du|| / ||u|| <= 4 eps
||dg|| / (tau^2 sqrt(n)); with ||dg|| <= 2e-5 ||g|| (the gradient's limit
and the global norm's), tau = 2 sqrt(eps rms(g)) of the leaf bounds it by
2e-5.  So each leaf's update is held to the unsharded step's at ||du|| /
||u|| <= 1e-4, AdamW's over the elements with |g| >= tau (where |dg| <=
tau / 2 is asserted) and those whose gradient is exactly 0 (embedding rows
no token reads, which the split step must leave 0), Adafactor's over every
element; and each rank's
shard of the whole update to the update that the unsharded optimiser makes
from the split step's own gradient (gathered whole), at the same 1e-4.  A
wrong shard, a flipped sign or a skipped update gives 1 to 2.

Planted faults, each of which must break one of those limits: a skipped
reduce-scatter after ``wo`` (each rank keeps its own partial sum), the wrong
kv head for a rank, a gathered weight's gradient not reduce-scattered over
``"data"`` (each rank keeps its own rows' part), and the MoE aux loss's
counts not summed over the model ranks.  The step must call
``full_tensor`` nowhere, gather no whole stacked layer weight, and
return gradients of the shards' shapes.
"""

import json

import pytest
from torch_ranks import spawn_ranks

WORLD = 8
MESHES = [(4, 2), (2, 4), (1, 8)]

SCRIPT = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

from unittest import mock

from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.checkpointer import flatten, reshard
from repro_torch.configs import get_config
from repro_torch.models import steps
from repro_torch.sharding import lm_split, spmd, tp
from repro_torch.sharding.compat import NamedSharding, P, local_shard, make_mesh
from repro_torch.sharding.specs import input_specs_sharding_for, lm_param_specs, opt_state_specs
from repro_torch.train.optimizer import OptConfig, clip_scale, opt_update, param_tree

MESHES = json.loads(sys.argv[5])
ADAMW = OptConfig(kind="adamw", warmup_steps=2, total_steps=100)
ADAFACTOR = OptConfig(kind="adafactor", warmup_steps=2, total_steps=100)
B, T = 8, 16


def rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / max(float(torch.linalg.vector_norm(b.double())), 1e-30))


def adamw_kept(opt, g_want, g_whole, norm_want, norm_got):
    """The elements whose first AdamW update is well-conditioned (module
    docstring): |g| >= tau = 2 sqrt(eps rms(g)) of the leaf or g = 0, g the
    unsharded step's clipped gradient; and the largest |dg| / tau over them,
    dg the two steps' clipped gradients' gap."""
    c_want = float(clip_scale(opt.clip_norm, torch.tensor(norm_want)))
    c_got = float(clip_scale(opt.clip_norm, torch.tensor(norm_got)))
    kept, gap = {}, 0.0
    for k, g in g_want.items():
        g = g.double() * c_want
        tau = 2 * (opt.eps * float(g.square().mean().sqrt())) ** 0.5
        kept[k] = (g.abs() >= tau) | (g == 0)
        d = (g_whole[k].double() * c_got - g)[kept[k]]
        gap = max(gap, float(d.abs().max()) / tau if d.numel() else 0.0)
    return kept, gap


def configs(m):
    q = get_config("qwen3-8b").reduced()
    g = get_config("granite-3-2b").reduced()
    mo = get_config("moonshot-v1-16b-a3b").reduced()
    heads, kv, hd = (6, 3, 16) if m < 8 else (12, 6, 8)
    return {
        "qk_kv": (dataclasses.replace(q, n_heads=8, n_kv_heads=2, head_dim=8), ADAMW, None, 1),
        "ragged": (dataclasses.replace(g, n_heads=heads, n_kv_heads=kv, head_dim=hd), ADAMW,
                   None, 1),
        "vocab": (dataclasses.replace(g, n_heads=8, vocab_size=509, head_dim=8), ADAMW, None, 1),
        "moe": (dataclasses.replace(mo, n_heads=8, n_kv_heads=2, head_dim=8, moe_groups=4,
                                    moe=dataclasses.replace(mo.moe, n_experts=8, top_k=2)),
                ADAMW, None, 2),
        "fsdp": (dataclasses.replace(g, n_heads=8, head_dim=8), ADAMW, True, 1),
        "nofsdp": (dataclasses.replace(g, n_heads=8, head_dim=8), ADAMW, False, 1),
        "adafactor": (dataclasses.replace(g, n_heads=8, head_dim=8), ADAFACTOR, True, 1),
    }


def state_specs(cfg, opt, mesh, fsdp):
    if fsdp is None:
        return spmd.state_specs_for(cfg, spmd.meta_state(cfg, opt), mesh)
    ps = lm_param_specs(cfg, mesh, False, fsdp)
    return {"params": ps, "opt": opt_state_specs(ps, spmd.meta_state(cfg, opt)["opt"]),
            "step": P()}


def whole(t, mesh, spec):
    return DTensor.from_local(t, mesh, NamedSharding(mesh, spec).placements(),
                              run_check=False).full_tensor()


class Gathers:
    """Counts full_tensor calls and records every gather's result shape."""

    def __init__(self):
        self.full_tensor, self.shapes = 0, []

    def __enter__(self):
        real_full, real_gather = DTensor.full_tensor, tp._gather_raw

        def full(t, *a, **k):
            self.full_tensor += 1
            return real_full(t, *a, **k)

        def gather(x, dim, group):
            y = real_gather(x, dim, group)
            self.shapes.append(list(y.shape))
            return y

        self._patches = [mock.patch.object(DTensor, "full_tensor", full),
                         mock.patch.object(tp, "_gather_raw", gather)]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def run_case(cfg, opt, fsdp, n_micro, mesh, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    params = steps.init_model_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    state = steps.init_state(params, opt)
    specs = state_specs(cfg, opt, mesh, fsdp)
    pspecs = specs["params"]
    bspecs = input_specs_sharding_for(cfg, "train_4k", mesh, False)
    sharded = reshard(state, mesh, specs)
    step = spmd.make_sharded_train_step(cfg, opt, mesh, specs, bspecs, n_micro=n_micro)
    whole_batch = steps._on_device(batch, "cpu")
    g_want = steps._accum_grads(steps.loss_for(cfg), params, whole_batch, n_micro)[2]
    want_shard = {k: local_shard(g.float(), mesh, NamedSharding(mesh, pspecs[k]).placements())
                  for k, g in g_want.items()}
    with Gathers() as seen:
        g_got, _ = step.grads(sharded, batch)
    # the optimiser stage: the unsharded update from the split step's gradient
    g_whole = {k: whole(g, mesh, pspecs[k]) for k, g in g_got.items()}
    twin = steps.init_model_params(cfg, None, "meta").to_empty(device="cpu")
    with torch.no_grad():
        for p, q in zip(param_tree(twin).values(), param_tree(params).values()):
            p.copy_(q)
    twin_state = steps.init_state(twin, opt)
    before = {k: p.detach().clone() for k, p in param_tree(params).items()}
    s1, m1 = steps.make_lm_train_step(cfg, opt, n_micro)(state, batch)
    with Gathers() as seen_step:
        s2, m2 = step(sharded, batch)
    opt_update(opt, twin_state["params"], g_whole, twin_state["opt"])
    f1, f2 = flatten(s1), flatten(s2)
    stage = {f"params/{k}": v for k, v in param_tree(twin).items()}
    du_got = {k: f2[k].full_tensor().float() - before[k[7:]].float() for k in stage}
    du_want = {k: f1[k].float() - before[k[7:]].float() for k in stage}
    kept, gap = ({}, 0.0) if opt.kind != "adamw" else adamw_kept(
        opt, g_want, g_whole, float(m1["grad_norm"]), float(m2["grad_norm"]))
    layers = {k for k in pspecs if k.startswith("layers/")}
    stacked = [list(t.shape) for k, t in param_tree(params).items() if k in layers]
    res = {
        "loss_rel": abs(float(m2["loss"]) - float(m1["loss"])) / abs(float(m1["loss"])),
        "grad_rel": {k: rel(g_got[k], want_shard[k]) for k in g_want},
        "grad_shapes_are_shards": all(
            list(g_got[k].shape) == list(sharded["params"][k].to_local().shape) for k in g_got),
        "grad_dtypes": sorted({str(g.dtype) for g in g_got.values()}),
        "slot_rel": {k: rel(f2[k].full_tensor().float(), f1[k].float())
                     for k in f1 if k.startswith("opt/") and k != "opt/step"},
        "update_rel": {k: rel(du_got[k][kept[k[7:]]], du_want[k][kept[k[7:]]])
                       if kept else rel(du_got[k], du_want[k]) for k in stage},
        "update_staged_rel": {k: rel(du_got[k], stage[k].float() - before[k[7:]].float())
                              for k in stage},
        "kept_gap": gap,
        "full_tensor_calls": seen.full_tensor + seen_step.full_tensor,
        "gathered_whole_layer_leaf": any(s in stacked for s in seen.shapes + seen_step.shapes),
        "n_gathers": len(seen.shapes),
        "metrics": {k: [float(m1[k]), float(m2[k])] for k in m1},
        "step": [int(f1["step"]), int(f2["step"].full_tensor())],
    }
    _, m1b = steps.make_lm_train_step(cfg, opt, n_micro)(s1, batch)
    _, m2b = step(s2, batch)
    res["loss2"] = [float(m1b["loss"]), float(m2b["loss"])]
    return res, (step, reshard(steps.init_state(params, opt), mesh, specs), batch, g_want,
                 pspecs, whole_batch)


def planted(fault, mesh, ctx):
    """The split step's gradients and loss with ``fault`` planted, against
    the unsharded step's: ``(largest grad_rel, loss_rel)``."""
    step, sharded, batch, g_want, pspecs, _ = ctx
    m, r = mesh.size(1), mesh.get_local_rank("model")
    data = mesh.get_group("data")
    patches = []
    if fault == "skip_wo_scatter":
        real, calls = tp.scatter, [0]

        def scatter(x, dim, group):
            calls[0] += 1
            if calls[0] % 2 == 1:  # a dense layer's first scatter is wo's
                return x.chunk(m, dim)[r]
            return real(x, dim, group)

        patches.append(mock.patch.object(tp, "scatter", scatter))
    elif fault == "wrong_kv_head":
        real_plan = lm_split.head_plan

        def head_plan(h, kh, m_, r_):
            q, (ka, kb), expand = real_plan(h, kh, m_, r_)
            return q, ((ka + 1) % kh, (ka + 1) % kh + kb - ka), expand

        patches.append(mock.patch.object(lm_split, "head_plan", head_plan))
    elif fault == "no_data_reduce_scatter":
        real_shard = tp.shard_grad

        def shard_grad(g, dim, group):
            if group is data:
                n = dist.get_world_size(group)
                return g.chunk(n, dim)[dist.get_rank(group)].clone()
            return real_shard(g, dim, group)

        patches.append(mock.patch.object(tp, "shard_grad", shard_grad))
    for p in patches:
        p.start()
    try:
        if fault == "wrong_kv_head":  # the plan is made with the step
            cfg, opt = step.split.cfg, ADAMW
            step = spmd.make_sharded_train_step(
                cfg, opt, mesh, {"params": pspecs, "opt": opt_state_specs(
                    pspecs, spmd.meta_state(cfg, opt)["opt"]), "step": P()},
                input_specs_sharding_for(cfg, "train_4k", mesh, False))
        if fault == "aux_counts_not_over_model":
            step.split.count_groups = [g for a, g in step.split.groups.items() if a != "model"]
        g_got, metrics = step.grads(sharded, batch)
    finally:
        for p in patches:
            p.stop()
    want_shard = {k: local_shard(g.float(), mesh, NamedSharding(mesh, pspecs[k]).placements())
                  for k, g in g_want.items()}
    return {"grad_rel": max(rel(g_got[k], want_shard[k]) for k in g_want),
            "loss": float(metrics["loss"])}


res = {"rank": rank}


def collectives(mesh):
    """tp's autograd collectives over the model group: each rank's loss is
    sum((r + 1) * out), so each input's gradient is known in closed form."""
    group, n = mesh.get_group("model"), mesh.size(1)
    r = mesh.get_local_rank("model")
    out = {}
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    y = tp.gather(x, 1, group)  # (2, 3 n): rank s's block is s + 1
    ((r + 1) * y).sum().backward()
    out["gather"] = [y[0, ::3].tolist(), x.grad.unique().tolist()]
    x = torch.full((2, 3 * n), float(r + 1), requires_grad=True)
    y = tp.scatter(x, 1, group)  # the sum over ranks, this rank's block
    ((r + 1) * y).sum().backward()
    out["scatter"] = [y.unique().tolist(), x.grad[0, ::3].tolist()]
    x = torch.full((4,), float(r + 1), requires_grad=True)
    y = tp.all_reduce(x, group)
    ((r + 1) * y).sum().backward()
    out["all_reduce"] = [y.unique().tolist(), x.grad.unique().tolist()]
    return out


for n_data, n_model in MESHES:
    mesh = make_mesh((n_data, n_model), ("data", "model"), device_type="cpu")
    tag = f"{n_data}x{n_model}"
    res[f"{tag}/collectives"] = collectives(mesh)
    for i, (name, (cfg, opt, fsdp, n_micro)) in enumerate(configs(n_model).items()):
        r, ctx = run_case(cfg, opt, fsdp, n_micro, mesh, 10 * i + n_model)
        r["heads"] = list(lm_split.head_plan(cfg.n_heads, cfg.n_kv_heads, n_model,
                                             mesh.get_local_rank("model"))[1])
        res[f"{tag}/{name}"] = r
        faults = {"nofsdp": ("skip_wo_scatter",), "qk_kv": ("wrong_kv_head",),
                  "fsdp": ("no_data_reduce_scatter",),
                  "moe": ("aux_counts_not_over_model",)}.get(name, ())
        if n_data == 1:  # no data axis to skip on a (1, 8) mesh
            faults = tuple(f for f in faults if f != "no_data_reduce_scatter")
        for f in faults:
            got = planted(f, mesh, ctx)
            got["loss_rel"] = abs(got["loss"] - r["metrics"]["loss"][0]) / abs(
                r["metrics"]["loss"][0])
            res[f"{tag}/{name}/planted/{f}"] = got
    dist.barrier()

dist.barrier()
dist.destroy_process_group()
with open(out, "w") as f:
    json.dump(res, f)
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(tmp_path_factory, "tp", SCRIPT, WORLD, [json.dumps(MESHES)])


LOSS_REL = 1e-6
GRAD_REL = 1e-5
UPDATE_REL = 1e-4
CASES = ["qk_kv", "ragged", "vocab", "moe", "fsdp", "nofsdp", "adafactor"]
PLANTED = [("nofsdp", "skip_wo_scatter"), ("qk_kv", "wrong_kv_head"),
           ("fsdp", "no_data_reduce_scatter"), ("moe", "aux_counts_not_over_model")]


def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_split_step_matches_unsharded(ranks, mesh, case):
    for r in ranks:
        got = r[f"{_tag(mesh)}/{case}"]
        assert got["loss_rel"] <= LOSS_REL, got["metrics"]
        assert max(got["grad_rel"].values()) <= GRAD_REL, got["grad_rel"]
        assert max(got["slot_rel"].values()) <= 2 * GRAD_REL, got["slot_rel"]
        assert max(got["update_rel"].values()) <= UPDATE_REL, got["update_rel"]
        assert got["kept_gap"] <= 0.5, got["kept_gap"]
        assert max(got["update_staged_rel"].values()) <= UPDATE_REL, got["update_staged_rel"]
        a, b = got["loss2"]
        assert abs(a - b) <= LOSS_REL * abs(a), got["loss2"]
        assert got["step"] == [1, 1]
        for k, (a, b) in got["metrics"].items():
            limit = GRAD_REL if k == "grad_norm" else 1e-5
            assert abs(a - b) <= limit * max(1.0, abs(a)), (k, a, b)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_split_step_gathers_no_whole_leaf(ranks, mesh, case):
    """No ``full_tensor`` in the gradients or the update (Adafactor's
    factored means included), no gather that makes a stacked layer weight
    whole, float32 gradients of the shards' shapes; the layer
    weights are gathered (per layer) where the mesh has more than one rank
    on an axis that shards them."""
    for r in ranks:
        got = r[f"{_tag(mesh)}/{case}"]
        assert got["full_tensor_calls"] == 0
        assert not got["gathered_whole_layer_leaf"]
        assert got["grad_shapes_are_shards"] and got["grad_dtypes"] == ["torch.float32"]
        assert got["n_gathers"] > 0


@pytest.mark.parametrize("case,fault", PLANTED, ids=[f for _, f in PLANTED])
@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_planted_fault_breaks_a_limit(ranks, mesh, case, fault):
    if fault == "no_data_reduce_scatter" and mesh[0] == 1:
        key = f"{_tag(mesh)}/{case}/planted/{fault}"
        assert all(key not in r for r in ranks)
        return
    worst = max(max(r[f"{_tag(mesh)}/{case}/planted/{fault}"]["grad_rel"],
                    r[f"{_tag(mesh)}/{case}/planted/{fault}"]["loss_rel"] / LOSS_REL * GRAD_REL)
                for r in ranks)
    assert worst > GRAD_REL, fault


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_autograd_collectives(ranks, mesh):
    """``tp.gather`` / ``scatter`` / ``all_reduce`` over the model ranks and
    their backwards (reduce-scatter / all-gather / all-reduce), for rank
    r's loss sum((r + 1) * out): exact small integers."""
    n = mesh[1]
    total = n * (n + 1) / 2
    for r in ranks:
        got = r[f"{_tag(mesh)}/collectives"]
        assert got["gather"] == [[float(s + 1) for s in range(n)], [total]]
        assert got["scatter"] == [[total], [float(s + 1) for s in range(n)]]
        assert got["all_reduce"] == [[total], [total]]


def test_traps_are_hit(ranks):
    """The configs reach the split's traps (module docstring): on 4 and 8
    model ranks fewer kv heads than ranks (one kv head a rank, shared with
    another rank); 1.5 q heads a rank; q heads that share their kv heads
    unevenly (k, v repeated to one kv head a q head)."""
    from repro_torch.sharding.lm_split import head_plan

    for m in (4, 8):
        plans = [head_plan(8, 2, m, r) for r in range(m)]
        assert all(kb - ka == 1 for _, (ka, kb), _ in plans)
        assert len({kv for _, kv, _ in plans}) < m
    for h, kv, m in ((6, 3, 4), (12, 6, 8)):
        plans = [head_plan(h, kv, m, r) for r in range(m)]
        assert sorted({b - a for (a, b), _, _ in plans}) == [1, 2]
        assert sum(b - a for (a, b), _, _ in plans) == h
    assert head_plan(6, 3, 2, 0)[2] == [0, 0, 1]
    for r in ranks:
        ka, kb = r["2x4/qk_kv"]["heads"]
        assert kb - ka == 1
