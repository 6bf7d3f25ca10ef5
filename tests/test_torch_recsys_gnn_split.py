"""Recsys tables row-sharded over ``"model"`` and the GIN's graphs split over
the mesh (``repro_torch.sharding.{recsys_split, gnn_split}``) across eight
gloo ranks on the CPU, against the reference's own sharded JAX steps.

Two runs for the module.  First the reference, in a subprocess with
``--xla_force_host_platform_device_count=8`` (as ``tests/test_distributed.py``
runs it): on the meshes (4, 2), (2, 4) and (1, 8) of ``("data", "model")``,
``make_recsys_serve_step(..., cand_shard_axes=("data", "model"),
cand_pad_multiple=16 n)`` and ``make_recsys_train_step`` under ``jax.jit``
with ``recsys_param_specs`` (and the registry's input specs), and
``make_gnn_train_step(..., pad_multiple=n, shard_axes=("data", "model"))``.
Its weights (``jax.random``) and the inputs (NumPy, from a seed) go across
with ``recsys_params_from_reference`` / ``gnn_params_from_reference``.  Then
eight spawned ranks (``tests/torch_ranks.py``) run the port's steps on the
same meshes: ``steps.make_recsys_serve_step(..., mesh=)``,
``spmd.make_sharded_train_step`` and ``steps.make_gnn_train_step(...,
mesh=)``.

Reduced configs: FM with 64 rows (every model axis divides them: the table
and the 1-D ``linear`` sharded, bags of 5 summed in partial sums per shard),
xDeepFM with 35 rows (no model axis divides them: replicated, looked up
locally), SASRec and two-tower with 96 items / users (sharded; two-tower's
ids run to ten times the rows, so its ``% n`` hashing matters), the GIN on
a whole graph of 61 nodes and on a sampled block of 6 seeds (fanout 3, 2),
both padded (nodes and edges) to a multiple of 8.

The bf16 retrieval (the reference dry-run's ``serve_dtype``) runs on (2, 4)
alone, as do the planted faults.

Limits, argued from the order of the sums.  Serving: a bag of one id is
one row plus zeros, exact; a bag of 5 and every product below it sum the
same terms in another grouping, a few float32 units of the sum's terms, so
float32 scores within 1e-5 of the largest |value| and bf16 retrieval within
2e-2 (one bf16 rounding of values of order 1; ``tests/test_torch_recsys.py``'s
limits).  Training: the mesh tier's (``tests/test_torch_distributed.py``):
the loss to a relative 1e-6 of the reference's sharded step, each leaf's
gradient to ||dg|| / ||g|| <= 1e-5 of the port's unsharded step (the
GIN's 2^-8: its messages are rounded to bf16, and one float32 unit before
the rounding can be one bf16 step after), and each leaf's update to the
unsharded step's and to the reference's sharded step's at ||du|| / ||u|| <=
1e-4 (the GIN's 2^-8) over the elements where AdamW's first update is
well-conditioned (``tests/test_torch_tp.py``'s ``kept`` argument: |g| >=
2 sqrt(eps rms g) of the leaf, or g = 0; over half of every case's
elements, though none of xDeepFM's last CIN layer, whose gradient is near
1e-8 at this init and whose gradient limit holds it instead).

Planted faults, each of which must break one of those limits: a table's
shard offset one row (``offset``), a table's gradient summed over
``"model"`` as well (``model_sum``), two-tower's ``% n`` taken on the
shard's rows (``hash_shard``), and the GIN's message partials kept by each
rank without the reduce-scatter (``gin_no_scatter``).  No step calls
``full_tensor``.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from torch_ranks import ROOT, spawn_ranks

WORLD = 8
MESHES = [(4, 2), (2, 4), (1, 8)]
FAULT_MESH = (2, 4)
B, NC, T = 16, 200, 10
#: name -> (arch, config fields replaced on its reduced config, init seed)
RECSYS = {"fm": ("fm", {"field_vocab_sizes": (8, 16, 8, 24, 8)}, 1),
          "xdeepfm": ("xdeepfm", {"field_vocab_sizes": (7, 11, 5, 9, 3)}, 2),
          "sasrec": ("sasrec", {"n_items": 96, "seq_len": T}, 3),
          "two_tower": ("two-tower-retrieval", {"n_users": 96, "n_items": 96}, 4)}
GNN = {"gin_full": ("gin-tu", {}, 5), "gin_mini": ("gin-tu", {}, 6)}
D_FEAT, N_CLASSES = 12, 5
FAULTS = {"offset": ("fm",), "model_sum": ("sasrec",), "hash_shard": ("two_tower",),
          "gin_no_scatter": ("gin_full",)}
#: the mesh whose retrieval also runs in bf16 (the reference dry-run's serve_dtype)
BF16_MESH = (2, 4)


def _inputs() -> dict:
    """Every case's inputs, NumPy from one seed."""
    from repro.data.graphs import NeighborSampler, synthetic_graph

    rng = np.random.default_rng(0)
    out = {}
    for name, (_, fields, _) in RECSYS.items():
        if name in ("fm", "xdeepfm"):
            sizes = np.asarray(fields["field_vocab_sizes"])
            rows = lambda n: (rng.random((n, len(sizes))) * sizes).astype(np.int32)  # noqa: E731
            out[name] = {"serve_p99": {"fields": rows(B)},
                         "retrieval_cand": {"candidates": rows(NC)},
                         "train_batch": {"fields": rows(B),
                                         "labels": (rng.random(B) < 0.5).astype(np.float32)}}
        elif name == "sasrec":
            ids = lambda *s: rng.integers(1, 96, s).astype(np.int32)  # noqa: E731
            labels = ids(B, T)
            labels[:, :T // 2] = 0
            labels[2:4] = 0  # rows with no label: a data rank may hold none
            out[name] = {"serve_p99": {"hist": ids(B, T), "target": ids(B)},
                         "retrieval_cand": {"hist": ids(1, T), "candidates": ids(NC)},
                         "train_batch": {"hist": ids(B, T), "labels": labels,
                                         "negatives": ids(B, T)}}
        else:
            ids = lambda *s: rng.integers(0, 960, s).astype(np.int32)  # noqa: E731
            out[name] = {"serve_p99": {"user_feats": ids(B, 16), "item_ids": ids(B)},
                         "retrieval_cand": {"user_feats": ids(1, 16), "candidates": ids(NC)},
                         "train_batch": {"user_feats": ids(B, 16), "item_ids": ids(B),
                                         "labels": np.ones(B, np.float32)}}
    g = synthetic_graph(61, 4, D_FEAT, N_CLASSES, seed=1)
    out["gin_full"] = {"train_batch": {"node_feat": g.node_feat, "edge_src": g.edge_src,
                                       "edge_dst": g.edge_dst, "labels": g.labels,
                                       "train_mask": rng.random(61) < 0.6}}
    big = synthetic_graph(200, 4, D_FEAT, N_CLASSES, seed=2)
    block = NeighborSampler(big, seed=3).sample_block(rng.integers(0, 200, 6), (3, 2))
    block["train_mask"] = np.array([1, 1, 0, 1, 1, 0], bool)
    out["gin_mini"] = {"train_batch": block}
    return out


REFERENCE = r'''
import os, pickle, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import gnn, steps
from repro.sharding.compat import AxisType, make_mesh
from repro.sharding.specs import input_specs_sharding_for, opt_state_specs, param_specs_for
from repro.train.optimizer import OptConfig

work = sys.argv[1]
with open(os.path.join(work, "inputs.pkl"), "rb") as f:
    data = pickle.load(f)
opt = OptConfig(kind="adamw", warmup_steps=2, total_steps=100)
tonp = lambda t: jax.tree.map(np.asarray, t)
out = {"params": {}, "results": {}}


def named(mesh, tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree, is_leaf=lambda x: isinstance(x, P))


for name, (arch, fields, seed) in data["cases"].items():
    cfg = dataclasses.replace(get_config(arch).reduced(), **fields)
    key = jax.random.PRNGKey(seed)
    gnn_case = name.startswith("gin")
    params = (gnn.init_params(cfg, key, data["d_feat"], data["n_classes"]) if gnn_case
              else steps.init_model_params(cfg, key))
    out["params"][name] = tonp(params)
    for dn, mn in data["meshes"]:
        mesh = make_mesh((dn, mn), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        res = {}
        pspecs = param_specs_for(cfg, params, mesh, False)
        state = steps.init_state(params, opt)
        sspecs = {"params": pspecs, "opt": opt_state_specs(pspecs, state["opt"]), "step": P()}
        batch = {k: jnp.asarray(v) for k, v in data["inputs"][name]["train_batch"].items()}
        with mesh:
            if gnn_case:
                step = steps.make_gnn_train_step(cfg, opt, pad_multiple=dn * mn,
                                                 shard_axes=("data", "model"))
                in_sh = {k: NamedSharding(mesh, P()) for k in batch}
            else:
                for shape in ("serve_p99", "retrieval_cand"):
                    x = {k: jnp.asarray(v) for k, v in data["inputs"][name][shape].items()}
                    specs = input_specs_sharding_for(cfg, shape, mesh, False)
                    sh = named(mesh, {k: specs[k] for k in x})
                    bf16 = shape == "retrieval_cand" and [dn, mn] == list(data["bf16_mesh"])
                    for dt in ((None, "bfloat16") if bf16 else (None,)):
                        serve = steps.make_recsys_serve_step(
                            cfg, retrieval=shape == "retrieval_cand",
                            cand_shard_axes=("data", "model"), cand_pad_multiple=dn * mn * 16,
                            serve_dtype=jnp.bfloat16 if dt else None)
                        fn = jax.jit(lambda p, x, serve=serve: serve(p, **x),
                                     in_shardings=(named(mesh, pspecs), sh))
                        res[f"{shape}/{dt}"] = np.asarray(fn(params, x).astype(jnp.float32))
                step = steps.make_recsys_train_step(cfg, opt)
                specs = input_specs_sharding_for(cfg, "train_batch", mesh, False)
                in_sh = named(mesh, {k: specs[k] for k in batch})
            fn = jax.jit(step, in_shardings=(named(mesh, sspecs), in_sh),
                         out_shardings=(named(mesh, sspecs), None))
            new, metrics = fn(state, batch)
        res["metrics"] = {k: float(v) for k, v in metrics.items()}
        res["new_params"] = tonp(new["params"])
        out["results"][f"{dn}x{mn}/{name}"] = res
with open(os.path.join(work, "reference.pkl"), "wb") as f:
    pickle.dump(out, f)
'''

SCRIPT = r'''
import dataclasses, json, math, pickle, sys
from unittest import mock
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
work = sys.argv[5]

from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.checkpointer import flatten, reshard
from repro_torch.configs import get_config
from repro_torch.models import gnn, recsys, steps
from repro_torch.sharding import gnn_split, recsys_split, spmd
from repro_torch.sharding.compat import NamedSharding, P, local_shard, make_mesh
from repro_torch.sharding.specs import input_specs_sharding_for, recsys_param_specs
from repro_torch.train.optimizer import OptConfig, clip_scale, param_tree

with open(f"{work}/inputs.pkl", "rb") as f:
    data = pickle.load(f)
with open(f"{work}/reference.pkl", "rb") as f:
    ref = pickle.load(f)
opt = OptConfig(kind="adamw", warmup_steps=2, total_steps=100)


def rel(a, b):
    d = float(torch.linalg.vector_norm((a.double() - b.double())))
    n = max(float(torch.linalg.vector_norm(b.double())), 1e-30)
    return d / n if math.isfinite(d) else math.inf


def peak_err(got, want):
    """max |got - want| / max |want| (inf for a non-finite gap)."""
    d = float((got.double() - want.double()).abs().max())
    return d / max(float(want.double().abs().max()), 1e-30) if math.isfinite(d) else math.inf


def ref_tree(name):
    """The reference's new params, as {path: tensor}."""
    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, f"{prefix}{k}/")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                yield from walk(v, f"{prefix}{i}/")
        else:
            yield prefix[:-1], torch.from_numpy(np.array(t, dtype=np.float32))
    return dict(walk(name, ""))


def kept(g_want, norm):
    """The elements whose first AdamW update is well-conditioned (module
    docstring): |g| >= 2 sqrt(eps rms(g)) of the clipped gradient, or g = 0."""
    c = float(clip_scale(opt.clip_norm, torch.tensor(norm)))
    out = {}
    for k, g in g_want.items():
        g = g.double() * c
        tau = 2 * (opt.eps * float(g.square().mean().sqrt())) ** 0.5
        out[k] = (g.abs() >= tau) | (g == 0)
    return out


class FullTensorCalls:
    def __enter__(self):
        self.n = 0
        real = DTensor.full_tensor

        def full(t, *a, **k):
            self.n += 1
            return real(t, *a, **k)
        self.patch = mock.patch.object(DTensor, "full_tensor", full)
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()


def fault_patches(fault):
    if fault == "offset":
        real = recsys_split.RecsysPlan.__init__

        def init(self, *a, **k):
            real(self, *a, **k)
            for path, (start, n) in list(self.sharded.items()):
                rows = n // self.mesh.size(list(self.names).index("model"))
                self.sharded[path] = (min(start + 1, n - rows), n)
        return [mock.patch.object(recsys_split.RecsysPlan, "__init__", init)]
    if fault == "model_sum":
        # every sum of the step over "model" too: a replicated leaf's gradient,
        # the loss's count and the metrics stay right (the model ranks hold
        # the same values, each weighted by 1 / m), a table shard's gradient
        # gains the other shards' rows
        real = recsys_split.RecsysPlan.__init__

        def init(self, *a, **k):
            real(self, *a, **k)
            self.data_groups = self.data_groups + [self.model_group]
        return [mock.patch.object(recsys_split.RecsysPlan, "__init__", init)]
    if fault == "hash_shard":
        def rows(table):
            return table.shard.shape[0] if isinstance(table, recsys_split.TableShard) \
                else table.shape[0]

        def user(cfg, params, feats):
            e = recsys._lookup(params.user_table, feats % rows(params.user_table))
            return recsys._normalize(recsys._mlp(e.reshape(e.shape[0], -1), params.user_mlp_w,
                                                 params.user_mlp_b))

        def item(cfg, params, ids):
            e = recsys._lookup(params.item_table, ids % rows(params.item_table))
            return recsys._normalize(recsys._mlp(e, params.item_mlp_w, params.item_mlp_b))
        return [mock.patch.object(recsys, "tt_user_tower", user),
                mock.patch.object(recsys, "tt_item_tower", item)]
    if fault == "gin_no_scatter":
        return [mock.patch.object(gnn_split.GraphSplit, "scatter", lambda self, x: self.chunk(x))]
    raise ValueError(fault)


def recsys_case(name, cfg, mesh, want):
    dn, mn = mesh.size(0), mesh.size(1)
    params = recsys.recsys_params_from_reference(cfg, ref["params"][name], "cpu")
    placed = reshard(params, mesh, recsys_param_specs(cfg, params, mesh, False))
    res = {"err": {}, "sharded": sorted(k for k, v in placed.items()
                                        if v.to_local().shape != v.shape)}
    full_calls = 0
    for shape in ("serve_p99", "retrieval_cand"):
        x = {k: torch.from_numpy(v) for k, v in data["inputs"][name][shape].items()}
        bf16 = shape == "retrieval_cand" and [dn, mn] == list(data["bf16_mesh"])
        for dt in ((None, "bfloat16") if bf16 else (None,)):
            serve = steps.make_recsys_serve_step(
                cfg, retrieval=shape == "retrieval_cand", cand_shard_axes=("data", "model"),
                cand_pad_multiple=dn * mn * 16, serve_dtype=torch.bfloat16 if dt else None,
                mesh=mesh)
            with FullTensorCalls() as calls:
                got = serve(placed, **x)
            full_calls += calls.n
            full = torch.from_numpy(want[f"{shape}/{dt}"])
            if shape == "serve_p99":  # the rank's rows, over "data"
                per = got.shape[0]
                full = full[mesh.get_local_rank("data") * per:][:per]
            res["err"][f"{shape}/{dt}"] = peak_err(got.float(), full)
    state = steps.init_state(params, opt)
    specs = spmd.state_specs_for(cfg, state, mesh)
    batch = data["inputs"][name]["train_batch"]
    bspecs = input_specs_sharding_for(cfg, "train_batch", mesh, False)
    bspecs = {k: bspecs[k] for k in batch}
    res.update(train(cfg, mesh, params, state, specs, bspecs, batch, want,
                     steps.make_recsys_train_step(cfg, opt), {}))
    res["full_tensor_calls"] += full_calls
    return res


def train(cfg, mesh, params, state, specs, bspecs, batch, want, unsharded, kw):
    sharded = reshard(state, mesh, specs)
    before = {k: v.detach().clone() for k, v in param_tree(params).items()}
    _, _, g_want = steps._grads(steps.loss_for(cfg), params, steps._on_device(batch, "cpu"))
    step = spmd.make_sharded_train_step(cfg, opt, mesh, specs, bspecs, **kw)
    with FullTensorCalls() as calls:
        g_got, _ = step.grads(sharded, batch)
        new, m2 = step(sharded, batch)
    s1, m1 = unsharded(state, batch)
    keep = kept(g_want, float(m1["grad_norm"]))
    f1, f2 = flatten(s1), flatten(new)
    r_new = ref_tree(want["new_params"])
    du_got = {k: f2[f"params/{k}"].full_tensor().float() - before[k] for k in before}
    pl = {k: NamedSharding(mesh, specs["params"][k]).placements() for k in before}
    return {"loss_rel": abs(float(m2["loss"]) - want["metrics"]["loss"])
            / abs(want["metrics"]["loss"]),
            "loss": [float(m2["loss"]), want["metrics"]["loss"], float(m1["loss"])],
            "grad_rel": {k: rel(g_got[k], local_shard(g_want[k].float(), mesh, pl[k]))
                         for k in before},
            "update_rel": {k: rel(du_got[k][keep[k]], (f1[f"params/{k}"].float()
                                                       - before[k])[keep[k]]) for k in before},
            "update_ref_rel": {k: rel(du_got[k][keep[k]], (r_new[k] - before[k])[keep[k]])
                               for k in before},
            "kept_share": (sum(int(v.sum()) for v in keep.values())
                           / sum(v.numel() for v in keep.values())),
            "full_tensor_calls": calls.n}


def gnn_case(name, cfg, mesh, want):
    dn, mn = mesh.size(0), mesh.size(1)
    params = gnn.gnn_params_from_reference(cfg, ref["params"][name], "cpu")
    state = steps.init_state(params, opt)
    specs = spmd.state_specs_for(cfg, state, mesh)
    batch = data["inputs"][name]["train_batch"]
    lead = {k: P(("data", "model")) for k in batch}
    shapes = {k: tuple(v.shape) for k, v in param_tree(params).items()}
    unsharded = steps.make_gnn_train_step(cfg, opt, pad_multiple=dn * mn)
    res = train(cfg, mesh, params, state, specs, lead, batch, want, unsharded,
                {"shard_axes": ("data", "model"), "pad_multiple": dn * mn, "shapes": shapes})
    # the entry point a user calls, steps.make_gnn_train_step(..., mesh=), from
    # the reference's weights again (the unsharded step updated params in place)
    entry = steps.make_gnn_train_step(cfg, opt, pad_multiple=dn * mn,
                                      shard_axes=("data", "model"), mesh=mesh)
    params = gnn.gnn_params_from_reference(cfg, ref["params"][name], "cpu")
    _, m3 = entry(reshard(steps.init_state(params, opt), mesh, specs), batch)
    res["entry_loss_rel"] = abs(float(m3["loss"]) - want["metrics"]["loss"]) / abs(
        want["metrics"]["loss"])
    local = gnn.pad_graph_batch({k: torch.from_numpy(v) for k, v in batch.items()}, dn * mn,
                                ("data", "model"), mesh)
    res["local_nodes"] = [int(local["node_feat"].shape[0]), int(local["edge_src"].shape[0])]
    return res


res = {"rank": rank}
for dn, mn in data["meshes"]:
    mesh = make_mesh((dn, mn), ("data", "model"), device_type="cpu")
    for name, (arch, fields, _) in data["cases"].items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **fields)
        want = ref["results"][f"{dn}x{mn}/{name}"]
        run = gnn_case if name.startswith("gin") else recsys_case
        res[f"{dn}x{mn}/{name}"] = run(name, cfg, mesh, want)
        if [dn, mn] == list(data["fault_mesh"]):
            for fault, names in data["faults"].items():
                if name not in names:
                    continue
                patches = fault_patches(fault)
                for p in patches:
                    p.start()
                try:
                    res[f"{dn}x{mn}/{name}/planted/{fault}"] = run(name, cfg, mesh, want)
                finally:
                    for p in patches:
                        p.stop()
    dist.barrier()

dist.barrier()
dist.destroy_process_group()
with open(out, "w") as f:
    json.dump(res, f)
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("recsys_gnn_ref")
    cases = {**RECSYS, **GNN}
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"cases": cases, "meshes": MESHES, "inputs": _inputs(), "d_feat": D_FEAT,
                     "n_classes": N_CLASSES, "faults": FAULTS, "fault_mesh": FAULT_MESH,
                     "bf16_mesh": BF16_MESH}, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(work)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return spawn_ranks(tmp_path_factory, "recsys_gnn", SCRIPT, WORLD, [str(work)])


SERVE_REL = {"None": 1e-5, "bfloat16": 2e-2}
LOSS_REL = 1e-6
GRAD_REL = {"recsys": 1e-5, "gin": 2.0 ** -8}
UPDATE_REL = {"recsys": 1e-4, "gin": 2.0 ** -8}


def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _family(name):
    return "gin" if name.startswith("gin") else "recsys"


def _broken(got, name) -> bool:
    """Whether a result breaks one of the limits (module docstring)."""
    fam = _family(name)
    serve = any(v > SERVE_REL[k.split("/")[1]] for k, v in got.get("err", {}).items())
    return (serve or got["loss_rel"] > LOSS_REL
            or max(got["grad_rel"].values()) > GRAD_REL[fam]
            or max(got["update_rel"].values()) > UPDATE_REL[fam]
            or max(got["update_ref_rel"].values()) > UPDATE_REL[fam])


@pytest.mark.parametrize("name", list(RECSYS))
@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_split_serving_matches_reference(ranks, mesh, name):
    for r in ranks:
        got = r[f"{_tag(mesh)}/{name}"]
        assert ("retrieval_cand/bfloat16" in got["err"]) == (mesh == BF16_MESH)
        for k, v in got["err"].items():
            assert v <= SERVE_REL[k.split("/")[1]], (k, v)


@pytest.mark.parametrize("name", list(RECSYS) + list(GNN))
@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_split_train_step_matches_reference(ranks, mesh, name):
    fam = _family(name)
    for r in ranks:
        got = r[f"{_tag(mesh)}/{name}"]
        assert got["loss_rel"] <= LOSS_REL, got["loss"]
        assert max(got["grad_rel"].values()) <= GRAD_REL[fam], got["grad_rel"]
        assert max(got["update_rel"].values()) <= UPDATE_REL[fam], got["update_rel"]
        assert max(got["update_ref_rel"].values()) <= UPDATE_REL[fam], got["update_ref_rel"]
        assert got["kept_share"] > 0.5  # the updates compared are most of the model's
        if fam == "gin":
            assert got["entry_loss_rel"] <= LOSS_REL


@pytest.mark.parametrize("name", list(RECSYS) + list(GNN))
@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_split_steps_gather_no_table(ranks, mesh, name):
    """No ``full_tensor`` in the split serve or train steps; the tables the
    model axis divides are sharded, the others (xDeepFM's 35 rows) not."""
    for r in ranks:
        got = r[f"{_tag(mesh)}/{name}"]
        assert got["full_tensor_calls"] == 0
        if name == "xdeepfm":
            assert got["sharded"] == []
        elif name == "fm":
            assert got["sharded"] == ["linear", "table"]
        elif name == "sasrec":
            assert got["sharded"] == ["item_emb"]
        elif name == "two_tower":
            assert got["sharded"] == ["item_table", "user_table"]


@pytest.mark.parametrize("fault,name", [(f, n) for f, names in FAULTS.items() for n in names])
def test_planted_fault_breaks_a_limit(ranks, fault, name):
    assert any(_broken(r[f"{_tag(FAULT_MESH)}/{name}/planted/{fault}"], name) for r in ranks)


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_graph_split_holds_a_slice(ranks, mesh):
    """``pad_graph_batch(..., shard_axes, mesh)``: each rank holds 1 / n of
    the padded nodes (61 -> 64; the block's 60 -> 64) and edges (244 -> 248;
    54 -> 56)."""
    n = mesh[0] * mesh[1]
    for r in ranks:
        assert r[f"{_tag(mesh)}/gin_full"]["local_nodes"] == [64 // n, 248 // n]
        assert r[f"{_tag(mesh)}/gin_mini"]["local_nodes"] == [64 // n, 56 // n]
