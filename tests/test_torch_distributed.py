"""The mesh tier across ranks: eight gloo ranks on the CPU, a (4, 2)
``("data", "model")`` mesh, as the reference's 8-device ``SCRIPT``
(``tests/test_distributed.py``) builds it.

One spawned run for the module: eight processes run ``SCRIPT`` (one
thread each, rendezvous on a file under the test's ``tmp_path``, bounded
by a timeout so that a rank stuck in a collective fails the run instead of
stalling the suite), each writes its results as JSON, and each test below
reads one part of them:

* the sharded train step (``repro_torch.sharding.spmd``) against the
  port's unsharded step on the whole batch, float32 on the plain path:
  granite-3-2b reduced with AdamW (as the reference's) and with Adafactor
  (2D weights, a leaf whose last two dimensions are both sharded),
  moonshot reduced in 4 token groups over 2 micro-batches (expert capacity
  and the router's aux loss those of the whole batch; one group on 4 data
  ranks refused), SASRec (a loss masked by its labels) and the GIN on a
  graph batch (masked graphs); the optimiser slots and each leaf's update
  after one step, and a second step's loss.  Limits, argued from the order
  of the sums: a rank's slice of
  the loss and gradients is the same arithmetic as the whole batch's
  except that the slices are summed after their own means, so the loss
  agrees to a relative 1e-6 and each leaf's gradient to ||dg|| / ||g|| <=
  1e-5 — but the GIN's, whose messages are rounded to bfloat16 (as the
  reference rounds them): a message one float32 ulp apart before that
  rounding may land one bf16 step (2^-8 relative) apart, so its limit is
  2^-8 (the same gap shows between the port's own batched step and its
  graphs one at a time); the slots and updates as
  ``test_sharded_step_matches_unsharded`` argues (the reference's own
  limit is 5e-2);
* ``psum_int8`` over the 4 data ranks, bit-equal to the NumPy formula on
  the same inputs and within the reference's 2e-2 of the mean; ``psum_topk``
  bit-equal to its formula;
* ``reshard`` of a saved sharded state from the 4 x 2 mesh onto a 2 x 4
  mesh, bit-equal, by ``reshard`` and by ``restore(sharding_tree=)``; an
  async save gathers on the calling thread;
* ``PartitionedServer(mesh)`` with 4 and 8 shards (one and two a data
  rank), AND and phrase: answers equal to the ``mesh=None`` server's, to
  the posting lists' intersections and to the reference's server without a
  mesh; ``device_bytes`` summed over the data ranks equal to the one-device
  number; 6 shards on 4 data ranks refused.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
WORLD = 8
TIMEOUT_S = 420

SCRIPT = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)

import dataclasses

from repro_torch.checkpoint.checkpointer import Checkpointer, flatten, reshard
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import steps
from repro_torch.serving import partitioned as part
from repro_torch.sharding import spmd
from repro_torch.sharding.compat import NamedSharding, P, flatten_specs, make_mesh
from repro_torch.sharding.specs import input_specs_sharding_for, lm_param_specs, opt_state_specs
from repro_torch.train import grad_compression as gc
from repro_torch.train.optimizer import OptConfig, param_tree

mesh = make_local_mesh(4, 2, device_type="cpu")
data_rank = mesh.get_local_rank("data")
res = {"rank": rank, "data_rank": data_rank, "model_rank": mesh.get_local_rank("model")}


def rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / max(float(torch.linalg.vector_norm(b.double())), 1e-30))


def compare(name, cfg, opt, params, batch, batch_specs, specs=None, shape_name=None,
            n_micro=1):
    """The sharded step against the unsharded one on the whole batch: the
    gradients, the first step's metrics, optimiser slots and parameter
    updates, then a second step's loss from the two updated states."""
    clone = steps.init_model_params(cfg, None, "meta", shape_name).to_empty(device="cpu")
    with torch.no_grad():
        for (k, p), q in zip(param_tree(clone).items(), param_tree(params).values()):
            p.copy_(q)
    state = steps.init_state(clone, opt)
    specs = specs or spmd.state_specs_for(cfg, state, mesh)
    sharded = reshard(state, mesh, specs)
    loss = steps.loss_for(cfg)
    _, _, g_want = steps._accum_grads(loss, state["params"], steps._on_device(batch, "cpu"),
                                      n_micro)
    step = spmd.make_sharded_train_step(cfg, opt, mesh, specs, batch_specs, n_micro=n_micro,
                                        shape_name=shape_name)
    g_got, _ = step.grads(sharded, batch)
    if name == "lm":
        unsharded = steps.make_lm_train_step(cfg, opt, n_micro)
    else:
        unsharded = {"gin": steps.make_gnn_train_step,
                     "sasrec": steps.make_recsys_train_step}[name](cfg, opt)
    before = {k: v.detach().clone() for k, v in flatten(state).items()
              if k.startswith("params/")}
    s1, m1 = unsharded(state, batch)
    s2, m2 = step(sharded, batch)
    f1, f2 = flatten(s1), flatten(s2)
    lr = float(m1["lr"])
    out = {"loss_rel": abs(float(m2["loss"]) - float(m1["loss"])) / abs(float(m1["loss"])),
           "metrics": {k: [float(m1[k]), float(m2[k])] for k in m1},
           "grad_rel": {k: rel(g_got[k], g_want[k].float()) for k in g_want},
           # each leaf's update, and each optimiser slot, against the unsharded step's
           "update_rel": {k: rel(f2[k].full_tensor().float() - before[k].float(),
                                 f1[k].float() - before[k].float()) for k in before},
           "slot_rel": {k: rel(f2[k].full_tensor().float(), f1[k].float())
                        for k in f1 if k.startswith("opt/") and k != "opt/step"},
           "step": [int(f1["step"]), int(f2["step"].full_tensor())],
           "lr": lr,
           "shards": {k: [list(v.to_local().shape), list(v.shape)] for k, v in
                      f2.items() if k.startswith("params/")}}
    _, m1b = unsharded(s1, batch)
    _, m2b = step(s2, batch)
    out["loss2"] = [float(m1b["loss"]), float(m2b["loss"])]
    return out, s2, specs


# 1) sharded LM steps == unsharded ----------------------------------------
cfg = get_config("granite-3-2b").reduced()
rng = np.random.default_rng(0)
B, T = 8, 16
lm_batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
lm_bspecs = input_specs_sharding_for(cfg, "train_4k", mesh, False)
params = steps.init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
adamw = OptConfig(kind="adamw", warmup_steps=2, total_steps=100)
res["lm_adamw"], lm_state, lm_specs = compare("lm", cfg, adamw, params, lm_batch, lm_bspecs)
adafactor = OptConfig(kind="adafactor", warmup_steps=2, total_steps=100)
af_pspecs = lm_param_specs(cfg, mesh, False, True)  # 2D weights: both last dims sharded
af_specs = {"params": af_pspecs,
            "opt": opt_state_specs(af_pspecs, spmd.meta_state(cfg, adafactor)["opt"]),
            "step": P()}
res["lm_adafactor"], _, _ = compare("lm", cfg, adafactor, params, lm_batch, lm_bspecs,
                                    specs=af_specs)
res["lm_adafactor"]["wq_spec"] = list(af_specs["params"]["layers/wq"])
res["lm_adafactor"]["vc_wq_spec"] = list(af_specs["opt"]["vc"]["layers/wq"])

# an MoE model in 4 token groups (one a data rank, as the reference's dry-run
# sets them), two micro-batches: capacity drops and the router's aux loss are
# the unsharded step's
cfg_m = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(), moe_groups=4)
rng = np.random.default_rng(5)
moe_batch = {"tokens": rng.integers(0, cfg_m.vocab_size, (B, T)).astype(np.int32),
             "targets": rng.integers(0, cfg_m.vocab_size, (B, T)).astype(np.int32)}
params_m = steps.init_model_params(cfg_m, torch.Generator().manual_seed(6), "cpu")
res["moe"], _, _ = compare("lm", cfg_m, adamw, params_m, moe_batch,
                           input_specs_sharding_for(cfg_m, "train_4k", mesh, False), n_micro=2)
try:
    one_group = dataclasses.replace(cfg_m, moe_groups=1)
    spmd.make_sharded_train_step(one_group, adamw, mesh, spmd.state_specs_for(
        one_group, spmd.meta_state(one_group, adamw), mesh), lm_bspecs)
    res["moe_one_group_refused"] = None
except ValueError as e:
    res["moe_one_group_refused"] = str(e)

# 2) SASRec (masked by labels) and the GIN on a graph batch (masked graphs)
cfg_r = get_config("sasrec").reduced()
rng = np.random.default_rng(1)
labels = rng.integers(1, cfg_r.n_items, (B, cfg_r.seq_len)).astype(np.int32)
labels[:, : cfg_r.seq_len // 2] = 0
labels[2:4] = 0  # two rows with no label at all: one data rank holds none
rec_batch = {"hist": rng.integers(1, cfg_r.n_items, (B, cfg_r.seq_len)).astype(np.int32),
             "labels": labels,
             "negatives": rng.integers(1, cfg_r.n_items, (B, cfg_r.seq_len)).astype(np.int32)}
rec_bspecs = input_specs_sharding_for(cfg_r, "train_batch", mesh, False)
params_r = steps.init_model_params(cfg_r, torch.Generator().manual_seed(2), "cpu")
res["sasrec"], _, _ = compare("sasrec", cfg_r, adamw, params_r, rec_batch, rec_bspecs)
res["sasrec"]["batch_spec"] = list(rec_bspecs["hist"])

cfg_g = get_config("gin-tu").reduced()
dims = cfg_g.shapes["molecule"].dims
rng = np.random.default_rng(3)
gin_batch = {"node_feat": rng.normal(size=(B, dims["n_nodes"], dims["d_feat"])).astype(np.float32),
             "edge_src": rng.integers(0, dims["n_nodes"], (B, dims["n_edges"])).astype(np.int32),
             "edge_dst": rng.integers(0, dims["n_nodes"], (B, dims["n_edges"])).astype(np.int32),
             "labels": rng.integers(0, dims["n_classes"], B).astype(np.int32),
             "train_mask": np.array([1, 1, 0, 1, 0, 0, 1, 1], bool)}
gin_bspecs = input_specs_sharding_for(cfg_g, "molecule", mesh, False)
params_g = steps.init_model_params(cfg_g, torch.Generator().manual_seed(4), "cpu", "molecule")
res["gin"], _, _ = compare("gin", cfg_g, adamw, params_g, gin_batch, gin_bspecs,
                           shape_name="molecule")
res["gin"]["batch_spec"] = [list(x) if isinstance(x, tuple) else x for x in gin_bspecs["labels"]]

# 3) compressed all-reduce over the data axis -------------------------------
x = np.random.default_rng(1).normal(size=(8, 64)).astype(np.float32)
local = torch.from_numpy(x.reshape(4, 2, 64)[data_rank].copy())
y = gc.psum_int8(local, (mesh, "data"))
blocks = [np.pad(x.reshape(4, 2, 64)[r].reshape(-1), (0, 128)).reshape(-1, 256) for r in range(4)]
scale = np.maximum(np.max([np.max(np.abs(b), axis=1, keepdims=True) / np.float32(127.0)
                           for b in blocks], axis=0), np.float32(1e-12)).astype(np.float32)
q = sum(np.clip(np.round(b / scale), -127, 127).astype(np.int32) for b in blocks)
formula = (q.astype(np.float32) * scale).reshape(-1)[:128].reshape(2, 64)
res["psum_int8_bitequal"] = bool(np.array_equal(y.numpy(), formula))
res["psum_int8_err"] = float(np.max(np.abs(y.numpy() / 4.0 - x.reshape(4, 2, 64).mean(0))))
tot, resid = gc.psum_topk(local, (mesh, "data"), k_frac=0.1)
want = np.zeros((4, 128), np.float32)
for r in range(4):
    flat = x.reshape(4, 2, 64)[r].reshape(-1)
    idx = np.argsort(-np.abs(flat), kind="stable")[:12]
    want[r, idx] = flat[idx]
res["psum_topk_bitequal"] = bool(np.array_equal(tot.numpy().reshape(-1), want.sum(0)))

# 4) elastic reshard: save on 4 x 2, restore, reshard onto 2 x 4 -----------
mesh2 = make_mesh((2, 4), ("data", "model"), device_type="cpu")
ckdir = os.path.join(os.path.dirname(out), "ckpt")
fresh = lambda: steps.init_state(  # noqa: E731
    steps.init_model_params(cfg, None, "meta").to_empty(device="cpu"), adamw)
for async_save in (False, True):
    ck = Checkpointer(ckdir, async_save=async_save)
    ck.save(1 + async_save, lm_state)
    ck.wait()
    specs2 = spmd.state_specs_for(cfg, fresh(), mesh2)
    restored, _ = ck.restore(fresh())
    re_sharded = reshard(restored, mesh2, specs2)
    named = {k: NamedSharding(mesh2, v) for k, v in flatten_specs(specs2).items()}
    via_restore, _ = ck.restore(fresh(), sharding_tree=named)
    a, b, c = flatten(lm_state), flatten(re_sharded), flatten(via_restore)
    res[f"reshard_bitequal_async{int(async_save)}"] = all(
        torch.equal(a[k].full_tensor(), b[k].full_tensor())
        and torch.equal(a[k].full_tensor(), c[k].full_tensor()) for k in a)
    res[f"reshard_wq_local_async{int(async_save)}"] = list(b["params/layers/wq"].to_local().shape)

# 5) the partitioned server across the data ranks --------------------------
n_docs = 1600
rng = np.random.default_rng(7)
lists = []
for i in range(16):
    n = int(rng.integers(300, 600)) if i < 4 else int(rng.integers(3, 150))
    lists.append(np.unique(rng.integers(0, n_docs, size=n)).astype(np.int64))


class Host:
    def lookup(self, term):
        return int(term[1:]) if term[1:].isdigit() and int(term[1:]) < len(lists) else None


qs = [[f"t{a}", f"t{b}"] for a, b in rng.integers(0, len(lists), (20, 2))]
qs += [["t0", "t1"], ["t1", "t2", "t3"], ["t0", "nope"], ["t2"], ["t5", "t6", "t0"]]
res["queries"] = qs
for s in (4, 8):
    whole = part.PartitionedAnchoredIndex.build(lists, n_docs, s, device="cpu")
    one = part.PartitionedServer(whole, Host(), probe="torch")
    on_mesh = part.PartitionedServer(whole, Host(), mesh=mesh, probe="torch")
    r = {"n_local": on_mesh.pidx.n_shards, "first_shard": on_mesh.pidx.first_shard}
    for method in ("conjunctive", "phrase"):
        got = getattr(on_mesh, method)(qs)
        ref = getattr(one, method)(qs)
        r[method] = [g.tolist() for g in got]
        r[method + "_equal_one_device"] = all(np.array_equal(g, w) for g, w in zip(got, ref))
    local_bytes = torch.tensor([on_mesh.pidx.device_bytes()], dtype=torch.int64)
    dist.all_reduce(local_bytes, group=mesh.get_group("data"))
    r["device_bytes_sum"] = int(local_bytes)
    r["device_bytes_one"] = one.pidx.device_bytes()
    r["windows_swept"] = on_mesh.windows_swept
    res[f"partitioned_{s}"] = r
try:
    part.PartitionedServer(part.PartitionedAnchoredIndex.build(lists, n_docs, 6, device="cpu"),
                           Host(), mesh=mesh, probe="torch")
    res["six_refused"] = None
except ValueError as e:
    res["six_refused"] = str(e)
res["lists"] = [l.tolist() for l in lists]

dist.barrier()
dist.destroy_process_group()
with open(out, "w") as f:
    json.dump(res, f)
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    script = tmp / "rank.py"
    script.write_text(SCRIPT)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "HOME": str(tmp),
           "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp)}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(WORLD),
                               str(tmp / "store"), str(tmp / f"rank{r}.json")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(tmp)) for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [(r, p.returncode, e[-3000:]) for r, (p, e) in enumerate(zip(procs, errs))
              if p.returncode != 0]
    assert not failed, failed[0]
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]


LOSS_REL = 1e-6
GRAD_REL = {"lm_adamw": 1e-5, "lm_adafactor": 1e-5, "moe": 1e-5, "sasrec": 1e-5,
            "gin": 2.0 ** -8}
CASES = list(GRAD_REL)


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_unsharded(ranks, case):
    """Limits: the module docstring's for the loss and the gradients; an
    optimiser slot is the gradient (AdamW's m), its square (v) or means of
    its square (Adafactor's vr, vc), so twice the gradient's; a parameter's
    first AdamW update is about lr * g / |g| and Adafactor's a normalised
    g, which move by less than the gradient's relative gap but where an
    element's sign lies within its rounding, so each leaf's update is held
    to ||du|| / ||u|| <= 1e-4 in float32 (the measured gaps are under 1.1e-5;
    a wrong shard's gradient, a flipped sign or a skipped update gives 1 to
    2), and the GIN's to its gradient limit; the second step's loss, from
    the two updated states, to the first's 1e-6."""
    update_rel = GRAD_REL[case] if case == "gin" else 1e-4
    for r in ranks:
        got = r[case]
        assert got["loss_rel"] <= LOSS_REL, got["metrics"]
        worst = max(got["grad_rel"].values())
        assert worst <= GRAD_REL[case], got["grad_rel"]
        assert max(got["slot_rel"].values()) <= 2 * GRAD_REL[case], got["slot_rel"]
        assert max(got["update_rel"].values()) <= update_rel, got["update_rel"]
        a, b = got["loss2"]
        assert abs(a - b) <= LOSS_REL * abs(a), got["loss2"]
        assert got["step"] == [1, 1]
        for k, (a, b) in got["metrics"].items():
            # the global norm moves with the gradients; the rest with the loss
            limit = GRAD_REL[case] if k == "grad_norm" else 1e-5
            assert abs(a - b) <= limit * max(1.0, abs(a)), (k, a, b)
        assert got["metrics"]["lr"][0] == got["metrics"]["lr"][1]


def test_moe_groups_not_dividing_the_slices_refused(ranks):
    """One token group over 4 data ranks: a rank's slice would route with
    its own capacity, so the sharded step refuses it by name."""
    for r in ranks:
        msg = r["moe_one_group_refused"]
        assert msg and "moe_groups=1 is not a multiple of the 4 batch slices" in msg


def test_sharded_state_is_sharded(ranks):
    """The specs shard the storage: granite's wq over "model" (and, with
    2D weights, its last two dimensions over "data" and "model"); the
    batch over the data ranks (the GIN's graphs over all eight)."""
    r = ranks[0]
    local, whole = r["lm_adamw"]["shards"]["params/layers/wq"]
    assert local[:2] == whole[:2] and local[2] * 2 == whole[2]
    assert r["lm_adafactor"]["wq_spec"] == [None, "data", "model"]
    assert r["lm_adafactor"]["vc_wq_spec"] == [None, "model"]
    local, whole = r["lm_adafactor"]["shards"]["params/layers/wq"]
    assert local[1] * 4 == whole[1] and local[2] * 2 == whole[2]
    assert r["sasrec"]["batch_spec"] == ["data", None]
    assert r["gin"]["batch_spec"] == [["data", "model"]]


def test_psum_int8(ranks):
    for r in ranks:
        assert r["psum_int8_bitequal"]
        assert r["psum_int8_err"] < 2e-2
        assert r["psum_topk_bitequal"]


def test_elastic_reshard(ranks):
    for r in ranks:
        for a in (0, 1):
            assert r[f"reshard_bitequal_async{a}"]
            assert r[f"reshard_wq_local_async{a}"][2] * 4 == ranks[0]["lm_adamw"]["shards"][
                "params/layers/wq"][1][2]


def _oracle(lists, q, phrase, n_shards):
    """The posting lists' AND, or their phrase matches that do not cross a
    shard's cut (equal cuts, as the layout makes them)."""
    if any(not (t[1:].isdigit() and int(t[1:]) < len(lists)) for t in q):
        return None
    ids = [int(t[1:]) for t in q]
    out = np.asarray(lists[ids[0]], dtype=np.int64)
    for k, i in enumerate(ids[1:], start=1):
        other = np.asarray(lists[i], dtype=np.int64)
        out = out[np.isin(out + k, other)] if phrase else np.intersect1d(out, other)
    if phrase:
        cuts = np.linspace(0, 1600, n_shards + 1).astype(np.int64)
        shard = np.searchsorted(cuts, out, side="right")
        out = out[shard == np.searchsorted(cuts, out + len(ids) - 1, side="right")]
    return out


@pytest.mark.parametrize("n_shards", [4, 8])
def test_partitioned_server_on_mesh(ranks, n_shards):
    from repro.serving import partitioned as ref_part

    class Host:
        def lookup(self, term):
            return int(term[1:]) if term[1:].isdigit() and int(term[1:]) < len(lists) else None

    lists = [np.asarray(x, dtype=np.int64) for x in ranks[0]["lists"]]
    qs = ranks[0]["queries"]
    ref = ref_part.PartitionedServer(
        ref_part.PartitionedAnchoredIndex.build(lists, 1600, n_shards), Host())
    for r in ranks:
        got = r[f"partitioned_{n_shards}"]
        assert got["n_local"] == n_shards // 4
        assert got["first_shard"] == r["data_rank"] * (n_shards // 4)
        assert got["device_bytes_sum"] == got["device_bytes_one"]
        for method in ("conjunctive", "phrase"):
            assert got[method + "_equal_one_device"]
            assert got[method] == ranks[0][f"partitioned_{n_shards}"][method]
            want = getattr(ref, method)(qs)
            for q, g, w in zip(qs, got[method], want):
                assert g == np.asarray(w).tolist(), (method, q)
                o = _oracle(lists, q, method == "phrase", n_shards)
                if o is not None:
                    assert g == o.tolist(), (method, q)


def test_shards_not_dividing_the_axis_refused(ranks):
    for r in ranks:
        assert r["six_refused"] and "6 shards do not divide" in r["six_refused"]
