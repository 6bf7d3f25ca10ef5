"""The port's GIN and graph data on the CPU, against the reference.

``data.graphs`` (the synthetic graph, the fanout sampler, the batch
generators) must give the reference's arrays exactly; the GIN forward
(node and batched-graph regimes), loss and gradients, with the reference's
weights carried across by ``gnn_params_from_reference``, and whole train
steps.  Tolerances:

* logits and the loss: 1e-5 of the largest |value| (both sides sum float32
  products in their own order; the messages are the same bf16 roundings);
* gradients: 2^-7 of the leaf's largest |gradient|.  Each edge's message
  gradient is rounded to bf16 on both sides; the reference's transpose
  scatter then adds those bf16 values in bf16 (the port adds them in
  float32), so the sums differ by bf16 roundings of partial sums (measured
  up to 3.7e-3 of the largest gradient in the batched-graph regime, 3e-7 in
  the mini-batch one);
* losses across three train steps: 1e-4 relative (the gradients above feed
  Adam, whose first step amplifies rounding noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import graphs as ref_graphs
from repro.models import gnn as ref_gnn
from repro.models import steps as ref_steps
from repro.train import optimizer as ref_opt
from repro_torch import configs
from repro_torch.data import graphs
from repro_torch.models import gnn, steps
from repro_torch.models.segment import ordered_segment_sum
from repro_torch.train import optimizer as opt

KEY = jax.random.PRNGKey(0)
GRAD_REL = 2.0 ** -7


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        assert np.array_equal(a[k], b[k]), k


# ----------------------------------------------------------------------
# graph data
# ----------------------------------------------------------------------
def test_synthetic_graph_and_sampler_match_reference():
    g, rg = graphs.synthetic_graph(300, 6, 12, 4, seed=3), ref_graphs.synthetic_graph(300, 6, 12,
                                                                                       4, seed=3)
    for f in ("edge_src", "edge_dst", "node_feat", "labels"):
        assert np.array_equal(getattr(g, f), getattr(rg, f)), f
    assert g.n_nodes == rg.n_nodes and g.n_edges == rg.n_edges
    s, rs = graphs.NeighborSampler(g, seed=1), ref_graphs.NeighborSampler(rg, seed=1)
    assert np.array_equal(s.indptr, rs.indptr) and np.array_equal(s.nbr_src, rs.nbr_src)
    seeds = np.arange(0, 300, 7)
    _same(s.sample_block(seeds, (5, 3)), rs.sample_block(seeds, (5, 3)))


def test_batch_generators_match_reference():
    g, rg = graphs.synthetic_graph(200, 4, 8, 3, seed=1), ref_graphs.synthetic_graph(200, 4, 8,
                                                                                      3, seed=1)
    it, rit = graphs.graph_batches(g, 16, (4, 2), seed=2), ref_graphs.graph_batches(rg, 16, (4, 2),
                                                                                    seed=2)
    for _ in range(3):
        _same(next(it), next(rit))
    it, rit = graphs.molecule_batches(4, 10, 20, 6, 2, seed=5), ref_graphs.molecule_batches(
        4, 10, 20, 6, 2, seed=5)
    for _ in range(2):
        _same(next(it), next(rit))


# ----------------------------------------------------------------------
# GIN
# ----------------------------------------------------------------------
def _models(d_feat: int, n_classes: int):
    rc, pc = ref_configs.get_config("gin-tu").reduced(), configs.get_config("gin-tu").reduced()
    rp = ref_gnn.init_params(rc, KEY, d_feat, n_classes)
    return rc, pc, rp, gnn.gnn_params_from_reference(pc, jax.tree.map(np.asarray, rp), "cpu")


def _node_batch():
    g = ref_graphs.synthetic_graph(400, 5, 16, 4, seed=7)
    return next(ref_graphs.graph_batches(g, 24, (5, 3), seed=8))


def _graph_batch():
    return next(ref_graphs.molecule_batches(6, 12, 30, 16, 2, seed=9))


@pytest.mark.parametrize("regime", ["minibatch", "full", "molecule"])
def test_gin_forward_loss_and_grads_match_reference(regime):
    if regime == "molecule":
        batch = _graph_batch()
    else:
        batch = _node_batch()
        if regime == "full":  # the block as a full graph: loss on every node
            n = batch["node_feat"].shape[0]
            rng = np.random.default_rng(1)
            batch = dict(batch, labels=rng.integers(0, 4, n).astype(np.int32),
                         train_mask=rng.random(n) < 0.5)
    rc, pc, rp, model = _models(16, 4 if regime != "molecule" else 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (rl, raux), rg = jax.value_and_grad(lambda p: ref_gnn.loss_fn(rc, p, jb), has_aux=True)(rp)
    pl, paux, pg = steps._grads(lambda p, b: gnn.loss_fn(pc, p, b), model, tb)
    np.testing.assert_allclose(float(pl), float(rl), rtol=1e-5)
    assert float(paux["acc"]) == float(raux["acc"])
    fwd = gnn.forward_graph_batch if regime == "molecule" else gnn.forward_node
    ref_fwd = ref_gnn.forward_graph_batch if regime == "molecule" else ref_gnn.forward_node
    with torch.no_grad():
        got = fwd(pc, model, tb["node_feat"], tb["edge_src"], tb["edge_dst"]).numpy()
    want = np.asarray(ref_fwd(rc, rp, jb["node_feat"], jb["edge_src"], jb["edge_dst"]))
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
    want_g = {_path(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(rg)[0]}
    assert sorted(want_g) == sorted(pg)
    for k, w in want_g.items():
        assert np.max(np.abs(pg[k].numpy() - w), initial=0) <= GRAD_REL * max(
            np.max(np.abs(w), initial=0), 1e-30), k


def test_gin_aggregation_is_ordered_and_device_free():
    """The sum by dst is the ordered sum: equal to a float64 oracle to
    float32 rounding, and bit for bit the same on a second call."""
    rng = np.random.default_rng(2)
    vals = torch.from_numpy(rng.normal(size=(500, 8)).astype(np.float32))
    dst = torch.from_numpy(rng.integers(0, 40, 500).astype(np.int32))
    got = ordered_segment_sum(vals, dst, 40)
    want = np.zeros((40, 8))
    np.add.at(want, dst.numpy(), vals.double().numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ordered_segment_sum(vals, dst, 40))


def test_pad_graph_batch_matches_reference():
    batch = _node_batch()
    n = batch["node_feat"].shape[0]
    batch = dict(batch, labels=np.zeros(n, np.int32), train_mask=np.ones(n, bool))
    want = ref_gnn.pad_graph_batch({k: jnp.asarray(v) for k, v in batch.items()}, 64)
    got = gnn.pad_graph_batch({k: torch.from_numpy(v) for k, v in batch.items()}, 64)
    _same({k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()})
    with pytest.raises(NotImplementedError, match="mesh"):
        gnn.pad_graph_batch(got, 64, shard_axes=("data",))


def test_gin_init_and_weights_from_reference():
    cfg = configs.get_config("gin-tu").reduced()
    a = steps.init_model_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = steps.init_model_params(cfg, torch.Generator().manual_seed(3), "cpu")
    dims = cfg.shapes["full_graph_sm"].dims
    ref = ref_steps.init_model_params(ref_configs.get_config("gin-tu").reduced(), KEY)
    shapes = {_path(p): np.shape(v) for p, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    mine = {k: tuple(v.shape) for k, v in opt.param_tree(a).items()}
    assert mine == shapes and list(mine) == list(shapes)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert a.layers[0]["w1"].shape == (dims["d_feat"], cfg.d_hidden)
    assert float(a.layers[0]["eps"].detach()) == 0.0 and not bool(a.out_b.detach().any())


def test_gin_train_steps_match_reference_losses():
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=100)
    ro, po = ref_opt.OptConfig(**kw), opt.OptConfig(**kw)
    rc, pc, rp, model = _models(16, 4)
    g = ref_graphs.synthetic_graph(400, 5, 16, 4, seed=7)
    it = ref_graphs.graph_batches(g, 24, (5, 3), seed=8)
    batches = [next(it) for _ in range(3)]
    rstep = jax.jit(ref_steps.make_gnn_train_step(rc, ro))
    pstep = steps.make_gnn_train_step(pc, po)
    rstate, pstate = ref_steps.init_state(rp, ro), steps.init_state(model, po)
    rl, pl = [], []
    for bt in batches:
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in bt.items()})
        pstate, pm = pstep(pstate, bt)
        rl.append(float(rm["loss"]))
        pl.append(float(pm["loss"]))
    np.testing.assert_allclose(pl, rl, rtol=1e-4)
    assert int(pstate["step"]) == 3
