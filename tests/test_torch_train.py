"""The port's training path on the CPU, against the reference.

The optimisers (given the same gradients), the flash attention custom VJP,
the LM loss and its gradients (dense and MoE, micro-batched), the recsys
losses and gradients of the four families, whole train steps, the
kernels' autograd Functions on CPU tensors (where each wrapper takes its
plain version: the plumbing, not the kernels, which ``chip_smoke.py``
holds against these on a card), ``TrainLoop`` and the driver.  Weights are
the reference's, carried across; inputs come from NumPy with a seed.

Tolerances, each measured well inside its bound:

* optimisers: parameters and state within 1e-6 of the leaf's largest
  |value| (float32 rounding: the global norm's sum runs in another order, so
  the clip scale may differ by one ulp; measured up to 5.6e-7); a bf16
  parameter within one bf16 step;
* float32 gradients: within 1e-5 of the leaf's largest |gradient| (both
  sides sum float32 products in their own order; measured ~1.4e-6);
* float32 attention: 1e-5 absolute (values O(1)); bf16 attention: the
  output is a bf16 rounding of float32 values that differ in their last
  bits, so the two may be neighbours: 2^-7 of the value plus 1e-5 (the
  products of bf16-rounded operands are exact in float32 on both sides,
  only their sums' order differs).  The bf16 gradients add 2^-9 of the
  tensor's largest |value|: a p or dS that differs in its last float32 bit
  may round to the neighbouring bf16 value, which moves one term of a sum
  (not the sum) by a bf16 step, visible where the terms cancel (measured
  1.2 of the first bound alone on one dk element, 6e-5 of max |dk|);
* losses across whole train steps: within 1e-5 relative (Adam's first step
  amplifies rounding noise in near-zero gradients, so parameters are not
  compared across steps: the optimiser is held separately on one set of
  gradients).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipelines as ref_pipelines
from repro.models import flash as ref_flash
from repro.models import layers as ref_layers
from repro.models import recsys as ref_recsys
from repro.models import steps as ref_steps
from repro.models import transformer as ref_transformer
from repro.train import optimizer as ref_opt
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer, flatten
from repro_torch.kernels.cin_interaction.ops import CinLayer, cin_layer_backward, cin_layer_torch
from repro_torch.kernels.embedding_bag.ops import (
    EmbeddingBag, embedding_bag_backward, embedding_bag_torch)
from repro_torch.kernels.flash_attention.ops import flash_attention_torch, flash_attention_tpu_fwd
from repro_torch.kernels.moe_gemm.ops import MoeGemm, moe_gemm, moe_gemm_torch
from repro_torch.launch import train as launch_train
from repro_torch.models import flash, layers, recsys, steps, transformer
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import TrainLoop, WatchdogStats

KEY = jax.random.PRNGKey(0)
GRAD_REL = 1e-5
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _ref_leaves(tree) -> dict:
    return {_path(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel_close(got, want, rel: float) -> None:
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want), initial=0.0) <= rel * max(np.max(np.abs(want),
                                                                         initial=0.0), 1e-30)


def _grads_close(ref_grads, port_grads: dict, rel: float = GRAD_REL) -> None:
    want = _ref_leaves(ref_grads)
    assert sorted(want) == sorted(port_grads)
    for k, g in want.items():
        got = _np(port_grads[k])
        scale = max(float(np.max(np.abs(g))), 1e-30) if g.size else 1.0
        assert got.shape == g.shape, k
        assert np.max(np.abs(got - g.astype(np.float32)), initial=0.0) <= rel * scale, k


# ----------------------------------------------------------------------
# optimisers
# ----------------------------------------------------------------------
SHAPES = {"layers/wq": (2, 3, 4), "embed": (5, 3), "bias": (7,), "scale": ()}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_matches_reference_on_the_same_gradients(kind, dtype):
    """Four updates with NumPy gradients from one seed (the first one large
    enough to clip): parameters, state, grad_norm and lr equal to float32
    rounding; a bf16 parameter comes back in bf16."""
    rng = np.random.default_rng(1)
    kw = dict(kind=kind, lr=1e-2, warmup_steps=2, total_steps=10)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    rp = {k: jnp.asarray(v, jdt) for k, v in init.items()}
    pp = {k: torch.from_numpy(_np(rp[k])).to(tdt) for k in init}
    rs, ps = ref_opt.opt_init(ref_opt.OptConfig(**kw), rp), opt.opt_init(opt.OptConfig(**kw), pp)
    for i in range(4):
        g = {k: np.asarray(rng.normal(size=s) * (10.0 if i == 0 else 1.0), np.float32)
             for k, s in SHAPES.items()}
        rp, rs, rm = ref_opt.opt_update(ref_opt.OptConfig(**kw), rp,
                                        {k: jnp.asarray(v) for k, v in g.items()}, rs)
        pp, ps, pm = opt.opt_update(opt.OptConfig(**kw), pp,
                                    {k: torch.from_numpy(v) for k, v in g.items()}, ps)
        for k in SHAPES:
            assert pp[k].dtype == tdt
            if dtype == "float32":
                _rel_close(pp[k], rp[k], 1e-6)
            else:
                _attn_close(pp[k], rp[k], torch.bfloat16)
        for key in ("m", "v") if kind == "adamw" else ("vr", "vc"):
            for k in SHAPES:
                _rel_close(ps[key][k], rs[key][k], 1e-6)
        assert int(ps["step"]) == int(rs["step"]) == i + 1
        assert ps["step"].dtype == torch.int32
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
        assert float(pm["lr"]) == float(rm["lr"])


def test_schedule_and_clipping_match_reference():
    cfg_r = ref_opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    cfg_p = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert float(opt.schedule(cfg_p, torch.tensor(s, dtype=torch.int32))) == \
            float(ref_opt.schedule(cfg_r, jnp.asarray(s, jnp.int32))), s
    tree = {"a": np.full((10,), 100.0, np.float32), "b": np.arange(6, dtype=np.float32)}
    rc, rn = ref_opt.clip_by_global_norm({k: jnp.asarray(v) for k, v in tree.items()}, 1.0)
    pc, pn = opt.clip_by_global_norm({k: torch.from_numpy(v) for k, v in tree.items()}, 1.0)
    np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(rc[k]), rtol=1e-6)
    assert abs(float(opt.global_norm(pc)) - 1.0) < 1e-5


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_converges(kind):
    """The reference's quadratic problem (tests/test_train.py:28)."""
    cfg = opt.OptConfig(kind=kind, lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=10000)
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}
    state = opt.opt_init(cfg, params)
    for _ in range(300):
        grads = {"w": 2 * params["w"], "b": 2 * params["b"]}
        params, state, _ = opt.opt_update(cfg, params, grads, state)
    assert float(torch.sum(params["w"] ** 2) + params["b"] ** 2) < 1e-2


def test_param_tree_uses_reference_paths():
    cfg = configs.get_config("sasrec").reduced()
    model = steps.init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = ref_steps.init_model_params(ref_configs.get_config("sasrec").reduced(), KEY)
    assert list(opt.param_tree(model)) == list(_ref_leaves(ref))


# ----------------------------------------------------------------------
# flash attention: the custom VJP
# ----------------------------------------------------------------------
ATTN_CASES = [  # (B, T, H, K, hd, block_kv, causal)
    (2, 50, 4, 2, 16, 16, True),   # T not a multiple of block_kv, GQA 2
    (1, 33, 4, 1, 32, 32, False),  # non-causal, GQA 4
    (2, 16, 2, 2, 16, 16, True),   # one block
]


def _attn_inputs(rng, b, t, h, kh, hd, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    arrs = [jnp.asarray(rng.normal(size=s).astype(np.float32), jdt)
            for s in ((b, t, h, hd), (b, t, kh, hd), (b, t, kh, hd), (b, t, h, hd))]
    return arrs, [torch.from_numpy(_np(a)).to(dtype) for a in arrs]


def _attn_close(got, want, dtype, grad: bool = False) -> None:
    got, want = _np(got), _np(want)
    if dtype == torch.float32:
        assert np.max(np.abs(got - want)) <= 1e-5
    else:
        slack = 2.0 ** -9 * np.max(np.abs(want)) if grad else 0.0
        assert np.all(np.abs(got - want) <= BF16_REL * np.abs(want) + BF16_ABS + slack)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", ["plain", "kernel_function"])
def test_flash_attention_vjp_matches_reference(case, dtype, fn):
    """Forward, log-sum-exp and (dq, dk, dv) against ``jax.vjp`` of the
    reference's custom VJP: ``FlashAttention`` over the plain forward (KV
    blocks) and over the kernel's forward (on CPU tensors the kernel
    wrapper takes its plain version: one block of all keys)."""
    b, t, h, kh, hd, blk, causal = case
    (q, k, v, do), (tq, tk, tv, tdo) = _attn_inputs(np.random.default_rng(2), b, t, h, kh, hd,
                                                    dtype)
    out, vjp = jax.vjp(lambda q, k, v: ref_flash.flash_attention(q, k, v, causal, blk), q, k, v)
    dq, dk, dv = vjp(do)
    _, lse = ref_flash._flash_fwd_impl(q, k, v, causal, blk)
    xs = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    fwd = None if fn == "plain" else flash_attention_tpu_fwd
    got = flash.FlashAttention.apply(*xs, causal, blk, fwd)
    got.backward(tdo)
    assert got.dtype == dtype and all(x.grad.dtype == dtype for x in xs)
    _attn_close(got, out, dtype)
    for g, w in ((xs[0].grad, dq), (xs[1].grad, dk), (xs[2].grad, dv)):
        _attn_close(g, w, dtype, grad=True)
    if fn == "plain":
        _, plse = flash.flash_attention_fwd(tq, tk, tv, causal, blk)
    else:
        _, plse = flash_attention_torch(tq, tk, tv, causal, return_lse=True)
    np.testing.assert_allclose(plse.reshape(np.shape(lse)).numpy(), np.asarray(lse),
                               rtol=1e-6, atol=1e-5)


def test_lse_of_a_row_with_one_live_key_is_its_score():
    """Under causal, row 0 sees key 0 only: its lse is that one scaled
    score (no log(l) term), which pins the units of the log-sum-exp."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((1, 5, 4, 16), (1, 5, 2, 16), (1, 5, 2, 16)))
    _, lse = flash_attention_torch(q, k, v, True, return_lse=True)
    assert lse.shape == (1, 5, 4) and lse.dtype == torch.float32
    score = (q[0, 0] * k[0, 0].repeat_interleave(2, dim=0)).sum(-1) / 4.0
    np.testing.assert_allclose(lse[0, 0].numpy(), score.numpy(), rtol=1e-6, atol=1e-6)


def test_bf16_backward_keeps_the_reference_roundings():
    """With p, dO and dS kept in float32 (no bf16 casts) the gradients
    would move off the reference's by more than the bf16 limit: the casts
    are what makes the two agree."""
    b, t, h, kh, hd, blk, causal = ATTN_CASES[0]
    (q, k, v, do), (tq, tk, tv, tdo) = _attn_inputs(np.random.default_rng(2), b, t, h, kh, hd,
                                                    torch.bfloat16)
    _, vjp = jax.vjp(lambda q, k, v: ref_flash.flash_attention(q, k, v, causal, blk), q, k, v)
    dq = _np(vjp(do)[0])
    out, lse = flash.flash_attention_fwd(tq, tk, tv, causal, blk)
    ours = flash.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal, blk)[0]
    exact = flash.flash_attention_bwd(tq.float(), tk.float(), tv.float(), out.float(), lse,
                                      tdo.float(), causal, blk)[0]
    assert np.max(np.abs(_np(ours) - dq)) < np.max(np.abs(_np(exact) - dq))


# ----------------------------------------------------------------------
# the LM loss and its gradients
# ----------------------------------------------------------------------
def _lm(name: str):
    rc = ref_configs.get_config(name).reduced()
    pc = configs.get_config(name).reduced()
    rp = ref_transformer.init_params(rc, KEY)
    return rc, pc, rp, transformer.params_from_reference(pc, jax.tree.map(np.asarray, rp), "cpu")


@pytest.fixture
def kernel_route_on_cpu(monkeypatch):
    """``attention=None`` answers ``"kernel"`` on the CPU, so that the
    train step goes through the kernels' autograd Functions (whose wrappers
    take their plain versions for CPU tensors)."""
    orig = transformer.resolve_attention
    monkeypatch.setattr(transformer, "resolve_attention",
                        lambda a, d: "kernel" if a is None else orig(a, d))


@pytest.mark.parametrize("name", ["qwen3-8b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("route", ["plain", "functions"])
def test_lm_loss_and_grads_match_reference(name, n_micro, route, request):
    """``loss_fn`` through the accumulation of ``steps._accum_grads`` against
    the reference's ``jax.value_and_grad`` (its scan over micro-batches)."""
    if route == "functions":
        request.getfixturevalue("kernel_route_on_cpu")
    rc, pc, rp, model = _lm(name)
    batch = next(ref_pipelines.lm_batches(rc, 4, 24, 0))
    rl, raux, rg = ref_steps._accum_grads(
        lambda p, bt: ref_transformer.loss_fn(rc, p, bt["tokens"], bt["targets"]), rp,
        {k: jnp.asarray(v) for k, v in batch.items()}, n_micro)
    pl, paux, pg = steps._accum_grads(
        lambda p, bt: transformer.loss_fn(pc, p, bt["tokens"], bt["targets"]), model,
        {k: torch.from_numpy(v) for k, v in batch.items()}, n_micro)
    np.testing.assert_allclose(float(pl), float(rl), rtol=1e-5)
    np.testing.assert_allclose(float(paux["aux"]), float(raux["aux"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(paux["nll"]), float(raux["nll"]), rtol=1e-5)
    _grads_close(rg, pg)
    if n_micro > 1:
        assert all(g.dtype == torch.float32 for g in pg.values())


@pytest.mark.parametrize("gemm", ["plain", "MoeGemm"])
def test_moe_block_grads_with_capacity_drops(gemm):
    """Experts overflow their capacity (the router prefers expert 0 for
    every token): gradients flow through the gates and the kept tokens
    only, as the reference's; x, the router and the three expert weights
    against ``jax.grad`` of the reference's ``moe_block``."""
    rng = np.random.default_rng(4)
    n, d, e, f, k = 24, 8, 4, 6, 2
    x, rw = rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(d, e)).astype(np.float32)
    rw[:, 0] += 4.0 * np.sign(x.mean(0))  # most tokens choose expert 0 first
    wg, wu = (rng.normal(size=(e, d, f)).astype(np.float32) for _ in range(2))
    wd = rng.normal(size=(e, f, d)).astype(np.float32)
    dims_r, dims_p = ref_layers.MoEDims(e, k), layers.MoEDims(e, k)
    plan = layers.moe_dispatch(layers.moe_router(torch.from_numpy(x), torch.from_numpy(rw),
                                                 k)[2], dims_p)
    assert not bool(plan["keep"].all())  # some choices are dropped

    def ref_loss(x, rw, wg, wu, wd):
        y, aux = ref_layers.moe_block(x, rw, wg, wu, wd, dims_r)
        return jnp.sum(y * jnp.cos(jnp.arange(d))) + aux

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, rw, wg, wu, wd)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, rw, wg, wu, wd)]
    fn = moe_gemm_torch if gemm == "plain" else (lambda b, w: MoeGemm.apply(b, w, moe_gemm))
    y, aux = layers.moe_block(*ts, dims_p, gemm=fn)
    (torch.sum(y * torch.cos(torch.arange(d).float())) + aux).backward()
    for t, w in zip(ts, want):
        w = np.asarray(w)
        assert np.max(np.abs(t.grad.numpy() - w)) <= GRAD_REL * np.max(np.abs(w))


# ----------------------------------------------------------------------
# recsys
# ----------------------------------------------------------------------
RECSYS = ["fm", "xdeepfm", "sasrec", "two-tower-retrieval"]


def _recsys(name: str):
    rc = ref_configs.get_config(name).reduced()
    pc = configs.get_config(name).reduced()
    rp = ref_steps.init_model_params(rc, KEY)
    return rc, pc, rp, recsys.recsys_params_from_reference(pc, jax.tree.map(np.asarray, rp),
                                                           "cpu")


@pytest.mark.parametrize("name", RECSYS)
def test_recsys_loss_and_grads_match_reference(name):
    rc, pc, rp, model = _recsys(name)
    batch = next(ref_pipelines.recsys_batches(rc, 16, seed=5))
    (rl, _), rg = jax.value_and_grad(lambda p: ref_steps._recsys_loss(rc, p, {
        k: jnp.asarray(v) for k, v in batch.items()}), has_aux=True)(rp)
    pl, _, pg = steps._grads(lambda p, bt: steps._recsys_loss(pc, p, bt), model,
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(pl), float(rl), rtol=1e-5)
    _grads_close(rg, pg)


def test_embedding_bag_backward_is_the_ordered_scatter():
    """The table gradient of bags of 3 with repeated ids and an id outside
    the table: each row the sum of its positions' bag gradients (against a
    float64 oracle), ids outside adding nothing; bit for bit the same on a
    second call (no atomics)."""
    rng = np.random.default_rng(6)
    idx = torch.from_numpy(rng.integers(0, 9, (40, 3)).astype(np.int32))
    idx[3, 1] = 12  # outside a 10-row table
    dout = torch.from_numpy(rng.normal(size=(40, 4)).astype(np.float32))
    got = embedding_bag_backward(idx, dout, 10)
    want = np.zeros((10, 4))
    for j, r in enumerate(idx.reshape(-1).tolist()):
        if r < 10:
            want[r] += dout[j // 3].double().numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, embedding_bag_backward(idx, dout, 10))
    table = torch.from_numpy(rng.normal(size=(10, 4)).astype(np.float32)).requires_grad_(True)
    EmbeddingBag.apply(idx, table, 1, embedding_bag_torch).backward(dout)
    assert torch.equal(table.grad, got)


def test_cin_layer_backward_matches_autograd_of_the_plain_layer(monkeypatch):
    """Chunked backward (chunks forced to 3 rows) against autograd through
    the reference's two einsums."""
    from repro_torch.kernels.cin_interaction import ops as cin_ops

    rng = np.random.default_rng(7)
    x0, xk = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in ((8, 3, 5), (8, 4, 5)))
    w = torch.from_numpy(rng.normal(size=(12, 6)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(8, 6, 5)).astype(np.float32))
    xs = [t.clone().requires_grad_(True) for t in (x0, xk, w)]
    z = torch.einsum("bmd,bhd->bmhd", xs[0], xs[1]).reshape(8, 12, 5)
    torch.einsum("bid,ih->bhd", z, xs[2]).backward(dout)
    monkeypatch.setattr(cin_ops, "plain_chunk_rows", lambda m, hk, d: 3)
    got = cin_layer_backward(x0, xk, w, dout)
    for g, t in zip(got, xs):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=1e-5, atol=1e-5)
    ys = [t.clone().requires_grad_(True) for t in (x0, xk, w)]
    CinLayer.apply(*ys, cin_layer_torch).backward(dout)
    for g, t in zip(got, ys):
        assert torch.equal(g, t.grad)


# ----------------------------------------------------------------------
# whole train steps
# ----------------------------------------------------------------------
def _train_losses(ref_step, port_step, rstate, pstate, batches):
    rl, pl = [], []
    for b in batches:
        rstate, rm = ref_step(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        pstate, pm = port_step(pstate, b)
        rl.append(float(rm["loss"]))
        pl.append(float(pm["loss"]))
    return rl, pl, pstate


@pytest.mark.parametrize("name", ["qwen3-8b", "xdeepfm", "sasrec"])
def test_train_steps_match_reference_losses(name):
    """Three steps of ``make_*_train_step`` from one set of weights: the
    losses agree step by step, the step counters advance."""
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=100)
    ro, po = ref_opt.OptConfig(**kw), opt.OptConfig(**kw)
    if name == "qwen3-8b":
        rc, pc, rp, model = _lm(name)
        rstep = jax.jit(ref_steps.make_lm_train_step(rc, ro, n_micro=2))
        pstep = steps.make_lm_train_step(pc, po, n_micro=2)
        it = ref_pipelines.lm_batches(rc, 4, 16, 1)
    else:
        rc, pc, rp, model = _recsys(name)
        rstep = jax.jit(ref_steps.make_recsys_train_step(rc, ro))
        pstep = steps.make_recsys_train_step(pc, po)
        it = ref_pipelines.recsys_batches(rc, 32, seed=1)
    batches = [next(it) for _ in range(3)]
    rl, pl, state = _train_losses(rstep, pstep, ref_steps.init_state(rp, ro),
                                  steps.init_state(model, po), batches)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    assert int(state["step"]) == 3 and int(state["opt"]["step"]) == 3


@pytest.mark.parametrize("name,kind", [("qwen3-8b", "adamw"), ("moonshot-v1-16b-a3b", "adafactor"),
                                       ("xdeepfm", "adafactor"), ("sasrec", "adamw"),
                                       ("gin-tu", "adamw")])
def test_train_state_from_reference_trains_on(name, kind):
    """A reference state after one train step, carried across with
    ``train_state_from_reference``: every leaf (weights, the optimiser's
    moments, both step counters) equal to the reference's, and the port's
    next step gives the reference's next loss (within 1e-5 relative, as the
    whole-step test above; the GIN within 1e-4, as its own step test, for
    the bf16 messages)."""
    from repro.data import graphs as ref_graphs
    from repro.models import gnn as ref_gnn

    kw = dict(kind=kind, lr=1e-2, warmup_steps=1, total_steps=100)
    ro, po = ref_opt.OptConfig(**kw), opt.OptConfig(**kw)
    rc, pc = ref_configs.get_config(name).reduced(), configs.get_config(name).reduced()
    if name == "gin-tu":
        rp = ref_gnn.init_params(rc, KEY, 16, 4)
        rstep = jax.jit(ref_steps.make_gnn_train_step(rc, ro))
        pstep = steps.make_gnn_train_step(pc, po)
        it = ref_graphs.graph_batches(ref_graphs.synthetic_graph(400, 5, 16, 4, seed=7), 24,
                                      (5, 3), seed=8)
        rtol = 1e-4
    elif name in ("qwen3-8b", "moonshot-v1-16b-a3b"):
        rp = ref_transformer.init_params(rc, KEY)
        rstep = jax.jit(ref_steps.make_lm_train_step(rc, ro))
        pstep = steps.make_lm_train_step(pc, po)
        it = ref_pipelines.lm_batches(rc, 2, 16, 1)
        rtol = 1e-5
    else:
        rp = ref_steps.init_model_params(rc, KEY)
        rstep = jax.jit(ref_steps.make_recsys_train_step(rc, ro))
        pstep = steps.make_recsys_train_step(pc, po)
        it = ref_pipelines.recsys_batches(rc, 16, seed=1)
        rtol = 1e-5
    rstate, _ = rstep(ref_steps.init_state(rp, ro), {k: jnp.asarray(v) for k, v in next(it).items()})
    pstate = steps.train_state_from_reference(pc, jax.tree.map(np.asarray, rstate), "cpu")
    want = _ref_leaves(rstate)
    got = {k: v.detach() for k, v in flatten(pstate).items()}
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.dtype == torch.from_numpy(np.zeros(0, want[k].dtype)).dtype, k
        assert np.array_equal(v.numpy(), want[k]), k
    assert int(pstate["step"]) == 1 and float(got[f"opt/{'m' if kind == 'adamw' else 'vr'}/"
                                               + next(iter(opt.param_tree(pstate["params"])))]
                                          .abs().max()) > 0
    batch = next(it)
    _, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    pstate, pm = pstep(pstate, batch)
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=rtol)
    assert int(pstate["step"]) == 2 and int(pstate["opt"]["step"]) == 2


def test_train_state_from_reference_refuses_a_foreign_state():
    rc, pc = ref_configs.get_config("fm").reduced(), configs.get_config("fm").reduced()
    rstate = jax.tree.map(np.asarray, ref_steps.init_state(ref_steps.init_model_params(rc, KEY),
                                                           ref_opt.OptConfig()))
    with pytest.raises(KeyError, match="optimiser"):
        steps.train_state_from_reference(pc, {**rstate, "opt": {"mu": 0, "step": 0}}, "cpu")
    bad = dict(rstate["opt"], m=dict(rstate["opt"]["m"]))
    leaf = next(iter(bad["m"]))
    bad["m"][leaf] = np.zeros((1, 2, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        steps.train_state_from_reference(pc, {**rstate, "opt": bad}, "cpu")


def test_train_step_metrics_stay_on_the_device():
    cfg = configs.get_config("fm").reduced()
    model = steps.init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = steps.init_state(model, opt.OptConfig())
    batch = next(ref_pipelines.recsys_batches(cfg, 8, seed=0))
    state, m = steps.make_recsys_train_step(cfg, opt.OptConfig())(state, batch)
    assert sorted(m) == ["grad_norm", "loss", "lr", "nll"]
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in m.values())


# ----------------------------------------------------------------------
# the loop and the driver
# ----------------------------------------------------------------------
def test_watchdog_flags_stragglers():
    w = WatchdogStats()
    for s in range(10):
        assert not w.update(s, 0.1)
    assert w.update(10, 1.0)
    assert w.stragglers == [10]


def test_train_loop_resume(tmp_path):
    """The reference's scenario (tests/test_train.py:116): 12 steps with a
    checkpoint every 5, resume from step 10, the loss keeps falling."""
    cfg = opt.OptConfig(lr=0.05, warmup_steps=0, total_steps=1000, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}
    loss = lambda p: torch.sum(p["w"] ** 2) + p["b"] ** 2  # noqa: E731

    def step(state, batch):
        grads = {"w": 2 * state["params"]["w"], "b": 2 * state["params"]["b"]}
        before = loss(state["params"])
        p, o, extra = opt.opt_update(cfg, state["params"], grads, state["opt"])
        return {"params": p, "opt": o, "step": state["step"] + 1}, {"loss": before, **extra}

    def data():
        while True:
            yield {}

    ck = Checkpointer(str(tmp_path), keep=3, async_save=False)
    fresh = lambda: {"params": {k: v.clone() for k, v in params.items()},  # noqa: E731
                     "opt": opt.opt_init(cfg, params), "step": torch.tensor(0, dtype=torch.int32)}
    loop = TrainLoop(train_step=step, data_iter=data(), checkpointer=ck, ckpt_every=5)
    state, logs = loop.run(fresh(), 12)
    assert ck.latest_step() == 10
    restored, start = TrainLoop.resume_or_init(ck, fresh())
    assert start == 10 and int(restored["step"]) == 10
    _, logs2 = loop.run(restored, 5, start_step=start)
    assert logs2[-1]["loss"] < logs[0]["loss"]
    assert [r["step"] for r in logs2] == list(range(10, 15))


def test_launch_train_resumes_from_its_checkpoint(tmp_path, capsys):
    """``main([...])`` on the CPU: 4 steps with a checkpoint every 2, then
    again from step 4; the log of each run is returned."""
    argv = ["--arch", "xdeepfm", "--reduced", "--device", "cpu", "--steps", "4",
            "--batch", "32", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
            "--log", str(tmp_path / "log.jsonl")]
    logs = launch_train.main(argv)
    assert [r["step"] for r in logs] == [0, 1, 2, 3]
    logs2 = launch_train.main(argv)
    assert "resumed from step 4" in capsys.readouterr().out
    assert [r["step"] for r in logs2] == [4, 5, 6, 7]
    assert sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*")) == [4, 6, 8]
    lines = [json.loads(x) for x in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert len(lines) == 8


def test_launch_train_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "fm", "--reduced", "--steps", "1"])
