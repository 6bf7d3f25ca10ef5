"""The port's MoE layer and MoE LM serving on the CPU, against the reference.

``moe_block`` against ``repro.models.layers.moe_block`` on the same seeded
numpy inputs, and its routing against the reference's routing as
``layers.py:179-201`` computes it (``jax.lax.top_k``, ``jnp.argsort``,
``searchsorted``), re-run here from the reference's own primitives; then the
reduced moonshot-v1-16b-a3b served by both (prefill, padded cache, greedy
decode) with the reference's weights carried across.  Tolerances:

* expert choices, positions in each expert's queue and ``keep`` (the
  capacity drops): equal;
* the aux loss: within 1e-6 relative — both sum float32 router
  probabilities in their own order, and the softmax's ``exp`` differs in its
  last bits between XLA and PyTorch, so equality is not to be had;
* float32 outputs: within 1e-5 of the largest |output| (the expert products
  and the combine sum float32 terms in their own order);
* the reduced model: float32 logits within 1e-4 of the largest |logit|, bf16
  logits within 0.15 (the tolerances the dense models' tests state,
  ``tests/test_torch_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as ref_layers
from repro.models import steps as ref_steps
from repro_torch import configs
from repro_torch.models import layers, steps, transformer

KEY = jax.random.PRNGKey(0)


def _inputs(seed, n, d, e, f, router_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    router = (rng.normal(size=(d, e)) * router_scale).astype(np.float32)
    wg = (rng.normal(size=(e, d, f)) * 0.1).astype(np.float32)
    wu = (rng.normal(size=(e, d, f)) * 0.1).astype(np.float32)
    wd = (rng.normal(size=(e, f, d)) * 0.1).astype(np.float32)
    return x, router, wg, wu, wd


def _ref_routing(x, router, k, e, g, cf):
    """The reference's routing decisions, from its own primitives
    (``repro/models/layers.py:179-201``)."""
    n = x.shape[0]
    s = n // g
    probs = jax.nn.softmax(jnp.einsum("nd,de->ne", jnp.asarray(x), jnp.asarray(router)), -1)
    _, expert_idx = jax.lax.top_k(probs, k)
    ge = expert_idx.reshape(g, s * k)
    order = jnp.argsort(ge, axis=1)
    se = jnp.take_along_axis(ge, order, axis=1)
    first = jax.vmap(lambda row: jnp.searchsorted(row, row, side="left"))(se)
    pos = jnp.arange(s * k)[None, :] - first
    cap = int(np.ceil(s * k / e * cf))
    return {"experts": np.asarray(expert_idx), "order": np.asarray(order), "pos": np.asarray(pos),
            "keep": np.asarray(pos < cap), "cap": cap}


CASES = {
    # (n, d, e, f, k, capacity_factor, n_groups, router scale)
    "no_drops": (32, 8, 4, 16, 2, 4.0, 1, 1.0),  # tests/test_models.py:151's case
    "drops": (64, 8, 8, 16, 2, 1.0, 1, 1.0),
    "two_groups": (64, 8, 8, 16, 3, 1.0, 2, 1.0),
    "tied_router": (24, 8, 8, 16, 2, 1.25, 1, 0.0),  # a zero router ties every expert
    "decode_capacity": (4, 16, 64, 8, 6, 1.25, 1, 1.0),  # cap = ceil(4*6/64*1.25) = 1
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_block_matches_reference(case):
    n, d, e, f, k, cf, g, scale = CASES[case]
    x, router, wg, wu, wd = _inputs(sum(map(ord, case)), n, d, e, f, scale)
    dims = layers.MoEDims(e, k, cf)
    want, want_aux = ref_layers.moe_block(*(jnp.asarray(a) for a in (x, router, wg, wu, wd)),
                                          ref_layers.MoEDims(e, k, cf), n_groups=g)
    got, aux = layers.moe_block(*(torch.from_numpy(a) for a in (x, router, wg, wu, wd)), dims,
                                n_groups=g)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, d)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)

    ref = _ref_routing(x, router, k, e, g, cf)
    _, _, experts = layers.moe_router(torch.from_numpy(x), torch.from_numpy(router), k)
    plan = layers.moe_dispatch(experts, dims, g)
    assert np.array_equal(experts.numpy(), ref["experts"])
    assert np.array_equal(plan["order"].numpy(), ref["order"])
    assert np.array_equal(plan["pos"].numpy(), ref["pos"])
    assert np.array_equal(plan["keep"].numpy(), ref["keep"])
    assert plan["cap"] == ref["cap"]
    if case == "no_drops":
        assert plan["keep"].all()
    if case in ("drops", "two_groups", "tied_router", "decode_capacity"):
        assert not plan["keep"].all()


def test_tied_router_picks_the_lower_experts_and_keeps_the_earlier_tokens():
    """Ties go to the lower expert (``jax.lax.top_k``'s order), and a full
    expert keeps the tokens that come first (the sort by expert is stable)."""
    x = torch.ones((10, 4))
    probs, gates, experts = layers.moe_router(x, torch.zeros((4, 8)), 3)
    assert torch.equal(experts, torch.tensor([[0, 1, 2]] * 10))
    assert torch.allclose(gates, torch.full((10, 3), 1 / 3))
    plan = layers.moe_dispatch(experts, layers.MoEDims(8, 3, 1.0), 1)
    cap = plan["cap"]  # ceil(10 * 3 / 8) = 4
    assert cap == 4
    kept_tokens = plan["token"][plan["keep"]].reshape(3, cap)
    assert torch.equal(kept_tokens, torch.arange(cap).expand(3, cap))


def test_decode_capacity_drops_the_second_token():
    """At decode (4 tokens, 64 experts, top-6) the capacity is 1: when two
    tokens share an expert, the later token's choice is dropped, as in the
    reference."""
    n, d, e, f, k = 4, 16, 64, 8, 6
    x, router, wg, wu, wd = _inputs(5, n, d, e, f)
    x[1] = x[0]  # tokens 0 and 1 pick the same six experts
    dims = layers.MoEDims(e, k)
    _, _, experts = layers.moe_router(torch.from_numpy(x), torch.from_numpy(router), k)
    plan = layers.moe_dispatch(experts, dims, 1)
    assert plan["cap"] == 1
    dropped_tokens = plan["token"][~plan["keep"]]
    assert (dropped_tokens == 1).sum() == k and not (dropped_tokens == 0).any()
    got, _ = layers.moe_block(*(torch.from_numpy(a) for a in (x, router, wg, wu, wd)), dims)
    want, _ = ref_layers.moe_block(*(jnp.asarray(a) for a in (x, router, wg, wu, wd)),
                                   ref_layers.MoEDims(e, k))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * np.abs(np.asarray(want)).max()
    # token 1 lost every expert to token 0: its output is 0
    assert torch.equal(got[1], torch.zeros(d))


def test_moe_block_bf16_matches_reference():
    """bf16 tokens and weights: the expert products come back in bf16 as the
    reference's einsum outputs do; outputs within a few bf16 roundings."""
    x, router, wg, wu, wd = _inputs(11, 48, 16, 8, 32)
    jx = [jnp.asarray(a, jnp.bfloat16) for a in (x, router, wg, wu, wd)]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in jx]
    want, want_aux = ref_layers.moe_block(*jx, ref_layers.MoEDims(8, 2), n_groups=2)
    got, aux = layers.moe_block(*tx, layers.MoEDims(8, 2), n_groups=2)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.float().numpy() - want).max() <= 3e-2 * np.abs(want).max()
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_moe_block_sums_each_tokens_experts_in_slot_order():
    """The combine adds each token's k weighted expert outputs in a fixed
    order (no atomics): the output equals that sum taken by hand."""
    x, router, wg, wu, wd = _inputs(3, 16, 8, 4, 16)
    tx = [torch.from_numpy(a) for a in (x, router, wg, wu, wd)]
    got, _ = layers.moe_block(*tx, layers.MoEDims(4, 2, 4.0))
    _, gates, experts = layers.moe_router(tx[0], tx[1], 2)
    want = torch.zeros_like(tx[0])
    for t in range(16):
        for r in range(2):
            ei = int(experts[t, r])
            h = torch.nn.functional.silu(tx[0][t] @ tx[2][ei]) * (tx[0][t] @ tx[3][ei])
            want[t] = want[t] + gates[t, r] * (h @ tx[4][ei])
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("n_groups", [1, 2])
def test_moe_block_dispatch_buffer_holds_only_the_kept_choices(n_groups):
    """With drops, the buffer the expert products get holds each kept
    choice's token at its (expert, group, slot) and zeros elsewhere (the
    dropped choices' scratch row is cut off); without ``with_aux`` the output
    is the same and the loss None."""
    x, router, wg, wu, wd = _inputs(5, 24, 8, 4, 16)
    tx = [torch.from_numpy(a) for a in (x, router, wg, wu, wd)]
    dims = layers.MoEDims(4, 2, 0.5)
    bufs = []

    def gemm(buf, w):
        bufs.append(buf.clone())
        return torch.bmm(buf.float(), w.float())

    out, aux = layers.moe_block(*tx, dims, n_groups=n_groups, gemm=gemm)
    _, _, experts = layers.moe_router(tx[0], tx[1], 2)
    plan = layers.moe_dispatch(experts, dims, n_groups)
    cap, s = plan["cap"], 24 // n_groups
    assert not bool(plan["keep"].all())
    want = torch.zeros((4, n_groups * cap, 8))
    for gi in range(n_groups):
        for c in range(s * 2):
            if plan["keep"][gi, c]:
                want[plan["expert"][gi, c], gi * cap + plan["pos"][gi, c]] = \
                    tx[0][gi * s + plan["token"][gi, c]]
    assert torch.equal(bufs[0], want)
    out2, aux2 = layers.moe_block(*tx, dims, n_groups=n_groups, gemm=gemm, with_aux=False)
    assert torch.equal(out, out2) and aux is not None and aux2 is None


def test_router_matmul_leaves_the_tf32_flag_as_it_was():
    """The router computes in full float32 whatever the caller set, and puts
    the caller's TF32 setting back."""
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = setting
            layers.moe_router(torch.ones((2, 4)), torch.ones((4, 3)), 2)
            assert torch.backends.cuda.matmul.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def test_moe_block_gemm_choice_and_refusals():
    """``gemm`` chooses the expert product; ragged groups and mesh sharding
    hints are refused."""
    x, router, wg, wu, wd = _inputs(4, 12, 8, 4, 16)
    tx = [torch.from_numpy(a) for a in (x, router, wg, wu, wd)]
    calls = []

    def gemm(buf, w):
        calls.append((tuple(buf.shape), tuple(w.shape)))
        return torch.bmm(buf.float(), w.float())

    layers.moe_block(*tx, layers.MoEDims(4, 2), n_groups=2, gemm=gemm)
    cap = int(np.ceil(6 * 2 / 4 * 1.25))
    assert calls == [((4, 2 * cap, 8), (4, 8, 16)), ((4, 2 * cap, 8), (4, 8, 16)),
                     ((4, 2 * cap, 16), (4, 16, 8))]
    with pytest.raises(ValueError, match="groups"):
        layers.moe_block(*tx, layers.MoEDims(4, 2), n_groups=5)
    cfg = dataclasses.replace(configs.get_config("moonshot-v1-16b-a3b").reduced(),
                              moe_dp_axes=("data",))
    with pytest.raises(NotImplementedError, match="moe_dp_axes"):
        steps.init_model_params(cfg, torch.Generator(), "cpu")


# ----------------------------------------------------------------------
# the reduced MoE model, served
# ----------------------------------------------------------------------
def _serve_both(cfg_name, dtype, b=2, t=12, new=4, shared=0):
    ref_cfg = ref_configs.get_config(cfg_name).reduced()
    cfg = configs.get_config(cfg_name).reduced()
    ref_cfg = dataclasses.replace(ref_cfg, dtype=dtype, moe=dataclasses.replace(
        ref_cfg.moe, n_shared_experts=shared))
    cfg = dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
        cfg.moe, n_shared_experts=shared))
    ref_params = ref_steps.init_model_params(ref_cfg, KEY)
    params = transformer.params_from_reference(cfg, jax.tree.map(np.asarray, ref_params),
                                               device="cpu")
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    ref_logits, ref_cache = jax.jit(ref_steps.make_lm_prefill_step(ref_cfg))(ref_params, toks)
    logits, cache = steps.make_lm_prefill_step(cfg)(params, torch.from_numpy(toks))
    out = [((ref_logits, ref_cache), (logits, cache.clone()))]
    ref_cache = jnp.pad(ref_cache, ((0, 0), (0, 0), (0, 0), (0, new), (0, 0), (0, 0)))
    cache = torch.nn.functional.pad(cache, (0, 0, 0, 0, 0, new))
    ref_dec = jax.jit(ref_steps.make_lm_decode_step(ref_cfg))
    dec = steps.make_lm_decode_step(cfg)
    ref_tok, tok = jnp.argmax(ref_logits, -1), logits.argmax(-1)
    toks_out = [(np.asarray(ref_tok), tok.numpy())]
    for i in range(new):
        pos = np.full((b,), t + i, np.int32)
        ref_logits, ref_cache = ref_dec(ref_params, ref_tok[:, None].astype(jnp.int32),
                                        jnp.asarray(pos), ref_cache)
        logits, cache = dec(params, tok[:, None].to(torch.int32), torch.from_numpy(pos), cache)
        out.append(((ref_logits, ref_cache), (logits, cache.clone())))
        ref_tok, tok = jnp.argmax(ref_logits, -1), logits.argmax(-1)
        toks_out.append((np.asarray(ref_tok), tok.numpy()))
    return out, toks_out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_serving_matches_reference_f32(shared):
    """Prefill logits and bf16 cache, then 4 greedy decode steps, of the
    reduced moonshot-v1-16b-a3b (4 experts, top-2; with one shared expert
    too) equal the reference's."""
    out, toks = _serve_both("moonshot-v1-16b-a3b", "float32", shared=shared)
    for (ref_logits, ref_cache), (logits, cache) in out:
        assert logits.dtype == torch.float32 and cache.dtype == torch.bfloat16
        scale = np.abs(_np(ref_logits)).max()
        assert np.abs(_np(logits) - _np(ref_logits)).max() <= 1e-4 * scale
        g, w = _np(cache), _np(ref_cache)
        assert g.shape == w.shape
        assert np.all(np.abs(g - w) <= np.abs(w) * 2.0 ** -7 + 1e-5 * np.abs(w).max())
        assert np.mean(g != w) < 1e-2
    assert all(np.array_equal(a, b) for a, b in toks)


def test_moe_serving_matches_reference_bf16():
    out, _ = _serve_both("moonshot-v1-16b-a3b", "bfloat16")
    for (ref_logits, _), (logits, cache) in out:
        assert logits.dtype == torch.bfloat16 and cache.dtype == torch.bfloat16
        assert np.abs(_np(logits) - _np(ref_logits)).max() < 0.15


def test_moe_forward_aux_matches_reference():
    """``forward``'s aux is the layers' Switch losses summed, as the
    reference's."""
    ref_cfg = ref_configs.get_config("moonshot-v1-16b-a3b").reduced()
    cfg = configs.get_config("moonshot-v1-16b-a3b").reduced()
    ref_params = ref_steps.init_model_params(ref_cfg, KEY)
    params = transformer.params_from_reference(cfg, jax.tree.map(np.asarray, ref_params),
                                               device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    from repro.models import transformer as ref_transformer

    _, want = ref_transformer.forward(ref_cfg, ref_params, jnp.asarray(toks))
    _, got = transformer.forward(cfg, params, torch.from_numpy(toks))
    assert float(got) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
