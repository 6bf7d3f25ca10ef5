"""The port's LM serving path on the CPU, against the reference.

Configs, the data pipeline, each layer, and the whole slice — prefill, the
padded cache, greedy decode — with the reference's weights carried across by
``params_from_reference``.  Inputs come from numpy with a seed; the port runs
its plain attention path here (the CUDA kernels run only on a card, where
``chip_smoke.py`` holds them against these plain versions).  Tolerances:

* float32 models: logits within 1e-4 of the largest |logit| (both sides sum
  float32 products in their own order; measured differences are ~1e-6);
* the bf16 caches: equal but for under 1 % of entries one bf16 rounding
  step apart, where the two sides' float32 K/V differ in their last bits
  across a rounding boundary (see ``_cache_close``);
* the bfloat16 model: logits within 0.15 (the reference's own tolerance for
  its bf16 decode-vs-forward check, tests/test_models.py:70).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipelines as ref_pipelines
from repro.models import flash as ref_flash
from repro.models import layers as ref_layers
from repro.models import steps as ref_steps
from repro.models import transformer as ref_transformer
from repro_torch import configs
from repro_torch.data import pipelines
from repro_torch.models import flash, layers, steps, transformer

KEY = jax.random.PRNGKey(0)


def _np(x) -> np.ndarray:
    """A JAX or torch array as float32 NumPy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(rng, shape, dtype=torch.float32):
    """The same values for both sides, rounded to bf16 once when bf16."""
    a = rng.normal(size=shape).astype(np.float32)
    j = jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(dtype)


# ----------------------------------------------------------------------
# configs and data
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ref_configs.ARCH_REGISTRY))
def test_config_matches_reference(name):
    """Registry, parameter counts, reduced() fields and input specs (shapes
    and dtypes; the port's are meta tensors) equal the reference's."""
    ref, port = ref_configs.get_config(name), configs.get_config(name)
    assert sorted(configs.ARCH_REGISTRY) == sorted(ref_configs.ARCH_REGISTRY)
    assert configs.ASSIGNED_ARCHS == ref_configs.ASSIGNED_ARCHS
    assert configs.all_cells() == ref_configs.all_cells()
    assert port.n_params() == ref.n_params()
    if hasattr(ref, "n_active_params"):
        assert port.n_active_params() == ref.n_active_params()
    r_ref, r_port = ref.reduced(), port.reduced()
    if dataclasses.is_dataclass(r_ref):
        assert dataclasses.asdict(r_port) == dataclasses.asdict(r_ref)
    else:
        assert vars(r_port) == vars(r_ref)
    assert r_port.n_params() == r_ref.n_params()
    for shape in ref.shapes:
        want, got = ref.input_specs(shape), port.input_specs(shape)
        assert list(got) == list(want)
        for k, spec in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(spec.shape), (shape, k)
            assert str(got[k].dtype).removeprefix("torch.") == str(spec.dtype), (shape, k)


def test_lm_token_stream_and_batches_match_reference():
    cfg = configs.get_config("qwen3-8b")
    got = pipelines.lm_token_stream(3000, cfg.vocab_size, seed=2)
    assert np.array_equal(got, ref_pipelines.lm_token_stream(3000, cfg.vocab_size, seed=2))
    a = next(pipelines.lm_batches(cfg.reduced(), 2, 16, seed=1))
    b = next(ref_pipelines.lm_batches(ref_configs.get_config("qwen3-8b").reduced(), 2, 16,
                                      seed=1))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("x_dtype,scale_dtype", [(torch.float32, torch.float32),
                                                 (torch.bfloat16, torch.bfloat16),
                                                 (torch.float32, torch.bfloat16)])
def test_rms_norm(x_dtype, scale_dtype):
    rng = np.random.default_rng(1)
    jx, x = _pair(rng, (3, 5, 64), x_dtype)
    js, s = _pair(rng, (64,), scale_dtype)
    got, want = layers.rms_norm(x, s, 1e-6), ref_layers.rms_norm(jx, js, 1e-6)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    tol = 1e-6 if x_dtype == torch.float32 else 1e-2
    assert np.abs(_np(got) - _np(want)).max() <= tol * max(1.0, np.abs(_np(want)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(dtype, theta):
    rng = np.random.default_rng(2)
    jx, x = _pair(rng, (2, 40, 3, 32), dtype)
    pos = rng.integers(0, 3000, (2, 40)).astype(np.int32)
    got = layers.apply_rope(x, torch.from_numpy(pos), theta)
    want = ref_layers.apply_rope(jx, jnp.asarray(pos), theta)
    assert got.dtype == dtype
    np.testing.assert_allclose(_np(layers.rope_freqs(32, theta)),
                               _np(ref_layers.rope_freqs(32, theta)), rtol=1e-6)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert np.abs(_np(got) - _np(want)).max() < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu(dtype):
    rng = np.random.default_rng(3)
    jx, x = _pair(rng, (2, 7, 32), dtype)
    (jg, g), (ju, u), (jd, d) = (_pair(rng, s, dtype) for s in ((32, 48), (32, 48), (48, 32)))
    got, want = layers.swiglu(x, g, u, d), ref_layers.swiglu(jx, jg, ju, jd)
    # relative to the output's scale: bf16 rounds each of the three products
    tol = 1e-6 if dtype == torch.float32 else 3e-2
    assert np.abs(_np(got) - _np(want)).max() <= tol * np.abs(_np(want)).max()


@pytest.mark.parametrize("t,block", [(1, 4), (37, 16), (64, 64), (100, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_plain_paths(t, block, dtype):
    """blocked_causal_attention and models.flash.flash_attention (both
    causal, and flash non-causal) against the reference's."""
    rng = np.random.default_rng(t)
    (jq, q), (jk, k), (jv, v) = (_pair(rng, s, dtype) for s in
                                 ((2, t, 4, 16), (2, t, 2, 16), (2, t, 2, 16)))
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    got = layers.blocked_causal_attention(q, k, v, block)
    want = ref_layers.blocked_causal_attention(jq, jk, jv, block)
    assert got.dtype == dtype and np.abs(_np(got) - _np(want)).max() < tol
    for causal in (True, False):
        got = flash.flash_attention(q, k, v, causal, block)
        want = ref_flash.flash_attention(jq, jk, jv, causal, block)
        assert got.dtype == dtype and np.abs(_np(got) - _np(want)).max() < tol


@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.float32, torch.float32),
                                              (torch.float32, torch.bfloat16),
                                              (torch.bfloat16, torch.bfloat16)])
def test_decode_attention(q_dtype, kv_dtype):
    rng = np.random.default_rng(4)
    jq, q = _pair(rng, (3, 1, 6, 32), q_dtype)
    (jk, k), (jv, v) = (_pair(rng, (3, 50, 2, 32), kv_dtype) for _ in range(2))
    pos = np.asarray([0, 49, 17], np.int32)
    got = layers.decode_attention(q, k, v, torch.from_numpy(pos))
    want = ref_layers.decode_attention(jq, jk, jv, jnp.asarray(pos))
    tol = 2e-5 if q_dtype == torch.float32 else 3e-2
    assert got.dtype == q_dtype and np.abs(_np(got) - _np(want)).max() < tol


def test_scale_promotes_like_the_reference():
    """JAX's ``q * (1 / np.sqrt(hd))`` on a bf16 q computes in float32 (the
    numpy scalar is strongly typed); PyTorch would keep bf16.  The port
    casts first, so its bf16 attention sees the reference's scaled q."""
    q = jnp.asarray(np.random.default_rng(6).normal(size=(64,)), jnp.bfloat16)
    scaled = q * (1.0 / np.sqrt(128))
    assert scaled.dtype == jnp.float32
    port = torch.from_numpy(np.array(_np(q))).to(torch.bfloat16).float() * (1.0 / np.sqrt(128))
    assert np.array_equal(port.numpy(), np.asarray(scaled))


# ----------------------------------------------------------------------
# the whole slice
# ----------------------------------------------------------------------
def _cache_close(got: torch.Tensor, want) -> None:
    """Equal bf16 caches but for a few entries (under 1 %) one rounding step
    apart, where the two sides' float32 K/V — equal up to their sums' order —
    fall on either side of a bf16 rounding boundary; near 0 that step is
    floored at 1e-5 of the cache's largest |value| (there the sums' last
    float32 bits are a large part of the value)."""
    g, w = _np(got), _np(want)
    assert np.all(np.abs(g - w) <= np.abs(w) * 2.0 ** -7 + 1e-5 * np.abs(w).max())
    assert np.mean(g != w) < 1e-2


def _serve_both(cfg_name: str, dtype: str, b: int = 2, t: int = 12, new: int = 4):
    """Prefill + ``new`` greedy decode steps through the reference (jitted
    steps) and the port (plain path), the port's weights carried from the
    reference's; returns the per-step logits, caches and tokens of both."""
    ref_cfg = dataclasses.replace(ref_configs.get_config(cfg_name).reduced(), dtype=dtype)
    cfg = dataclasses.replace(configs.get_config(cfg_name).reduced(), dtype=dtype)
    ref_params = ref_steps.init_model_params(ref_cfg, KEY)
    params = transformer.params_from_reference(cfg, jax.tree.map(np.asarray, ref_params),
                                               device="cpu")
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    pad = ((0, 0), (0, 0), (0, 0), (0, new), (0, 0), (0, 0))

    ref_logits, ref_cache = jax.jit(ref_steps.make_lm_prefill_step(ref_cfg))(ref_params, toks)
    logits, cache = steps.make_lm_prefill_step(cfg)(params, torch.from_numpy(toks))
    out = {"ref": [(ref_logits, ref_cache)], "port": [(logits, cache.clone())]}
    ref_cache = jnp.pad(ref_cache, pad)
    cache = torch.nn.functional.pad(cache, (0, 0, 0, 0, 0, new))
    ref_dec = jax.jit(ref_steps.make_lm_decode_step(ref_cfg))
    dec = steps.make_lm_decode_step(cfg)
    ref_tok, tok = jnp.argmax(ref_logits, -1), logits.argmax(-1)
    toks_out = {"ref": [np.asarray(ref_tok)], "port": [tok.numpy()]}
    for i in range(new):
        pos = np.full((b,), t + i, np.int32)
        ref_logits, ref_cache = ref_dec(ref_params, ref_tok[:, None].astype(jnp.int32),
                                        jnp.asarray(pos), ref_cache)
        logits, cache = dec(params, tok[:, None].to(torch.int32), torch.from_numpy(pos), cache)
        out["ref"].append((ref_logits, ref_cache))
        out["port"].append((logits, cache.clone()))
        ref_tok, tok = jnp.argmax(ref_logits, -1), logits.argmax(-1)
        toks_out["ref"].append(np.asarray(ref_tok))
        toks_out["port"].append(tok.numpy())
    return out, toks_out, params, cfg, toks


@pytest.mark.parametrize("name", ["qwen3-8b", "granite-3-2b"])
def test_lm_serving_matches_reference_f32(name):
    """Prefill logits and cache, then 4 greedy decode steps — logits, cache
    and tokens at every step — equal the reference's (float32 model)."""
    out, toks, *_ = _serve_both(name, "float32")
    for (ref_logits, ref_cache), (logits, cache) in zip(out["ref"], out["port"]):
        assert logits.dtype == torch.float32 and cache.dtype == torch.bfloat16
        assert tuple(logits.shape) == tuple(ref_logits.shape)
        scale = np.abs(_np(ref_logits)).max()
        assert np.abs(_np(logits) - _np(ref_logits)).max() <= 1e-4 * scale
        assert tuple(cache.shape) == tuple(ref_cache.shape)
        _cache_close(cache, ref_cache)
    assert all(np.array_equal(a, b) for a, b in zip(toks["ref"], toks["port"]))


def test_lm_serving_matches_reference_bf16():
    out, toks, *_ = _serve_both("qwen3-8b", "bfloat16")
    for (ref_logits, _), (logits, cache) in zip(out["ref"], out["port"]):
        assert logits.dtype == torch.bfloat16 and cache.dtype == torch.bfloat16
        assert np.abs(_np(logits) - _np(ref_logits)).max() < 0.15


def test_decode_matches_forward():
    """The port against itself, as tests/test_models.py:56-70 checks the
    reference: decode logits at position T - 1 equal the forward's."""
    cfg = configs.get_config("granite-3-2b").reduced()
    params = steps.init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 12))
                            .astype(np.int32))
    with torch.no_grad():
        logits_all, aux = transformer.forward(cfg, params, toks)
    assert float(aux) == 0.0 and tuple(logits_all.shape) == (2, 12, cfg.vocab_size)
    _, cache = steps.make_lm_prefill_step(cfg)(params, toks[:, :-1])
    cache = torch.nn.functional.pad(cache, (0, 0, 0, 0, 0, 1))
    logits, new_cache = steps.make_lm_decode_step(cfg)(params, toks[:, -1:],
                                                       torch.full((2,), 11, dtype=torch.int32),
                                                       cache)
    assert new_cache is cache  # updated in place
    assert (logits - logits_all[:, -1]).abs().max() < 0.15  # the bf16 cache's rounding


def test_forward_runs_without_gradients():
    """A direct ``forward`` on parameters that require gradients builds no
    graph (the attention kernel has no backward before the training slice)."""
    cfg = configs.get_config("qwen3-8b").reduced()
    params = steps.init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(p.requires_grad for p in params.parameters())
    logits, _, cache = transformer.forward(cfg, params, torch.zeros((1, 5), dtype=torch.int32),
                                           return_cache=True)
    assert not logits.requires_grad and logits.grad_fn is None and not cache.requires_grad


def test_decode_updates_only_the_position_rows():
    """The in-place cache update writes row ``positions[b]`` of batch row b
    in every layer, and nothing else."""
    out, _, params, cfg, toks = _serve_both("granite-3-2b", "float32", new=1)
    before, after = out["port"][0][1], out["port"][1][1]
    t = toks.shape[1]
    assert torch.equal(after[:, :, :, :t], before)
    assert after[:, :, :, t].abs().sum() > 0


# ----------------------------------------------------------------------
# choices, refusals and parameters
# ----------------------------------------------------------------------
def test_attention_choice_and_refusals():
    cfg = configs.get_config("qwen3-8b").reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    assert transformer.resolve_attention(None, torch.device("cpu")) == "torch"
    assert transformer.resolve_attention(None, torch.device("cuda")) == "kernel"
    with pytest.raises(ValueError, match="attention='kernel'"):
        steps.make_lm_prefill_step(cfg, attention="kernel")(params, toks)
    with pytest.raises(ValueError, match="expected one of"):
        steps.make_lm_prefill_step(cfg, attention="pallas")(params, toks)
    _, cache = steps.make_lm_prefill_step(cfg, attention="torch")(params, toks)
    dec = steps.make_lm_decode_step(cfg)
    for bad in (4, -1):
        with pytest.raises(IndexError, match="outside the cache"):
            dec(params, toks[:, :1], torch.tensor([bad], dtype=torch.int32), cache)


def test_init_params_layout_and_determinism():
    cfg = configs.get_config("qwen3-8b").reduced()
    a = steps.init_model_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = steps.init_model_params(cfg, torch.Generator().manual_seed(3), "cpu")
    ref = ref_transformer.init_params(ref_configs.get_config("qwen3-8b").reduced(), KEY)
    assert sorted(a.layers) == sorted(ref["layers"])
    for name, p in a.layers.items():
        assert tuple(p.shape) == ref["layers"][name].shape, name
        assert torch.equal(p, b.layers[name])
    assert torch.equal(a.layers["attn_norm"], torch.ones_like(a.layers["attn_norm"]))
    assert tuple(a.embed.shape) == ref["embed"].shape
    assert tuple(a.lm_head.shape) == ref["lm_head"].shape
    n = sum(p.numel() for p in a.parameters())
    assert n == cfg.n_params() + (2 * cfg.head_dim * cfg.n_layers if cfg.qk_norm else 0)
    assert 0.8 < float(a.layers["wq"].detach().std()) * np.sqrt(cfg.d_model) < 1.2
    # the MoE model (its slice has come): the reference's layer names and
    # shapes, router and experts drawn with the reference's fan-ins
    moe_cfg = configs.get_config("moonshot-v1-16b-a3b").reduced()
    moe = steps.init_model_params(moe_cfg, torch.Generator().manual_seed(3), "cpu")
    moe_ref = ref_transformer.init_params(
        ref_configs.get_config("moonshot-v1-16b-a3b").reduced(), KEY)
    assert sorted(moe.layers) == sorted(moe_ref["layers"])
    for name, p in moe.layers.items():
        assert tuple(p.shape) == moe_ref["layers"][name].shape, name
    assert sum(p.numel() for p in moe.parameters()) == moe_cfg.n_params()
    assert 0.8 < float(moe.layers["w_gate"].detach().std()) * np.sqrt(moe_cfg.d_model) < 1.2
    assert 0.8 < float(moe.layers["w_down"].detach().std()) * np.sqrt(
        moe_cfg.moe.d_ff_expert) < 1.2
    # the GNN (its slice has come): the reference's parameter names
    gin = steps.init_model_params(configs.get_config("gin-tu").reduced(), torch.Generator(),
                                  "cpu")
    assert {n.split(".")[-1] for n, _ in gin.named_parameters()} == {
        "w1", "b1", "w2", "b2", "eps", "out_w", "out_b"}


def test_params_from_reference_refuses_other_keys():
    cfg = configs.get_config("granite-3-2b").reduced()
    ref = jax.tree.map(np.asarray, ref_transformer.init_params(
        ref_configs.get_config("granite-3-2b").reduced(), KEY))
    model = transformer.params_from_reference(cfg, ref, device="cpu")
    assert np.array_equal(_np(model.layers["wq"]), ref["layers"]["wq"])
    with pytest.raises(KeyError):
        transformer.params_from_reference(cfg, {**ref, "extra": ref["embed"]}, device="cpu")
    bad = {**ref, "layers": {**ref["layers"], "wq": ref["layers"]["wk"]}}
    with pytest.raises(ValueError, match="shape"):
        transformer.params_from_reference(cfg, bad, device="cpu")
