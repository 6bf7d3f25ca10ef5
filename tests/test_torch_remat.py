"""Remat in the port's LM (``cfg.remat``, ``models.transformer``): each layer
under ``torch.utils.checkpoint.checkpoint`` for ``"block"`` / ``"full"``, as
the reference's ``jax.checkpoint(layer)``.

* The recompute repeats the forward bit for bit, so the gradients, the
  loss and the aux loss with remat equal those without it exactly (float32
  and bf16, the plain path and the kernels' autograd Functions, dense and
  MoE in two token groups, one and two micro-batches);
* each layer runs twice a step under remat (forward, then recompute in the
  backward) and once without;
* the port's step under remat against the reference's ``make_lm_train_step``
  (which remats too): losses over three steps and the first gradients within
  ``tests/test_torch_train.py``'s limits (1e-5 relative losses; gradients
  within 1e-5 of the leaf's largest |gradient|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipelines as ref_pipelines
from repro.models import steps as ref_steps
from repro.models import transformer as ref_transformer
from repro.train import optimizer as ref_opt
from repro_torch import configs
from repro_torch.models import steps, transformer
from repro_torch.train import optimizer as opt

KEY = jax.random.PRNGKey(0)
GRAD_REL = 1e-5
LMS = ["qwen3-8b", "moonshot-v1-16b-a3b"]


def _cfg(name: str, dtype: str, remat: str):
    cfg = configs.get_config(name).reduced()
    if cfg.moe:  # grouped dispatch: capacity per group of 48 tokens
        cfg = dataclasses.replace(cfg, moe_groups=2)
    return dataclasses.replace(cfg, dtype=dtype, remat=remat)


def _batch(cfg, rows: int = 4, t: int = 24, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, t)).astype(np.int32))
            for k in ("tokens", "targets")}


@pytest.fixture
def kernel_route_on_cpu(monkeypatch):
    orig = transformer.resolve_attention
    monkeypatch.setattr(transformer, "resolve_attention",
                        lambda a, d: "kernel" if a is None else orig(a, d))


@pytest.mark.parametrize("name", LMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", ["block", "full"])
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("route", ["plain", "functions"])
def test_remat_gradients_equal_no_remat_bit_for_bit(name, dtype, remat, n_micro, route,
                                                    request):
    if route == "functions":
        request.getfixturevalue("kernel_route_on_cpu")
    cfg = _cfg(name, dtype, remat)
    params = steps.init_model_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = _batch(cfg)
    got = steps._accum_grads(steps.loss_for(cfg), params, batch, n_micro)
    want = steps._accum_grads(steps.loss_for(dataclasses.replace(cfg, remat="none")), params,
                              batch, n_micro)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        assert got[2][k].dtype == want[2][k].dtype and torch.equal(got[2][k], want[2][k]), k


@pytest.mark.parametrize("remat,runs", [("none", 1), ("block", 2), ("full", 2)])
def test_each_layer_runs_once_more_under_remat(monkeypatch, remat, runs):
    cfg = _cfg("qwen3-8b", "float32", remat)
    params = steps.init_model_params(cfg, torch.Generator().manual_seed(2), "cpu")
    calls = []
    real = transformer._layer

    def layer(cfg_, view, i, *a, **k):
        calls.append(i)
        return real(cfg_, view, i, *a, **k)

    monkeypatch.setattr(transformer, "_layer", layer)
    steps._accum_grads(steps.loss_for(cfg), params, _batch(cfg), 1)
    assert sorted(calls) == sorted(list(range(cfg.n_layers)) * runs)
    calls.clear()
    transformer.forward(cfg, params, _batch(cfg)["tokens"])  # serving: no checkpoint
    assert calls == list(range(cfg.n_layers))


def test_unknown_remat_refused():
    cfg = _cfg("qwen3-8b", "float32", "sometimes")
    params = steps.init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="remat='sometimes'"):
        steps._accum_grads(steps.loss_for(cfg), params, _batch(cfg), 1)


@pytest.mark.parametrize("name", LMS)
@pytest.mark.parametrize("remat", ["none", "block"])
def test_remat_step_matches_reference(name, remat):
    """Three steps of ``make_lm_train_step`` from the reference's weights,
    both sides with ``remat``: losses within 1e-5 relative step by step,
    and the first step's gradients within 1e-5 of each leaf's largest
    |gradient|."""
    rc = dataclasses.replace(ref_configs.get_config(name).reduced(), remat=remat)
    pc = dataclasses.replace(configs.get_config(name).reduced(), remat=remat)
    rp = ref_transformer.init_params(rc, KEY)
    model = transformer.params_from_reference(pc, jax.tree.map(np.asarray, rp), "cpu")
    batches = [next(ref_pipelines.lm_batches(rc, 4, 16, s)) for s in range(3)]
    _, _, rg = ref_steps._accum_grads(
        lambda p, bt: ref_transformer.loss_fn(rc, p, bt["tokens"], bt["targets"]), rp,
        {k: jnp.asarray(v) for k, v in batches[0].items()}, 2)
    _, _, pg = steps._accum_grads(steps.loss_for(pc), model,
                                  {k: torch.from_numpy(v) for k, v in batches[0].items()}, 2)
    for path, g in jax.tree_util.tree_flatten_with_path(rg)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        want = np.asarray(g, np.float32)
        got = pg[key].detach().float().numpy()
        assert np.max(np.abs(got - want)) <= GRAD_REL * max(np.max(np.abs(want)), 1e-30), key
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=100)
    ro, po = ref_opt.OptConfig(**kw), opt.OptConfig(**kw)
    rstep = jax.jit(ref_steps.make_lm_train_step(rc, ro, n_micro=2))
    pstep = steps.make_lm_train_step(pc, po, n_micro=2)
    rstate, pstate = ref_steps.init_state(rp, ro), steps.init_state(model, po)
    for b in batches:
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        pstate, pm = pstep(pstate, b)
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=1e-5)
