"""The port's recsys serving path on the CPU, against the reference.

FM, xDeepFM, SASRec and two-tower, reduced (``RecsysConfig.reduced``), with
the reference's weights carried across by ``recsys_params_from_reference``
and the same ``recsys_batches`` inputs: serve and retrieval steps, and the
retrieval steps served in bf16 (``serve_dtype``).  On the CPU the lookups
and the CIN layers run the kernels' plain versions (``embedding_bag_torch``,
``cin_layer_torch``); ``chip_smoke.py`` holds the kernels against them on a
card.  Tolerances:

* float32 logits and scores within 1e-5 of the largest |value| (the
  reference sums the same float32 terms in another order: its FM sum over
  fields and its CIN einsums, ours the bag sums and the CIN's chunked
  einsums; measured differences are ~1e-7);
* bf16 retrieval within 2e-2 of the largest |value| (a bf16 rounding or
  two: the reference's bf16 reductions and ours round at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipelines as ref_pipelines
from repro.models import recsys as ref_recsys
from repro.models import steps as ref_steps
from repro_torch import configs
from repro_torch.data import pipelines
from repro_torch.models import recsys, steps

KEY = jax.random.PRNGKey(1)
NAMES = ["fm", "xdeepfm", "sasrec", "two-tower-retrieval"]
SERVE_KEYS = {"fm-2way": ("fields",), "cin": ("fields",), "self-attn-seq": ("hist", "target"),
              "dot": ("user_feats", "item_ids")}


def _models(name):
    ref_cfg, cfg = ref_configs.get_config(name).reduced(), configs.get_config(name).reduced()
    ref_params = ref_steps.init_model_params(ref_cfg, KEY)
    params = recsys.recsys_params_from_reference(cfg, jax.tree.map(np.asarray, ref_params),
                                                 device="cpu")
    return ref_cfg, cfg, ref_params, params


def _close(got: torch.Tensor, want, rel: float) -> None:
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    g = got.detach().float().numpy()
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= rel * np.abs(w).max()


@pytest.mark.parametrize("name", NAMES)
def test_recsys_batches_match_reference(name):
    cfg, ref_cfg = configs.get_config(name).reduced(), ref_configs.get_config(name).reduced()
    a = next(pipelines.recsys_batches(cfg, 7, seed=3))
    b = next(ref_pipelines.recsys_batches(ref_cfg, 7, seed=3))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)


@pytest.mark.parametrize("name", NAMES)
def test_serve_matches_reference(name):
    ref_cfg, cfg, ref_params, params = _models(name)
    batch = next(pipelines.recsys_batches(cfg, 9, seed=4))
    keys = SERVE_KEYS[cfg.interaction]
    want = ref_steps.make_recsys_serve_step(ref_cfg)(
        ref_params, **{k: jnp.asarray(batch[k]) for k in keys})
    got = steps.make_recsys_serve_step(cfg)(params, **{k: torch.from_numpy(batch[k])
                                                       for k in keys})
    assert got.dtype == torch.float32 and not got.requires_grad
    _close(got, want, 1e-5)


def _retrieval_inputs(cfg, batch):
    if cfg.interaction in ("fm-2way", "cin"):
        return batch["fields"], {}
    if cfg.interaction == "self-attn-seq":
        return np.arange(1, 40, dtype=np.int32), {"hist": batch["hist"][:2]}
    # ids past the table's rows: both towers hash them with % n
    return np.arange(0, 150, dtype=np.int32), {"user_feats": batch["user_feats"][:2] + 90}


@pytest.mark.parametrize("serve_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_retrieval_matches_reference(name, serve_dtype):
    """Retrieval with the candidates padded to a multiple of 16 and the
    scores sliced back, in float32 and in bf16."""
    ref_cfg, cfg, ref_params, params = _models(name)
    batch = next(pipelines.recsys_batches(cfg, 11, seed=5))
    cand, extra = _retrieval_inputs(cfg, batch)
    jdt = None if serve_dtype is None else jnp.bfloat16
    tdt = None if serve_dtype is None else torch.bfloat16
    want = ref_steps.make_recsys_serve_step(ref_cfg, retrieval=True, cand_pad_multiple=16,
                                            serve_dtype=jdt)(
        ref_params, candidates=jnp.asarray(cand), **{k: jnp.asarray(v) for k, v in extra.items()})
    got = steps.make_recsys_serve_step(cfg, retrieval=True, cand_pad_multiple=16,
                                       serve_dtype=tdt)(
        params, candidates=torch.from_numpy(cand),
        **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    _close(got, want, 1e-5 if serve_dtype is None else 2e-2)
    # the module itself keeps its float32 weights
    assert all(p.dtype == torch.float32 for p in params.parameters())


def test_fm_sum_square_trick():
    """FM's pairwise term equals the explicit O(n^2) enumeration (the
    reference's own check, tests/test_models.py:129)."""
    cfg = configs.get_config("fm").reduced()
    params = steps.init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    fields = torch.from_numpy(np.random.default_rng(6).integers(0, 4, (4, cfg.n_fields))
                              .astype(np.int32))
    got = recsys.fm_logits(cfg, params, fields)
    rows = fields + torch.from_numpy(recsys.field_offsets(cfg)[:-1])
    v = params.table[rows.long()].detach()
    pair = torch.zeros(4)
    for i in range(cfg.n_fields):
        for j in range(i + 1, cfg.n_fields):
            pair = pair + (v[:, i] * v[:, j]).sum(-1)
    want = params.bias.detach() + params.linear[rows.long()].detach().sum(-1) + pair
    assert (got - want).abs().max() < 1e-6


def test_embed_fields_and_offsets_match_reference():
    cfg, ref_cfg = configs.get_config("xdeepfm").reduced(), ref_configs.get_config("xdeepfm").reduced()
    assert np.array_equal(recsys.field_offsets(cfg), ref_recsys.field_offsets(ref_cfg))
    table = np.random.default_rng(7).normal(size=(sum(cfg.field_vocab_sizes), 8)).astype(np.float32)
    fields = next(pipelines.recsys_batches(cfg, 5, seed=8))["fields"]
    offs = recsys.field_offsets(cfg)
    got = recsys.embed_fields(torch.from_numpy(table), torch.from_numpy(fields), offs)
    want = ref_recsys.embed_fields(jnp.asarray(table), jnp.asarray(fields), offs)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bad", [-1, "vocab"])
def test_field_ids_outside_their_vocabulary_raise(bad):
    """The reference would read the next field's row; the port refuses."""
    cfg = configs.get_config("xdeepfm").reduced()
    params = steps.init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    fields = torch.zeros((3, cfg.n_fields), dtype=torch.int32)
    fields[1, 5] = cfg.field_vocab_sizes[5] if bad == "vocab" else bad
    for fn in (recsys.xdeepfm_logits, recsys.fm_logits):
        with pytest.raises(IndexError, match="field 5"):
            fn(cfg, params, fields)


@pytest.mark.parametrize("name", NAMES)
def test_init_layout_and_determinism(name):
    """``init_model_params`` dispatches the four configs; the parameters
    have the reference's names and shapes, draw the same numbers from the
    same generator seed, and follow the reference's scales."""
    cfg, ref_cfg = configs.get_config(name).reduced(), ref_configs.get_config(name).reduced()
    a = steps.init_model_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = steps.init_model_params(cfg, torch.Generator().manual_seed(3), "cpu")
    ref = jax.tree.map(np.asarray, ref_steps.init_model_params(ref_cfg, KEY))
    ours = {k: v for k, v in a.state_dict().items()}
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]

    def name_of(path):
        return ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)

    want = {name_of(path): leaf for path, leaf in flat}
    assert sorted(ours) == sorted(want)
    for k, v in want.items():
        assert tuple(ours[k].shape) == v.shape, k
        assert torch.equal(ours[k], b.state_dict()[k]), k
    big = max(want, key=lambda k: want[k].size)
    assert abs(float(ours[big].std()) / float(want[big].std()) - 1) < 0.2


def test_refusals():
    cfg = configs.get_config("two-tower-retrieval").reduced()
    with pytest.raises(NotImplementedError, match="cand_shard_axes"):
        steps.make_recsys_serve_step(cfg, retrieval=True, cand_shard_axes=("model",))
    ref = jax.tree.map(np.asarray, ref_steps.init_model_params(
        ref_configs.get_config("two-tower-retrieval").reduced(), KEY))
    with pytest.raises(KeyError):
        recsys.recsys_params_from_reference(cfg, {**ref, "extra": ref["user_table"]}, "cpu")
    bad = {**ref, "item_table": ref["user_table"][:3]}
    with pytest.raises(ValueError, match="shape"):
        recsys.recsys_params_from_reference(cfg, bad, "cpu")
    # the GNN is no longer refused (models.gnn); a card is still asked for
    gin = configs.get_config("gin-tu").reduced()
    assert steps.init_model_params(gin, torch.Generator(), "cpu").out_w.shape[0] == gin.d_hidden
    with pytest.raises(RuntimeError):
        steps.init_model_params(gin, torch.Generator(), "cuda")  # no card here
    with pytest.raises(RuntimeError):
        steps.init_model_params(cfg, torch.Generator(), "cuda")  # no card here


def test_serving_builds_no_graph():
    """Parameters require gradients; serving builds no autograd graph (the
    serve steps run under ``torch.no_grad()``; training goes through the
    kernels' autograd Functions instead)."""
    cfg = configs.get_config("xdeepfm").reduced()
    params = steps.init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(p.requires_grad for p in params.parameters())
    fields = torch.from_numpy(next(pipelines.recsys_batches(cfg, 4, seed=0))["fields"])
    out = steps.make_recsys_serve_step(cfg)(params, fields=fields)
    assert out.grad_fn is None and not out.requires_grad
