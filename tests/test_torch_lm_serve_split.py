"""The LM's serving steps split over the mesh (``repro_torch.sharding.
{lm_serve, lm_split, decode_split}``) across eight gloo ranks on the CPU:
the sequence-parallel prefill, whose cache comes out in the decode spec's
layout, and the decode over a cache split over T, with the ranks' partial
``(o, lse)`` joined by ``combine_partials``.

One spawned run for the module (``tests/torch_ranks.py``).  Each rank runs
every layout below, each against the port's unsharded steps
(``steps.make_lm_prefill_step`` / ``make_lm_decode_step``) on the whole
batch, float32, plain path:

* ``decode_32k`` on the meshes (4, 2), (2, 4) and (1, 8) of ``("data",
  "model")``: B = 8 rows over ``"data"``, the prompt's T = 16 and the
  cache's T over ``"model"``: the prefill, then two decode steps;
* ``long_500k`` on (1, 8) and (2, 4): one row, the cache's T over
  ``("data", "model")`` (the reference's spec on (2, 4); on (1, 8) the data
  axis has one rank), tokens and positions replicated: three decode steps
  on the unsharded prefill's cache.

Reduced configs that hit the traps: ``qk_kv`` (qwen3-8b, 8 heads on 2 kv
heads: on 4 and 8 model ranks a kv head lies on several ranks, and one of
them alone sends it in the prefill's all-to-all), ``ragged`` (granite, 6
heads on 3 kv heads, 12 on 6 on 8 model ranks: 1.5 q heads a rank) and
``moe`` (moonshot, E = 8, top-2, its token groups those of the whole
batch).  The decode positions put a row's position in every slice, at a
slice's first and last row, and leave slices with no live row (a row at
position 0 sees slice 0 alone).

Limits, argued from the order of the sums before any run.  The split steps
compute the unsharded steps' products on the same operands and sum some of
them in other groups: the row-parallel products (``wo``, ``w_down``, the
experts' combine) as m partial sums, and the decode's softmax as per-slice
sums joined by ``combine_partials`` (a max, then weights ``e^(lse - M)``
that are one float32 rounding each).  Each such float32 sum moves by a few
units of its last place relative to the sum of its terms' magnitudes, so:

* the logits (prefill and every decode step) to ``||d|| / ||want|| <=
  1e-5`` over the rank's rows (as ``tests/test_torch_tp.py`` holds the
  loss);
* the prefill's cache, bf16 as the unsharded prefill writes it, element by
  element within one bf16 step of the unsharded value plus the float32
  drift, ``|d| <= 2^-7 |want| + 1e-5`` (``chip_smoke.py``'s
  ``ATTENTION_TOL`` for a bf16 output): a k or v that moved by a few
  float32 units of its terms' magnitudes (about 1 here) may round to the
  neighbouring bf16 value, and where it is the small result of cancelling
  terms its float32 drift is not small beside it, so the 1e-5 floor;
* the decode runs on a float32 cache (the unsharded prefill's, widened), so
  the cache after the steps, the new rows included, to ``||d|| / ||want||
  <= 1e-5``.

Bit-equality is not promised here (it is on the card at a world of one,
``chip_smoke.py``'s ``mesh`` phase).  Planted faults, each of which must
break one of those limits: a combine that drops the rank with the largest
``lse``, the new token's k and v written on every T rank, a kv head sent by
every rank that holds it in the prefill's all-to-all (assembled by
position), and ``lse`` in base 2.  The steps call ``full_tensor`` nowhere,
gather no stacked layer weight and no whole cache.
"""

import json

import pytest
from torch_ranks import spawn_ranks

WORLD = 8
#: (n_data, n_model, the cache's layout)
LAYOUTS = [(4, 2, "decode_32k"), (2, 4, "decode_32k"), (1, 8, "decode_32k"),
           (1, 8, "long_500k"), (2, 4, "long_500k")]
CASES = ["qk_kv", "ragged", "moe"]
FAULTS = ["drop_max_lse", "write_every_rank", "dup_kv_send", "lse_base2"]

SCRIPT = r'''
import dataclasses, json, math, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
LAYOUTS = json.loads(sys.argv[5])
FAULTS = json.loads(sys.argv[6])

from unittest import mock

from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.checkpointer import reshard
from repro_torch.configs import get_config
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models import steps
from repro_torch.sharding import decode_split, lm_serve, lm_split, tp
from repro_torch.sharding.compat import NamedSharding, local_shard, make_mesh
from repro_torch.sharding.specs import input_specs_sharding_for, lm_param_specs
from repro_torch.train.optimizer import param_tree

B, T = 8, 16
#: each step's positions: B = 8 rows, or one row (long_500k)
POSITIONS = {8: [[0, 3, 4, 7, 8, 11, 12, 15], [1, 2, 5, 6, 9, 10, 13, 14]],
             1: [[8], [15], [0]]}


def rel(a, b):
    d = float(torch.linalg.vector_norm((a.double() - b.double())))
    n = max(float(torch.linalg.vector_norm(b.double())), 1e-30)
    return d / n if math.isfinite(d) else math.inf


def step_ratio(a, b):
    """The largest |a - b| / (2^-7 |b| + 1e-5): the share of the prefill
    cache's limit (module docstring) that the worst element takes."""
    d = (a.double() - b.double()).abs()
    r = d / (b.double().abs() * 2.0 ** -7 + 1e-5)
    return float(r.max()) if bool(torch.isfinite(r).all()) else math.inf


def configs(m, b):
    q = get_config("qwen3-8b").reduced()
    g = get_config("granite-3-2b").reduced()
    mo = get_config("moonshot-v1-16b-a3b").reduced()
    heads, kv, hd = (6, 3, 16) if m < 8 else (12, 6, 8)
    return {
        "qk_kv": dataclasses.replace(q, n_heads=8, n_kv_heads=2, head_dim=8),
        "ragged": dataclasses.replace(g, n_heads=heads, n_kv_heads=kv, head_dim=hd),
        "moe": dataclasses.replace(mo, n_heads=8, n_kv_heads=2, head_dim=8,
                                   moe_groups=4 if b == B else 1,
                                   moe=dataclasses.replace(mo.moe, n_experts=8, top_k=2)),
    }


class Seen:
    """full_tensor calls and every gather's result shape in the block."""

    def __enter__(self):
        self.full_tensor, self.shapes = 0, []
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


def fault_patches(fault):
    """The planted fault's patches (module docstring)."""
    if fault == "drop_max_lse":
        def combine(o, lse, group, out_dtype):
            groups = decode_split._live_groups(group)
            m = tp.max_into(lse.clone(), groups)
            w = torch.where(lse == m, torch.zeros_like(lse), torch.exp(lse - m))
            packed = tp.sum_into(torch.cat([o[:, 0] * w[..., None], w[..., None]], -1), groups)
            out = packed[..., :-1] / packed[..., -1:].clamp(min=1e-30)
            return out[:, None].to(out_dtype), m
        return [mock.patch.object(decode_split, "combine_partials", combine)]
    if fault == "write_every_rank":
        def write(self, cache, rows, pos, new):
            s = cache.shape[1]
            cache[rows, (pos - self.t_index * s).clamp(0, s - 1)] = new
        return [mock.patch.object(lm_split.DecodeView, "decode_write", write)]
    if fault == "dup_kv_send":
        real = lm_split.RankView.cache_rows

        def cache_rows(self, k, v):
            sp = self.split
            kh = sp.cfg.n_kv_heads
            owned = sp.kv_owned
            sp.kv_owned = sp.kv_ranges  # every holder sends its kv heads
            try:
                k2, v2 = real(self, k, v)
            finally:
                sp.kv_owned = owned
            return k2[:, :, :kh], v2[:, :, :kh]  # assembled by position
        return [mock.patch.object(lm_split.RankView, "cache_rows", cache_rows)]
    if fault == "lse_base2":
        real = fd_ops.flash_decode_partial_torch

        def partial(*a):
            o, lse = real(*a)
            return o, torch.where(lse > -1e29, lse / math.log(2.0), lse)
        return [mock.patch.object(fd_ops, "flash_decode_partial_torch", partial)]
    raise ValueError(fault)


def run(cfg, mesh, layout, seed, fault=None):
    b = B if layout == "decode_32k" else 1
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, T)).astype(np.int64))
    steps_tok = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int64))
                 for _ in POSITIONS[b]]
    params = steps.init_model_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    pspecs = lm_param_specs(cfg, mesh, False)
    placed = reshard(params, mesh, pspecs)
    dec_specs = input_specs_sharding_for(cfg, layout, mesh, False)
    cache_pl = NamedSharding(mesh, dec_specs["kv_cache"]).placements()
    want_logits, want_cache = steps.make_lm_prefill_step(cfg, "torch")(params, tokens)
    res = {"cache_spec": [str(p) for p in cache_pl]}
    n_data = mesh.size(0)
    d = mesh.get_local_rank("data")
    patches = fault_patches(fault) if fault else []
    for p in patches:
        p.start()
    try:
        with Seen() as seen:
            if layout == "decode_32k":
                pre = lm_serve.make_sharded_prefill_step(
                    cfg, mesh, pspecs, input_specs_sharding_for(cfg, "prefill_32k", mesh, False),
                    "torch")
                logits, cache = pre(placed, tokens)
                holds = mesh.get_local_rank("model") == mesh.size(1) - 1
                res["prefill_logits_none"] = logits is None
                rows = slice(d * b // n_data, (d + 1) * b // n_data)
                res["prefill_logits_rel"] = (rel(logits, want_logits[rows]) if holds
                                             else None)
                want_local = local_shard(want_cache, mesh, cache_pl)
                res["prefill_cache_shape"] = [list(cache.shape), list(want_local.shape)]
                res["prefill_cache_steps"] = step_ratio(cache, want_local)
            whole = want_cache.float()
            local = local_shard(whole, mesh, cache_pl).clone()
            dec = lm_serve.make_sharded_decode_step(cfg, mesh, pspecs, dec_specs, "torch")
            res["t_index"], res["t_slices"] = dec.t_index, dec.t_slices
            res["kv_owned"] = dec.split.kv_owned
            unsharded = steps.make_lm_decode_step(cfg, "torch")
            res["decode_logits_rel"] = []
            for tok, pos in zip(steps_tok, POSITIONS[b]):
                pos = torch.tensor(pos, dtype=torch.int32)
                want, _ = unsharded(params, tok, pos, whole)
                got, _ = dec(placed, tok, pos, local)
                rows = NamedSharding(mesh, dec_specs["positions"]).placements()
                res["decode_logits_rel"].append(rel(got, local_shard(want, mesh, rows)))
            res["decode_cache_rel"] = rel(local, local_shard(whole, mesh, cache_pl))
    finally:
        for p in patches:
            p.stop()
    layers = [list(t.shape) for k, t in param_tree(params).items() if k.startswith("layers/")]
    caches = [list(want_cache.shape), list(want_cache.shape[1:]), list(want_cache.shape[2:]),
              [b // n_data, T, cfg.n_kv_heads, cfg.head_dim]]
    res["full_tensor_calls"] = seen.full_tensor
    res["gathered_layer_leaf"] = any(s in layers for s in seen.shapes)
    res["gathered_whole_cache"] = any(s in caches for s in seen.shapes)
    res["n_gathers"] = len(seen.shapes)
    return res


res = {"rank": rank}
for n_data, n_model, layout in LAYOUTS:
    mesh = make_mesh((n_data, n_model), ("data", "model"), device_type="cpu")
    tag = f"{n_data}x{n_model}/{layout}"
    for i, (name, cfg) in enumerate(configs(n_model, B if layout == "decode_32k" else 1).items()):
        res[f"{tag}/{name}"] = run(cfg, mesh, layout, 10 * i + n_model)
        if name == "qk_kv" and layout == "decode_32k":
            for fault in FAULTS:
                res[f"{tag}/{name}/planted/{fault}"] = run(cfg, mesh, layout, 10 * i + n_model,
                                                          fault)
    dist.barrier()

dist.barrier()
dist.destroy_process_group()
with open(out, "w") as f:
    json.dump(res, f)
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(tmp_path_factory, "serve", SCRIPT, WORLD,
                       [json.dumps(LAYOUTS), json.dumps(FAULTS)])


LOGITS_REL = 1e-5
CACHE_REL = 1e-5
PREFILL_STEPS = 1.0  # one bf16 step


def _tag(layout):
    return f"{layout[0]}x{layout[1]}/{layout[2]}"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
def test_split_serving_matches_unsharded(ranks, layout, case):
    for r in ranks:
        got = r[f"{_tag(layout)}/{case}"]
        assert max(got["decode_logits_rel"]) <= LOGITS_REL, got["decode_logits_rel"]
        assert got["decode_cache_rel"] <= CACHE_REL, got["decode_cache_rel"]
        if layout[2] == "decode_32k":
            shape, want = got["prefill_cache_shape"]
            assert shape == want  # the decode spec's layout: (L, 2, B / dp, T / m, K, hd)
            assert got["prefill_cache_steps"] <= PREFILL_STEPS, got["prefill_cache_steps"]
            last = r["rank"] % layout[1] == layout[1] - 1
            assert got["prefill_logits_none"] is (not last)
            if last:
                assert got["prefill_logits_rel"] <= LOGITS_REL, got["prefill_logits_rel"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
def test_split_serving_gathers_no_whole_leaf(ranks, layout, case):
    """No ``full_tensor``, no gather that makes a stacked layer weight or a
    cache whole; the layer weights are gathered per layer."""
    for r in ranks:
        got = r[f"{_tag(layout)}/{case}"]
        assert got["full_tensor_calls"] == 0
        assert not got["gathered_layer_leaf"]
        assert not got["gathered_whole_cache"]
        assert got["n_gathers"] > 0


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("layout", LAYOUTS[:3], ids=_tag)
def test_planted_fault_breaks_a_limit(ranks, layout, fault):
    tag = f"{_tag(layout)}/qk_kv/planted/{fault}"
    broken = []
    for r in ranks:
        got = r[tag]
        broken.append(max(got["decode_logits_rel"]) > LOGITS_REL
                      or got["decode_cache_rel"] > CACHE_REL
                      or got["prefill_cache_steps"] > PREFILL_STEPS
                      or (got["prefill_logits_rel"] or 0.0) > LOGITS_REL)
    if fault == "dup_kv_send" and layout[1] == 2:  # 2 kv heads on 2 ranks: none shared
        assert not any(broken)
        return
    assert any(broken), fault


def test_cache_slices_follow_the_specs(ranks):
    """Each rank's slice of T: its model coordinate under ``decode_32k``;
    data-major over ``("data", "model")`` under ``long_500k`` on (2, 4)."""
    for r in ranks:
        d, m = r["rank"] // 4, r["rank"] % 4
        assert r["2x4/long_500k/qk_kv"]["t_index"] == 4 * d + m
        assert r["2x4/long_500k/qk_kv"]["t_slices"] == 8
        assert r["2x4/decode_32k/qk_kv"]["t_index"] == m
        assert r["1x8/long_500k/qk_kv"]["t_slices"] == 8


def test_traps_are_hit(ranks):
    """On 4 and 8 model ranks a kv head of ``qk_kv`` lies on several ranks
    and only the first sends it; ``ragged`` has 1.5 q heads a rank."""
    r = ranks[0]
    for layout, m in (("2x4/decode_32k", 4), ("1x8/decode_32k", 8)):
        owned = r[f"{layout}/qk_kv"]["kv_owned"]
        assert sum(b - a for a, b in owned) == 2
        assert sum(1 for a, b in owned if b == a) == m - 2
    from repro_torch.sharding.lm_split import head_plan

    assert sorted({b - a for (a, b), _, _ in (head_plan(12, 6, 8, j) for j in range(8))}) == [1, 2]
