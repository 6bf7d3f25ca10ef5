"""The port's dry-run tier (``repro_torch.launch.{hlo_cost, hlo_analysis,
roofline, dryrun}``) against the reference's.

* ``analyze_hlo`` of the port's copy gives the reference's record, field
  for field, on HLO text that JAX compiles here (the programs of
  ``tests/test_hlo_cost.py``);
* ``model_flops_for`` and ``opt_config_for`` equal the reference's for all
  40 (arch, shape) cells, exactly;
* ``roofline.table`` / ``summary`` print the reference's text for the same
  records; ``roofline_terms`` gives the stated figures on the H100's
  datasheet peaks;
* on a ``fake`` world of 256 ranks (and of 512 for one cell), in a
  subprocess, ``run_cell`` gives ``status == "ok"`` with the stated keys for
  a dense LM train cell, an MoE train cell, an LM decode cell, a GNN cell
  and a recsys serve cell, touching no CUDA; the dense LM train cell's
  collective bytes by op (the LM's split step) equal those computed from
  the specs and shapes;
* a reduced LM train cell on a ``fake`` world of 8 ranks, mesh (2, 4): its
  memory parts and its collective bytes by op equal those computed from
  the specs and shapes, and its FLOPs are within 1 % of an analytic count
  a rank that includes remat's recomputed forward;
* on a reduced LM and a 1-rank mesh, the port's FLOPs of a train step and
  the reference's ``analyze_hlo`` of its compiled step each equal their
  analytical count: both recompute the forward in the backward (remat);
  neither skips the masked causal blocks.
"""

import dataclasses
import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import hlo_cost as ref_hlo_cost
from repro.launch import roofline as ref_roofline
from repro.models import steps as ref_steps
from repro.train.optimizer import OptConfig as RefOptConfig
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import dryrun, hlo_analysis, hlo_cost, roofline
from repro_torch.models import steps
from repro_torch.sharding import specs
from repro_torch.sharding.compat import AbstractMesh, NamedSharding
from repro_torch.train.optimizer import param_tree

ROOT = Path(__file__).resolve().parent.parent
CELLS = [(a, s) for a in ASSIGNED_ARCHS for s in get_config(a).shapes]
RECORD_KEYS = {"arch", "shape", "mesh", "multi_pod", "n_chips", "status", "build_s", "count_s",
               "memory", "collectives", "hlo_cost", "roofline", "notes"}
MEMORY_KEYS = {"state_bytes", "input_bytes", "gathered_weight_bytes", "output_bytes",
               "grad_bytes", "saved_activation_bytes", "total_per_device_gib"}


def _ref_dryrun():
    """The reference's dry-run module: its import sets ``XLA_FLAGS`` for 512
    host devices, which this process must not keep (the backend is started
    first, so the flag cannot take effect here either)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


# ----------------------------------------------------------------------
# hlo_cost: the port's copy on HLO that JAX builds here
# ----------------------------------------------------------------------
def _matmul():
    return (lambda a, b: a @ b, jax.ShapeDtypeStruct((256, 512), jnp.float32),
            jax.ShapeDtypeStruct((512, 128), jnp.float32))


def _scan():
    def f(a):
        def body(c, _):
            return jnp.tanh(c @ a), None

        out, _ = jax.lax.scan(body, a, None, length=9)
        return out

    return f, jax.ShapeDtypeStruct((128, 128), jnp.float32)


def _nested_scan():
    def f(a):
        def outer(c, _):
            def inner(d, _):
                return d @ a, None

            d, _ = jax.lax.scan(inner, c, None, length=3)
            return d, None

        out, _ = jax.lax.scan(outer, a, None, length=4)
        return out

    return f, jax.ShapeDtypeStruct((64, 64), jnp.float32)


def _elementwise():
    return (lambda a: jnp.tanh(a) * 2), jax.ShapeDtypeStruct((512, 512), jnp.float32)


@pytest.mark.parametrize("program", [_matmul, _scan, _nested_scan, _elementwise])
def test_analyze_hlo_matches_reference(program):
    f, *args = program()
    hlo = jax.jit(f).lower(*args).compile().as_text()
    port, ref = hlo_cost.analyze_hlo(hlo).as_dict(), ref_hlo_cost.analyze_hlo(hlo).as_dict()
    assert port == ref
    assert port["flops"] > 0 or program is _elementwise


# ----------------------------------------------------------------------
# the configs' arithmetic
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_opt_config_match_reference(arch, shape):
    ref = _ref_dryrun()
    assert dryrun.model_flops_for(get_config(arch), shape) == \
        ref.model_flops_for(ref_get_config(arch), shape)
    assert dataclasses.asdict(dryrun.opt_config_for(get_config(arch))) == \
        dataclasses.asdict(ref.opt_config_for(ref_get_config(arch)))


def test_forty_cells():
    assert len(CELLS) == 40
    assert CELLS == [(a, s) for a in _ref_dryrun().ASSIGNED_ARCHS
                     for s in ref_get_config(a).shapes]


# ----------------------------------------------------------------------
# roofline: the report's text, the H100 terms
# ----------------------------------------------------------------------
def _records():
    def ok(arch, shape, mesh, gib, comp, mem, coll, dom, useful, cb):
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                "memory": {"total_per_device_gib": gib},
                "roofline": {"compute_s": comp, "memory_s": mem, "collective_s": coll,
                             "dominant": dom, "useful_fraction": useful,
                             "collective_bytes_per_device": cb}}

    return [ok("qwen3-8b", "train_4k", "16x16", 620.25, 3.56, 24.9, 1.0, "memory", 0.9, 5e10),
            ok("gin-tu", "molecule", "16x16", 0.002, 2e-7, 4e-5, 0.0, "memory", 0.0, 0.0),
            ok("fm", "serve_p99", "2x16x16", 0.25, 0.0004, 0.0002, 0.004, "collective",
               0.001, 2e8),
            {"arch": "kimi-k2-1t-a32b", "shape": "decode_32k", "mesh": "16x16",
             "status": "fail", "error": "ValueError: " + "x" * 100}]


@pytest.mark.parametrize("mesh_filter", [None, "16x16", "2x16x16"])
def test_roofline_table_matches_reference(mesh_filter):
    recs = _records()
    assert roofline.table(recs, mesh_filter) == ref_roofline.table(recs, mesh_filter)
    assert roofline.summary(recs) == ref_roofline.summary(recs)


def test_roofline_main_reads_a_directory(tmp_path, capsys):
    for i, r in enumerate(_records()):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    assert roofline.load_records(str(tmp_path)) == ref_roofline.load_records(str(tmp_path))
    roofline.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith(ref_roofline.table(_records()))
    assert json.loads(out.split("\n\n", 1)[1]) == json.loads(
        json.dumps(ref_roofline.summary(_records())))


def test_roofline_terms_on_h100_peaks():
    """989e12 FLOP/s, 3.35e12 HBM bytes/s, 50e9 collective bytes/s a rank:
    one second of each peak's work costs one second."""
    assert (hlo_analysis.PEAK_FLOPS, hlo_analysis.HBM_BW, hlo_analysis.COLL_BW) == \
        (989e12, 3.35e12, 50e9)
    coll = type("C", (), {"total_bytes": 25e9})()
    r = hlo_analysis.roofline_terms({"flops": 989e12, "bytes accessed": 6.7e12}, coll, 256,
                                    model_flops=989e12 * 128)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 2.0, 0.5)
    assert r.dominant == "memory" and r.useful_fraction == 0.5
    assert set(r.as_dict()) == {"flops_per_device", "hbm_bytes_per_device",
                                "collective_bytes_per_device", "n_chips", "compute_s",
                                "memory_s", "collective_s", "dominant", "model_flops",
                                "useful_fraction"}
    assert hlo_analysis._DTYPE_BYTES["bf16"] == 2


# ----------------------------------------------------------------------
# the fake world: one subprocess runs every cell below
# ----------------------------------------------------------------------
FAKE_CELLS = [("llama3.2-3b", "train_4k", False), ("moonshot-v1-16b-a3b", "train_4k", False),
              ("qwen3-8b", "decode_32k", False), ("gin-tu", "molecule", False),
              ("xdeepfm", "serve_p99", False), ("qwen3-8b", "decode_32k", True)]

#: the reduced qwen3-8b of the (2, 4) split cell: 8 heads of 8 on 2 kv heads
#: (a kv head shared by two model ranks), 2 layers
SPLIT_CELL = {"n_heads": 8, "n_kv_heads": 2, "head_dim": 8}

FAKE_SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.sharding.compat import make_mesh

out = {"cells": [dryrun.run_cell(a, s, m, verbose=False) for a, s, m in json.loads(sys.argv[1])]}
out["group_after"] = dist.is_initialized()
# the reduced qwen3-8b train step on a world of one
dist.init_process_group("fake", rank=0, world_size=1, store=FakeStore())
mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
cell = dryrun.build_cell("qwen3-8b", "train_4k", mesh, False,
                         cfg=get_config("qwen3-8b").reduced())
hc, saved = dryrun.count_cell(cell)
dist.destroy_process_group()
out["tiny_flops"] = hc.flops
# a reduced LM train cell split over a (2, 4) mesh of 8 fake ranks
import dataclasses
dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
small = dataclasses.replace(get_config("qwen3-8b").reduced(), **json.loads(sys.argv[2]))
cell = dryrun.build_cell("qwen3-8b", "train_4k", mesh, False, cfg=small)
hc, saved = dryrun.count_cell(cell)
dist.destroy_process_group()
out["split_cell"] = {"flops": hc.flops, "bytes_by_op": hc.bytes_by_op,
                     "count_by_op": hc.count_by_op, "state_bytes": cell.state_bytes,
                     "input_bytes": cell.input_bytes, "grad_bytes": cell.grad_bytes,
                     "gathered_bytes": cell.gathered_bytes, "saved_bytes": saved}
# the same model's split prefill and decode cells on the same (2, 4) mesh
dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
out["serve_cells"] = {}
for shape in ("prefill_32k", "decode_32k", "long_500k"):
    cell = dryrun.build_cell("qwen3-8b", shape, mesh, False, cfg=small)
    hc, saved = dryrun.count_cell(cell)
    out["serve_cells"][shape] = {
        "bytes_by_op": hc.bytes_by_op, "count_by_op": hc.count_by_op,
        "state_bytes": cell.state_bytes, "input_bytes": cell.input_bytes,
        "output_bytes": cell.output_bytes, "gathered_bytes": cell.gathered_bytes,
        "saved_bytes": saved, "grad_bytes": cell.grad_bytes}
dist.destroy_process_group()
out["cuda_initialized"] = torch.cuda.is_initialized()
out["jax_loaded"] = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_world():
    proc = subprocess.run([sys.executable, "-c", FAKE_SCRIPT, json.dumps(FAKE_CELLS),
                           json.dumps(SPLIT_CELL)],
                          capture_output=True, text=True, timeout=600, cwd=str(ROOT),
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["by_cell"] = {(r["arch"], r["shape"], r["multi_pod"]): r for r in out["cells"]}
    return out


def test_fake_world_touches_no_device_and_imports_no_jax(fake_world):
    assert fake_world["cuda_initialized"] is False
    assert fake_world["group_after"] is False
    assert fake_world["jax_loaded"] == []


@pytest.mark.parametrize("cell", FAKE_CELLS, ids=lambda c: f"{c[0]}-{c[1]}-{'512' if c[2] else '256'}")
def test_fake_world_cell_is_ok(fake_world, cell):
    r = fake_world["by_cell"][cell]
    assert r["status"] == "ok", r.get("traceback")
    assert RECORD_KEYS <= set(r)
    assert set(r["memory"]) == MEMORY_KEYS
    assert r["n_chips"] == (512 if cell[2] else 256)
    assert r["mesh"] == ("2x16x16" if cell[2] else "16x16")
    parts = sum(v for k, v in r["memory"].items() if k != "total_per_device_gib")
    assert r["memory"]["total_per_device_gib"] == round(parts / 2**30, 3)
    assert r["hlo_cost"]["flops"] > 0 and r["hlo_cost"]["hbm_bytes"] > 0
    assert r["roofline"]["flops_per_device"] == r["hlo_cost"]["flops"]
    assert r["roofline"]["model_flops"] == dryrun.model_flops_for(get_config(cell[0]), cell[1])
    assert r["collectives"]["total_bytes"] == sum(r["collectives"]["bytes_by_op"].values())
    kind = get_config(cell[0]).shapes[cell[1]].kind
    train = kind in ("train", "graph_batch")
    assert (r["memory"]["grad_bytes"] > 0) == train
    assert (r["memory"]["saved_activation_bytes"] > 0) == train


#: rank 0's (q heads, kv heads) in the split cells, worked out by hand from
#: the layout (model rank r computes heads ceil(r h / m) to ceil((r + 1) h /
#: m) - 1 and the kv heads h / kh of them share): 8 heads on 2 kv heads on 4
#: model ranks, 2 q heads of kv head 0; llama3.2-3b's 24 heads on 8 kv heads
#: on 16, heads 0 and 1 (1.5 a rank) of kv head 0 (3 q heads a kv head)
RANK0_HEADS = {(8, 2, 4): ((0, 2), (0, 1)), (24, 8, 16): ((0, 2), (0, 1))}

#: reduce-scatters that a layer's recompute leaves out: the FFN's after
#: ``w_down``, past the layer's last saved tensor, where
#: ``torch.utils.checkpoint`` stops recomputing
#: (``test_checkpoint_recompute_stops_at_the_last_saved_tensor``)
RECOMPUTE_SKIPS = 1


def _split_expectation(cfg, mesh: AbstractMesh, batch: int, seq: int) -> dict:
    """Rank 0's collectives and memory parts in the LM's split train step
    (``sharding.lm_split``; dense layers, one micro-batch, remat on), from
    the reference's specs and the model's shapes alone.

    A weight the rank computes with beyond its shard is gathered in the
    forward (per layer, twice under remat: the forward and the recompute;
    the embedding and head once): first over "data" along the dimension
    the spec shards there (FSDP), then over "model" where the rank's
    columns (its heads: ``RANK0_HEADS``; the embedding and head: all) are
    not its shard.  Its float32 gradient is reduce-scattered back in the
    backward, once.  The residual stream: per layer and pass a gather along
    T before attention and before the FFN (B / dp, T, D) and a
    reduce-scatter after each (B / dp, T / m, D), but the
    ``RECOMPUTE_SKIPS`` last of the recompute's; the backward the
    transposes.  Then each gradient shard
    all-reduced over each axis its leaf is replicated on; the token count,
    the three metrics and the per-leaf squares of the global norm over
    "data" and "model"."""
    dp, m = mesh.shape["data"], mesh.shape["model"]
    elem = 2 if cfg.dtype == "bfloat16" else 4
    params = param_tree(steps.init_model_params(cfg, None, "meta"))
    pspecs = specs.lm_param_specs(cfg, mesh, False)
    hd, L = cfg.head_dim, cfg.n_layers
    (a, b), (ka, kb) = RANK0_HEADS[(cfg.n_heads, cfg.n_kv_heads, m)]
    want = {"layers/wq": (a * hd, b * hd), "layers/wk": (ka * hd, kb * hd),
            "layers/wv": (ka * hd, kb * hd), "layers/wo": (a * hd, b * hd)}
    ag = rs = ar = 0
    n_ag = n_rs = n_ar = 0
    gathered = transient = shards = 0
    for k, p in params.items():
        spec = list(pspecs[k]) + [None] * (p.dim() - len(pspecs[k]))
        layer = k.startswith("layers/")
        whole = p.numel() // (L if layer else 1)
        local = whole // (dp if "data" in spec else 1) // (m if "model" in spec else 1)
        shards += 4 * local * (L if layer else 1)
        passes = 2 * L if layer else 1
        steps_ = []  # (result elements of the gather) in order
        n = local
        if "data" in spec:
            n *= dp
            steps_.append(n)
        if "model" in spec:
            cols = want.get(k)
            aligned = cols is not None and cols == (0, p.shape[spec.index("model")] // m)
            if cols is None and layer:  # FFN columns: the rank's shard
                aligned = True
            if not aligned:
                n *= m
                steps_.append(n)
        for e in steps_:
            ag += passes * e * elem
            n_ag += passes
        # the backward: each gather's float32 reduce-scatter back to its input
        for e in ([local] + steps_)[:len(steps_)]:
            rs += 4 * e * (L if layer else 1)
            n_rs += L if layer else 1
        if layer:
            transient += 4 * n
        if steps_:
            gathered += n * elem
        for axis, size in (("data", dp), ("model", m)):
            if axis not in spec:
                ar += 4 * local * (L if layer else 1)
                n_ar += 1
    bl, t = batch // dp, seq // m
    full, part = bl * seq * cfg.d_model * elem, bl * t * cfg.d_model * elem
    # forward and recompute gathers, the backward of the two scatters; the
    # forward's two scatters, the recompute's but those it skips, the
    # gathers' backward
    ag += L * (2 * 2 * full + 2 * full)
    rs += L * (2 * part + (2 - RECOMPUTE_SKIPS) * part + 2 * part)
    n_ag += L * 6
    n_rs += L * (6 - RECOMPUTE_SKIPS)
    small = 1 + 3 + len(params)  # count, metrics, the norm's per-leaf squares
    ar += 2 * 4 * small
    n_ar += 2 * 3
    return {"bytes": {"all-gather": ag, "reduce-scatter": rs, "all-reduce": ar},
            "count": {"all-gather": n_ag, "reduce-scatter": n_rs, "all-reduce": n_ar},
            "gathered": gathered, "grad": shards + transient, "boundary": L * part}


def test_checkpoint_recompute_stops_at_the_last_saved_tensor():
    """``torch.utils.checkpoint`` (non-reentrant) recomputes a block's
    forward only until the last tensor the backward needs is back: an op
    after it that saves nothing (a layer's last reduce-scatter) runs once,
    the ops before it twice.  ``RECOMPUTE_SKIPS`` rests on this."""
    from torch.utils.checkpoint import checkpoint

    runs = []

    class Mark(torch.autograd.Function):  # saves nothing, as tp.scatter
        @staticmethod
        def forward(ctx, x, tag):
            runs.append(tag)
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g, None

    def block(x):
        return Mark.apply(torch.sin(Mark.apply(x, "first")), "last")

    x = torch.ones(3, requires_grad=True)
    checkpoint(block, x, use_reentrant=False).sum().backward()
    assert runs == ["first", "last", "first"]
    assert runs.count("last") == 2 - RECOMPUTE_SKIPS


def test_collective_bytes_equal_the_specs(fake_world):
    """The dense LM train cell (llama3.2-3b on (16, 16): FSDP, 24 heads and
    8 kv heads on 16 model ranks, so wq / wo and wk / wv gathered over
    "model"): its collectives by op, bytes and counts, equal
    :func:`_split_expectation`'s; the gradient and the gathered weights are
    the split step's (shards plus one layer's transient; embedding, head
    and one layer)."""
    r = fake_world["by_cell"][("llama3.2-3b", "train_4k", False)]
    cfg = get_config("llama3.2-3b")
    want = _split_expectation(cfg, AbstractMesh((16, 16), ("data", "model")), 256, 4096)
    coll = r["collectives"]
    assert coll["bytes_by_op"] == want["bytes"]
    assert coll["count_by_op"] == want["count"]
    assert r["memory"]["grad_bytes"] == want["grad"]
    assert r["memory"]["gathered_weight_bytes"] == want["gathered"]


def _flops_expectation(cfg, b: int, t: int, m: int = 1) -> tuple[float, float]:
    """``(linear FLOPs of the layers, of the logits)`` a rank: every
    column- and row-parallel product over the B x T rows of its data slice
    (the gathered stream) at its share of the heads (``RANK0_HEADS``; every
    head at m = 1) and the FFN; the logits over its T / m tokens."""
    whole = ((0, cfg.n_heads), (0, cfg.n_kv_heads))
    (a, bq), (ka, kb) = whole if m == 1 else RANK0_HEADS[(cfg.n_heads, cfg.n_kv_heads, m)]
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff // m
    hq, hk = bq - a, kb - ka
    per_layer = 2 * (d * hq * hd + 2 * d * hk * hd + hq * hd * d + 3 * d * f)
    return b * t * cfg.n_layers * per_layer, b * (t // m) * 2 * d * cfg.vocab_size


def test_flops_against_reference_hlo(fake_world):
    """Reduced qwen3-8b, 256 x 4,096 tokens, one rank.  Linear FLOPs per
    token L * 2 * (the four projections + the three FFN matrices) + the
    logits; attention per matmul 2 * T^2 * hd a (row, head), over every
    block (masked causal blocks included, on both sides).  Both the port
    (``cfg.remat = "block"``: ``torch.utils.checkpoint``) and the reference
    (``jax.checkpoint``) run a forward (1 linear, 2 attention units), the
    layers' forward again in the backward (its linear but the logits, 2
    attention units) and a backward (2 linear, 5 attention units: dV, dP,
    dQ, dK and the recomputed scores)."""
    cfg = get_config("qwen3-8b").reduced()
    b, t = 256, 4096
    layers_lin, logits = _flops_expectation(cfg, b, t)
    attn_unit = 2 * t * t * cfg.head_dim * cfg.n_heads * b * cfg.n_layers
    expect = 4 * layers_lin + 3 * logits + 9 * attn_unit

    ref_cfg = ref_get_config("qwen3-8b").reduced()
    opt = RefOptConfig(kind="adamw")
    key = jax.random.PRNGKey(0)
    ps = jax.eval_shape(partial(ref_steps.init_model_params, ref_cfg), key)
    st = jax.eval_shape(partial(ref_steps.init_state, opt_cfg=opt), ps)
    hlo = jax.jit(ref_steps.make_lm_train_step(ref_cfg, opt)).lower(
        st, ref_cfg.input_specs("train_4k")).compile().as_text()
    ref_flops = ref_hlo_cost.analyze_hlo(hlo).flops

    assert fake_world["tiny_flops"] == pytest.approx(expect, rel=0.01)
    assert ref_flops == pytest.approx(expect, rel=0.02)


def _small_cfg():
    import dataclasses as dc

    return dc.replace(get_config("qwen3-8b").reduced(), **SPLIT_CELL)


def test_split_cell_flops_include_the_recompute(fake_world):
    """The (2, 4) cell: a rank's 2 of 8 heads, 1 kv head, a quarter of the
    FFN on its 128 rows x 4,096 gathered tokens, the logits of its 1,024;
    4 x the layers' linear FLOPs + 3 x the logits' + 9 attention units
    (remat's recomputed forward included), within 1 %."""
    cfg = _small_cfg()
    b, t, m = 256 // 2, 4096, 4
    layers_lin, logits = _flops_expectation(cfg, b, t, m)
    attn_unit = 2 * t * t * cfg.head_dim * (cfg.n_heads // m) * b * cfg.n_layers
    got = fake_world["split_cell"]["flops"]
    assert got == pytest.approx(4 * layers_lin + 3 * logits + 9 * attn_unit, rel=0.01)
    assert got < 4 * layers_lin + 4 * logits + 9 * attn_unit  # the logits are not recomputed


def test_split_cell_memory_and_collectives_equal_the_specs(fake_world):
    """The (2, 4) cell's parts: the state is the rank's shards (parameters,
    AdamW's float32 m and v, its step), the input the whole batch, the
    gathered weights the embedding and head (vocabulary over "model") and
    one layer's wk and wv (the kv head of the rank's q heads), the gradient
    its float32 shards plus one layer's float32 transient, the saved
    activations hold remat's layer boundaries; the collectives by op equal
    :func:`_split_expectation`'s."""
    cfg = _small_cfg()
    mesh = AbstractMesh((2, 4), ("data", "model"))
    got = fake_world["split_cell"]
    want = _split_expectation(cfg, mesh, 256, 4096)
    params = param_tree(steps.init_model_params(cfg, None, "meta"))
    pspecs = specs.lm_param_specs(cfg, mesh, False)
    local = {k: p.numel() // (4 if "model" in pspecs[k] else 1) for k, p in params.items()}
    assert got["state_bytes"] == sum(4 * n + 2 * 4 * n for n in local.values()) + 4
    assert got["input_bytes"] == 2 * 256 * 4096 * 4
    v, d, hd = cfg.vocab_size, cfg.d_model, cfg.head_dim
    assert got["gathered_bytes"] == want["gathered"] == 4 * (2 * v * d + 2 * d * 2 * hd)
    assert got["grad_bytes"] == want["grad"]
    assert got["saved_bytes"] > want["boundary"] == cfg.n_layers * 128 * 1024 * d * 4
    assert got["bytes_by_op"] == want["bytes"]
    assert got["count_by_op"] == want["count"]


def test_cli_writes_records_and_skips_existing(tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "gin-tu", "--shape",
           "molecule", "--out", str(tmp_path)]
    first = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env,
                           cwd=str(ROOT))
    assert first.returncode == 0, first.stderr[-2000:]
    assert "1/1 cells OK" in first.stdout
    rec = json.loads((tmp_path / "gin-tu__molecule__singlepod.json").read_text())
    assert rec["status"] == "ok"
    again = subprocess.run(cmd + ["--skip-existing"], capture_output=True, text=True,
                           timeout=300, env=env, cwd=str(ROOT))
    assert "skip gin-tu x molecule (cached ok)" in again.stdout
    assert "0/0 cells OK" in again.stdout


def test_failure_is_recorded_with_its_traceback(monkeypatch):
    """A cell that raises is recorded, not raised; the group is gone after."""
    import torch.distributed as dist

    def boom(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "_world", boom)
    rec = dryrun.run_cell("gin-tu", "molecule", False, verbose=False)
    assert rec["status"] == "fail" and rec["error"] == "RuntimeError: planted"
    assert "planted" in rec["traceback"]
    assert not dist.is_initialized()


#: rank 0 (data 0, model 0) of the (2, 4) split serving cells of the reduced
#: qwen3-8b (``SPLIT_CELL``: 2 layers, D 64, 8 heads of 8 on 2 kv heads,
#: d_ff 128, vocabulary 512, float32 weights, bf16 cache), every number
#: worked out by hand from the shapes and the reference's specs:
#:
#: * prefill_32k, tokens (32, 32,768) int32, rows over "data": input 16 x
#:   32,768 x 4 = 2,097,152; out the cache (2, 2, 16, 8,192, 2, 8) bf16 =
#:   16,777,216 (rank 0 holds no last position: no logits).  Per layer the
#:   stream gathered along T before attention and the FFN, (16, 32,768, 64)
#:   f32 = 134,217,728 each, and wk / wv gathered over "model" (the kv head
#:   of rank 0's 2 q heads: (64, 16) f32 = 4,096 each); embed and head
#:   gathered once, (512, 64) f32 = 131,072 each: 10 all-gathers of
#:   537,149,440 bytes.  wo and w_down reduce-scattered along T, (16, 8,192,
#:   64) f32 = 33,554,432 each: 4 of 134,217,728.  One all-to-all a layer,
#:   its result the rank's cache rows of both kv heads, (2, 16, 8,192, 2, 8)
#:   bf16 = 8,388,608: 2 of 16,777,216;
#: * decode_32k, tokens and positions (128,) over "data" (256 bytes each),
#:   the cache (2, 2, 64, 8,192, 2, 8) bf16 = 67,108,864; out the logits (64,
#:   512) f32 = 131,072.  Per layer wk, wv (4,096 each), q (64, 1, 8, 8) f32
#:   = 16,384, k and v (64, 1, 4, 8) f32 = 8,192 each (one kv head a rank,
#:   gathered from all four): 5 all-gathers of 40,960, plus embed and head:
#:   12 of 344,064.  All-reduces over "model" a layer: the combine's max
#:   (64, 8) = 2,048 and sum (64, 8, 9) = 18,432, wo's and w_down's partial
#:   sums (64, 1, 64) = 16,384 each: 8 of 106,496;
#: * long_500k, one row, the cache's T over ("data", "model"): (2, 2, 1,
#:   65,536, 2, 8) bf16 = 8,388,608, plus 4 + 4 bytes of token and position;
#:   out (1, 512) f32 = 2,048.  All-gathers as decode_32k's at one row: 2 x
#:   (4,096 + 4,096 + 256 + 128 + 128) + 262,144 = 279,552 in 12; the
#:   combine over "data" and then "model" (max 32 and sum 288 bytes each)
#:   and the two partial sums (256 each): 12 all-reduces of 2,304.
#:
#: The state is rank 0's shards, 136,576 bytes; the gathered weights held at
#: once embed, head and one layer's wk and wv, 270,336.  None of them is a
#: whole cache: the cache never moves.
SERVE_CELLS = {
    "prefill_32k": {"input_bytes": 2_097_152, "output_bytes": 16_777_216,
                    "bytes_by_op": {"all-gather": 537_149_440, "reduce-scatter": 134_217_728,
                                    "all-to-all": 16_777_216},
                    "count_by_op": {"all-gather": 10, "reduce-scatter": 4, "all-to-all": 2}},
    "decode_32k": {"input_bytes": 67_109_376, "output_bytes": 131_072,
                   "bytes_by_op": {"all-gather": 344_064, "all-reduce": 106_496},
                   "count_by_op": {"all-gather": 12, "all-reduce": 8}},
    "long_500k": {"input_bytes": 8_388_616, "output_bytes": 2_048,
                  "bytes_by_op": {"all-gather": 279_552, "all-reduce": 2_304},
                  "count_by_op": {"all-gather": 12, "all-reduce": 12}},
}


@pytest.mark.parametrize("shape", list(SERVE_CELLS))
def test_split_serve_cells_equal_the_hand_counts(fake_world, shape):
    """The LM prefill and decode cells run the split serving steps: inputs,
    outputs and collectives by op as worked out above (``SERVE_CELLS``),
    the rank's shards as state, per-layer gathered weights, no gradient and
    nothing saved."""
    got = fake_world["serve_cells"][shape]
    want = SERVE_CELLS[shape]
    for key, value in want.items():
        assert got[key] == value, (key, got[key])
    assert got["state_bytes"] == 136_576
    assert got["gathered_bytes"] == 270_336
    assert got["grad_bytes"] == got["saved_bytes"] == 0
