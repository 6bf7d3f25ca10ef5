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
  and a recsys serve cell, touching no CUDA; the recorded gather and
  all-reduce bytes equal those computed from the specs;
* on a reduced LM and a 1-rank mesh, the port's FLOPs of a train step and
  the reference's ``analyze_hlo`` of its compiled step each equal their
  analytical count: the reference recomputes the forward in the backward
  (remat) and the port does not; neither skips the masked causal blocks.
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
MEMORY_KEYS = {"state_bytes", "input_bytes", "gathered_weight_bytes", "grad_bytes",
               "saved_activation_bytes", "total_per_device_gib"}


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
out["cuda_initialized"] = torch.cuda.is_initialized()
out["jax_loaded"] = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_world():
    proc = subprocess.run([sys.executable, "-c", FAKE_SCRIPT, json.dumps(FAKE_CELLS)],
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


def _gather_bytes(leaf, spec, mesh: AbstractMesh) -> int:
    """Result bytes of the gathers that make ``leaf`` whole from its shard
    under ``spec``: one a sharding mesh axis, the last axis first."""
    shape = list(leaf.shape)
    dims = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
            dims[a] = d
            shape[d] //= mesh.shape[a]
    total = 0
    for a in reversed(mesh.axis_names):
        if a in dims:
            shape[dims[a]] *= mesh.shape[a]
            total += int(np.prod(shape)) * leaf.element_size()
    return total


def test_collective_bytes_equal_the_specs(fake_world):
    """The dense LM train cell: the gathers make every sharded weight whole
    (bytes from the reference's specs), and the all-reduce sums each
    weight's float32 gradient over ``"data"``, plus the loss normaliser and
    the metrics (a few floats)."""
    r = fake_world["by_cell"][("llama3.2-3b", "train_4k", False)]
    cfg = get_config("llama3.2-3b")
    mesh = AbstractMesh((16, 16), ("data", "model"))
    params = param_tree(steps.init_model_params(cfg, None, "meta"))
    pspecs = specs.param_specs_for(cfg, steps.init_model_params(cfg, None, "meta"), mesh, False)
    gather = sum(_gather_bytes(p, pspecs[k], mesh) for k, p in params.items())
    n_gathers = sum(1 for k in params for e in pspecs[k] if e is not None
                    for _ in ((e,) if isinstance(e, str) else e))
    coll = r["collectives"]
    assert coll["bytes_by_op"]["all-gather"] == gather
    assert coll["count_by_op"]["all-gather"] == n_gathers
    grads = 4 * sum(p.numel() for p in params.values())
    assert coll["count_by_op"]["all-reduce"] == len(params) + 2
    assert 8 <= coll["bytes_by_op"]["all-reduce"] - grads <= 64
    assert r["memory"]["grad_bytes"] == grads
    assert r["memory"]["gathered_weight_bytes"] == sum(
        p.numel() * p.element_size() for p in params.values())


def test_flops_against_reference_hlo(fake_world):
    """Reduced qwen3-8b, 256 x 4,096 tokens, one rank.  Linear FLOPs per
    token L * 2 * (the four projections + the three FFN matrices) + the
    logits; attention per matmul 2 * T^2 * hd a (row, head), over every
    block (masked causal blocks included, on both sides).  The port: a
    forward (1 linear, 2 attention units) and a backward (2 linear, 5
    attention units: dV, dP, dQ, dK and the recomputed scores).  The
    reference: the same plus the forward recomputed in the backward (remat),
    its logits excepted."""
    cfg = get_config("qwen3-8b").reduced()
    b, t = 256, 4096
    d, h, kh, hd, f, v, layers = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                  cfg.d_ff, cfg.vocab_size, cfg.n_layers)
    per_layer = 2 * (d * h * hd + 2 * d * kh * hd + h * hd * d + 3 * d * f)
    logits = 2 * d * v
    linear = b * t * (layers * per_layer + logits)
    attn_unit = 2 * t * t * hd * h * b * layers
    port_expect = 3 * linear + 7 * attn_unit
    ref_expect = 4 * linear - b * t * logits + 9 * attn_unit

    ref_cfg = ref_get_config("qwen3-8b").reduced()
    opt = RefOptConfig(kind="adamw")
    key = jax.random.PRNGKey(0)
    ps = jax.eval_shape(partial(ref_steps.init_model_params, ref_cfg), key)
    st = jax.eval_shape(partial(ref_steps.init_state, opt_cfg=opt), ps)
    hlo = jax.jit(ref_steps.make_lm_train_step(ref_cfg, opt)).lower(
        st, ref_cfg.input_specs("train_4k")).compile().as_text()
    ref_flops = ref_hlo_cost.analyze_hlo(hlo).flops

    assert fake_world["tiny_flops"] == pytest.approx(port_expect, rel=0.01)
    assert ref_flops == pytest.approx(ref_expect, rel=0.02)


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
