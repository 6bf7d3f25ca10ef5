"""The port's checkpointer on the CPU, and checkpoints across the two
packages.

The reference's scenarios (tests/test_train.py:54-91) on the port: round
trip, retention, a corrupt step skipped, async errors surfaced.  Then the
shared format: a reference checkpoint of a float32 train state opens in the
port and a port checkpoint opens in the reference, each with ``.npy`` files
byte-identical to the other package's for the same state and the same
manifest; a bf16 state round-trips in the port bit for bit, in files the
reference writes the same way; and the reference's own bf16 restore hands
back two-byte voids (a fault of the reference, ROADMAP Queue C).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.models import steps as ref_steps
from repro.models import transformer as ref_transformer
from repro.train import optimizer as ref_opt
from repro_torch import configs
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.checkpoint.checkpointer import Checkpointer, flatten, reshard
from repro_torch.models import recsys, steps, transformer
from repro_torch.train import optimizer as opt

KEY = jax.random.PRNGKey(0)


def _files(d) -> dict:
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def _manifest(d) -> dict:
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


# ----------------------------------------------------------------------
# the reference's scenarios
# ----------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "step": torch.tensor(7)}
    ck.save(7, state)
    like = {"params": {"w": torch.zeros(2, 3)}, "step": torch.tensor(0)}
    restored, step = ck.restore(like)
    assert step == 7 and int(restored["step"]) == 7
    assert torch.equal(restored["params"]["w"], torch.arange(6.0).reshape(2, 3))
    assert restored["params"]["w"] is like["params"]["w"]  # written in place


def test_checkpoint_retention_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (10, 20, 30):
        ck.save(s, {"x": torch.tensor(1.0)})
    assert ck.all_steps() == [20, 30]
    assert ck.latest_step() == 30


def test_corrupt_checkpoint_skipped(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5, async_save=False)
    ck.save(1, {"x": torch.tensor(1.0)})
    ck.save(2, {"x": torch.tensor(2.0)})
    d = os.path.join(str(tmp_path), "step_0000000002")
    fname = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, fname), "wb") as f:
        f.write(b"garbage")
    like = {"x": torch.tensor(-1.0)}
    with pytest.raises(IOError, match="checksum"):
        ck.restore(like, 2)
    assert float(like["x"]) == -1.0  # nothing written before the checks
    restored, step = ck.restore_latest_valid(like)
    assert step == 1 and float(restored["x"]) == 1.0


def test_async_save_surfaces_errors(tmp_path):
    ck = Checkpointer(str(tmp_path / "sub"), keep=1, async_save=True)
    ck.save(1, {"x": torch.tensor(1.0)})
    ck.wait()
    assert ck.latest_step() == 1
    # a writer that fails (a file where its scratch directory goes): the
    # error comes back on the next wait(), once, and the step is not listed
    (tmp_path / "sub" / "step_0000000002.tmp").write_text("in the way")
    ck.save(2, {"x": torch.tensor(2.0)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()
    assert ck.all_steps() == [1]


def test_async_save_is_a_snapshot(tmp_path, monkeypatch):
    """An async save holds the values of the moment it was called: the
    train step that follows updates the CPU state in place while the writer
    thread runs, and the files must not pick that up.  The writer is held
    until the state has changed, so a save that shares memory with the live
    tensors fails every time."""
    import threading

    go = threading.Event()
    write = ckpt_mod.save_npy

    def held(*a):
        go.wait(10)
        write(*a)

    monkeypatch.setattr(ckpt_mod, "save_npy", held)
    rng = np.random.default_rng(0)
    state = {"params": {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)),
                        "e": torch.from_numpy(rng.standard_normal(5)).to(torch.bfloat16)},
             "opt": {"m": np.zeros(3, np.float32)},
             "step": torch.tensor(7, dtype=torch.int32)}
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else v.copy())
            for k, v in flatten(state).items()}
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(7, state)
    with torch.no_grad():
        state["params"]["w"].add_(1.0)
        state["params"]["e"].mul_(2.0)
        state["step"].fill_(8)
    state["opt"]["m"] += 1.0
    go.set()
    ck.wait()
    like = {"params": {"w": torch.zeros(4, 3), "e": torch.zeros(5, dtype=torch.bfloat16)},
            "opt": {"m": np.zeros(3, np.float32)}, "step": torch.tensor(0, dtype=torch.int32)}
    got, step = ck.restore(like)
    assert step == 7
    for k, v in flatten(got).items():
        assert np.array_equal(np.asarray(v.float() if isinstance(v, torch.Tensor) else v),
                              np.asarray(want[k].float() if isinstance(want[k], torch.Tensor)
                                         else want[k])), k


def test_missing_leaf_and_mesh_refused(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, {"x": torch.tensor(1.0)})
    with pytest.raises(KeyError, match="y"):
        ck.restore({"x": torch.tensor(0.0), "y": torch.tensor(0.0)})
    # a sharding tree of something else, a mesh that is not a DeviceMesh: refused
    # by name (the mesh path runs in tests/test_torch_distributed.py)
    with pytest.raises(TypeError, match="neither a spec nor a sharding"):
        ck.restore({"x": torch.tensor(0.0)}, sharding_tree={"x": "spec"})
    with pytest.raises(TypeError, match="DeviceMesh"):
        reshard({"x": torch.tensor(0.0)}, "mesh", {"x": None})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"x": torch.tensor(0.0)})


# ----------------------------------------------------------------------
# across the packages
# ----------------------------------------------------------------------
def _states(name: str, kind: str = "adamw"):
    """One train state (params from the reference's init, fresh optimiser
    state) in both packages."""
    rc, pc = ref_configs.get_config(name).reduced(), configs.get_config(name).reduced()
    rp = ref_steps.init_model_params(rc, KEY)
    np_params = jax.tree.map(np.asarray, rp)
    if name in ("qwen3-8b", "moonshot-v1-16b-a3b"):
        model = transformer.params_from_reference(pc, np_params, "cpu")
    else:
        model = recsys.recsys_params_from_reference(pc, np_params, "cpu")
    ro, po = ref_opt.OptConfig(kind=kind), opt.OptConfig(kind=kind)
    return ref_steps.init_state(rp, ro), steps.init_state(model, po)


@pytest.mark.parametrize("name,kind", [("qwen3-8b", "adamw"), ("sasrec", "adafactor"),
                                       ("xdeepfm", "adamw")])
def test_float32_checkpoints_are_the_same_files(tmp_path, name, kind):
    """The same float32 state saved by each package: the same file names,
    byte for byte, and the same manifest (keys in the same order)."""
    rstate, pstate = _states(name, kind)
    RefCheckpointer(str(tmp_path / "ref"), async_save=False).save(3, rstate)
    Checkpointer(str(tmp_path / "port"), async_save=False).save(3, pstate)
    rd, pd = tmp_path / "ref" / "step_0000000003", tmp_path / "port" / "step_0000000003"
    assert _files(rd) == _files(pd)
    assert list(_manifest(rd)["leaves"]) == list(flatten(pstate))
    assert {"params/" + k for k in opt.param_tree(pstate["params"])} <= set(_manifest(pd)["leaves"])
    assert _manifest(pd)["leaves"]["step"]["shape"] == []


def test_reference_checkpoint_trains_on_in_the_port(tmp_path):
    """A reference state after two train steps, saved by the reference,
    restored by the port into a fresh state: every leaf equal, and the
    port's train step goes on from it with the reference's next loss."""
    from repro.data import pipelines as ref_pipelines

    rc, pc = ref_configs.get_config("fm").reduced(), configs.get_config("fm").reduced()
    ro, po = ref_opt.OptConfig(lr=1e-2, warmup_steps=1), opt.OptConfig(lr=1e-2, warmup_steps=1)
    rstate = ref_steps.init_state(ref_steps.init_model_params(rc, KEY), ro)
    rstep = jax.jit(ref_steps.make_recsys_train_step(rc, ro))
    it = ref_pipelines.recsys_batches(rc, 32, seed=2)
    for _ in range(2):
        rstate, _ = rstep(rstate, {k: jnp.asarray(v) for k, v in next(it).items()})
    RefCheckpointer(str(tmp_path), async_save=False).save(2, rstate)
    fresh = steps.init_state(steps.init_model_params(pc, torch.Generator().manual_seed(9), "cpu"),
                             po)
    pstate, step = Checkpointer(str(tmp_path)).restore(fresh)
    assert step == 2 and int(pstate["step"]) == 2 and int(pstate["opt"]["step"]) == 2
    ref_leaves = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
                  np.asarray(v) for path, v in jax.tree_util.tree_flatten_with_path(rstate)[0]}
    for k, v in flatten(pstate).items():
        assert np.array_equal(v.detach().numpy(), ref_leaves[k]), k
    batch = next(it)
    _, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _, pm = steps.make_recsys_train_step(pc, po)(pstate, batch)
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=1e-6)


def test_port_checkpoint_opens_in_the_reference(tmp_path):
    rstate, pstate = _states("qwen3-8b")
    with torch.no_grad():
        for p in pstate["params"].parameters():
            p.mul_(3.0)
    pstate["step"] = pstate["step"] + 5
    Checkpointer(str(tmp_path), async_save=False).save(5, pstate)
    restored, step = RefCheckpointer(str(tmp_path)).restore(rstate)
    assert step == 5 and int(restored["step"]) == 5
    ref_leaves = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): v
                  for path, v in jax.tree_util.tree_flatten_with_path(restored)[0]}
    for k, v in flatten(pstate).items():
        assert np.array_equal(np.asarray(ref_leaves[k]), v.detach().numpy()), k


def test_bf16_state_round_trips_bit_for_bit(tmp_path):
    """A bf16 LM state (reduced qwen3-8b in bf16, after one train step):
    saved, restored into a zeroed state, every leaf equal bit for bit; the
    bf16 files carry the reference's header and bytes."""
    import dataclasses

    from repro.data import pipelines as ref_pipelines

    cfg = dataclasses.replace(configs.get_config("qwen3-8b").reduced(), dtype="bfloat16")
    model = transformer.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    po = opt.OptConfig(lr=1e-2, warmup_steps=1)
    state = steps.init_state(model, po)
    batch = next(ref_pipelines.lm_batches(cfg, 2, 16, 0))
    state, _ = steps.make_lm_train_step(cfg, po)(state, batch)
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, state)
    ck.wait()
    want = {k: v.detach().clone() for k, v in flatten(state).items()}
    assert want["params/embed"].dtype == torch.bfloat16
    like = steps.init_state(transformer.init_params(cfg, torch.Generator().manual_seed(2), "cpu"),
                            po)
    got, _ = Checkpointer(str(tmp_path)).restore(like)
    for k, v in flatten(got).items():
        assert v.dtype == want[k].dtype, k
        assert torch.equal(v.view(torch.int16) if v.dtype == torch.bfloat16 else v,
                           want[k].view(torch.int16) if v.dtype == torch.bfloat16 else want[k]), k
    d = tmp_path / "step_0000000001"
    man = _manifest(d)["leaves"]
    assert man["params/layers/wq"]["dtype"] == "bfloat16"
    assert man["opt/m/layers/wq"]["dtype"] == "float32" and man["opt/step"]["dtype"] == "int32"
    raw = (d / "params__layers__wq.npy").read_bytes()
    assert b"'descr': '<V2'" in raw
    # the reference writes the same file for the same bf16 values
    ref_dir = tmp_path / "ref"
    wq = jnp.asarray(want["params/layers/wq"].float().numpy(), jnp.bfloat16)
    RefCheckpointer(str(ref_dir), async_save=False).save(1, {"params": {"layers": {"wq": wq}}})
    assert (ref_dir / "step_0000000001" / "params__layers__wq.npy").read_bytes() == raw


def test_reference_restores_bf16_as_void(tmp_path):
    """The reference fault: ``repro``'s Checkpointer saves a bf16 leaf (its
    manifest says "bfloat16") and restores it as two-byte voids; the port
    reads the manifest's dtype and restores bfloat16."""
    st = {"w": jnp.ones((2, 3), jnp.bfloat16), "step": jnp.zeros((), jnp.int32)}
    RefCheckpointer(str(tmp_path), async_save=False).save(1, st)
    r, _ = RefCheckpointer(str(tmp_path)).restore(st)
    assert r["w"].dtype == np.dtype("V2")
    assert _manifest(tmp_path / "step_0000000001")["leaves"]["w"]["dtype"] == "bfloat16"
    like = {"w": torch.zeros((2, 3), dtype=torch.bfloat16), "step": torch.tensor(0, dtype=torch.int32)}
    got, _ = Checkpointer(str(tmp_path)).restore(like)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], torch.ones(2, 3,
                                                                              dtype=torch.bfloat16))


def test_bf16_file_with_a_foreign_header_is_refused(tmp_path):
    path = str(tmp_path / "x.npy")
    np.save(path, np.zeros((2, 2), np.float32))
    with pytest.raises(IOError, match="bfloat16"):
        ckpt_mod.load_npy(path, "bfloat16")
