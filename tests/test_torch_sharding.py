"""The mesh tier in one process: the partition-spec rules against the
reference's, the models' shapes on ``meta`` against ``jax.eval_shape``, the
compressed all-reduce against the reference under a 1-device
``shard_map``, meshes (a ``fake`` world of 256 / 512 ranks for the
production mesh) and their refusals, and the port's unsharded step against
the reference's single-device step on the reference's own test
configuration.  The same rules and steps across eight ranks:
``tests/test_torch_distributed.py``.

Specs are compared tuple for tuple (no tolerance); ``psum_int8`` and
``psum_topk`` bit for bit (the same float32 operations in the same order;
the integer sum is exact); a train step's loss within 1e-5 relative, as
``tests/test_torch_train.py`` holds whole steps.
"""

import json
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec

from repro import configs as ref_configs
from repro.models import steps as ref_steps
from repro.sharding import specs as ref_specs
from repro.sharding.compat import AxisType as RefAxisType
from repro.sharding.compat import make_mesh as ref_make_mesh
from repro.sharding.compat import shard_map
from repro.train import grad_compression as ref_gc
from repro.train import optimizer as ref_opt
from repro_torch import configs
from repro_torch.models import steps
from repro_torch.sharding import compat, specs
from repro_torch.train import grad_compression as gc
from repro_torch.train import optimizer as opt

ROOT = Path(__file__).resolve().parent.parent
KEY = jax.random.PRNGKey(0)
MESHES = {"4x2": ((4, 2), ("data", "model"), False),
          "16x16": ((16, 16), ("data", "model"), False),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"), True)}


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _norm(entry):
    return tuple(entry) if isinstance(entry, (tuple, list)) else entry


def _ref_specs(tree) -> dict:
    """``{path: spec as a tuple}`` of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {_path(p): tuple(_norm(e) for e in v) for p, v in leaves}


def _port_specs(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, compat.P):
            out[prefix + k] = tuple(_norm(e) for e in v)
        else:
            out.update(_port_specs(v, f"{prefix}{k}/"))
    return out


def _ref_params_shape(cfg, shape_name=None):
    return jax.eval_shape(lambda k: ref_steps.init_model_params(cfg, k, shape_name), KEY)


def _shape_name(cfg):
    """The GNN's parameter widths come from a shape; every other family's not."""
    return "molecule" if cfg.family == "gnn" else None


@pytest.mark.parametrize("name", configs.ASSIGNED_ARCHS)
def test_meta_shapes_equal_reference_eval_shape(name):
    """The port's model on ``meta`` (nothing drawn, nothing allocated: a
    ``torch.Generator`` has no meta device, so none is passed) has the
    reference's parameter paths, shapes and dtypes."""
    rc, pc = ref_configs.get_config(name), configs.get_config(name)
    want = {_path(p): v for p, v in jax.tree_util.tree_flatten_with_path(
        _ref_params_shape(rc, _shape_name(rc)))[0]}
    model = steps.init_model_params(pc, None, "meta", _shape_name(pc))
    got = opt.param_tree(model)
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).replace("torch.", "") == str(want[k].dtype), k


@pytest.mark.parametrize("name", configs.ASSIGNED_ARCHS)
def test_specs_equal_reference(name):
    """``param_specs_for``, ``input_specs_sharding_for`` (every shape),
    ``opt_state_specs`` (AdamW and Adafactor) and ``best_div_axes``, on the
    three meshes: the reference's specs, tuple for tuple."""
    rc, pc = ref_configs.get_config(name), configs.get_config(name)
    sn = _shape_name(rc)
    rshape = _ref_params_shape(rc, sn)
    pshape = steps.init_model_params(pc, None, "meta", sn)
    for mesh_name, (sizes, axes, multi_pod) in MESHES.items():
        rmesh, pmesh = AbstractMesh(sizes, axes), compat.AbstractMesh(sizes, axes)
        rp = ref_specs.param_specs_for(rc, rshape, rmesh, multi_pod)
        pp = specs.param_specs_for(pc, pshape, pmesh, multi_pod)
        assert _port_specs(pp) == _ref_specs(rp), mesh_name
        for shape in rc.shapes:
            want = _ref_specs(ref_specs.input_specs_sharding_for(rc, shape, rmesh, multi_pod))
            got = _port_specs(specs.input_specs_sharding_for(pc, shape, pmesh, multi_pod))
            assert got == want, (mesh_name, shape)
        for kind in ("adamw", "adafactor"):
            rstate = jax.eval_shape(lambda p: ref_opt.opt_init(ref_opt.OptConfig(kind=kind), p),
                                    rshape)
            pstate = opt.opt_init(opt.OptConfig(kind=kind), pshape)
            want = _ref_specs(ref_specs.opt_state_specs(rp, rstate))
            got = _port_specs(specs.opt_state_specs(pp, pstate))
            assert got == want, (mesh_name, kind)
        for n in (1, 2, 7, 16, 48, 128, 256, 4096, 49155, 151936):
            for pref in (axes, axes[::-1], axes[-1], ("data",)):
                assert _norm(specs.best_div_axes(n, pmesh, pref)) == _norm(
                    ref_specs.best_div_axes(n, rmesh, pref)), (mesh_name, n, pref)


def test_index_input_specs_equal_reference():
    rc, pc = ref_configs.get_config("uihrdc"), configs.get_config("uihrdc")
    for sizes, axes, multi_pod in MESHES.values():
        for shape in rc.shapes:
            want = ref_specs.input_specs_sharding_for(rc, shape, AbstractMesh(sizes, axes),
                                                      multi_pod)
            got = specs.input_specs_sharding_for(pc, shape, compat.AbstractMesh(sizes, axes),
                                                 multi_pod)
            assert _port_specs(got) == _ref_specs(want)


def test_placements_follow_the_spec():
    """A spec on a mesh: ``Shard(dim)`` on each mesh dimension it names for
    tensor dimension ``dim`` (the first name the outer one), ``Replicate``
    on the rest; a name out of the mesh's order or used twice raises."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    ns = compat.NamedSharding(Mesh(), compat.P(("pod", "data"), None, "model"))
    assert ns.placements() == (Shard(0), Shard(0), Shard(2))
    assert compat.NamedSharding(Mesh(), compat.P()).placements() == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        compat.NamedSharding(Mesh(), compat.P(("data", "pod"))).placements()
    with pytest.raises(ValueError, match="two dimensions"):
        compat.NamedSharding(Mesh(), compat.P("data", "data")).placements()
    with pytest.raises(ValueError, match="not in the mesh"):
        compat.NamedSharding(Mesh(), compat.P("expert")).placements()


# ----------------------------------------------------------------------
# compressed all-reduce: one rank, against the reference under shard_map
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def world_of_one():
    """A gloo group of one rank in this process (an in-memory store: no
    port), taken down after the module."""
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield dist.group.WORLD
    if started:
        dist.destroy_process_group()


def _ref_mesh():
    return ref_make_mesh((1,), ("d",), axis_types=(RefAxisType.Auto,))


def _ref_psum(fn, x):
    f = partial(shard_map, mesh=_ref_mesh(), in_specs=PartitionSpec(),
                out_specs=PartitionSpec())(fn)
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(37, 5), (256,), (3, 300), (1,)])
def test_psum_int8_bit_equal_reference(world_of_one, shape):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    x.reshape(-1)[::7] *= 100.0  # blocks of very different scales
    want = _ref_psum(lambda v: ref_gc.psum_int8(v, "d"), x)
    got = gc.psum_int8(torch.from_numpy(x), world_of_one).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.max(np.abs(got - x)) <= np.max(np.abs(x)) / 127.0  # quantization only
    q, scale = gc._quantize_int8(torch.from_numpy(x))
    rq, rscale = ref_gc._quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(rq)) and np.array_equal(scale.numpy(),
                                                                        np.asarray(rscale))
    back = gc._dequantize_int8(q, scale, x.shape, torch.float32).numpy()
    assert np.array_equal(back, np.asarray(ref_gc._dequantize_int8(rq, rscale, x.shape,
                                                                   jnp.float32)))


def _tied(n: int, seed: int) -> np.ndarray:
    """Magnitudes drawn from a few values, both signs: ties everywhere."""
    rng = np.random.default_rng(seed)
    return (rng.choice([0.5, 1.0, 2.0, 0.0], size=n) * rng.choice([-1.0, 1.0], size=n)
            ).astype(np.float32)


@pytest.mark.parametrize("k_frac", [0.01, 0.1, 0.37, 1.0])
def test_topk_sparsify_ties_and_psum_topk(world_of_one, k_frac):
    """Ties go to the lowest index, as ``jax.lax.top_k`` orders them: the
    indices, the kept values and the residual equal the reference's; the
    summed gradient and the residual of ``psum_topk`` too (with error
    feedback), and at k = 100 % the sum is the input."""
    for n, seed in ((300, 1), (1000, 2), (7, 3)):
        x = _tied(n, seed).reshape(-1, 1) if n % 2 else _tied(n, seed)
        kept, idx, resid = gc.topk_sparsify(torch.from_numpy(x), k_frac)
        rk, ri, rr = ref_gc.topk_sparsify(jnp.asarray(x), k_frac)
        assert np.array_equal(idx.numpy(), np.asarray(ri))
        assert np.array_equal(kept.numpy(), np.asarray(rk))
        assert np.array_equal(resid.numpy(), np.asarray(rr))
        ef = np.random.default_rng(seed).normal(size=x.shape).astype(np.float32) * 0.01
        total, res = gc.psum_topk(torch.from_numpy(x), world_of_one, k_frac,
                                  error_feedback=torch.from_numpy(ef))
        rt, rres = shard_map(lambda v, e: ref_gc.psum_topk(v, "d", k_frac, e), mesh=_ref_mesh(),
                             in_specs=(PartitionSpec(), PartitionSpec()),
                             out_specs=(PartitionSpec(), PartitionSpec()))(jnp.asarray(x),
                                                                           jnp.asarray(ef))
        assert np.array_equal(total.numpy(), np.asarray(rt))
        assert np.array_equal(res.numpy(), np.asarray(rres))
        if k_frac == 1.0:
            assert np.array_equal(total.numpy(), x + ef)


def test_group_may_be_a_mesh_axis(world_of_one):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(9, 31)).astype(np.float32))
    assert torch.equal(gc.psum_int8(x, (mesh, "data")), gc.psum_int8(x, world_of_one))


# ----------------------------------------------------------------------
# meshes and their refusals
# ----------------------------------------------------------------------
def test_make_mesh_cuda_without_a_gpu_raises(monkeypatch):
    """No hidden fallback: a CUDA mesh on a machine without a GPU raises
    (``is_available`` is forced False, as it is here) instead of turning to
    gloo or the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        compat.make_mesh((1, 1), ("data", "model"))
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_local_mesh()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_production_mesh()


MESH_SCRIPT = r"""
import json, os
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_production_mesh, dp_axes
from repro_torch.sharding.compat import make_mesh

out = {}
try:
    make_mesh((1,), ("data",), device_type="cpu")
except RuntimeError as e:
    out["no_group"] = str(e)
for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())
    m = make_production_mesh(multi_pod=multi, device_type="cpu")
    out[str(world)] = [list(m.mesh_dim_names), list(m.shape), list(dp_axes(multi))]
    for shape in ((16, 16), (4, 4)):
        try:
            make_mesh(shape, ("data", "model"), device_type="cpu")
            out[f"{world}_{shape}"] = "built"
        except ValueError as e:
            out[f"{world}_{shape}"] = str(e)
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_production_mesh_on_a_fake_world():
    """One process stands for 256 / 512 ranks (the ``fake`` backend): the
    production meshes carry the reference's axis names and shapes; a shape
    that does not hold the world is refused by name, as is a mesh with no
    process group and no ``RANK`` / ``WORLD_SIZE`` to start one."""
    proc = subprocess.run([sys.executable, "-c", MESH_SCRIPT], capture_output=True, text=True,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                          timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["256"] == [["data", "model"], [16, 16], ["data"]]
    assert out["512"] == [["pod", "data", "model"], [2, 16, 16], ["pod", "data"]]
    assert out["256_(16, 16)"] == "built"
    assert "holds 16 ranks but the world has 256" in out["256_(4, 4)"]
    assert "holds 256 ranks but the world has 512" in out["512_(16, 16)"]
    assert "RANK" in out["no_group"] and "WORLD_SIZE" in out["no_group"]


# ----------------------------------------------------------------------
# the unsharded step the sharded one is held against, against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_unsharded_step_matches_reference_single_device(kind):
    """The reference's sharded-step test configuration (granite-3-2b
    reduced, warm-up 2 of 100 steps, 8 x 16 tokens from one seed), its
    weights carried across: the port's step gives the reference's
    single-device loss and, from the updated weights, its next loss."""
    from repro_torch.models import transformer

    rc = ref_configs.get_config("granite-3-2b").reduced()
    pc = configs.get_config("granite-3-2b").reduced()
    kw = dict(kind=kind, warmup_steps=2, total_steps=100)
    ro, po = ref_opt.OptConfig(**kw), opt.OptConfig(**kw)
    rparams = ref_steps.init_model_params(rc, KEY)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, rc.vocab_size, (8, 16)).astype(np.int32),
                "targets": rng.integers(0, rc.vocab_size, (8, 16)).astype(np.int32)}
               for _ in range(2)]
    rstep = jax.jit(ref_steps.make_lm_train_step(rc, ro))
    pstep = steps.make_lm_train_step(pc, po)
    rstate = ref_steps.init_state(rparams, ro)
    pstate = steps.init_state(transformer.params_from_reference(
        pc, jax.tree.map(np.asarray, rparams), "cpu"), po)
    for b in batches:
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        pstate, pm = pstep(pstate, b)
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=1e-5)
    assert int(pstate["step"]) == 2
