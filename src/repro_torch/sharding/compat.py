"""Meshes, partition specs and placements on ``torch.distributed``
(``repro.sharding.compat`` and the ``jax.sharding`` types it stands for).

SPMD by process: each rank is one process with one device —
``cuda:{LOCAL_RANK}`` over NCCL, or, when the caller asks for
``device_type="cpu"`` (the tests), the CPU over gloo.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimensions carry the
reference's axis names (``"data"``, ``"model"``, ``"pod"``).

* :class:`AxisType` — the reference's stand-in enum; :func:`make_mesh`
  takes it (and ``devices=``) only so the reference's call sites read the
  same: no caller of the port sets them.
* :func:`make_mesh` — ``init_device_mesh`` over the current world; it
  starts the default process group from ``RANK`` / ``WORLD_SIZE`` /
  ``MASTER_ADDR`` / ``MASTER_PORT`` when none exists, and never falls back
  to another backend or device.
* :class:`P` — a partition spec: one entry per tensor dimension, each
  ``None``, a mesh axis name or a tuple of names (the first the outermost),
  as ``jax.sharding.PartitionSpec``.
* :class:`NamedSharding` — ``(mesh, spec)``; :meth:`NamedSharding.placements`
  gives the DTensor placements: ``Shard(dim)`` on each mesh dimension the
  spec names for tensor dimension ``dim``, ``Replicate()`` on the others.
* :class:`AbstractMesh` — axis sizes and names with no process group, which
  is all the spec rules read (``mesh_shape``).
* :func:`local_shard`, :func:`place`, :func:`flatten_specs` — a rank's own
  slice of a tensor every rank holds, a state's leaves placed as DTensors
  by a tree of shardings, and such a tree flattened to ``{path: leaf}``
  (the checkpointer's ``reshard`` and the sharded train step use them);
  :func:`to_local` — a DTensor's local shard (another tensor as it is);
  :func:`axes_index` — the rank's slice among those a set of mesh axes cuts
  a dimension into.

There is no ``shard_map``: a rank's own code is its local function, and
data moves between ranks through explicit collectives (``all_gather``,
``all_reduce`` over one mesh dimension's group, ``DTensor.full_tensor``).
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..train.optimizer import param_tree


class AxisType(enum.Enum):
    """The reference's axis kinds; :func:`make_mesh` accepts and ignores them."""

    Auto = "auto"
    Explicit = "explicit"
    Manual = "manual"


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"), "model")``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, without devices or a process group."""

    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} axis sizes for names "
                             f"{self.axis_names!r}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    raise TypeError(f"mesh={mesh!r} is neither a torch DeviceMesh nor an AbstractMesh")


def require_device_mesh(mesh, what: str) -> None:
    """Refuse, by name, a ``mesh`` that is not a ``DeviceMesh`` (a jax mesh,
    a shape, an :class:`AbstractMesh`)."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{what}: mesh={mesh!r} is not a "
                        f"torch.distributed.device_mesh.DeviceMesh; build one with "
                        f"repro_torch.sharding.compat.make_mesh")


def _local_cuda_device() -> torch.device:
    rank = int(os.environ.get("RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                   rank % torch.cuda.device_count())))


def _init_default_group(device_type: str) -> None:
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"no default process group, and {missing} are not set: start "
                           f"the ranks with torchrun, or call "
                           f"torch.distributed.init_process_group first")
    kw = {}
    if device_type == "cuda":  # NCCL bound to this rank's card from the start
        kw["device_id"] = _local_cuda_device()
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kw)


def make_mesh(axis_shapes, axis_names, *, axis_types=None, devices=None,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over the
    whole current world (``axis_types`` is accepted for the reference's call
    sites and ignored).  ``device_type="cuda"`` without a GPU raises, as
    does a shape whose product is not the world size."""
    del axis_types
    axis_shapes, axis_names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if devices is not None:
        raise NotImplementedError("devices=: a rank's device is cuda:{LOCAL_RANK}; pick "
                                  "the ranks when starting the processes")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type={device_type!r}; use 'cuda' or 'cpu'")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda') but torch.cuda.is_available() is "
                           "False; pass device_type='cpu' to run the ranks on the CPU")
    if not dist.is_initialized():
        _init_default_group(device_type)
    world = dist.get_world_size()
    size = 1
    for s in axis_shapes:
        size *= s
    if size != world:
        raise ValueError(f"mesh shape {dict(zip(axis_names, axis_shapes))} holds {size} "
                         f"ranks but the world has {world}")
    if device_type == "cuda":
        torch.cuda.set_device(_local_cuda_device())
    return init_device_mesh(device_type, axis_shapes, mesh_dim_names=axis_names)


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def to_local(t):
    """``t``'s local shard if it is a DTensor, else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def axes_index(mesh, axes) -> tuple[list, int, int]:
    """``(groups, n, index)`` of the mesh axes ``axes`` (major first): their
    process groups, the number of slices they cut a dimension into, and the
    rank's slice among them in a DTensor's order (the major axis first).
    No axes: ``([], 1, 0)``."""
    names = list(mesh.mesh_dim_names)
    groups, n, index = [], 1, 0
    for a in axes:
        size = mesh.size(names.index(a))
        groups.append(mesh.get_group(a))
        n *= size
        index = index * size + mesh.get_local_rank(a)
    return groups, n, index


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: P

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dimension."""
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate() for _ in names]
        for dim, entry in enumerate(self.spec):
            axes = _axes_of(entry)
            order = [names.index(a) if a in names else -1 for a in axes]
            if -1 in order:
                raise ValueError(f"spec {self.spec!r} names an axis not in the mesh {names}")
            if order != sorted(order):
                raise ValueError(f"spec {self.spec!r}: axes {axes} of one dimension must come "
                                 f"in the mesh's order {names}")
            for m in order:
                if not isinstance(out[m], Replicate):
                    raise ValueError(f"spec {self.spec!r} shards two dimensions over "
                                     f"{names[m]!r}")
                out[m] = Shard(dim)
        return tuple(out)


def local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` (which every rank holds) under
    ``placements``, sliced locally: no collective.  A ``meta`` tensor (the
    dry-run's) stays on ``meta``."""
    if not full.is_meta:
        full = full.to(mesh_device(mesh))
    return distribute_tensor(full, mesh, placements, src_data_rank=None).to_local()


def _place(leaf, sharding: NamedSharding):
    """A leaf as a DTensor with ``sharding``'s placements, in a storage of
    its own (the in-place updates of a sharded step never reach ``leaf``)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
    placements = sharding.placements()
    local = local_shard(t, sharding.mesh, placements).clone()
    return DTensor.from_local(local, sharding.mesh, placements, run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())


def place(state, sharding_tree):
    """``state`` with every leaf placed by the :class:`NamedSharding` at its
    path in ``sharding_tree`` (a model becomes ``{path: DTensor}``, keyed by
    its ``param_tree`` paths)."""
    shardings = flatten_specs(sharding_tree)

    def walk(tree, prefix):
        if isinstance(tree, nn.Module):
            return {k: walk(v, f"{prefix}{k}/") for k, v in param_tree(tree).items()}
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{prefix}{i}/") for i, v in enumerate(tree))
        key = prefix[:-1]
        if key not in shardings:
            raise KeyError(f"no sharding for leaf {key}")
        return _place(tree, shardings[key])

    return walk(state, "")


def flatten_specs(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of a spec or sharding tree (a :class:`P` or a
    :class:`NamedSharding` is a leaf, not a tuple to walk)."""
    if isinstance(tree, (P, NamedSharding)):
        return {prefix[:-1]: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_specs(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_specs(v, f"{prefix}{i}/"))
        return out
    raise TypeError(f"{prefix[:-1] or 'spec tree'}: {tree!r} is neither a spec nor a sharding")
