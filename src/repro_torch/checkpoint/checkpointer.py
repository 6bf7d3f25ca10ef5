"""Fault-tolerant checkpointing in the reference's on-disk format
(``repro.checkpoint.checkpointer``), so that either package opens the
other's checkpoints:

* ``<dir>/step_{N:010d}/`` holds one ``.npy`` file a leaf, named by its
  pytree path with ``/`` -> ``__`` (``params__layers__wq.npy``), and
  ``manifest.json``: ``{"step": N, "leaves": {path: {"file", "crc32",
  "shape", "dtype"}}}`` with the leaves in the reference's order;
* atomic: written to ``step_N.tmp/``, then ``os.replace``\\ d;
* async: the device -> host copy on the caller's thread, the files on a
  writer thread; its error surfaces on the next ``wait()`` (or ``save``);
* integrity: ``restore`` checks every file's crc32 before it touches the
  state; ``restore_latest_valid`` walks back past a corrupt step;
* retention: the newest ``keep`` steps stay, older ones go after a save.

Leaves are a train state's tensors under the reference's paths:
``{"params": model, "opt": {...}, "step": ...}`` flattens to
``params/layers/wq``, ``opt/m/layers/wq``, ``opt/step``, ``step`` (a model's
``layers.wq`` is named ``layers/wq``, :func:`~repro_torch.train.optimizer.
param_tree`); a 0-d tensor saves with shape ``[]``.

bfloat16 leaves are written as the reference writes them (it saves
``ml_dtypes.bfloat16`` arrays: the header's ``descr`` is ``'<V2'``, the
payload the raw two-byte values, the manifest's dtype ``"bfloat16"``) and
restored from the manifest's dtype to ``torch.bfloat16``, bit for bit.  The
reference's own ``restore`` hands such a leaf back as two-byte voids (a
fault of the reference, ROADMAP Queue C).

``restore`` writes the checkpoint's values into the tensors of
``state_like`` (a model's parameters included) in place, on their devices
and in their dtypes, and returns the state; a NumPy or Python leaf of
``state_like`` comes back as a new NumPy array.

On a mesh (``repro_torch.sharding``): :func:`reshard` places a state as
DTensors, each leaf with its spec's placements, every rank slicing its own
shard of the whole leaf it holds (the elastic path: restore unsharded, then
reshard onto the new mesh).  ``restore(..., sharding_tree=)`` does the same
after the restore, and a DTensor leaf of ``state_like`` takes its own shard
of the file.  ``save`` of a sharded state writes the same format: every
rank joins the gather of each leaf on the calling thread (so the async
writer never runs a collective), rank 0 alone writes, and a barrier
follows the write (for an async save, in the next ``wait()``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from ..sharding.compat import (NamedSharding, flatten_specs, local_shard, place,
                               require_device_mesh)
from ..train.optimizer import param_tree, sort_paths

BF16_DESCR = "<V2"


def _leaves(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of a state (dicts, lists, models, tensors, arrays)."""
    if isinstance(tree, nn.Module):
        return {prefix + k: v for k, v in param_tree(tree).items()}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def flatten(state) -> dict:
    """``{path: leaf}`` in the reference's leaf order."""
    return sort_paths(_leaves(state))


def to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a C-contiguous NumPy array and its manifest dtype name (the
    reference's: NumPy's name, ``bfloat16`` for bf16, whose raw 16-bit
    values come back as int16).  The array is always a copy: the writer
    thread reads it while the next step updates the state in place, and
    ``.cpu()`` of a host tensor (or ``np.asarray`` of an array) would share
    the live memory."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.clone(memory_format=torch.contiguous_format) if t.device.type == "cpu" \
            else t.cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf, order="C")  # (np.ascontiguousarray would make a 0-d leaf 1-d)
    return a, str(a.dtype)


def save_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, but a bf16 leaf gets the reference's header
    (``'descr': '<V2'``) over its raw two-byte values."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def load_npy(path: str, dtype: str) -> np.ndarray:
    """A leaf file as NumPy; a ``bfloat16`` leaf as its raw values (int16)."""
    if dtype != "bfloat16":
        return np.load(path)
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, fortran, descr = read(f)
        if np.dtype(descr).itemsize != 2 or fortran:
            raise IOError(f"{path}: a bfloat16 leaf with header {descr!r}, fortran={fortran}")
        return np.frombuffer(f.read(), dtype="<i2").reshape(shape).copy()


def _put(like, arr: np.ndarray, dtype: str):
    """The restored value of one leaf: written into ``like`` when it is a
    tensor (its device and dtype kept), else a new NumPy array."""
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    if isinstance(like, DTensor):
        if tuple(like.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} for a tensor of "
                             f"shape {tuple(like.shape)}")
        with torch.no_grad():
            like.to_local().copy_(local_shard(t.to(like.dtype), like.device_mesh,
                                              like.placements))
        return like
    if isinstance(like, torch.Tensor):
        if tuple(like.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} for a tensor of "
                             f"shape {tuple(like.shape)}")
        with torch.no_grad():
            like.copy_(t.to(like.dtype))
        return like
    return arr


def _rebuild(tree, arrays: dict, prefix: str = ""):
    if isinstance(tree, nn.Module):
        for k, p in param_tree(tree).items():
            _put(p, *arrays[prefix + k])
        return tree
    if isinstance(tree, dict):
        return {k: _rebuild(v, arrays, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, arrays, f"{prefix}{i}/") for i, v in enumerate(tree))
    return _put(tree, *arrays[prefix[:-1]])


def _sharded(flat: dict) -> bool:
    return any(isinstance(v, DTensor) for v in flat.values())


@dataclass
class Checkpointer:
    directory: str
    keep: int = 3
    async_save: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._barrier_pending = False

    # ------------------------------------------------------------------
    def save(self, step: int, state) -> None:
        flat = flatten(state)
        distributed = _sharded(flat) and dist.is_initialized()
        writer = not distributed or dist.get_rank() == 0  # rank 0 alone writes
        host = []
        for k, v in flat.items():
            if isinstance(v, DTensor):  # every rank joins each gather, on this thread
                v = v.full_tensor()
            if writer:
                host.append((k, *to_host(v)))
        self.wait()  # one in-flight save at a time
        if writer and self.async_save:
            self._thread = threading.Thread(target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        elif writer:
            self._write(step, host)
        self._barrier_pending = distributed
        if not self.async_save:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier_pending:
            self._barrier_pending = False
            dist.barrier()  # the files are on disk before any rank goes on
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host: list) -> None:
        try:
            final = os.path.join(self.directory, f"step_{step:010d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": {}}
            for key, arr, dtype in host:
                fname = key.replace("/", "__") + ".npy"
                path = os.path.join(tmp, fname)
                save_npy(path, arr, dtype)
                with open(path, "rb") as f:
                    crc = zlib.crc32(f.read())
                manifest["leaves"][key] = {"file": fname, "crc32": crc,
                                           "shape": list(arr.shape), "dtype": dtype}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
        except Exception as e:  # noqa: BLE001 — surfaced on the next wait()
            self._error = e

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: int | None = None, sharding_tree=None):
        """``(state, step)``: every leaf of ``state_like`` from the checkpoint
        at ``step`` (default the newest), all checksums verified before any
        tensor is written; a corrupt file or a missing leaf raises.  With
        ``sharding_tree`` (a tree of :class:`NamedSharding` in the state's
        layout) the restored state is then placed on the mesh (:func:`place`)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints found")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = {}
        for key, rec in manifest["leaves"].items():
            path = os.path.join(d, rec["file"])
            with open(path, "rb") as f:
                data = f.read()
            if zlib.crc32(data) != rec["crc32"]:
                raise IOError(f"checksum mismatch in {path}")
            arrays[key] = (load_npy(path, rec["dtype"]), rec["dtype"])
        missing = [k for k in flatten(state_like) if k not in arrays]
        if missing:
            raise KeyError(f"checkpoint missing leaf {missing[0]}")
        state = _rebuild(state_like, arrays)
        if sharding_tree is not None:
            state = place(state, sharding_tree)
        return state, step

    def restore_latest_valid(self, state_like, sharding_tree=None):
        """Walk the checkpoints newest first until one verifies (a
        half-written or bit-rotted snapshot is skipped)."""
        last_err: Exception | None = None
        for step in reversed(self.all_steps()):
            try:
                return self.restore(state_like, step, sharding_tree)
            except Exception as e:  # noqa: BLE001
                last_err = e
        raise FileNotFoundError(f"no valid checkpoint ({last_err})")


def reshard(state, mesh, spec_tree):
    """Re-place a state onto ``mesh`` by ``spec_tree`` (specs in the
    state's layout, :mod:`repro_torch.sharding.specs`) — the elastic path:
    restore unsharded, then reshard to the new topology.  A DTensor leaf is
    gathered first; every rank slices its own shard, and the state passed
    in is left as it is."""
    require_device_mesh(mesh, "reshard")
    shardings = {k: NamedSharding(mesh, v) for k, v in flatten_specs(spec_tree).items()}
    return place(state, shardings)
