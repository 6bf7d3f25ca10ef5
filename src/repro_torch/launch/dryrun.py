"""Multi-pod dry-run (``repro.launch.dryrun``): what one rank's step costs on
the production mesh, for every (arch x shape), with nothing allocated and
no device touched.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

Per cell, one process stands for the 256 ranks of the (16, 16) mesh, or the
512 of the (2, 16, 16) mesh with ``--multi-pod``, on the ``fake`` backend of
``torch.distributed`` (its collectives do nothing and wait for no one); the
group is destroyed after the cell.  The state and the inputs are ``meta``
tensors placed as DTensors by the reference's partition specs
(:mod:`repro_torch.sharding.specs`), and the cell runs rank 0's step once:

* LM train cells: :func:`repro_torch.sharding.spmd.make_sharded_train_step`,
  the split step (:mod:`repro_torch.sharding.lm_split`): the rank's rows and
  T / m tokens, its heads, FFN columns and experts, per-layer gathers over
  ``"data"`` (FSDP) and ``"model"``, each layer checkpointed as
  ``cfg.remat`` says (the recompute is counted), gradients reduce-scattered
  into float32 shards, the update of the rank's shards;
* the recsys train cells: the same factory's split step
  (:mod:`repro_torch.sharding.recsys_split`): the rank's rows over the data
  axes, looked up on its shards of the tables row-sharded over
  ``"model"`` (partials summed over ``"model"``), two-tower's items gathered
  over the data axes, gradients summed over the data axes, the update of
  the rank's shards; no table is gathered;
* the GIN cells: the same factory's split step
  (:mod:`repro_torch.sharding.gnn_split`): a node-level graph padded and
  split over every axis (each layer's ``h @ w1`` all-gathered, its messages'
  partials reduce-scattered), ``molecule`` split by examples;
* LM prefill / decode cells: :mod:`repro_torch.sharding.lm_serve`'s split
  steps (the train step's plan, without autograd): the prefill on the
  rank's rows and T / m tokens, its heads, FFN columns and experts, the
  weights gathered per layer, its cache written in the decode spec's layout
  (one all-to-all a layer); the decode on the rank's slice of the cache
  (``decode_32k``: its rows and T / m rows; ``long_500k``: its T slice of
  the one row), which is never gathered, every head's partial attention
  joined over the axes that split T;
* the recsys serve cells: :func:`repro_torch.sharding.recsys_split.
  make_sharded_recsys_serve_step` as the reference's dry-run builds its
  step (``cand_shard_axes`` every axis, ``cand_pad_multiple`` 16 a rank,
  bf16 retrieval): the rank's rows over the data axes, or its slice of the
  candidates over every axis, looked up on its table shards; the scores
  gathered over the candidates' axes.

Every model op runs the plain PyTorch route, named in the call
(``attention="torch"`` for the LMs and their MoE products; the recsys
models' ``embedding_bag`` / ``cin_layer`` set to their plain versions for
the cell): the kernel wrappers refuse a ``meta`` tensor.

What a record holds, against the reference's:

* ``hlo_cost``: the reference's fields (:class:`.hlo_cost.HLOCost`),
  counted from the dispatched ops.  ``flops``: ``FlopCounterMode``'s count
  of the matmul-like ops (forward and backward); ``hbm_bytes``: operand +
  result bytes of every aten op a ``TorchDispatchMode`` sees, views and
  allocations excepted: an unfused upper bound, not XLA's bytes at fusion
  boundaries; ``bytes_by_op`` / ``count_by_op``: the collectives the step
  issues, under the reference's names (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``), each counted by its result's bytes
  as ``hlo_cost`` counts them.  ``n_while`` is 0 and ``max_trip`` 1: the
  step is eager, a loop's every iteration is dispatched and counted.
* ``memory``: the port's own model of a rank's bytes, in parts:
  ``state_bytes`` (its shards of the parameters and the optimiser state),
  ``input_bytes`` (the batch, or its shards of the serving inputs),
  ``gathered_weight_bytes`` (the weights gathered whole: none for the
  recsys and GIN split steps and the uihrdc index's expansion table; for
  the LM split steps the largest set gathered at once: the embedding and
  head and one layer's gathered weights, :func:`lm_train_parts`),
  ``output_bytes`` (what the step returns beside its inputs: the LM
  prefill's logits and cache, a decode's logits, a recsys step's scores; 0
  for a train step, which updates its state in place), ``grad_bytes`` (a
  train step's float32 gradient: the rank's shards plus, for the LM step,
  one layer's float32 transient, for the recsys and GIN steps the largest
  float32 rows a sparse backward holds at once: a table gradient's rows a
  lookup, ``EmbeddingBag``'s, or the GIN's messages, ``GatherRows``', as
  the step's split reports them in the counted run),
  ``saved_activation_bytes`` (what autograd saves for the backward,
  weights excluded, from ``saved_tensors_hooks``; under remat those hooks
  see only what is saved outside the checkpointed layers, so the LM train
  step adds the layer boundaries that remat keeps and one layer's
  recompute, counted in a run without remat), and
  ``total_per_device_gib``, their sum; not XLA's ``memory_analysis()``.
* ``roofline``: :func:`.hlo_analysis.roofline_terms` on the H100's
  datasheet peaks.
* ``xla_cost_analysis``, ``lower_s`` and ``compile_s`` have no
  counterpart (nothing is lowered or compiled); ``count_s`` is the time of
  the counted run on the host.

A cell that raises is recorded with ``status == "fail"``, its error and
its traceback; callers check ``status`` themselves.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import json
import logging
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ASSIGNED_ARCHS, get_config
from ..configs.archs import UIHRDCConfig
from ..configs.base import GNNConfig, LMConfig, RecsysConfig
from ..kernels.cin_interaction.ops import cin_layer_torch
from ..kernels.embedding_bag.ops import embedding_bag_torch
from ..models import recsys
from ..models import steps as steps_mod
from ..sharding import lm_serve, recsys_split, spmd, tp
from ..sharding.compat import NamedSharding, P, place
from ..sharding.specs import best_div_axes, input_specs_sharding_for, param_specs_for
from ..train.optimizer import OptConfig
from .hlo_analysis import roofline_terms
from .hlo_cost import HLOCost
from .mesh import make_production_mesh


class _CollProxy:
    def __init__(self, total: float):
        self.total_bytes = total


def opt_config_for(cfg) -> OptConfig:
    if isinstance(cfg, LMConfig) and cfg.n_params() > 100e9:
        return OptConfig(kind="adafactor")
    return OptConfig(kind="adamw")


def model_flops_for(cfg, shape_name: str) -> float:
    """MODEL_FLOPS = 6*N*D for LM training (N params, D tokens); analogous
    useful-work estimates for the other families."""
    if isinstance(cfg, LMConfig):
        s = cfg.shapes[shape_name]
        n = cfg.n_active_params() if cfg.moe else cfg.n_params()
        if s.kind == "train":
            return 6.0 * n * s.dims["global_batch"] * s.dims["seq_len"]
        if s.kind == "prefill":
            return 2.0 * n * s.dims["global_batch"] * s.dims["seq_len"]
        # decode: one token per sequence + attention over the cache
        b = s.dims["global_batch"]
        t = s.dims["seq_len"]
        attn = 4.0 * cfg.n_layers * b * t * cfg.n_kv_heads * cfg.head_dim
        return 2.0 * n * b + attn
    if isinstance(cfg, GNNConfig):
        s = cfg.shapes[shape_name]
        d = s.dims
        h = cfg.d_hidden
        if s.kind == "graph_batch":
            nn, ne, rep = d["n_nodes"] * d["batch"], d["n_edges"] * d["batch"], 1
        elif s.kind == "graph_mini":
            b = d["batch_nodes"]
            f1, f2 = d["fanout"]
            nn = b + b * f1 + b * f1 * f2
            ne = b * f1 + b * f1 * f2
        else:
            nn, ne = d["n_nodes"], d["n_edges"]
        mlp = 6.0 * nn * (d.get("d_feat", h) * h + (cfg.n_layers - 1) * 2 * h * h)
        agg = 6.0 * ne * h
        return mlp + agg
    if isinstance(cfg, RecsysConfig):
        s = cfg.shapes[shape_name]
        b = s.dims["batch"]
        mult = 6.0 if s.kind == "train" else 2.0
        dense = 0
        if cfg.interaction == "cin":
            m, k = cfg.n_fields, cfg.embed_dim
            prev = m
            for hk in cfg.cin_layers:
                dense += m * prev * hk * k
                prev = hk
            dims = [m * k] + list(cfg.mlp_dims) + [1]
            dense += sum(a * bb for a, bb in zip(dims[:-1], dims[1:]))
        elif cfg.interaction == "fm-2way":
            dense += cfg.n_fields * cfg.embed_dim * 2
        elif cfg.interaction == "self-attn-seq":
            t, dd = cfg.seq_len, cfg.embed_dim
            dense += cfg.n_blocks * (4 * t * dd * dd + 2 * t * t * dd + 8 * t * dd * dd)
        elif cfg.interaction == "dot":
            dims = [cfg.embed_dim * 16] + list(cfg.tower_mlp)
            dense += sum(a * bb for a, bb in zip(dims[:-1], dims[1:])) * 2
        if s.kind == "retrieval":
            nc = s.dims["n_candidates"]
            return 2.0 * nc * (cfg.embed_dim if cfg.interaction != "cin" else dense) + mult * b * dense
        return mult * b * dense
    return 0.0


# ----------------------------------------------------------------------
# counting one rank's step
# ----------------------------------------------------------------------
#: the dispatched collectives, under the reference's HLO names
_COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::allreduce_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_base_": "all-to-all",
}
#: ops that move no bytes of their own
_FREE = {"aten::empty", "aten::empty_strided", "aten::empty_like", "aten::detach",
         "_c10d_functional::wait_tensor", "_c10d_functional::_wrap_tensor_autograd"}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class CostMode(TorchDispatchMode):
    """Sums operand + result bytes of every dispatched op (views and
    allocations excepted) and the result bytes of every collective, by the
    reference's op names.  An in-place collective (``c10d::allreduce_``)
    counts the tensors it reduces."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.bytes_by_op: dict[str, int] = {}
        self.count_by_op: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        coll = _COLLECTIVES.get(name)
        if coll is not None:
            b = _nbytes(args[0] if name.startswith("c10d::") else out)
            self.bytes_by_op[coll] = self.bytes_by_op.get(coll, 0) + b
            self.count_by_op[coll] = self.count_by_op.get(coll, 0) + 1
        elif name not in _FREE and not func.is_view:
            self.hbm_bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


class SavedBytes:
    """``saved_tensors_hooks`` that sum the bytes autograd saves for the
    backward, each storage once, the weights' storages excluded (those of
    ``exclude``, and every weight operand that the LM splits passed to
    :meth:`hooks` fetch while it is on).  A checkpointed layer's saves are its own
    hooks': these see what is saved outside the layers.  Every storage
    seen is held until the record is dropped, so that a storage freed in
    the step cannot hand its identity to a new one (``meta`` storages hold
    no memory)."""

    def __init__(self, exclude):
        self._held = [t.untyped_storage() for t in exclude]
        self.seen = {st._cdata for st in self._held}
        self.bytes = 0

    def _hold(self, t) -> bool:
        st = t.untyped_storage()
        if st._cdata in self.seen:
            return False
        self._held.append(st)
        self.seen.add(st._cdata)
        return True

    def pack(self, t):
        if self._hold(t):
            self.bytes += t.untyped_storage().nbytes()
        return t

    @contextlib.contextmanager
    def hooks(self, *splits):
        for split in splits:
            split.on_fetch = self._hold
        try:
            with torch.autograd.graph.saved_tensors_hooks(self.pack, lambda t: t):
                yield
        finally:
            for split in splits:
                split.on_fetch = None


@contextlib.contextmanager
def plain_recsys_route():
    """The recsys models' lookups and CIN layers on their plain versions for
    the block (the module's names are read at each call)."""
    saved = recsys.embedding_bag, recsys.cin_layer
    recsys.embedding_bag, recsys.cin_layer = embedding_bag_torch, cin_layer_torch
    try:
        yield
    finally:
        recsys.embedding_bag, recsys.cin_layer = saved


# ----------------------------------------------------------------------
# building one cell: (rank step, its arguments, what it holds)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    run: object  # () -> outputs: the rank's step on its arguments
    work_params: dict  # the whole working weights the step reads
    state_bytes: int
    input_bytes: int
    grad_bytes: int
    notes: list
    #: the largest set of gathered weights held at once (None: work_params')
    gathered_bytes: int | None = None
    #: an LM train cell's plan (``sharding.lm_split.LMSplit``), whose
    #: fetched weights the saved activations leave out
    split: object = None
    #: an LM train cell's saved activations from the counted run's
    #: (outside the layers): ``saved(outside) -> bytes``, the layer
    #: boundaries that remat keeps and one layer's recompute added
    saved: object = None
    #: the bytes of the step's outputs that are not its inputs:
    #: ``outputs(result) -> bytes`` (None: none), counted into
    #: ``output_bytes`` by :func:`count_cell`
    outputs: object = None
    output_bytes: int = 0
    #: a split recsys / GIN train cell: ``{"bytes": n}``, the largest float32
    #: rows a sparse backward holds at once, as the step's split reports them
    #: (``on_rows``) in the counted run; :func:`count_cell` adds them to
    #: ``grad_bytes``
    sparse_rows: dict | None = None


def _named(mesh, spec_tree):
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    return {k: _named(mesh, v) for k, v in spec_tree.items()}


def _local_bytes(tree) -> int:
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    return _nbytes(tree)


def _rank_rows(t: DTensor, row_dim: int) -> torch.Tensor:
    """The rank's operand of a placed input: its shard along ``row_dim``
    kept, every other sharded dimension gathered."""
    keep = tuple(p if isinstance(p, Shard) and p.dim == row_dim else Replicate()
                 for p in t.placements)
    return t.redistribute(t.device_mesh, keep).to_local()


def _mesh_size(mesh, axes) -> int:
    names = list(mesh.mesh_dim_names)
    return math.prod(mesh.shape[names.index(a)] for a in axes)


def _moe_groups(cfg, shape_name: str, mesh, multi_pod: bool):
    # grouped MoE dispatch: one token group per data shard (the reference's)
    n_dp = _mesh_size(mesh, ("pod", "data") if multi_pod else ("data",))
    sdims = cfg.shapes[shape_name].dims
    n_tok = sdims["global_batch"] * (1 if cfg.shapes[shape_name].kind == "decode"
                                     else sdims["seq_len"])
    groups = n_dp if n_tok % n_dp == 0 else 1  # decode b=1: single group
    return dataclasses.replace(cfg, moe_groups=groups)


def build_cell(arch: str, shape_name: str, mesh, multi_pod: bool, cfg=None) -> Cell:
    """Rank 0's step of ``arch`` x ``shape_name`` on ``mesh``; ``cfg``
    replaces the registry's config of ``arch`` (a reduced one, say)."""
    cfg = get_config(arch) if cfg is None else cfg
    if isinstance(cfg, LMConfig) and cfg.moe is not None:
        cfg = _moe_groups(cfg, shape_name, mesh, multi_pod)
    kind = cfg.shapes[shape_name].kind
    notes = []
    if isinstance(cfg, UIHRDCConfig):
        return _uihrdc_cell(cfg, shape_name, mesh, multi_pod)
    in_specs = input_specs_sharding_for(cfg, shape_name, mesh, multi_pod)
    inputs = cfg.input_specs(shape_name)
    attention = "torch" if isinstance(cfg, LMConfig) else None

    if kind == "train" and isinstance(cfg, LMConfig):
        return _lm_train_cell(cfg, shape_name, mesh, multi_pod, in_specs, inputs)
    if isinstance(cfg, LMConfig):
        return _lm_serve_cell(cfg, shape_name, mesh, multi_pod, in_specs, inputs)
    if kind == "train" or isinstance(cfg, GNNConfig):
        opt_cfg = opt_config_for(cfg)
        state = spmd.meta_state(cfg, opt_cfg, shape_name)
        sspecs = spmd.state_specs_for(cfg, state, mesh, multi_pod)
        placed = place(state, _named(mesh, sspecs))
        step = spmd.make_sharded_train_step(cfg, opt_cfg, mesh, sspecs, in_specs,
                                            shape_name=shape_name, attention=attention,
                                            device="meta")
        local = {k: v.to_local() for k, v in placed["params"].items()}
        if isinstance(cfg, GNNConfig):
            notes.append(_gnn_note(cfg, shape_name, inputs, step.split))
        else:
            notes.append(_recsys_note(step.split))
        rows = {"bytes": 0}
        step.split.on_rows = lambda b: rows.update(bytes=max(rows["bytes"], b))

        def run():
            with plain_recsys_route():
                return step(placed, inputs)

        return Cell(run=run, work_params=local,
                    state_bytes=_local_bytes({"params": placed["params"],
                                              "opt": placed["opt"]}),
                    input_bytes=_nbytes(inputs), grad_bytes=4 * sum(
                        t.numel() for t in local.values()), notes=notes, gathered_bytes=0,
                    sparse_rows=rows)

    params = steps_mod.init_model_params(cfg, None, "meta", shape_name)
    pspecs = param_specs_for(cfg, params, mesh, multi_pod)
    placed = place(params, _named(mesh, pspecs))
    placed_in = {k: _place_leaf(v, mesh, in_specs[k]) for k, v in inputs.items()}
    retrieval = kind == "retrieval"
    names = tuple(mesh.mesh_dim_names)
    serve = recsys_split.make_sharded_recsys_serve_step(
        cfg, mesh, pspecs, in_specs, retrieval=retrieval, cand_shard_axes=names,
        cand_pad_multiple=16 * math.prod(mesh.shape),
        serve_dtype=torch.bfloat16 if retrieval else None, device="meta")
    notes.append(_recsys_note(serve.plan)
                 + ("; candidates over every axis, scores gathered" if retrieval else ""))
    if retrieval:
        casts = sum(t.to_local().numel() * 2 for t in placed.values() if t.dtype == torch.float32)
        notes.append(f"serve_dtype bf16: the rank's shards cast, {casts} bytes (not a part)")

    def run():
        with plain_recsys_route():
            return serve(placed, **inputs)

    return Cell(run=run, work_params={}, state_bytes=_local_bytes(placed),
                input_bytes=_local_bytes(placed_in), grad_bytes=0, notes=notes,
                gathered_bytes=0, outputs=_nbytes)


def _recsys_note(plan) -> str:
    sharded = sorted(plan.sharded)
    replicated = [k for k in plan.tables if k not in plan.sharded]
    return (f"split: tables row-sharded over 'model' {sharded or 'none'}"
            + (f", replicated {replicated} (rows not a multiple of the model axis)"
               if replicated else "") + "; rows over the data axes; no table gathered")


def _gnn_note(cfg, shape_name: str, inputs: dict, split) -> str:
    if inputs["node_feat"].dim() == 3:
        return "split: the graphs by examples over the batch's axes"
    n, e = inputs["node_feat"].shape[0], inputs["edge_src"].shape[0]
    pad = lambda x: -(-x // split.n) * split.n  # noqa: E731
    return (f"split: {pad(n) // split.n} of {n} nodes and {pad(e) // split.n} of {e} edges "
            f"a rank over {list(split.axes)} (padded to a multiple of {split.n}); h @ w1 "
            f"all-gathered, message partials reduce-scattered each layer")


def _lm_train_cell(cfg, shape_name: str, mesh, multi_pod: bool, in_specs: dict,
                   inputs: dict) -> Cell:
    """An LM's split train step (``sharding.lm_split``): its memory parts
    from the plan, one layer's recompute from a run without remat."""
    opt_cfg = opt_config_for(cfg)
    state = spmd.meta_state(cfg, opt_cfg, shape_name)
    sspecs = spmd.state_specs_for(cfg, state, mesh, multi_pod)
    placed = place(state, _named(mesh, sspecs))
    kw = dict(shape_name=shape_name, attention="torch", device="meta")
    step = spmd.make_sharded_train_step(cfg, opt_cfg, mesh, sspecs, in_specs, **kw)
    plain = spmd.make_sharded_train_step(dataclasses.replace(cfg, remat="none"), opt_cfg, mesh,
                                         sspecs, in_specs, **kw)
    parts = lm_train_parts(cfg, step.split, placed["params"], inputs["tokens"].shape)

    def saved(outside: int) -> int:
        record = SavedBytes(())
        with record.hooks(plain.split):
            plain.grads(placed, inputs)
        per_layer = (record.bytes - outside) // cfg.n_layers
        return outside + parts["boundary_bytes"] + per_layer

    notes = [f"split: {step.split.heads[0]} q heads, {step.split.heads[1]} kv heads"
             + (f", experts {step.split.expert_range}" if cfg.moe else "")
             + f" and {inputs['tokens'].shape[1] // step.split.m} tokens a row a rank; "
             f"remat {cfg.remat}"]
    return Cell(run=lambda: step(placed, inputs), work_params={},
                state_bytes=_local_bytes({"params": placed["params"], "opt": placed["opt"]}),
                input_bytes=_nbytes(inputs), grad_bytes=parts["grad_bytes"], notes=notes,
                gathered_bytes=parts["gathered_weight_bytes"], split=step.split,
                saved=saved if cfg.remat != "none" else None)


def _lm_serve_cell(cfg, shape_name: str, mesh, multi_pod: bool, in_specs: dict,
                   inputs: dict) -> Cell:
    """An LM's split prefill or decode (``sharding.lm_serve``): the whole
    tokens (and positions) as every rank gets them, the decode's cache as
    the rank's slice; the gathered weights from the plan."""
    params = steps_mod.init_model_params(cfg, None, "meta", shape_name)
    pspecs = param_specs_for(cfg, params, mesh, multi_pod)
    placed = place(params, _named(mesh, pspecs))
    placed_in = {k: _place_leaf(v, mesh, in_specs[k]) for k, v in inputs.items()}
    kw = dict(attention="torch", device="meta")
    if cfg.shapes[shape_name].kind == "prefill":
        step = lm_serve.make_sharded_prefill_step(cfg, mesh, pspecs, in_specs, **kw)
        run = lambda: step(placed, inputs["tokens"])  # noqa: E731
        outputs = _nbytes
        what = f"{inputs['tokens'].shape[1] // step.split.m} tokens a row a rank"
    else:
        step = lm_serve.make_sharded_decode_step(cfg, mesh, pspecs, in_specs, **kw)
        cache = placed_in["kv_cache"].to_local()

        def run():
            return step(placed, inputs["tokens"], inputs["positions"], cache)

        outputs = lambda out: _nbytes(out[0])  # noqa: E731  (the cache is updated in place)
        what = (f"a cache slice of {cache.shape[3]} of {inputs['kv_cache'].shape[3]} rows, "
                f"{cache.shape[2]} of {inputs['kv_cache'].shape[2]} sequences")
    split = step.split
    parts = lm_train_parts(cfg, split, placed, inputs["tokens"].shape)
    notes = [f"split: {split.heads[0]} q heads, {split.heads[1]} kv heads"
             + (f", experts {split.expert_range}" if cfg.moe else "") + f"; {what}"]
    return Cell(run=run, work_params={}, state_bytes=_local_bytes(placed),
                input_bytes=_local_bytes(placed_in), grad_bytes=0, notes=notes,
                gathered_bytes=parts["gathered_weight_bytes"], split=split,
                outputs=outputs)


def lm_train_parts(cfg, split, placed_params: dict, batch_shape) -> dict:
    """A rank's bytes of the LM split step, from its plan: the gathered
    weights held at once (the gathered embed / head and one layer's
    gathered weights), its float32 gradient (the shards and one layer's
    float32 transient before the reduce-scatters) and the layer boundaries
    that remat keeps (one (B / data ranks, T / m, D) tensor a layer)."""
    def operand(path: str) -> tuple[int, int]:  # (elements of one operand, element size)
        local = placed_params[path].to_local()
        n = local[0].numel() if path.startswith("layers/") else local.numel()
        for _, group in split.plans[path][0]:
            n *= tp.group_size(group)
        return n, local.element_size()

    gathered = transient = 0
    for path, (gathers, _) in split.plans.items():
        n, size = operand(path)
        if gathers:
            gathered += n * size
        if path.startswith("layers/"):
            transient += 4 * n
    shards = sum(4 * t.to_local().numel() for t in placed_params.values())
    n_slices = math.prod(split.mesh.size(j) for j, a in enumerate(split.names) if a != "model")
    b, t = batch_shape
    elem = 2 if cfg.dtype == "bfloat16" else 4
    return {"gathered_weight_bytes": gathered, "grad_bytes": shards + transient,
            "boundary_bytes": cfg.n_layers * (b // n_slices) * (t // split.m) * cfg.d_model
            * elem}


def _place_leaf(t: torch.Tensor, mesh, spec: P) -> DTensor:
    return place({"x": t}, {"x": NamedSharding(mesh, spec)})["x"]


def _uihrdc_cell(cfg, shape_name: str, mesh, multi_pod: bool) -> Cell:
    """The paper's own architecture: batched AND queries over the anchored
    index; the anchors replicated, the expansion table sharded as the
    reference places it, and gathered whole by each rank (the port does
    not probe remote rows)."""
    from ..serving.engine import make_uihrdc_serve_step

    full = tuple(mesh.mesh_dim_names)
    nc, nt, el = cfg.c_entries, cfg.n_terms, cfg.expand_len
    meta = torch.device("meta")
    index = {
        "anchors": torch.empty((nc,), dtype=torch.int32, device=meta),
        "c_offsets": torch.empty((nt + 1,), dtype=torch.int32, device=meta),
        "expand": torch.empty((nc, el), dtype=torch.int32, device=meta),
        "expand_valid": torch.empty((nc, el), dtype=torch.bool, device=meta),
        "lengths": torch.empty((nt,), dtype=torch.int32, device=meta),
    }
    ca = best_div_axes(nc, mesh, full)
    index_specs = {"anchors": P(None), "c_offsets": P(None), "expand": P(ca, None),
                   "expand_valid": P(ca, None), "lengths": P(None)}
    placed_index = {k: _place_leaf(v, mesh, index_specs[k]) for k, v in index.items()}
    in_specs = input_specs_sharding_for(cfg, shape_name, mesh, multi_pod)
    placed_in = {k: _place_leaf(v, mesh, in_specs[k])
                 for k, v in cfg.input_specs(shape_name).items()}
    serve = make_uihrdc_serve_step(max_terms=cfg.max_terms)

    def run():
        idx = {k: v.full_tensor() for k, v in placed_index.items()}
        q = {k: _rank_rows(v, 0) for k, v in placed_in.items()}
        return serve(idx, q["query_terms"], q["query_lens"])

    return Cell(run=run, work_params={}, state_bytes=_local_bytes(placed_index),
                input_bytes=_local_bytes(placed_in), grad_bytes=0,
                notes=["the whole index is gathered on every rank"])


# ----------------------------------------------------------------------
def _world(multi_pod: bool):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already: the dry-run starts its own "
                           "fake world for each cell")
    dist.init_process_group("fake", rank=0, world_size=512 if multi_pod else 256,
                            store=FakeStore())
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def count_cell(cell: Cell) -> tuple[HLOCost, int]:
    """Runs ``cell`` once under the counters: ``(cost, saved activation
    bytes)``; sets the cell's ``output_bytes``."""
    cost_mode = CostMode()
    saved = SavedBytes(cell.work_params.values())
    splits = () if cell.split is None else (cell.split,)
    with FlopCounterMode(display=False) as flop_mode, cost_mode, saved.hooks(*splits):
        out = cell.run()
    if cell.sparse_rows is not None:
        cell.grad_bytes += cell.sparse_rows["bytes"]
    cell.output_bytes = 0 if cell.outputs is None else cell.outputs(out)
    hc = HLOCost(flops=float(flop_mode.get_total_flops()), hbm_bytes=float(cost_mode.hbm_bytes),
                 collective_bytes=float(sum(cost_mode.bytes_by_op.values())),
                 bytes_by_op=dict(cost_mode.bytes_by_op),
                 count_by_op=dict(cost_mode.count_by_op))
    return hc, saved.bytes if cell.saved is None else cell.saved(saved.bytes)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str | None = None,
             verbose: bool = True) -> dict:
    faulthandler.enable()
    # DTensor warns at each gather over two mesh dimensions; the record counts them
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    n_chips = 512 if multi_pod else 256
    cfg = get_config(arch)
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "multi_pod": multi_pod, "n_chips": n_chips}
    t0 = time.time()
    try:
        mesh = _world(multi_pod)
        try:
            cell = build_cell(arch, shape_name, mesh, multi_pod)
            t1 = time.time()
            hc, saved = count_cell(cell)
            t2 = time.time()
        finally:
            dist.destroy_process_group()
        gathered = (_nbytes(list(cell.work_params.values())) if cell.gathered_bytes is None
                     else cell.gathered_bytes)
        parts = {"state_bytes": cell.state_bytes, "input_bytes": cell.input_bytes,
                 "gathered_weight_bytes": gathered, "output_bytes": cell.output_bytes,
                 "grad_bytes": cell.grad_bytes, "saved_activation_bytes": saved}
        mf = model_flops_for(cfg, shape_name)
        roof = roofline_terms({"flops": hc.flops, "bytes accessed": hc.hbm_bytes},
                              _CollProxy(hc.collective_bytes), n_chips, model_flops=mf)
        rec.update({
            "status": "ok",
            "build_s": round(t1 - t0, 2),
            "count_s": round(t2 - t1, 2),
            "memory": {**parts, "total_per_device_gib": round(sum(parts.values()) / 2**30, 3)},
            "collectives": {"bytes_by_op": hc.bytes_by_op, "count_by_op": hc.count_by_op,
                            "total_bytes": int(hc.collective_bytes)},
            "hlo_cost": hc.as_dict(),
            "roofline": roof.as_dict(),
            "notes": cell.notes,
        })
        if verbose:
            print(f"[{rec['mesh']}] {arch} x {shape_name}: OK "
                  f"count={rec['count_s']}s "
                  f"mem/dev={rec['memory']['total_per_device_gib']}GiB "
                  f"dominant={roof.dominant} "
                  f"(comp={roof.compute_s:.4f}s mem={roof.memory_s:.4f}s coll={roof.collective_s:.4f}s)",
                  flush=True)
    except Exception as e:  # noqa: BLE001 - record and continue
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"[{rec['mesh']}] {arch} x {shape_name}: FAIL {rec['error'][:300]}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = "multipod" if multi_pod else "singlepod"
        path = os.path.join(out_dir, f"{arch.replace('.', '_')}__{shape_name}__{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]]
    if args.all:
        cells = [(a, s) for a in ASSIGNED_ARCHS for s in get_config(a).shapes]
    else:
        if not args.arch:
            raise SystemExit("--arch required unless --all")
        shapes = [args.shape] if args.shape else list(get_config(args.arch).shapes)
        cells = [(args.arch, s) for s in shapes]

    results = []
    for arch, shape in cells:
        if args.skip_existing:
            tag = "multipod" if args.multi_pod else "singlepod"
            p = os.path.join(args.out, f"{arch.replace('.', '_')}__{shape}__{tag}.json")
            if os.path.exists(p):
                with open(p) as f:
                    old = json.load(f)
                if old.get("status") == "ok":
                    print(f"skip {arch} x {shape} (cached ok)", flush=True)
                    continue
        results.append(run_cell(arch, shape, args.multi_pod, args.out))
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"\n{n_ok}/{len(results)} cells OK", flush=True)


if __name__ == "__main__":
    main()
