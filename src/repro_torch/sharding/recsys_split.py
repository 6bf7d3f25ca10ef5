"""RecSys lookups on tables row-sharded over ``"model"`` (the reference's
``recsys_param_specs``: every ``*table*`` / ``item_emb`` leaf, and the 1-D
``linear``, split by rows over ``"model"`` where the rows divide).

A rank holds rows ``[row_start, row_start + V / m)`` of such a table and
never gathers it.  :class:`RecsysPlan` reads the param specs; its
:meth:`~RecsysPlan.view` hands the recsys models (``models.recsys``) a
parameter namespace in which each sharded table is a :class:`TableShard`,
whose lookups ``models.recsys._bag`` passes on:

* **batch rows** (serving and training): the rank looks up its rows' ids on
  its shard with ``embedding_bag``'s shard mode (another shard's rows add
  exactly 0.0) and sums the partials over ``"model"``
  (``tp.sum_partials``: its backward is the identity, since every model rank
  of a data slice computes the same thing downstream); the table's gradient
  lands in the rank's shard only (``EmbeddingBag``'s shard mode);
* **retrieval candidates** split over every axis: the rank gathers its model
  group's candidate ids over ``"model"``, looks them up on its shard and
  reduce-scatters the partial rows back over ``"model"``.

A table the specs replicate (FM's and xDeepFM's on (16, 16): 3,008,562
Criteo rows are not a multiple of 16) is a :class:`TableShard` without a
group, looked up locally as the unsharded models look it up, with no
collective.  A bag of one id sums one row and zeros, so
its lookup equals the whole table's bit for bit; a longer bag (the linear
term, FM's field sum) sums its rows in partial sums per shard.

Every model rank of a data slice computes the same loss, so (in
``sharding.spmd``) a shard's table gradient is summed over the data axes
only, never over ``"model"``, and so is every replicated leaf's.

:func:`make_sharded_recsys_serve_step` is the serving step on the mesh;
:func:`loss_for` the train loss the sharded train step differentiates
(two-tower's in-batch softmax split by rows: the rank's users against the
whole batch's items, gathered over the data axes).
"""

from __future__ import annotations

import math
import types

import torch
from torch.distributed.tensor import Replicate, Shard

from ..configs.base import RecsysConfig
from ..kernels.embedding_bag.ops import EmbeddingBag
from ..models import recsys, steps
from ..train.optimizer import param_tree
from . import tp
from .compat import (NamedSharding, axes_index, flatten_specs, local_shard, mesh_device,
                     require_device_mesh, to_local)
from .specs import is_recsys_table


class TableShard:
    """A rank's ``shard`` of a table of ``n_rows`` rows row-sharded over
    ``group`` (``"model"``), starting at ``row_start``; ``candidates`` picks
    the lookup of retrieval candidates split over the group (module
    docstring).  Without a group, ``shard`` is a replicated table, looked up
    locally as the unsharded models look it up.  ``shape`` and ``dtype`` are
    the whole table's.  ``record`` (or None) is called with the float32
    bytes of each lookup's rows that its backward holds."""

    def __init__(self, shard: torch.Tensor, row_start: int = 0, n_rows: int | None = None,
                 group=None, candidates: bool = False, record=None):
        self.shard, self.row_start, self.n_rows = shard, row_start, n_rows
        self.group, self.candidates, self.record = group, candidates, record

    @property
    def shape(self) -> tuple:
        return (self.shard.shape[0] if self.n_rows is None else self.n_rows,
                *self.shard.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shard.dtype

    def __getitem__(self, key):
        """``linear[:, None]``: a view that keeps the rows whole."""
        if not (isinstance(key, tuple) and key and key[0] == slice(None)):
            raise IndexError(f"a table shard is indexed by [:, ...] only, got {key!r}")
        return TableShard(self.shard[key], self.row_start, self.n_rows, self.group,
                          self.candidates, self.record)

    def _partial(self, ids: torch.Tensor, bag: int) -> torch.Tensor:
        if torch.is_grad_enabled() and self.shard.requires_grad:
            if self.record is not None:
                self.record(4 * ids.numel() * self.shard.shape[1])
            return EmbeddingBag.apply(ids, self.shard, bag, recsys.embedding_bag,
                                      self.row_start, self.n_rows)
        # the module's name, read at the call (the plain route swaps it)
        return recsys.embedding_bag(ids, self.shard, bag, self.row_start, self.n_rows)

    def bag(self, ids: torch.Tensor, bag: int) -> torch.Tensor:
        """float32 bag sums of ``ids`` over the whole table."""
        if self.group is None:
            return self._partial(ids, bag)
        if not self.candidates:
            return tp.sum_partials(self._partial(ids, bag), self.group)
        if torch.is_grad_enabled() and self.shard.requires_grad:
            raise NotImplementedError("candidate lookups serve only: they have no backward")
        every = tp.gather_nograd(ids, 0, self.group)
        return tp.scatter_nograd(self._partial(every, bag), 0, self.group)


class RecsysPlan:
    """Which leaves of ``cfg``'s model the param specs (``param_sh``: ``{path:
    placements}``) shard over ``"model"``, and the rank's rows of each.
    ``data_groups``: the groups every gradient is summed over, the data
    axes (every model rank of a data slice computes the same loss).
    ``on_rows``, when set, is called with the float32 bytes of each table
    lookup's rows that its backward holds."""

    def __init__(self, cfg: RecsysConfig, mesh, param_sh: dict):
        if not isinstance(cfg, RecsysConfig):
            raise TypeError(f"the recsys split plans recsys models; got {type(cfg).__name__}")
        shapes = {k: tuple(p.shape) for k, p in
                  param_tree(steps.init_model_params(cfg, None, "meta")).items()}
        if set(shapes) != set(param_sh):
            raise KeyError(f"param specs for {sorted(set(param_sh) ^ set(shapes))[:4]} do not "
                           f"match the model's parameters")
        self.cfg, self.mesh = cfg, mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.model_group = mesh.get_group("model") if "model" in self.names else None
        self.tables = sorted(k for k, s in shapes.items() if is_recsys_table(k, len(s)))
        self.sharded: dict[str, tuple[int, int]] = {}  # path -> (row_start, n_rows)
        for k, pl in param_sh.items():
            for j, p in enumerate(pl):
                if isinstance(p, Replicate):
                    continue
                if not (self.names[j] == "model" and isinstance(p, Shard) and p.dim == 0
                        and k in self.tables):
                    raise ValueError(f"{k}: the recsys split shards tables by rows over "
                                     f"'model' only, not {p} on {self.names[j]!r}")
                n = shapes[k][0]
                m, r = mesh.size(j), mesh.get_local_rank("model")
                if n % m:
                    raise ValueError(f"{k}: {n} rows do not split over {m} model ranks")
                self.sharded[k] = (r * (n // m), n)
        self.data_groups = [mesh.get_group(a) for a in self.names if a != "model"]
        self.on_rows = None

    def _record(self, nbytes: int) -> None:
        if self.on_rows is not None:
            self.on_rows(nbytes)

    def view(self, local: dict, candidates: bool = False) -> types.SimpleNamespace:
        """The models' parameter namespace from the rank's local tensors
        (``{path: tensor}``), each table a :class:`TableShard` (a replicated
        one without a group)."""
        def leaf(k, v):
            if k in self.sharded:
                return TableShard(v, *self.sharded[k], self.model_group, candidates,
                                  self._record)
            return TableShard(v, record=self._record) if k in self.tables else v

        return namespace(self.cfg, {k: leaf(k, v) for k, v in local.items()})


def namespace(cfg: RecsysConfig, leaves: dict) -> types.SimpleNamespace:
    """``{path: leaf}`` (``param_tree`` paths) as the attributes the recsys
    models read: ``cin/0`` into the list ``cin``, ``blocks/0/wq`` into the
    list of dicts ``blocks``."""
    out = {}
    for f in recsys._model_class(cfg).FIELDS:
        if f in leaves:
            out[f] = leaves[f]
            continue
        items: dict[int, object] = {}
        for k, v in leaves.items():
            if k.startswith(f + "/"):
                i, _, rest = k[len(f) + 1:].partition("/")
                if rest:
                    items.setdefault(int(i), {})[rest] = v
                else:
                    items[int(i)] = v
        out[f] = [items[i] for i in sorted(items)]
    return types.SimpleNamespace(**out)


def row_split(mesh, batch_sh: dict) -> tuple[list, int]:
    """The groups of the mesh dimensions that split the batch's rows (major
    first) and the rank's index among the slices, from the batch's
    placements; a spec that splits rows over ``"model"`` is refused (the
    model ranks of a data slice must hold the same rows)."""
    names = tuple(mesh.mesh_dim_names)
    dims = None
    for k, pl in batch_sh.items():
        here = [j for j, p in enumerate(pl) if isinstance(p, Shard)]
        for j in here:
            if names[j] == "model" or pl[j].dim != 0:
                raise ValueError(f"batch leaf {k}'s spec splits it over {names[j]!r} (dim "
                                 f"{pl[j].dim}): the recsys split takes rows over the data "
                                 f"axes only")
        if here and dims is not None and here != dims:
            raise ValueError("the batch's leaves split their rows over different axes")
        dims = here if here else dims
    groups, _, index = axes_index(mesh, [names[j] for j in (dims or [])])
    return groups, index


def loss_for(cfg: RecsysConfig, row_groups: list, row_index: int):
    """``loss(view, rows) -> (loss, aux)`` of the rank's rows: the unsharded
    step's loss (a mean over the rank's rows) for FM, xDeepFM and SASRec; for
    two-tower the in-batch softmax split by rows: the rank's users scored
    against the whole batch's items (gathered over ``row_groups``, minor axis
    first; the gather's backward reduce-scatters), the mean of the rank's
    diagonal log-probabilities."""
    if cfg.interaction != "dot":
        return lambda view, rows: steps._recsys_loss(cfg, view, rows)

    def loss(view, rows):
        u = recsys.tt_user_tower(cfg, view, rows["user_feats"])
        v = recsys.tt_item_tower(cfg, view, rows["item_ids"])
        for g in reversed(row_groups):
            v = tp.gather(v, 0, g)
        logp = torch.log_softmax(recsys._mm(u, v.T) * 20.0, dim=-1)
        nll = -torch.mean(torch.diagonal(logp, offset=row_index * u.shape[0]))
        return nll, {"nll": nll}

    return loss


def make_sharded_recsys_serve_step(cfg: RecsysConfig, mesh, param_specs: dict,
                                   in_specs: dict | None = None, retrieval: bool = False,
                                   cand_shard_axes=None, cand_pad_multiple: int = 1,
                                   serve_dtype=None, device=None):
    """``serve(params, **inputs)`` on ``mesh`` for parameters placed by
    ``param_specs`` (``{path: DTensor}`` or the rank's local tensors), with
    the whole inputs on every rank: the unsharded step's own functions
    (``steps.make_recsys_serve_step``, ``steps.retrieval_scores``) on the
    plan's view of the rank's shards.

    * serving (``retrieval=False``): the rank's rows of the batch (the data
      axes of ``in_specs``; without them, over every data axis that divides
      the rows) through the lookups of the module docstring, then the CIN
      (row 10), the MLPs and SASRec's blocks as in the unsharded step;
      returns the rank's rows' outputs;
    * retrieval: the candidates padded to ``cand_pad_multiple`` by repeating
      the first (the reference's padding), the rank's slice over
      ``cand_shard_axes`` scored against the whole user side, the scores
      gathered over those axes and cut to the candidates given: what the
      unsharded step returns.  With ``"model"`` the last of the axes, the
      candidates' lookups gather their ids over ``"model"``; without it, they
      are batch rows.  ``serve_dtype`` casts the rank's shards, never a
      gathered table.

    ``device`` is the rank's compute device (the mesh's by default; the
    dry-run passes ``"meta"``)."""
    require_device_mesh(mesh, "make_sharded_recsys_serve_step")
    param_sh = {k: NamedSharding(mesh, v).placements()
                for k, v in flatten_specs(param_specs).items()}
    plan = RecsysPlan(cfg, mesh, param_sh)
    dev = mesh_device(mesh) if device is None else torch.device(device)
    names = tuple(mesh.mesh_dim_names)
    in_sh = None if in_specs is None else {k: NamedSharding(mesh, v).placements()
                                          for k, v in flatten_specs(in_specs).items()}

    if retrieval:
        axes = tuple(cand_shard_axes or ())
        if any(a not in names for a in axes):
            raise ValueError(f"cand_shard_axes={axes!r}: not axes of the mesh {names}")
        if "model" in axes and axes[-1] != "model":
            raise ValueError(f"cand_shard_axes={axes!r}: 'model' must be the last (minor) axis, "
                             f"so that a model group's candidates lie together")
        groups, n_slices, index = axes_index(mesh, axes)
        by_model = "model" in axes

        @torch.no_grad()
        def serve(params, **inputs):
            local = {k: to_local(v) for k, v in _leaves(params).items()}
            if serve_dtype is not None:
                local = {k: recsys.cast_leaf(v, serve_dtype) for k, v in local.items()}
            whole = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
            cand, nc = steps.pad_candidates(whole.pop("candidates"), cand_pad_multiple)
            if cand.shape[0] % n_slices:
                raise ValueError(f"{cand.shape[0]} candidates do not split over {n_slices} "
                                 f"ranks of {axes}: pad them (cand_pad_multiple)")
            per = cand.shape[0] // n_slices
            mine = cand[index * per:(index + 1) * per]
            out = steps.retrieval_scores(cfg, plan.view(local), whole, mine,
                                         plan.view(local, candidates=by_model))
            dim = out.dim() - 1  # candidates last for (B, NC) scores, first for (NC,) logits
            for g in reversed(groups):
                out = tp.gather_nograd(out, dim, g)
            return steps.cut_candidates(out, nc)

        serve.plan = plan
        return serve

    unsharded = steps.make_recsys_serve_step(cfg)

    @torch.no_grad()
    def serve(params, **inputs):
        local = {k: to_local(v) for k, v in _leaves(params).items()}
        whole = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
        sh = in_sh if in_sh is not None else _row_specs(mesh, whole)
        row_split(mesh, {k: sh[k] for k in whole})  # refuses rows over "model"
        return unsharded(plan.view(local),
                         **{k: local_shard(v, mesh, sh[k]) for k, v in whole.items()})

    serve.plan = plan
    return serve


def _leaves(params) -> dict:
    """``{path: leaf}`` of a model or of a placed ``{path: DTensor}``."""
    return params if isinstance(params, dict) else param_tree(params)


def _row_specs(mesh, inputs: dict) -> dict:
    """Placements that split the inputs' rows over every data axis together
    when the rows divide their product, else replicate them (the reference's
    ``recsys_input_specs_sharding`` for a batch)."""
    names = tuple(mesh.mesh_dim_names)
    data = [j for j, a in enumerate(names) if a != "model"]
    rows = {v.shape[0] for v in inputs.values() if v.dim()}
    split = len(rows) == 1 and rows.pop() % math.prod(mesh.size(j) for j in data) == 0
    return {k: tuple(Shard(0) if split and j in data and v.dim() else Replicate()
                     for j in range(len(names))) for k, v in inputs.items()}
