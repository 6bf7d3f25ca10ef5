"""The GIN's node-level graphs split over mesh axes: the counterpart of the
reference's ``pad_graph_batch(..., shard_axes)`` constraints
(``node_feat`` / ``edge_src`` / ``edge_dst`` to ``P(shard_axes, ...)``),
which GSPMD turns into a split graph.

The batch (the whole graph, the same on every rank) is padded as the
reference pads it (padded edges point at a padded node, whose mask is
False) and each rank keeps its slice of the nodes, the edges and, where
they are per node, the labels and the mask: chunk ``i`` of ``n`` for the
rank's index ``i`` over ``shard_axes``, major axis first (a DTensor's
order).  Each GIN layer is ``models.gnn._gin_layer`` given the split:

1. ``hw = h @ w1`` on the rank's nodes;
2. ``hw`` all-gathered over ``shard_axes`` (backward: reduce-scatter);
3. the messages of the rank's edges, ``hw[src]``, rounded to bf16;
4. summed by ``dst`` with ``ordered_segment_sum`` into a float32 partial
   over every node;
5. the partial reduce-scattered to the rank's nodes (backward: all-gather);
6. the rest of the layer on the rank's nodes.

The loss is masked over the rank's labelled nodes and divided by the whole
mask's count, so that the ranks' losses sum to the unsharded loss; the
GIN's weights are replicated (the reference's ``gnn_param_specs``) and
their gradient is summed over ``shard_axes``.

``graph_mini`` (a sampled block): its labels cover the first
``batch_nodes`` rows only.  Each rank writes its nodes' logits among those
rows into a zero (``batch_nodes``, C) buffer, the buffers are summed over
``shard_axes`` (one rank holds each row, so the sum is that row's logits;
the backward sums the rows' gradients, which reach the rank that holds the
node), and the rank takes its slice of the rows by the labels' own axes
(``specs.gnn_input_specs_sharding``); a rank whose coordinates on the other
axes are not 0 counts no label, so that each is counted once.

``graph_batch`` (batched small graphs) keeps the per-example split: the
rank's examples by the batch's spec, its masked mean weighted by its share
of the mask, the gradient summed over the axes that split the examples.

A world of one makes every collective the identity and every weight 1.0:
the unsharded step's arithmetic, bit for bit.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from ..configs.base import GNNConfig
from ..models import gnn
from . import tp
from .compat import axes_index, local_shard, to_local


class GraphSplit:
    """``shard_axes`` of ``mesh``: their groups (major first), the number of
    slices they cut a dimension into and the rank's index among them.
    ``on_rows``, when set, is called at each step with the float32 bytes of
    the largest message gradient the backward holds (the rank's edges by
    the widest layer: ``GatherRows``' rows before their ordered sum)."""

    def __init__(self, mesh, shard_axes):
        names = tuple(mesh.mesh_dim_names)
        axes = (shard_axes,) if isinstance(shard_axes, str) else tuple(shard_axes)
        if not axes or any(a not in names for a in axes) or len(set(axes)) != len(axes):
            raise ValueError(f"shard_axes={shard_axes!r}: not distinct axes of the mesh {names}")
        self.mesh, self.axes = mesh, axes
        self.groups, self.n, self.index = axes_index(mesh, axes)
        self.on_rows = None

    def chunk(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's slice of ``t``'s rows (their count a multiple of n)."""
        if t.shape[0] % self.n:
            raise ValueError(f"{t.shape[0]} rows do not split over {self.n} ranks of {self.axes}")
        per = t.shape[0] // self.n
        return t[self.index * per:(self.index + 1) * per]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        for g in reversed(self.groups):  # minor axis first: each gather joins whole blocks
            x = tp.gather(x, 0, g)
        return x

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        for g in self.groups:  # major axis first
            x = tp.scatter(x, 0, g)
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        for g in self.groups:
            x = tp.all_reduce(x, g)
        return x


def pad_and_split(batch: dict, multiple: int, split: GraphSplit) -> dict:
    """The reference's padding (``gnn.pad_graph_batch``), then the rank's
    slice of the nodes, the edges and the per-node labels and mask
    (a block's seed labels stay whole: module docstring)."""
    if multiple % split.n:
        raise ValueError(f"pad_multiple={multiple} is not a multiple of the {split.n} ranks of "
                         f"{split.axes}: the nodes and edges would not split evenly")
    per_node = batch["labels"].shape[0] == batch["node_feat"].shape[0]
    out = gnn.pad_graph_batch(batch, multiple)
    keep = ("node_feat", "edge_src", "edge_dst") + (("labels", "train_mask") if per_node else ())
    return {k: split.chunk(v) if k in keep else v for k, v in out.items()}


def label_split(split: GraphSplit, n_labels: int, axes) -> tuple[int, int, bool]:
    """A block's seed rows split by the labels' own ``axes`` (``None`` for
    none; those outside ``shard_axes`` ignored): ``(start, stop, counts)``,
    ``counts`` False where the rank's coordinate on another of the shard
    axes is not 0 (its rows are another rank's too)."""
    mesh = split.mesh
    axes = () if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))
    axes = tuple(a for a in axes if a in split.axes)
    _, n, index = axes_index(mesh, axes)
    if n_labels % n:
        raise ValueError(f"{n_labels} labels do not split over {n} ranks of {axes}")
    counts = all(mesh.get_local_rank(a) == 0 for a in split.axes if a not in axes)
    per = n_labels // n
    return index * per, (index + 1) * per, counts


def node_loss(cfg: GNNConfig, params, local: dict, split: GraphSplit, seeds: bool = False,
              label_axes=None):
    """``(loss, aux)`` of the rank's part: its masked NLL sum over the whole
    mask's count, and its share of the accuracy (their sums over
    ``shard_axes`` are the unsharded loss and accuracy).  ``seeds``: the
    labels are a block's seed rows, split by ``label_axes``."""
    logits = gnn.forward_node(cfg, params, local["node_feat"], local["edge_src"],
                              local["edge_dst"], split)
    labels, m = local["labels"], local["train_mask"].float()
    if seeds:  # module docstring
        nl = labels.shape[0]
        lo = min(split.index * logits.shape[0], nl)
        hi = min(lo + logits.shape[0], nl)
        rows = split.sum(F.pad(logits[:hi - lo], (0, 0, lo, nl - hi)))
        start, stop, counts = label_split(split, nl, label_axes)
        logits, labels, m = rows[start:stop], labels[start:stop], m[start:stop]
        if not counts:
            m = torch.zeros_like(m)
    return gnn.masked_loss(logits, labels, m, tp.sum_into(m.sum().detach().clone(),
                                                          split.groups))


def namespace(leaves: dict) -> types.SimpleNamespace:
    """``{path: tensor}`` (``layers/0/w1``, ``out_w``) as the attributes the
    GIN functions read."""
    layers: dict[int, dict] = {}
    for k, v in leaves.items():
        if k.startswith("layers/"):
            i, name = k[len("layers/"):].split("/")
            layers.setdefault(int(i), {})[name] = v
    return types.SimpleNamespace(layers=[layers[i] for i in sorted(layers)],
                                 out_w=leaves["out_w"], out_b=leaves["out_b"])


def make_split_grads(cfg: GNNConfig, mesh, shard_axes, pad_multiple: int, batch_sh: dict,
                     label_axes=None, device=None):
    """``grads(state, batch) -> ({path: float32 gradient}, metrics)`` of the
    GIN on ``mesh``: a node-level batch split over ``shard_axes`` after
    padding to ``pad_multiple``, a batch of small graphs split by its
    ``batch_sh`` placements (module docstring).  ``label_axes``: the mesh axes
    of a block's seed labels (``specs.gnn_input_specs_sharding``'s
    ``labels``).  Each gradient is the whole batch's, replicated."""
    split = GraphSplit(mesh, shard_axes)
    names = tuple(mesh.mesh_dim_names)

    def grads(state: dict, batch: dict):
        params = state["params"]
        leaves = {k: to_local(v).detach().requires_grad_() for k, v in params.items()}
        dev = device or next(iter(leaves.values())).device
        whole = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        view = namespace(leaves)
        if whole["node_feat"].dim() == 3:
            dims = sorted({j for k, pl in batch_sh.items() if k in whole
                           for j, p in enumerate(pl) if isinstance(p, Shard)})
            groups = [mesh.get_group(names[j]) for j in dims]
            local = {k: local_shard(v, mesh, batch_sh[k]) for k, v in whole.items()}
            loss, aux = gnn.loss_fn(cfg, view, local)
            count = local["train_mask"].float().sum()
            total = tp.sum_into(count.clone(), groups)
            w = torch.clamp(count, min=1.0) / torch.clamp(total, min=1.0)
            scale = w
        else:
            groups = split.groups
            seeds = whole["labels"].shape[0] != whole["node_feat"].shape[0]
            local = pad_and_split(whole, pad_multiple, split)
            loss, aux = node_loss(cfg, view, local, split, seeds, label_axes)
            scale = None
        if split.on_rows is not None:
            split.on_rows(4 * local["edge_src"].numel() * max(lp["w1"].shape[1]
                                                               for lp in view.layers))
        out = loss if scale is None else loss * scale
        g = torch.autograd.grad(out, list(leaves.values()), allow_unused=True)
        with torch.no_grad():
            g = {k: tp.sum_into(torch.zeros_like(p, dtype=torch.float32) if v is None
                                else v.float(), groups)
                 for (k, p), v in zip(leaves.items(), g)}
            metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
            vals = torch.stack([v.float() for v in metrics.values()])
            vals = tp.sum_into(vals if scale is None else vals * scale, groups)
        return g, dict(zip(metrics, vals.unbind()))

    grads.split = split
    return grads
