"""GIN (Graph Isomorphism Network, Xu et al. 2019) over edge lists — the
reference's ``repro.models.gnn``.

Three input regimes, as in the reference: full graph (N, F) features with
(E,) src / dst edges (node classification); a sampled mini-batch block (the
same arrays, from ``data.graphs.NeighborSampler``, loss on the seed rows);
batched small graphs (B, n, F) with (B, E) edges (graph classification by
sum readout).

The sum aggregation ``m_v = sum_{u -> v} h_u`` is the reference's
``jax.ops.segment_sum`` of bf16-rounded messages into float32: here
``models.segment.GatherRows`` (the messages ``hw16[src]``; backward an
ordered sum by ``src``) and ``SegmentSum`` (the sum by ``dst``; backward a
gather), both ordered (a fixed tree of float32 adds, the same bits on the
CPU and the card; no float atomics).  Each edge's message gradient is
rounded to bf16, as the reference's, and summed by ``src`` in float32 (the
reference's transpose scatter adds in bf16).  No kernel of the TPU table
is on this path.

Parameters are an ``nn.Module`` (:class:`GIN`) holding the reference's
names: ``layers/<i>/{w1, b1, w2, b2, eps}``, ``out_w``, ``out_b``;
:func:`gnn_params_from_reference` carries the reference's weights across.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import GNNConfig
from ..core.device import resolve_device
from .segment import GatherRows, SegmentSum


class GIN(nn.Module):
    """``layers`` (one ParameterDict a layer: w1 (d_in, H), b1 (H,), w2 (H,
    H), b2 (H,), eps ()), ``out_w`` (H, n_classes), ``out_b`` (n_classes,)."""

    def __init__(self, cfg: GNNConfig, d_feat: int, n_classes: int, device):
        super().__init__()
        p = lambda *shape: nn.Parameter(  # noqa: E731
            torch.empty(shape, dtype=torch.float32, device=device))
        h, layers, d_in = cfg.d_hidden, [], d_feat
        for _ in range(cfg.n_layers):
            layers.append(nn.ParameterDict({"w1": p(d_in, h), "b1": p(h), "w2": p(h, h),
                                            "b2": p(h), "eps": p()}))
            d_in = h
        self.layers = nn.ModuleList(layers)
        self.out_w = p(h, n_classes)
        self.out_b = p(n_classes)


@torch.no_grad()
def init_params(cfg: GNNConfig, generator: torch.Generator, d_feat: int, n_classes: int,
                device="cuda") -> GIN:
    """Random weights drawn with ``generator`` on ``device``: matrices N(0, 1)
    / sqrt(fan-in), biases and eps zeros (the reference's init; the numbers
    differ from ``jax.random``'s)."""
    dev = resolve_device(device)
    model = GIN(cfg, d_feat, n_classes, dev)
    for name, p in model.named_parameters():
        if p.dim() == 2:
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[0]), generator=generator)
        else:
            p.zero_()
    return model


@torch.no_grad()
def gnn_params_from_reference(cfg: GNNConfig, params: dict, device="cuda") -> GIN:
    """The reference's ``gnn.init_params`` output, as a nested dict of NumPy
    arrays (``jax.tree.map(np.asarray, params)``), as the port's model."""
    dev = resolve_device(device)
    d_feat, n_classes = np.shape(params["layers"][0]["w1"])[0], np.shape(params["out_w"])[1]
    model = GIN(cfg, d_feat, n_classes, dev)
    if set(params) != {"layers", "out_w", "out_b"} or len(params["layers"]) != cfg.n_layers:
        raise KeyError(f"reference params hold {sorted(params)}, expected layers / out_w / "
                       f"out_b with {cfg.n_layers} layers")
    pairs = [(model.out_w, params["out_w"]), (model.out_b, params["out_b"])]
    for lp, src in zip(model.layers, params["layers"]):
        if set(src) != set(lp):
            raise KeyError(f"reference layer holds {sorted(src)}, expected {sorted(lp)}")
        pairs += [(lp[k], src[k]) for k in lp]
    for dst, src in pairs:
        a = np.array(src, dtype=np.float32)
        if a.shape != tuple(dst.shape):
            raise ValueError(f"reference array of shape {a.shape} for a parameter of "
                             f"shape {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(a))
    return model


def _gin_layer(lp, h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               n_nodes: int, split=None) -> torch.Tensor:
    # W1 before the gather / scatter (W1 sum_u h_u == sum_u W1 h_u); messages
    # rounded to bf16, summed in float32 (autograd rounds each message's
    # gradient to bf16 too, as the reference's two casts do).  On a split
    # graph h and the result are the rank's nodes, src / dst its edges: hw is
    # gathered from every rank and the float32 partial over every node
    # reduce-scattered back
    hw = h @ lp["w1"]
    every = hw if split is None else split.gather(hw)
    msg = SegmentSum.apply(GatherRows.apply(every, src).to(torch.bfloat16).float(), dst, n_nodes)
    if split is not None:
        msg = split.scatter(msg)
    z = (1.0 + lp["eps"]) * hw + msg
    z = F.relu(z + lp["b1"])
    return F.relu(z @ lp["w2"] + lp["b2"])


def forward_node(cfg: GNNConfig, params: GIN, node_feat: torch.Tensor,
                 edge_src: torch.Tensor, edge_dst: torch.Tensor, split=None) -> torch.Tensor:
    """Node classification logits (N, n_classes).  ``split``: the rank's
    part of a graph split over mesh axes (``sharding.gnn_split.GraphSplit``:
    ``n`` ranks, ``gather`` / ``scatter`` over them); the features are then
    its nodes, the edges its edges, and the logits its nodes'."""
    n = node_feat.shape[0] * (1 if split is None else split.n)
    h = node_feat
    for lp in params.layers:
        h = _gin_layer(lp, h, edge_src, edge_dst, n, split)
    return h @ params.out_w + params.out_b


def forward_graph_batch(cfg: GNNConfig, params: GIN, node_feat: torch.Tensor,
                        edge_src: torch.Tensor, edge_dst: torch.Tensor) -> torch.Tensor:
    """Batched small graphs: node_feat (B, n, F), edges (B, E) -> (B,
    classes).  The B graphs run as one graph of B * n nodes (graph b's node
    i is node b * n + i), the reference's vmap over them."""
    b, n, f = node_feat.shape
    shift = (torch.arange(b, device=edge_src.device) * n)[:, None]
    src = (edge_src.long() + shift).reshape(-1)
    dst = (edge_dst.long() + shift).reshape(-1)
    h = node_feat.reshape(b * n, f)
    for lp in params.layers:
        h = _gin_layer(lp, h, src, dst, b * n)
    pooled = h.reshape(b, n, -1).sum(dim=1)  # sum readout
    return pooled @ params.out_w + params.out_b


def pad_graph_batch(batch: dict, multiple: int, shard_axes=None, mesh=None) -> dict:
    """Pad node / edge arrays to a multiple of ``multiple``: padded edges
    point at a padded node (mask False, never read).  With ``shard_axes`` and
    ``mesh``, the rank's slice of the padded nodes, edges and per-node labels
    and mask over those axes (``sharding.gnn_split``: what a rank holds of
    the reference's constrained arrays); without a mesh ``shard_axes`` is
    refused."""
    if mesh is not None and shard_axes is not None:
        from ..sharding.gnn_split import GraphSplit, pad_and_split

        return pad_and_split(batch, multiple, GraphSplit(mesh, shard_axes))
    if shard_axes is not None:
        raise NotImplementedError(
            f"shard_axes={shard_axes!r} is a mesh sharding constraint of the reference on "
            f"activations; give a mesh (mesh=) to split the graph over those axes, or train "
            f"with repro_torch.sharding.spmd.make_sharded_train_step")
    n = batch["node_feat"].shape[0]
    e = batch["edge_src"].shape[0]
    npad = (-n) % multiple
    epad = (-e) % multiple
    if epad and not npad:
        npad = multiple  # padded edges need a padded node to point at
    out = dict(batch)
    out["node_feat"] = F.pad(batch["node_feat"], (0, 0, 0, npad))
    if epad:
        fill = torch.full((epad,), n, dtype=batch["edge_src"].dtype,
                          device=batch["edge_src"].device)
        out["edge_src"] = torch.cat([batch["edge_src"], fill])
        out["edge_dst"] = torch.cat([batch["edge_dst"], fill])
    if npad and batch["labels"].shape[0] == n:
        out["labels"] = F.pad(batch["labels"], (0, npad))
        out["train_mask"] = F.pad(batch["train_mask"], (0, npad))
    return out


def masked_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                count: torch.Tensor | None = None):
    """``(loss, {"nll", "acc"})``: the NLL of ``labels`` summed over
    ``mask`` and the masked accuracy, each divided by the mask's count
    (``count``: the whole mask's, of which ``mask`` is a rank's part)."""
    labels, m = labels.long(), mask.float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    denom = torch.clamp(m.sum() if count is None else count, min=1.0)
    loss = torch.sum(nll * m) / denom
    acc = torch.sum((logits.argmax(dim=-1) == labels).float() * m) / denom
    return loss, {"nll": loss, "acc": acc.detach()}


def loss_fn(cfg: GNNConfig, params: GIN, batch: dict):
    """``(loss, {"nll", "acc"})``: the masked mean NLL of the labels (on the
    seed rows of a mini-batch block) and the masked accuracy."""
    if batch["node_feat"].dim() == 3:
        logits = forward_graph_batch(cfg, params, batch["node_feat"], batch["edge_src"],
                                     batch["edge_dst"])
    else:
        logits = forward_node(cfg, params, batch["node_feat"], batch["edge_src"],
                              batch["edge_dst"])
        if batch["labels"].shape[0] != logits.shape[0]:
            # mini-batch block: loss only on the seed nodes (first b rows)
            logits = logits[: batch["labels"].shape[0]]
    return masked_loss(logits, batch["labels"], batch["train_mask"])
