"""Graph data: synthetic generators + the fanout neighbor sampler.

``NeighborSampler`` implements real layered fanout sampling (GraphSAGE
style, fanout 15-10 for minibatch_lg): CSR adjacency, per-layer uniform
sampling with replacement-free truncation, emitting the block's node list
and edge index in the layout the GIN model consumes.  NumPy only, the
reference's module (``repro.data.graphs``) as it is: the same seed gives the
same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Graph:
    n_nodes: int
    edge_src: np.ndarray
    edge_dst: np.ndarray
    node_feat: np.ndarray
    labels: np.ndarray

    @property
    def n_edges(self) -> int:
        return len(self.edge_src)


def synthetic_graph(n_nodes: int, avg_degree: int, d_feat: int, n_classes: int,
                    seed: int = 0, homophily: float = 0.7) -> Graph:
    """Community-structured random graph (labels correlate with communities)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes)
    n_edges = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, n_edges)
    # homophilous edges: most targets share the source's label
    same = rng.random(n_edges) < homophily
    dst = np.where(
        same,
        _random_same_label(rng, labels, src, n_classes),
        rng.integers(0, n_nodes, n_edges),
    )
    centers = rng.normal(size=(n_classes, d_feat)) * 2.0
    feat = centers[labels] + rng.normal(size=(n_nodes, d_feat))
    return Graph(n_nodes, src.astype(np.int32), dst.astype(np.int32),
                 feat.astype(np.float32), labels.astype(np.int32))


def _random_same_label(rng, labels, src, n_classes):
    by_label = [np.flatnonzero(labels == c) for c in range(n_classes)]
    out = np.empty(len(src), dtype=np.int64)
    for c in range(n_classes):
        m = labels[src] == c
        pool = by_label[c]
        out[m] = pool[rng.integers(0, len(pool), m.sum())]
    return out


class NeighborSampler:
    """Layered fanout sampling over CSR adjacency."""

    def __init__(self, graph: Graph, seed: int = 0):
        self.g = graph
        order = np.argsort(graph.edge_dst, kind="stable")
        self.nbr_src = graph.edge_src[order]  # in-neighbors of each node
        self.indptr = np.zeros(graph.n_nodes + 1, dtype=np.int64)
        counts = np.bincount(graph.edge_dst, minlength=graph.n_nodes)
        self.indptr[1:] = np.cumsum(counts)
        self.rng = np.random.default_rng(seed)

    def sample_block(self, seed_nodes: np.ndarray, fanout: tuple[int, ...]) -> dict:
        """Returns padded arrays matching the minibatch input_specs layout:
        nodes = seeds + layer1 + layer2 ...; one edge per sampled neighbor
        (sampled src -> its target node)."""
        nodes = [seed_nodes.astype(np.int64)]
        edge_src_local: list[np.ndarray] = []
        edge_dst_local: list[np.ndarray] = []
        frontier = seed_nodes.astype(np.int64)
        base = 0
        for f in fanout:
            deg = self.indptr[frontier + 1] - self.indptr[frontier]
            # uniform sample f neighbors per frontier node (with replacement
            # when degree < f; isolated nodes self-loop)
            offs = (self.rng.random((len(frontier), f)) * np.maximum(deg, 1)[:, None]).astype(np.int64)
            nbrs = self.nbr_src[np.minimum(self.indptr[frontier][:, None] + offs,
                                           len(self.nbr_src) - 1)]
            nbrs = np.where(deg[:, None] > 0, nbrs, frontier[:, None])
            new_base = base + len(frontier)
            layer_nodes = nbrs.reshape(-1)
            nodes.append(layer_nodes)
            # edges: sampled neighbor (local id in new layer) -> its target
            edge_src_local.append(np.arange(len(layer_nodes)) + new_base)
            edge_dst_local.append(np.repeat(np.arange(len(frontier)) + base, f))
            frontier = layer_nodes
            base = new_base
        all_nodes = np.concatenate(nodes)
        return {
            "node_feat": self.g.node_feat[all_nodes],
            "edge_src": np.concatenate(edge_src_local).astype(np.int32),
            "edge_dst": np.concatenate(edge_dst_local).astype(np.int32),
            "labels": self.g.labels[seed_nodes].astype(np.int32),
            "train_mask": np.ones(len(seed_nodes), bool),
        }


def graph_batches(graph: Graph, batch_nodes: int, fanout: tuple[int, ...], seed: int = 0):
    sampler = NeighborSampler(graph, seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        seeds = rng.integers(0, graph.n_nodes, batch_nodes)
        yield sampler.sample_block(seeds, fanout)


def molecule_batches(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                     n_classes: int, seed: int = 0):
    """Batched small graphs (TU-style graph classification)."""
    rng = np.random.default_rng(seed)
    while True:
        feat = rng.normal(size=(batch, n_nodes, d_feat)).astype(np.float32)
        src = rng.integers(0, n_nodes, (batch, n_edges)).astype(np.int32)
        dst = rng.integers(0, n_nodes, (batch, n_edges)).astype(np.int32)
        # label = parity of a feature statistic (learnable)
        labels = (feat.mean((1, 2)) > 0).astype(np.int32) % n_classes
        yield {"node_feat": feat, "edge_src": src, "edge_dst": dst,
               "labels": labels, "train_mask": np.ones(batch, bool)}
