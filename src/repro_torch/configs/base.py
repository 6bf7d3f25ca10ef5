"""Config dataclasses for all supported architecture families.

Every architecture is a frozen dataclass with its *full* (paper-exact)
dimensions plus a ``reduced()`` method producing a CPU-smoke-test-sized
variant of the same family.  ``input_specs(shape_name)`` yields tensors on
the ``meta`` device (shape and dtype, no storage) for every model input of
that shape, where the reference yields ``jax.ShapeDtypeStruct`` stand-ins; no
allocation ever happens for full configs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch


# ----------------------------------------------------------------------
# shape specs
# ----------------------------------------------------------------------
def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """A stand-in for one model input: shape and dtype, no storage."""
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | graph_full | graph_mini | graph_batch
    dims: dict[str, Any] = field(default_factory=dict)


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    "long_500k": ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "graph_full",
                               {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7}),
    "minibatch_lg": ShapeSpec("minibatch_lg", "graph_mini",
                              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
                               "fanout": (15, 10), "d_feat": 602, "n_classes": 41}),
    "ogb_products": ShapeSpec("ogb_products", "graph_full",
                              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100, "n_classes": 47}),
    "molecule": ShapeSpec("molecule", "graph_batch",
                          {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 7, "n_classes": 2}),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
}


# ----------------------------------------------------------------------
# LM configs
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    router_aux_weight: float = 0.001


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    moe: MoEConfig | None = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "block"  # none | block | full  (activation checkpointing)
    moe_groups: int = 1  # token groups for MoE dispatch (== data shards)
    moe_dp_axes: Any = None  # mesh axes for MoE sharding constraints
    moe_ep_axis: Any = None
    source: str = ""

    family = "lm"
    shapes = LM_SHAPES

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---------------- parameter counting ----------------
    def n_params(self) -> int:
        d, h = self.d_model, self.head_dim
        attn = d * h * self.n_heads + 2 * d * h * self.n_kv_heads + h * self.n_heads * d
        if self.moe:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_ff_expert
            ffn += self.moe.n_shared_experts * 3 * d * self.moe.d_ff_expert
            ffn += d * self.moe.n_experts  # router
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d  # + norms
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def n_active_params(self) -> int:
        if not self.moe:
            return self.n_params()
        d = self.d_model
        h = self.head_dim
        attn = d * h * self.n_heads + 2 * d * h * self.n_kv_heads + h * self.n_heads * d
        ffn = (self.moe.top_k + self.moe.n_shared_experts) * 3 * d * self.moe.d_ff_expert
        ffn += d * self.moe.n_experts
        per_layer = attn + ffn + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    # ---------------- dry-run inputs ----------------
    def input_specs(self, shape_name: str) -> dict[str, torch.Tensor]:
        s = self.shapes[shape_name]
        b = s.dims["global_batch"]
        t = s.dims["seq_len"]
        if s.kind == "train":
            return {
                "tokens": _spec((b, t), torch.int32),
                "targets": _spec((b, t), torch.int32),
            }
        if s.kind == "prefill":
            return {"tokens": _spec((b, t), torch.int32)}
        if s.kind == "decode":
            nk = self.n_kv_heads
            hd = self.head_dim
            return {
                "tokens": _spec((b, 1), torch.int32),
                "positions": _spec((b,), torch.int32),
                "kv_cache": _spec((self.n_layers, 2, b, t, nk, hd), torch.bfloat16),
            }
        raise ValueError(shape_name)

    def reduced(self) -> "LMConfig":
        moe = None
        if self.moe:
            moe = replace(self.moe, n_experts=4, top_k=2, d_ff_expert=64)
        return replace(
            self, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=512, moe=moe, dtype="float32",
        )


# ----------------------------------------------------------------------
# GNN configs
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 64
    aggregator: str = "sum"
    learnable_eps: bool = True
    dtype: str = "float32"
    source: str = ""

    family = "gnn"
    shapes = GNN_SHAPES

    def n_params(self, d_feat: int = 1433, n_classes: int = 7) -> int:
        p = d_feat * self.d_hidden + self.d_hidden
        for _ in range(self.n_layers - 1):
            p += 2 * (self.d_hidden * self.d_hidden + self.d_hidden)  # 2-layer MLP per GIN layer
        p += self.d_hidden * n_classes + n_classes
        return p

    def input_specs(self, shape_name: str) -> dict[str, torch.Tensor]:
        s = self.shapes[shape_name]
        d = s.dims
        f32, i32 = torch.float32, torch.int32
        if s.kind == "graph_full":
            return {
                "node_feat": _spec((d["n_nodes"], d["d_feat"]), f32),
                "edge_src": _spec((d["n_edges"],), i32),
                "edge_dst": _spec((d["n_edges"],), i32),
                "labels": _spec((d["n_nodes"],), i32),
                "train_mask": _spec((d["n_nodes"],), torch.bool),
            }
        if s.kind == "graph_mini":
            # two-hop sampled block: layer sizes from fanout
            b = d["batch_nodes"]
            f1, f2 = d["fanout"]
            n1 = b * f1
            n2 = n1 * f2
            n_sub = b + n1 + n2
            e_sub = n1 + n2  # one edge per sampled neighbor
            return {
                "node_feat": _spec((n_sub, d["d_feat"]), f32),
                "edge_src": _spec((e_sub,), i32),
                "edge_dst": _spec((e_sub,), i32),
                "labels": _spec((b,), i32),
                "train_mask": _spec((b,), torch.bool),
            }
        if s.kind == "graph_batch":
            b = d["batch"]
            return {
                "node_feat": _spec((b, d["n_nodes"], d["d_feat"]), f32),
                "edge_src": _spec((b, d["n_edges"]), i32),
                "edge_dst": _spec((b, d["n_edges"]), i32),
                "labels": _spec((b,), i32),
                "train_mask": _spec((b,), torch.bool),
            }
        raise ValueError(shape_name)

    def reduced(self) -> "GNNConfig":
        return replace(self, n_layers=2, d_hidden=16)


# ----------------------------------------------------------------------
# RecSys configs
# ----------------------------------------------------------------------
def criteo_vocab_sizes(scale: float = 1.0) -> tuple[int, ...]:
    """39 fields: 13 dense-bucketized + 26 categorical, Criteo-like skew."""
    sizes = [64] * 13  # bucketized numeric
    cat = [
        1_000_000, 800_000, 500_000, 300_000, 200_000, 100_000, 50_000, 20_000,
        10_000, 10_000, 5_000, 5_000, 2_000, 2_000, 1_000, 1_000,
        500, 500, 200, 200, 100, 100, 50, 50, 20, 10,
    ]
    sizes += [max(4, int(c * scale)) for c in cat]
    return tuple(sizes)


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    interaction: str  # fm-2way | cin | self-attn-seq | dot
    embed_dim: int
    field_vocab_sizes: tuple[int, ...] = ()
    mlp_dims: tuple[int, ...] = ()
    cin_layers: tuple[int, ...] = ()
    # sasrec
    n_items: int = 0
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    # two-tower
    tower_mlp: tuple[int, ...] = ()
    n_users: int = 0
    dtype: str = "float32"
    source: str = ""

    family = "recsys"
    shapes = RECSYS_SHAPES

    @property
    def n_fields(self) -> int:
        return len(self.field_vocab_sizes)

    def n_params(self) -> int:
        p = sum(self.field_vocab_sizes) * self.embed_dim
        if self.interaction == "fm-2way":
            p += sum(self.field_vocab_sizes)  # linear terms
        if self.interaction == "cin":
            m = self.n_fields
            prev = m
            for h in self.cin_layers:
                p += h * m * prev
                prev = h
            dims = [self.n_fields * self.embed_dim] + list(self.mlp_dims) + [1]
            for a, b in zip(dims[:-1], dims[1:]):
                p += a * b + b
        if self.interaction == "self-attn-seq":
            p += self.n_items * self.embed_dim + self.seq_len * self.embed_dim
            p += self.n_blocks * (4 * self.embed_dim * self.embed_dim + 2 * self.embed_dim * 4)
        if self.interaction == "dot":
            p += (self.n_users + self.n_items) * self.embed_dim
            for t in (self.tower_mlp, self.tower_mlp):
                dims = [self.embed_dim * 16] + list(t)
                for a, b in zip(dims[:-1], dims[1:]):
                    p += a * b + b
        return p

    def input_specs(self, shape_name: str) -> dict[str, torch.Tensor]:
        s = self.shapes[shape_name]
        b = s.dims["batch"]
        i32, f32 = torch.int32, torch.float32
        if self.interaction == "self-attn-seq":
            d = {
                "hist": _spec((b, self.seq_len), i32),
                "target": _spec((b,), i32),
            }
            if s.kind == "train":
                d["labels"] = _spec((b, self.seq_len), i32)
                d["negatives"] = _spec((b, self.seq_len), i32)
            if s.kind == "retrieval":
                d = {
                    "hist": _spec((b, self.seq_len), i32),
                    "candidates": _spec((s.dims["n_candidates"],), i32),
                }
            return d
        if self.interaction == "dot":
            nf = 16  # user feature fields
            d = {"user_feats": _spec((b, nf), i32)}
            if s.kind == "retrieval":
                d["candidates"] = _spec((s.dims["n_candidates"],), i32)
            else:
                d["item_ids"] = _spec((b,), i32)
                if s.kind == "train":
                    d["labels"] = _spec((b,), f32)
            return d
        # fm / cin (field-wise categorical)
        d = {"fields": _spec((b, self.n_fields), i32)}
        if s.kind == "train":
            d["labels"] = _spec((b,), f32)
        if s.kind == "retrieval":
            d = {
                "fields": _spec((b, self.n_fields), i32),
                "candidates": _spec((s.dims["n_candidates"], self.n_fields), i32),
            }
        return d

    def reduced(self) -> "RecsysConfig":
        small_vocab = tuple(min(v, 50) for v in self.field_vocab_sizes)
        return replace(
            self,
            embed_dim=min(self.embed_dim, 8),
            field_vocab_sizes=small_vocab,
            mlp_dims=tuple(min(m, 16) for m in self.mlp_dims),
            cin_layers=tuple(min(c, 8) for c in self.cin_layers),
            n_items=min(self.n_items, 100) if self.n_items else 0,
            seq_len=min(self.seq_len, 10) if self.seq_len else 0,
            n_blocks=min(self.n_blocks, 1) if self.n_blocks else 0,
            tower_mlp=tuple(min(m, 16) for m in self.tower_mlp),
            n_users=min(self.n_users, 100) if self.n_users else 0,
        )
