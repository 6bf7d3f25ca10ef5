"""The ten assigned architectures (+ the paper's own index-service config).

Dimensions are verbatim from the assignment (public-literature configs);
``source`` records the provenance tag.
"""

from __future__ import annotations

import torch

from .base import _spec, GNNConfig, LMConfig, MoEConfig, RecsysConfig, ShapeSpec, criteo_vocab_sizes

# ----------------------------------------------------------------------
# LM-family transformers (5)
# ----------------------------------------------------------------------
MOONSHOT_V1_16B_A3B = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408),
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)

KIMI_K2_1T_A32B = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048),
    source="arXiv:2501.kimi2; unverified (paper-table)",
)

QWEN3_8B = LMConfig(
    name="qwen3-8b",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12288,
    vocab_size=151936, qk_norm=True,
    source="hf:Qwen/Qwen3-8B; hf",
)

LLAMA3_2_3B = LMConfig(
    name="llama3.2-3b",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab_size=128256,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)

GRANITE_3_2B = LMConfig(
    name="granite-3-2b",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab_size=49155,
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)

# ----------------------------------------------------------------------
# GNN (1)
# ----------------------------------------------------------------------
GIN_TU = GNNConfig(
    name="gin-tu",
    n_layers=5, d_hidden=64, aggregator="sum", learnable_eps=True,
    source="arXiv:1810.00826; paper",
)

# ----------------------------------------------------------------------
# RecSys (4)
# ----------------------------------------------------------------------
XDEEPFM = RecsysConfig(
    name="xdeepfm",
    interaction="cin",
    embed_dim=10,
    field_vocab_sizes=criteo_vocab_sizes(),
    cin_layers=(200, 200, 200),
    mlp_dims=(400, 400),
    source="arXiv:1803.05170; paper",
)

SASREC = RecsysConfig(
    name="sasrec",
    interaction="self-attn-seq",
    embed_dim=50,
    n_items=1_000_000,
    seq_len=50,
    n_blocks=2,
    n_heads=1,
    source="arXiv:1808.09781; paper",
)

FM = RecsysConfig(
    name="fm",
    interaction="fm-2way",
    embed_dim=10,
    field_vocab_sizes=criteo_vocab_sizes(),
    source="ICDM'10 (Rendle); paper",
)

TWO_TOWER = RecsysConfig(
    name="two-tower-retrieval",
    interaction="dot",
    embed_dim=256,
    tower_mlp=(1024, 512, 256),
    n_items=10_000_000,
    n_users=10_000_000,
    source="RecSys'19 (YouTube); unverified",
)


# ----------------------------------------------------------------------
# the paper's own architecture: the uiHRDC batched index service
# ----------------------------------------------------------------------
class UIHRDCConfig:
    """Anchored Re-Pair index as a batched TPU query service (DESIGN.md §2).

    Device-resident arrays: anchors (prefix sums of phrase sums over C),
    per-list offsets, bounded expansion table.  A query batch is a padded
    (batch, max_terms) matrix of term ids; the serve step intersects via
    vectorized binary search over anchors.
    """

    name = "uihrdc"
    family = "index"
    dtype = "int32"
    source = "this paper"

    n_terms = 1_000_000
    c_entries = 16_000_000  # compressed symbols across all lists
    expand_len = 32  # bounded per-symbol expansion table width
    max_terms = 8

    shapes = {
        "serve_4k": ShapeSpec("serve_4k", "serve", {"batch": 4096}),
        "serve_64k": ShapeSpec("serve_64k", "serve", {"batch": 65536}),
    }

    def input_specs(self, shape_name: str) -> dict[str, torch.Tensor]:
        b = self.shapes[shape_name].dims["batch"]
        return {
            "query_terms": _spec((b, self.max_terms), torch.int32),
            "query_lens": _spec((b,), torch.int32),
        }

    def reduced(self) -> "UIHRDCConfig":
        r = UIHRDCConfig()
        r.n_terms = 1000
        r.c_entries = 8000
        return r

    def n_params(self) -> int:
        return 0


UIHRDC = UIHRDCConfig()
