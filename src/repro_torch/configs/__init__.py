"""Architecture registry: ``get_config("qwen3-8b")`` etc."""

from .archs import (
    FM,
    GIN_TU,
    GRANITE_3_2B,
    KIMI_K2_1T_A32B,
    LLAMA3_2_3B,
    MOONSHOT_V1_16B_A3B,
    QWEN3_8B,
    SASREC,
    TWO_TOWER,
    UIHRDC,
    XDEEPFM,
)
from .base import GNNConfig, LMConfig, MoEConfig, RecsysConfig, ShapeSpec

ARCH_REGISTRY = {
    c.name: c
    for c in [
        MOONSHOT_V1_16B_A3B,
        KIMI_K2_1T_A32B,
        QWEN3_8B,
        LLAMA3_2_3B,
        GRANITE_3_2B,
        GIN_TU,
        XDEEPFM,
        SASREC,
        FM,
        TWO_TOWER,
        UIHRDC,
    ]
}

# the 40 assigned (arch x shape) dry-run cells
ASSIGNED_ARCHS = [
    "moonshot-v1-16b-a3b",
    "kimi-k2-1t-a32b",
    "qwen3-8b",
    "llama3.2-3b",
    "granite-3-2b",
    "gin-tu",
    "xdeepfm",
    "sasrec",
    "fm",
    "two-tower-retrieval",
]


def get_config(name: str):
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for a in ASSIGNED_ARCHS:
        for s in get_config(a).shapes:
            cells.append((a, s))
    return cells


__all__ = [
    "ARCH_REGISTRY",
    "ASSIGNED_ARCHS",
    "get_config",
    "all_cells",
    "LMConfig",
    "MoEConfig",
    "GNNConfig",
    "RecsysConfig",
    "ShapeSpec",
]
