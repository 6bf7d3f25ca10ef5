"""Posting-list codecs (classical baselines + the paper's new methods)."""

from .base import (
    CODEC_REGISTRY,
    STORE_REGISTRY,
    Codec,
    EncodedList,
    ListStore,
    PerListStore,
    register_codec,
    register_store,
)
from .vbyte import VByte, vbyte_decode_array, vbyte_encode_array
from .rice import Rice, RiceRuns
from .simple9 import Simple9
from .pfordelta import OptPFD, PForDelta
from .elias_fano import EliasFano, PartitionedEF
from .interpolative import Interpolative
from .elias import Delta, Gamma
from .lz_codecs import VbyteLZMA

__all__ = [
    "CODEC_REGISTRY",
    "STORE_REGISTRY",
    "Codec",
    "EncodedList",
    "ListStore",
    "PerListStore",
    "register_codec",
    "register_store",
    "VByte",
    "Rice",
    "RiceRuns",
    "Simple9",
    "PForDelta",
    "OptPFD",
    "EliasFano",
    "PartitionedEF",
    "Interpolative",
    "VbyteLZMA",
    "Gamma",
    "Delta",
    "vbyte_encode_array",
    "vbyte_decode_array",
]
