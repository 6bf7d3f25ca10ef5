"""Posting-list codecs: the codec/store interfaces and per-list Vbyte."""

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
    "vbyte_encode_array",
    "vbyte_decode_array",
]
