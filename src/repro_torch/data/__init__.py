"""Seeded collection and query-traffic generators (NumPy, host side)."""

from .collection import VersionedCollection, generate_collection
from .synthetic import SyntheticSpec, ingest_stream, stream_collection
from .text import STOPWORDS, Vocabulary, detokenize, tokenize

__all__ = [
    "Vocabulary",
    "tokenize",
    "detokenize",
    "STOPWORDS",
    "VersionedCollection",
    "generate_collection",
    "SyntheticSpec",
    "ingest_stream",
    "stream_collection",
]
