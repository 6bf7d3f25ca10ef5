"""The plain reference index: worked out from the documents alone.

Plain Python and NumPy over the frozen tokenizer of ``pbench.text``.  It
imports nothing of the program and reads nothing the program made; the
answers of each query kind are in ``port_bench/reference/<kind>.py``, found
by the kind's name.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

from .text import tokenize, word_term

REFERENCE_DIR = Path(__file__).resolve().parent.parent / "reference"


class RefIndex:
    """Word and positional posting lists of one collection.

    * ``docs_of(term)``: sorted ids of the documents whose analyzed words
      hold ``term``;
    * ``positions_of(token)``: sorted offsets of ``token`` in the stream of
      every document's tokens, each document followed by one separator, so
      that no phrase spans two documents.
    """

    def __init__(self, docs: list[str], tokens: list[list[str]] | None = None):
        self.n_docs = len(docs)
        self.collection_bytes = sum(len(d) for d in docs)
        self.tokens = [tokenize(d) for d in docs] if tokens is None else tokens
        postings: dict[str, list[int]] = {}
        for d, toks in enumerate(self.tokens):
            for term in dict.fromkeys(t for t in map(word_term, toks) if t is not None):
                postings.setdefault(term, []).append(d)
        self._docs = {t: np.asarray(v, dtype=np.int64) for t, v in postings.items()}
        self._positions: dict[str, np.ndarray] | None = None

    def docs_of(self, word: str) -> np.ndarray:
        """Documents of a query word, analyzed as the index's words are."""
        term = word_term(word)
        return self._docs.get(term, np.zeros(0, dtype=np.int64)) if term else np.zeros(
            0, dtype=np.int64)

    def positions_of(self, token: str) -> np.ndarray:
        if self._positions is None:
            self._positions = self._build_positions()
        return self._positions.get(token, np.zeros(0, dtype=np.int64))

    def _build_positions(self) -> dict[str, np.ndarray]:
        lists: dict[str, list[int]] = {}
        pos = 0
        for toks in self.tokens:
            for t in toks:
                lists.setdefault(t, []).append(pos)
                pos += 1
            pos += 1  # the document's separator
        return {t: np.asarray(v, dtype=np.int64) for t, v in lists.items()}


def load_kind(kind: str):
    """The reference module of one query kind (``reference/<kind>.py``)."""
    path = REFERENCE_DIR / f"{kind}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference for query kind {kind!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"pb_reference_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Reference:
    """Answers queries of any kind whose reference file exists, each distinct
    query once."""

    def __init__(self, ref: RefIndex):
        self.ref = ref
        self._kinds: dict[str, object] = {}
        self._memo: dict[tuple, np.ndarray] = {}

    def answer(self, query) -> np.ndarray:
        """``query`` is a ``pbench.traffic.Query``."""
        key = (query.kind, query.text)
        got = self._memo.get(key)
        if got is None:
            mod = self._kinds.get(query.kind)
            if mod is None:
                mod = self._kinds[query.kind] = load_kind(query.kind)
            got = self._memo[key] = mod.answer(self.ref, query.terms)
        return got
