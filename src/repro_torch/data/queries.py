"""Synthetic serving traffic over a collection (shared by the serve launcher,
the example, and the throughput benchmark).

Query strings in the planner's surface syntax (`engine.parse_query`):
``w`` (word), ``w1 w2`` (AND), ``"w1 w2"`` (phrase sampled from real text,
like the paper's query sets), ``top<k>: w1 w2`` (ranked AND),
``rank<k>: w1 w2`` (BM25 ranked disjunction),
``docs: w1 w2`` / ``docs: "w1 w2"`` (document listing) and
``docs-top<k>: ...`` (ranked document retrieval).
"""

from __future__ import annotations

import numpy as np

from .text import tokenize

MIX_KINDS = ("word", "and", "phrase", "topk", "docs", "rank")


def sample_traffic(mix: str, n: int, docs: list[str], vocab_words: list[str],
                   rng: np.random.Generator, n_terms: int = 2,
                   k: int = 10) -> list[str]:
    """n query strings of kind ``mix`` (one of MIX_KINDS, plus
    "docs-phrase" / "docs-topk", or "mixed" for a round-robin of the
    MIX_KINDS)."""

    def rand_word() -> str:
        return vocab_words[int(rng.integers(len(vocab_words)))]

    def rand_and() -> str:
        return " ".join(rand_word() for _ in range(n_terms))

    def rand_phrase() -> str:
        doc = docs[int(rng.integers(len(docs)))]
        toks = tokenize(doc)
        i = int(rng.integers(0, max(1, len(toks) - n_terms)))
        return '"' + " ".join(toks[i : i + n_terms]) + '"'

    gens = {"word": rand_word, "and": rand_and, "phrase": rand_phrase,
            "topk": lambda: f"top{k}: {rand_and()}",
            "rank": lambda: f"rank{k}: {rand_and()}",
            "docs": lambda: f"docs: {rand_and()}",
            "docs-phrase": lambda: f"docs: {rand_phrase()}",
            "docs-topk": lambda: f"docs-top{k}: {rand_and()}"}
    if mix == "mixed":
        return [gens[MIX_KINDS[i % len(MIX_KINDS)]]() for i in range(n)]
    return [gens[mix]() for _ in range(n)]
