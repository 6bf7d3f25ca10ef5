"""Synthetic highly-repetitive versioned document collections.

Mirrors the paper's experimental data (versioned Wikipedia subsets, Table 1)
at laptop scale, with the three versioning topologies the paper's
*universality* claim covers (§1, §6):

* ``linear``  — each article is a chain of versions (wiki-style);
* ``tree``    — versions branch from random earlier versions (VCS-style);
* ``chaotic`` — near-copies of random earlier documents, shuffled order, no
  identifiable versioning structure (DNA / crawl-style).

Edits between versions are word-level insert/delete/substitute operations at
a configurable rate, so d-gap lists exhibit exactly the regularities the
paper's methods exploit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_CONSONANTS = "bcdfghjklmnpqrstvwz"
_VOWELS = "aeiou"


def _make_word(rng: np.random.Generator) -> str:
    n_syll = int(rng.integers(1, 4))
    return "".join(
        _CONSONANTS[int(rng.integers(len(_CONSONANTS)))] + _VOWELS[int(rng.integers(len(_VOWELS)))]
        for _ in range(n_syll)
    ) + (_CONSONANTS[int(rng.integers(len(_CONSONANTS)))] if rng.random() < 0.4 else "")


@dataclass
class VersionedCollection:
    docs: list[str]
    structure: str
    article_of: np.ndarray  # article id per document (identity info; our
    # universal methods never read it — it exists for the He-et-al-style
    # baselines and for Table-1 statistics)

    @property
    def n_docs(self) -> int:
        return len(self.docs)

    @property
    def total_bytes(self) -> int:
        return sum(len(d) for d in self.docs)

    def stats(self) -> dict:
        arts = int(self.article_of.max()) + 1 if len(self.article_of) else 0
        return {
            "size_bytes": self.total_bytes,
            "articles": arts,
            "versions": self.n_docs,
            "versions_per_article": self.n_docs / max(1, arts),
            "avg_bytes_per_version": self.total_bytes / max(1, self.n_docs),
            "structure": self.structure,
            # ground-truth cluster labels, doc id -> article id — for
            # purity/recall assertions; mining itself must never read these
            "article_of": self.article_of.tolist(),
        }

    def similar_pairs(self) -> set[tuple[int, int]]:
        """All ground-truth near-copy pairs ``(i, j)`` with ``i < j``: two
        docs are a pair iff they are versions of the same article.  The
        recall reference for mined clusterings."""
        pairs: set[tuple[int, int]] = set()
        arts = int(self.article_of.max()) + 1 if len(self.article_of) else 0
        for a in range(arts):
            members = np.flatnonzero(self.article_of == a)
            for k, i in enumerate(members):
                for j in members[k + 1:]:
                    pairs.add((int(i), int(j)))
        return pairs


def _mutate(words: list[str], rng: np.random.Generator, rate: float, vocab: list[str]) -> list[str]:
    out: list[str] = []
    i = 0
    n = len(words)
    while i < n:
        r = rng.random()
        if r < rate / 3:  # delete
            i += 1
        elif r < 2 * rate / 3:  # substitute
            out.append(vocab[int(rng.integers(len(vocab)))])
            i += 1
        elif r < rate:  # insert
            out.append(vocab[int(rng.integers(len(vocab)))])
        else:
            out.append(words[i])
            i += 1
    if not out:
        out = [vocab[0]]
    return out


def generate_collection(
    n_articles: int = 20,
    versions_per_article: int = 25,
    words_per_doc: int = 300,
    vocab_size: int = 2000,
    edit_rate: float = 0.02,
    structure: str = "linear",
    seed: int = 0,
) -> VersionedCollection:
    rng = np.random.default_rng(seed)
    vocab: list[str] = []
    seen: set[str] = set()
    while len(vocab) < vocab_size:
        w = _make_word(rng)
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    # zipf-ish word frequencies for base articles
    probs = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
    probs /= probs.sum()

    docs_words: list[list[str]] = []
    article_of: list[int] = []
    for a in range(n_articles):
        base = [vocab[int(i)] for i in rng.choice(vocab_size, size=words_per_doc, p=probs)]
        versions = [base]
        for v in range(1, versions_per_article):
            if structure == "linear":
                parent = versions[-1]
            elif structure == "tree":
                parent = versions[int(rng.integers(len(versions)))]
            elif structure == "chaotic":
                # near-copy of any earlier doc in the whole collection
                pool = docs_words + versions
                parent = pool[int(rng.integers(len(pool)))]
            else:
                raise ValueError(f"unknown structure {structure!r}")
            versions.append(_mutate(parent, rng, edit_rate, vocab))
        docs_words.extend(versions)
        article_of.extend([a] * versions_per_article)

    docs = [" ".join(ws) for ws in docs_words]
    order = np.arange(len(docs))
    if structure == "chaotic":
        rng.shuffle(order)  # destroy any doc-id locality
    return VersionedCollection(
        docs=[docs[i] for i in order],
        structure=structure,
        article_of=np.asarray(article_of, dtype=np.int64)[order],
    )
