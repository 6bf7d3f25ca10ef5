"""Versioned document collections, made from the run's seed.

A frozen copy of the port's ``data/collection.py`` generator (linear,
tree and chaotic versioning; word-level insert / delete / substitute edits at
a fixed rate over a Zipf-sampled base text), kept here so that the inputs of
every run are the benchmark's and no change to the program changes them.

Two changes, so that every seed gets the same sizes: the vocabulary (the
words and their Zipf ranks) comes from the configuration's ``vocab_seed`` and
the texts and edits from its ``text_seed``; the run's seed then renames the
words, each to another word of the same length (stop words keep their names).
Renaming changes no posting list, no document's bytes and no list length, so
the index's shape and the window counts are the same for every seed, while
the words a seed's queries name, and so their answers, differ.  With
everything drawn from the run's seed, the collection's bytes moved by ±5 %
and the windows a batch sweeps by ±2 % from seed to seed (1,000 documents).
"""

from __future__ import annotations

import numpy as np

from .text import STOPWORDS

_CONSONANTS = "bcdfghjklmnpqrstvwz"
_VOWELS = "aeiou"


def _make_word(rng: np.random.Generator) -> str:
    n_syll = int(rng.integers(1, 4))
    return "".join(
        _CONSONANTS[int(rng.integers(len(_CONSONANTS)))] + _VOWELS[int(rng.integers(len(_VOWELS)))]
        for _ in range(n_syll)
    ) + (_CONSONANTS[int(rng.integers(len(_CONSONANTS)))] if rng.random() < 0.4 else "")


def _mutate(words: list[str], rng: np.random.Generator, rate: float,
            vocab: list[str]) -> list[str]:
    out: list[str] = []
    i, n = 0, len(words)
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
    return out or [vocab[0]]


def generate(seed: int, n_articles: int, versions_per_article: int, words_per_doc: int,
             vocab_size: int = 2000, edit_rate: float = 0.02, structure: str = "linear",
             vocab_seed: int = 0, text_seed: int = 0) -> list[str]:
    """The documents of one collection, in document-id order."""
    vrng = np.random.default_rng(vocab_seed)
    vocab: list[str] = []
    seen: set[str] = set()
    while len(vocab) < vocab_size:
        w = _make_word(vrng)
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    rng = np.random.default_rng(text_seed)
    probs = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
    probs /= probs.sum()
    docs_words: list[list[str]] = []
    for _ in range(n_articles):
        base = [vocab[int(i)] for i in rng.choice(vocab_size, size=words_per_doc, p=probs)]
        versions = [base]
        for _ in range(1, versions_per_article):
            if structure == "linear":
                parent = versions[-1]
            elif structure == "tree":
                parent = versions[int(rng.integers(len(versions)))]
            elif structure == "chaotic":
                pool = docs_words + versions
                parent = pool[int(rng.integers(len(pool)))]
            else:
                raise ValueError(f"unknown structure {structure!r}")
            versions.append(_mutate(parent, rng, edit_rate, vocab))
        docs_words.extend(versions)
    if structure == "chaotic":
        order = np.arange(len(docs_words))
        rng.shuffle(order)
        docs_words = [docs_words[i] for i in order]
    name = rename(vocab, seed)
    return [" ".join(name[w] for w in ws) for ws in docs_words]


def rename(vocab: list[str], seed: int) -> dict[str, str]:
    """A renaming of ``vocab`` drawn from ``seed``: each word to a word of the
    same length, stop words to themselves."""
    rng = np.random.default_rng(seed)
    out = {w: w for w in vocab if w in STOPWORDS}
    by_len: dict[int, list[str]] = {}
    for w in vocab:
        if w not in STOPWORDS:
            by_len.setdefault(len(w), []).append(w)
    for n in sorted(by_len):
        words = by_len[n]
        out.update(zip(words, (words[i] for i in rng.permutation(len(words)))))
    return out
