"""Streaming synthetic versioned collections — scale without residency.

:func:`repro_torch.data.collection.generate_collection` materializes the whole
collection as one Python list, which caps it at what fits in RAM; the
scale benchmarks need collections 100× the test sizes, streamed straight
into :class:`~repro_torch.core.writer.IndexWriter` commits.  This module is the
streaming twin:

* :class:`SyntheticSpec` pins the collection — article count, versions
  per article, document length, vocabulary, edit rate, branching factor,
  seed.  The same spec always streams the same documents (seeded
  generator; no global state), so a benchmark's differential spot-check
  can regenerate any chunk independently.

* :func:`stream_collection` yields the collection in **chunks of
  documents** (one commit batch each).  Memory is bounded by the chunk
  plus one live parent version per article — never the collection: each
  article keeps only the version(s) a future edit script may branch
  from, bounded by ``branching``.

Edits between versions are the word-level insert/delete/substitute
scripts of the eager generator at a configurable rate, so the streamed
collections are highly repetitive in exactly the way the paper's
universal indexes exploit — and the way compaction's merged stores
compress.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .collection import _make_word, _mutate


@dataclass(frozen=True)
class SyntheticSpec:
    """One reproducible streamed collection.

    ``branching == 1`` is linear versioning (each version edits the
    latest); ``branching > 1`` is tree-style — every version edits one of
    the article's last ``branching`` versions, chosen by the seeded
    generator.  ``chunk_docs`` is the streaming granularity (one
    :meth:`~repro_torch.core.writer.IndexWriter.commit` batch per chunk).
    """

    n_articles: int = 20
    versions_per_article: int = 25
    words_per_doc: int = 300
    vocab_size: int = 2000
    edit_rate: float = 0.02
    branching: int = 1
    chunk_docs: int = 256
    seed: int = 0

    @property
    def n_docs(self) -> int:
        return self.n_articles * self.versions_per_article

    def approx_bytes(self) -> int:
        """Rough collection size (words_per_doc × ~6 bytes/word) — for
        sizing a benchmark run before streaming it."""
        return self.n_docs * self.words_per_doc * 6

    def config(self) -> dict:
        from dataclasses import asdict

        return asdict(self)


def _build_vocab(spec: SyntheticSpec, rng: np.random.Generator) -> list[str]:
    vocab: list[str] = []
    seen: set[str] = set()
    while len(vocab) < spec.vocab_size:
        w = _make_word(rng)
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    return vocab


def stream_collection(spec: SyntheticSpec):
    """Yield the spec's collection as lists of document strings, one chunk
    (≤ ``spec.chunk_docs`` docs) at a time, in version order per article
    round-robin — version v of every article streams before version v+1
    of any, so near-copies land in different commit batches and the
    segment structure exercises cross-segment repetitiveness.

    Never holds the collection: live state is the vocabulary plus the
    last ``branching`` versions of each article (the only documents a
    future edit script may branch from).
    """
    if spec.branching < 1:
        raise ValueError(f"branching must be >= 1, got {spec.branching}")
    if spec.chunk_docs < 1:
        raise ValueError(f"chunk_docs must be >= 1, got {spec.chunk_docs}")
    rng = np.random.default_rng(spec.seed)
    vocab = _build_vocab(spec, rng)
    probs = 1.0 / np.arange(1, spec.vocab_size + 1) ** 1.1
    probs /= probs.sum()

    # per-article ring of the last `branching` versions (word lists)
    tails: list[list[list[str]]] = []
    chunk: list[str] = []
    for v in range(spec.versions_per_article):
        for a in range(spec.n_articles):
            if v == 0:
                words = [vocab[int(i)] for i in rng.choice(
                    spec.vocab_size, size=spec.words_per_doc, p=probs)]
                tails.append([words])
            else:
                tail = tails[a]
                parent = tail[int(rng.integers(len(tail)))]
                words = _mutate(parent, rng, spec.edit_rate, vocab)
                tail.append(words)
                if len(tail) > spec.branching:
                    del tail[0]
            chunk.append(" ".join(words))
            if len(chunk) >= spec.chunk_docs:
                yield chunk
                chunk = []
    if chunk:
        yield chunk


def ingest_stream(writer, spec: SyntheticSpec, max_docs: int | None = None,
                  commit_every: int = 1) -> int:
    """Stream the spec into ``writer`` — one commit per ``commit_every``
    chunks — and return the number of documents ingested.  ``max_docs``
    truncates the stream (benchmark smoke modes); a partial trailing
    buffer is still committed."""
    ingested = 0
    chunks_buffered = 0
    for chunk in stream_collection(spec):
        if max_docs is not None and ingested + len(chunk) > max_docs:
            chunk = chunk[:max_docs - ingested]
        if chunk:
            writer.add_documents(chunk)
            ingested += len(chunk)
            chunks_buffered += 1
        if chunks_buffered >= commit_every and writer._pending:
            writer.commit()
            chunks_buffered = 0
        if max_docs is not None and ingested >= max_docs:
            break
    if writer._pending:
        writer.commit()
    return ingested
