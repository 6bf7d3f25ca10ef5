"""Inverted indexes over document collections (paper §3, §5, §6).

* :class:`NonPositionalIndex` — per word, the sorted doc-ids containing it.
  Word parsing mirrors the paper's §5.1.3 setup: case folding, no stemming,
  top-20 stopwords removed.  Conjunctive (AND) queries via the backend's
  capability-selected intersection path.

* :class:`PositionalIndex` — per token (words *and* separators, §5.2: the
  text is indexed as-is), the increasing global word offsets in the
  concatenation ``D`` of all documents (with per-document boundary
  separators against false phrase matches).  Phrase queries via offset-
  shifted intersection; positions translate to (doc, offset) through the
  stored array of document start positions.

Both are parameterized by a **registered backend** (``store="repair_skip"``,
``store="rlcsa"``, … — see :mod:`repro_torch.core.registry`).  Inverted-family
backends build from the posting lists; self-index-family backends build
from the token-id stream of the same collection and answer the same
queries (word / AND / phrase) through the same ``SearchBackend`` protocol.
All query dispatch goes through declared capabilities — there is no
store-type switching here.

The builds run on the host except where a kernel runs: version mining
(``mine_similarity=True``) and a backend whose build takes a ``device``
(``rlz``, which MinHash-signs its lists).  There ``device`` is the GPU unless
the caller asks for ``"cpu"``; every other build ignores it, so it needs no
GPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..data.text import Vocabulary, tokenize
from .analyzer import DEFAULT_ANALYZER, Analyzer, get_analyzer
from .registry import (
    FAMILY_SELFINDEX,
    BuildSource,
    build_backend,
    get_backend_spec,
)


def _build_store(spec, source: BuildSource, store_kw: dict, device):
    """Build the backend, handing ``device`` only to a builder that takes
    one (a device is not part of an index: it never joins ``store_kw``)."""
    extra = {"device": device} if "device" in spec.build_kwargs else {}
    return build_backend(spec.name, source, **store_kw, **extra)


# ----------------------------------------------------------------------
@dataclass(frozen=True)
class IndexStats:
    """Aggregate index statistics — the cost signal of the query-plan
    compiler (``serving.plan``): list lengths bound candidate counts,
    ``universe_size`` is the selectivity denominator, ``avgdl`` the BM25
    length-normalization pivot (0.0 when no scoring statistics exist)."""

    n_lists: int
    n_postings: int
    universe_size: int
    avg_list_length: float
    max_list_length: int
    avgdl: float = 0.0


def _compute_stats(store, universe: int, scoring=None) -> IndexStats:
    lengths = [store.list_length(i) for i in range(store.n_lists)]
    total = int(sum(lengths))
    return IndexStats(
        n_lists=store.n_lists, n_postings=total, universe_size=int(universe),
        avg_list_length=round(total / max(1, store.n_lists), 2),
        max_list_length=int(max(lengths, default=0)),
        avgdl=0.0 if scoring is None else round(scoring.avgdl, 2))


# ----------------------------------------------------------------------
@dataclass
class ScoringStats:
    """Per-term (doc, tf) runs + per-doc lengths — the ranked-retrieval
    substrate (Gagie et al., *Document Retrieval on Repetitive String
    Collections*): each term's run is its ascending doc-id list with the
    in-document frequency alongside.  Stored index-level (independent of
    the backend's compressed posting representation) so every backend
    family ranks identically; persisted as artifact components and merged
    across segments on commit/compact."""

    doc_lengths: np.ndarray  # int64[n_docs] — analyzed terms kept per doc
    run_docs: np.ndarray     # int64[n_postings] — concatenated doc runs
    run_tfs: np.ndarray      # int64[n_postings] — tf aligned with run_docs
    run_offsets: np.ndarray  # int64[n_lists + 1]
    max_tf: np.ndarray       # int64[n_lists] — per-term tf upper input

    @property
    def n_docs(self) -> int:
        return len(self.doc_lengths)

    @property
    def total_terms(self) -> int:
        return int(self.doc_lengths.sum())

    @property
    def avgdl(self) -> float:
        return self.total_terms / max(1, self.n_docs)

    def df(self, tid: int) -> int:
        return int(self.run_offsets[tid + 1] - self.run_offsets[tid])

    def term_runs(self, tid: int) -> tuple[np.ndarray, np.ndarray]:
        """(ascending doc ids, aligned term frequencies) of one term."""
        lo, hi = int(self.run_offsets[tid]), int(self.run_offsets[tid + 1])
        return self.run_docs[lo:hi], self.run_tfs[lo:hi]

    def term_max_tf(self, tid: int) -> int:
        return int(self.max_tf[tid])

    @property
    def size_in_bits(self) -> int:
        return 64 * (len(self.doc_lengths) + len(self.run_docs)
                     + len(self.run_tfs) + len(self.run_offsets)
                     + len(self.max_tf))


class _StatsMixin:
    """Shared stats surface (both index classes expose ``lookup`` /
    ``universe_size`` / ``store``)."""

    def stats(self) -> IndexStats:
        """Aggregate statistics (computed once, cached)."""
        cached = self.__dict__.get("_stats")
        if cached is None:
            cached = _compute_stats(self.store, self.universe_size,
                                    getattr(self, "scoring", None))
            self.__dict__["_stats"] = cached
        return cached

    def term_length(self, term: str) -> int:
        """Posting-list length of ``term`` (0 when out of vocabulary) —
        the per-term cost-model input."""
        tid = self.lookup(term)
        return 0 if tid is None else int(self.store.list_length(tid))


# ----------------------------------------------------------------------
@dataclass
class NonPositionalIndex(_StatsMixin):
    vocab: Vocabulary
    store: object  # any SearchBackend
    n_docs: int
    collection_bytes: int
    store_name: str
    doc_starts: np.ndarray | None = None  # only set for self-index backends
    store_kw: dict = field(default_factory=dict)  # build kwargs (persisted)
    analyzer: Analyzer | None = None      # build-time analysis chain
    scoring: ScoringStats | None = None   # BM25 substrate (doc runs + dl)
    similarity: object | None = None      # mined SimilarityIndex (optional)

    @classmethod
    def build(cls, docs: list[str], store: str = "repair_skip", case_fold: bool = True,
              drop_stopwords: bool = True, analyzer=None, mine_similarity: bool = False,
              similarity_config=None, device="cuda", **store_kw) -> "NonPositionalIndex":
        """Index ``docs`` with backend ``store``.  ``mine_similarity=True``
        also mines the version structure (``similarity_config``: a
        ``MinHashConfig`` or its dict), signing the documents on ``device``;
        an ``rlz`` store signs its lists there too."""
        spec = get_backend_spec(store)  # unknown name -> ValueError up front
        if analyzer is None:
            analyzer = Analyzer(case_fold=case_fold, drop_stopwords=drop_stopwords)
        else:
            analyzer = get_analyzer(analyzer)
        vocab = Vocabulary()
        postings: dict[int, list[int]] = {}
        tf_lists: dict[int, list[int]] = {}
        need_stream = spec.family == FAMILY_SELFINDEX
        stream: list[int] = []
        doc_starts = np.zeros(len(docs), dtype=np.int64)
        doc_lengths = np.zeros(len(docs), dtype=np.int64)
        doc_terms: list[list[int]] | None = [] if mine_similarity else None
        for d, doc in enumerate(docs):
            doc_starts[d] = len(stream)
            if doc_terms is not None:
                doc_terms.append([])
            for tok in tokenize(doc):
                w = analyzer.normalize(tok)
                if w is None:
                    continue
                doc_lengths[d] += 1
                wid = vocab.add(w)
                if need_stream:
                    stream.append(wid)
                if doc_terms is not None:
                    doc_terms[d].append(wid)
                plist = postings.setdefault(wid, [])
                tfs = tf_lists.setdefault(wid, [])
                if plist and plist[-1] == d:
                    tfs[-1] += 1
                else:
                    plist.append(d)
                    tfs.append(1)
        lists = [np.asarray(postings.get(w, []), dtype=np.int64) for w in range(len(vocab))]
        run_offsets = np.zeros(len(vocab) + 1, dtype=np.int64)
        max_tf = np.zeros(len(vocab), dtype=np.int64)
        flat_tfs: list[int] = []
        for w in range(len(vocab)):
            tl = tf_lists.get(w, [])
            run_offsets[w + 1] = run_offsets[w] + len(tl)
            max_tf[w] = max(tl, default=0)
            flat_tfs.extend(tl)
        scoring = ScoringStats(
            doc_lengths=doc_lengths,
            run_docs=(np.concatenate(lists) if lists
                      else np.zeros(0, dtype=np.int64)),
            run_tfs=np.asarray(flat_tfs, dtype=np.int64),
            run_offsets=run_offsets, max_tf=max_tf)
        source = BuildSource(
            lists=lists, n_docs=len(docs),
            stream=np.asarray(stream, dtype=np.int64) if need_stream else None,
            doc_starts=doc_starts if need_stream else None,
            doc_lists=True)
        built = _build_store(spec, source, store_kw, device)
        similarity = None
        if mine_similarity:
            from .similarity import MinHashConfig, SimilarityIndex

            similarity = SimilarityIndex.mine(
                [np.asarray(t, dtype=np.int64) for t in doc_terms],
                MinHashConfig.from_config(similarity_config)
                if not isinstance(similarity_config, MinHashConfig)
                else similarity_config,
                device=device)
        return cls(vocab=vocab, store=built, n_docs=len(docs),
                   collection_bytes=sum(len(d) for d in docs), store_name=store,
                   doc_starts=doc_starts if need_stream else None,
                   store_kw=dict(store_kw), analyzer=analyzer, scoring=scoring,
                   similarity=similarity)

    def word_id(self, w: str) -> int | None:
        # exact vocabulary hit first: index terms are already analyzed and
        # analysis is not idempotent (re-stemming an analyzed term can map
        # it elsewhere), so an already-analyzed query term must resolve to
        # itself before the chain runs
        wid = self.vocab.get(w)
        if wid is not None:
            return wid
        term = (self.analyzer or DEFAULT_ANALYZER).normalize(w)
        return None if term is None else self.vocab.get(term)

    # uniform term lookup for the planner/serving layers
    lookup = word_id

    @property
    def universe_size(self) -> int:
        """The id universe postings live in (idf denominator)."""
        return self.n_docs

    def query_word(self, w: str) -> np.ndarray:
        wid = self.word_id(w)
        if wid is None:
            return np.zeros(0, dtype=np.int64)
        return self.store.get_list(wid)

    def query_and(self, words: list[str]) -> np.ndarray:
        ids = []
        for w in words:
            wid = self.word_id(w)
            if wid is None:
                return np.zeros(0, dtype=np.int64)
            ids.append(wid)
        return self.store.intersect_multi(ids)

    @property
    def size_in_bits(self) -> int:
        return self.store.size_in_bits

    @property
    def space_fraction(self) -> float:
        """index_size / original_size (paper's space metric)."""
        return (self.size_in_bits / 8) / self.collection_bytes


# ----------------------------------------------------------------------
DOC_SEP = "\x00"


@dataclass
class PositionalIndex(_StatsMixin):
    vocab: Vocabulary
    store: object  # any SearchBackend
    doc_starts: np.ndarray  # word offset where each document begins in D
    n_tokens: int
    collection_bytes: int
    store_name: str
    token_stream: np.ndarray | None = None  # kept only when keep_text=True
    store_kw: dict = field(default_factory=dict)  # build kwargs (persisted)

    @classmethod
    def build(cls, docs: list[str], store: str = "repair_skip", keep_text: bool = False,
              device="cuda", **store_kw) -> "PositionalIndex":
        """Index the token stream of ``docs`` with backend ``store`` (an
        ``rlz`` store signs its lists on ``device``)."""
        spec = get_backend_spec(store)  # unknown name -> ValueError up front
        vocab = Vocabulary()
        sep_id = vocab.add(DOC_SEP)
        stream: list[int] = []
        doc_starts = np.zeros(len(docs), dtype=np.int64)
        for d, doc in enumerate(docs):
            doc_starts[d] = len(stream)
            stream.extend(vocab.add(t) for t in tokenize(doc))
            stream.append(sep_id)
        tok = np.asarray(stream, dtype=np.int64)
        postings: list[list[int]] = [[] for _ in range(len(vocab))]
        for pos, t in enumerate(stream):
            postings[t].append(pos)
        # the separator list is not part of the index (never queried)
        lists = [np.asarray(postings[w], dtype=np.int64) if w != sep_id else np.zeros(0, dtype=np.int64)
                 for w in range(len(vocab))]
        source = BuildSource(
            lists=lists, n_docs=len(docs),
            stream=tok if spec.family == FAMILY_SELFINDEX else None,
            doc_starts=doc_starts, sep_id=sep_id)
        built = _build_store(spec, source, store_kw, device)
        return cls(vocab=vocab, store=built, doc_starts=doc_starts, n_tokens=len(tok),
                   collection_bytes=sum(len(d) for d in docs), store_name=store,
                   token_stream=tok if keep_text else None,
                   store_kw=dict(store_kw))

    def token_id(self, t: str) -> int | None:
        return self.vocab.get(t)

    # uniform term lookup for the planner/serving layers
    lookup = token_id

    @property
    def universe_size(self) -> int:
        """The id universe postings live in (idf denominator)."""
        return self.n_tokens

    def query_word(self, w: str) -> np.ndarray:
        tid = self.token_id(w)
        if tid is None:
            return np.zeros(0, dtype=np.int64)
        return self.store.get_list(tid)

    def query_phrase(self, tokens: list[str]) -> np.ndarray:
        """Positions of the first token of each phrase occurrence."""
        ids = []
        for t in tokens:
            tid = self.token_id(t)
            if tid is None:
                return np.zeros(0, dtype=np.int64)
            ids.append(tid)
        if len(ids) == 1:
            return self.store.get_list(ids[0])
        return self.store.intersect_shifted(ids, list(range(len(ids))))

    def positions_to_docs(self, positions: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Translate global offsets to (doc id, in-doc word offset) (§3)."""
        d = np.searchsorted(self.doc_starts, positions, side="right") - 1
        return d, positions - self.doc_starts[d]

    @property
    def size_in_bits(self) -> int:
        return self.store.size_in_bits + 32 * len(self.doc_starts)

    @property
    def space_fraction(self) -> float:
        return (self.size_in_bits / 8) / self.collection_bytes
