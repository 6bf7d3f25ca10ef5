"""Document listing and ranked document retrieval (the new workload).

The paper's indexes answer *where* a pattern occurs (postings / stream
positions).  Document listing asks for the *distinct documents* containing
it — on highly repetitive collections the number of distinct documents is
typically far below the number of occurrences, and the same run/grammar
regularities the stores exploit for space make listing answerable without
touching every occurrence:

* :func:`positions_to_docs` / :func:`positions_to_doc_counts` — the generic
  reducer: map any backend's position answers to distinct documents (and
  per-document pattern frequencies) through the document-boundary array.
  Works for every registered backend, device or host.

* :class:`DocRunIndex` — an ILCP-style structure in the spirit of Gagie
  et al., "Document Retrieval on Repetitive String Collections": because a
  token's stream positions are increasing, its *document array* is
  non-decreasing, so it run-length encodes into one ``(doc, count)`` run
  per distinct document.  Precomputing (or caching) those runs answers
  single-term listing in time proportional to the number of distinct
  documents, and the run lengths are exactly the per-document term
  frequencies needed for ranked (top-k) retrieval.

* :func:`grammar_doc_runs` — the grammar-aware fast path in the spirit of
  Cobas & Navarro, "Fast, Small, and Simple Document Listing on Repetitive
  Text Collections": walk the Re-Pair sequence ``C`` of a list and use the
  *phrase sums* (§4.1 skip data) to bound the absolute range each
  compressed phrase covers.  A phrase whose range falls inside one document
  contributes ``(doc, phrase_len)`` without being expanded; only phrases
  straddling a document boundary are opened.  On repetitive collections
  most grammar phrases repeat within versions of one document, so listing
  cost tracks C-entries + boundary crossings, not occurrences.

Backends with a sub-occurrence listing path declare the ``doc_list``
capability (``CAP_DOC_LIST``): the Re-Pair family (this grammar walk) and
the self-index family (one whole-pattern ``locate`` + reduce).
"""

from __future__ import annotations

import numpy as np

from .registry import CAP_DOC_LIST, capabilities_of


# ----------------------------------------------------------------------
# generic reducer: positions -> distinct documents
# ----------------------------------------------------------------------
def positions_to_docs(positions: np.ndarray,
                      doc_starts: np.ndarray | None = None) -> np.ndarray:
    """Distinct (sorted) document ids of ``positions``.

    ``doc_starts`` is the stream offset where each document begins; when it
    is ``None`` the positions already *are* document ids (non-positional
    postings) and only deduplication is applied.
    """
    pos = np.asarray(positions, dtype=np.int64)
    if doc_starts is None:
        return np.unique(pos)
    d = np.searchsorted(doc_starts, pos, side="right") - 1
    return np.unique(d)


def positions_to_doc_counts(positions: np.ndarray,
                            doc_starts: np.ndarray | None = None
                            ) -> tuple[np.ndarray, np.ndarray]:
    """(distinct docs, per-doc occurrence counts) of ``positions``."""
    pos = np.asarray(positions, dtype=np.int64)
    if doc_starts is None:
        d = pos
    else:
        d = np.searchsorted(doc_starts, pos, side="right") - 1
    docs, counts = np.unique(d, return_counts=True)
    return docs.astype(np.int64), counts.astype(np.int64)


def rank_docs(docs: np.ndarray, scores: np.ndarray, k: int) -> np.ndarray:
    """Top-``k`` docs by score, ties broken by lowest doc id (``docs`` is
    sorted ascending, so a stable sort on -score gives that order)."""
    order = np.argsort(-np.asarray(scores), kind="stable")
    return np.asarray(docs, dtype=np.int64)[order][:k]


# ----------------------------------------------------------------------
# BM25 scoring (the `rank<k>:` relevance model)
# ----------------------------------------------------------------------
# Okapi BM25 with the non-negative idf variant: every matching term
# contributes a strictly positive score, so score > 0 <=> some query term
# occurs — the property the device top-k uses to mask padding.
BM25_K1 = 1.2
BM25_B = 0.75


def bm25_idf(df: int, n_docs: int) -> float:
    """ln(1 + (N - df + 0.5) / (df + 0.5)) — positive for every df <= N."""
    return float(np.log1p((n_docs - df + 0.5) / (df + 0.5)))


def bm25_tf_weight(tf, dl, avgdl: float,
                   k1: float = BM25_K1, b: float = BM25_B):
    """tf·(k1+1) / (tf + k1·(1 − b + b·dl/avgdl)); vectorized, float64."""
    tf = np.asarray(tf, dtype=np.float64)
    dl = np.asarray(dl, dtype=np.float64)
    return (tf * (k1 + 1.0)) / (tf + k1 * (1.0 - b + b * dl / max(avgdl, 1e-9)))


def bm25_upper_bound(df: int, max_tf: int, n_docs: int,
                     k1: float = BM25_K1, b: float = BM25_B) -> float:
    """Largest score any single document can draw from this term: idf times
    the tf weight at the term's max tf and the most favorable (dl → 0)
    length normalization.  Safe for WAND/MaxScore pruning: no document's
    contribution can exceed it."""
    if df <= 0 or max_tf <= 0:
        return 0.0
    w = (max_tf * (k1 + 1.0)) / (max_tf + k1 * (1.0 - b))
    return bm25_idf(df, n_docs) * w


# ----------------------------------------------------------------------
# grammar-aware fast path (Re-Pair stores)
# ----------------------------------------------------------------------
def grammar_doc_runs(store, i: int, doc_starts: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(distinct docs, per-doc counts) of list ``i`` of a Re-Pair store.

    Walks the C-sequence accumulating phrase sums: entry ``j`` starting at
    cumulative gap ``run`` covers absolute postings in
    ``[run, run + sum - 1]`` (postings are ``cumsum(gaps) - 1`` and gaps are
    >= 1).  When both range ends land in the same document the whole phrase
    contributes ``symbol_len`` occurrences of that document *without being
    expanded*; only boundary-straddling phrases are opened.
    """
    doc_starts = np.asarray(doc_starts, dtype=np.int64)
    lo, hi = int(store.c_offsets[i]), int(store.c_offsets[i + 1])
    docs: list[int] = []
    counts: list[int] = []

    def add(d: int, n: int) -> None:
        if docs and docs[-1] == d:
            counts[-1] += n
        else:
            docs.append(d)
            counts.append(n)

    run = 0
    for j in range(lo, hi):
        sym = int(store.c[j])
        ssum = store.symbol_sum(sym)
        d_lo = int(np.searchsorted(doc_starts, run, side="right")) - 1
        d_hi = int(np.searchsorted(doc_starts, run + ssum - 1, side="right")) - 1
        if d_lo == d_hi:
            # the whole compressed phrase lies inside one document: its
            # postings are in [run, run+ssum-1] which d_lo..d_hi brackets
            add(d_hi, store.symbol_len(sym))
        else:
            pos = np.cumsum(store.expand_symbol(sym)) + run - 1
            ds = np.searchsorted(doc_starts, pos, side="right") - 1
            for d, n in zip(*np.unique(ds, return_counts=True)):
                add(int(d), int(n))
        run += ssum
    return (np.asarray(docs, dtype=np.int64),
            np.asarray(counts, dtype=np.int64))


def _decode_doc_runs(store, i: int, doc_starts: np.ndarray | None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Decode-and-reduce fallback for backends without a listing path."""
    return positions_to_doc_counts(store.get_list(i), doc_starts)


class DocRunIndex:
    """Per-list document runs over a positional store (ILCP-style).

    For each posting list, the non-decreasing document array collapses to
    one run per distinct document; ``list_docs`` / ``list_doc_counts``
    answer single-term document listing and term-frequency lookups in
    O(distinct docs).  Runs are materialized through the store's best path:
    the grammar walk for ``doc_list``-capable Re-Pair stores, decode+reduce
    otherwise.  With ``precompute=True`` all lists are materialized up
    front (the precomputed doc-boundary/run structure); otherwise runs are
    cached on first touch.
    """

    def __init__(self, store, doc_starts: np.ndarray, precompute: bool = False):
        self.store = store
        self.doc_starts = np.asarray(doc_starts, dtype=np.int64)
        self._grammar = (CAP_DOC_LIST in capabilities_of(store)
                         and hasattr(store, "symbol_sum"))
        self._runs: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        if precompute:
            for i in range(store.n_lists):
                self.runs(i)

    def runs(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        got = self._runs.get(i)
        if got is None:
            if self._grammar:
                got = grammar_doc_runs(self.store, i, self.doc_starts)
            else:
                got = _decode_doc_runs(self.store, i, self.doc_starts)
            self._runs[i] = got
        return got

    def list_docs(self, i: int) -> np.ndarray:
        """Sorted distinct documents containing term ``i``."""
        return self.runs(i)[0]

    def list_doc_counts(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(docs, per-doc term frequency) for term ``i``."""
        return self.runs(i)

    def term_frequencies(self, i: int, docs: np.ndarray) -> np.ndarray:
        """tf of term ``i`` in each of ``docs`` (0 where absent)."""
        rd, rc = self.runs(i)
        docs = np.asarray(docs, dtype=np.int64)
        j = np.searchsorted(rd, docs)
        j = np.minimum(j, max(0, len(rd) - 1))
        out = np.zeros(len(docs), dtype=np.int64)
        if len(rd):
            hit = rd[j] == docs
            out[hit] = rc[j[hit]]
        return out

    @property
    def size_in_bits(self) -> int:
        """Exact bits of the materialized runs (32-bit doc ids + counts,
        plus one 32-bit list pointer per materialized list)."""
        bits = 0
        for d, c in self._runs.values():
            bits += 32 * (len(d) + len(c)) + 32
        return bits


# ----------------------------------------------------------------------
# full listing over an index store (any backend)
# ----------------------------------------------------------------------
def doc_list_terms(runs: DocRunIndex, term_ids: list[int]) -> np.ndarray:
    """Distinct docs containing ALL terms: intersect the per-term run docs
    (each already distinct and sorted, so pairwise intersect1d is exact)."""
    if not term_ids:
        return np.zeros(0, dtype=np.int64)
    order = sorted(term_ids, key=lambda t: len(runs.list_docs(t)))
    out = runs.list_docs(order[0])
    for t in order[1:]:
        if len(out) == 0:
            break
        out = np.intersect1d(out, runs.list_docs(t), assume_unique=True)
    return out
