"""`Session` — the one serving entry point over compiled query plans.

A :class:`Session` owns the built indexes (non-positional and/or
positional), the optional batched device servers, a **plan cache**, and the
host execution operators.  Everything flows through two methods:

* :meth:`Session.execute` — serve one query or a heterogeneous batch.
  Every query is parsed, routed through the plan compiler
  (``serving.plan.route_query``), and grouped with the other queries that
  share its **physical plan shape**: device-routed queries of one shape
  (index, kind, k, phrase-ness, padded width bucket) run as a single
  padded device batch, so they share one cached device step; host-routed
  queries execute through the capability-selected operators.  Routes are
  cached keyed by ``plan_key`` (plan structure × backend × batch bucket) —
  a repeated traffic shape performs **zero re-plans and builds zero new
  device steps** (see :meth:`metrics`).

* :meth:`Session.explain` — the costed physical operator tree for a query
  as text or JSON, without executing it.

    sess = Session.build(index, positional=pidx)             # servers on the GPU
    sess = Session.build(index, positional=pidx, device="cpu")
    results = sess.execute(["w1 w2", '"a b"', "top5: w1 w2"])
    print(sess.explain('docs: "a b"'))
    print(sess.metrics())   # plan-cache hit rate, device-step builds, ...

``Session(index, positional=pidx)`` with no servers is the host-only
session: the paper's sequential algorithms, independent of the device steps.

``similar:`` / ``versions-of:`` answer from the similarity index that
``NonPositionalIndex.build(..., mine_similarity=True)`` mined.

**Not in this package yet.** :meth:`Session.open` / :meth:`Session.refresh`
(persisted artifacts, segmented collections) raise ``NotImplementedError``
naming the ROADMAP queue that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.doclist import (
    BM25_B,
    BM25_K1,
    DocRunIndex,
    bm25_idf,
    bm25_upper_bound,
    doc_list_terms,
    positions_to_doc_counts,
    positions_to_docs,
    rank_docs,
)
from ..core.index import NonPositionalIndex, PositionalIndex
from .plan import (
    AND,
    DOCS,
    DOCS_TOPK,
    GRAMMAR,
    PHRASE,
    RANK,
    SIMILAR,
    TOPK,
    VERSIONS,
    WORD,
    ParsedQuery,
    Route,
    compile_query,
    explain_json,
    explain_text,
    parse_query,
    plan_key,
    route_query,
    unparse,
)


@dataclass
class Session:
    """One serving session: indexes + device servers + plan cache."""

    index: NonPositionalIndex | None = None
    positional: PositionalIndex | None = None
    server: object | None = None  # device path over `index`
    positional_server: object | None = None  # device path over `positional`

    def __post_init__(self):
        self._plan_cache: dict[tuple, Route] = {}
        self._doc_run_index: DocRunIndex | None = None
        self.plans_compiled = 0
        self.plan_cache_hits = 0
        self.queries_executed = 0
        self.device_batches = 0
        # ranked retrieval: MaxScore pruning toggle + work counters
        # (a posting is one (doc, tf) run entry; scored + skipped = the
        # total postings of the query's term lists)
        self.rank_pruning = True
        self.rank_postings_scored = 0
        self.rank_postings_skipped = 0
        self.rank_lists_scored = 0
        self.rank_lists_skipped = 0

    # -- construction ---------------------------------------------------
    @classmethod
    def build(cls, index: NonPositionalIndex | None = None,
              positional: PositionalIndex | None = None, device="cuda",
              attach: bool = True, probe: str | None = None,
              expand_len: int = 32, layout: str = "auto") -> "Session":
        """Build a session over already-built indexes, attaching batched
        device servers on ``device`` (``"cuda"`` unless the caller asks for
        ``"cpu"``; without a GPU the default raises).  ``attach=False`` builds
        the host-only session.  Self-index backends always serve natively on
        the host (their ``locate`` answers whole patterns — no per-term probe
        loop to batch), so they get no server.  ``probe`` is ``"kernel"`` (the
        CUDA kernels; default on a GPU) or ``"torch"`` (plain tensor code;
        default on the CPU).  ``layout`` picks the device posting memory model
        ("dense" | "fused"; "auto" fuses device-resident Re-Pair stores,
        densifies the rest)."""
        from ..core.registry import FAMILY_SELFINDEX, get_backend_spec
        from .engine import BatchedServer

        def serve(ix):
            if not (attach and ix is not None
                    and get_backend_spec(ix.store_name).family != FAMILY_SELFINDEX):
                return None
            return BatchedServer.from_index(ix, expand_len=expand_len,
                                            probe=probe, layout=layout,
                                            device=device)

        return cls(index=index, positional=positional,
                   server=serve(index), positional_server=serve(positional))

    # -- persisted artifacts / segmented collections --------------------
    @classmethod
    def open(cls, path, **kw) -> "Session":
        """Serve a persisted index instead of rebuilding — not in this
        package yet."""
        raise NotImplementedError(
            "Session.open needs core/artifact and core/writer, which this "
            "package does not hold yet: ROADMAP.md, Queue A (artifact / "
            "storage / writer + Session.open/refresh)")

    def refresh(self) -> int:
        """Pick up segments committed by a live writer — not in this
        package yet."""
        raise NotImplementedError(
            "Session.refresh needs core/writer, which this package does not "
            "hold yet: ROADMAP.md, Queue A (artifact / storage / writer + "
            "Session.open/refresh)")

    @property
    def analyzer(self):
        """The analysis chain pinned into the served non-positional index
        (None when the session has no such index).  Ranked queries are
        analyzed with this chain before planning, so query terms match the
        index terms exactly."""
        return None if self.index is None else self.index.analyzer

    def _parse(self, q) -> ParsedQuery:
        """Parse ``q`` with the session's analyzer applied to ranked
        queries.  Already-analyzed ``ParsedQuery`` objects pass through
        untouched — stemming is not idempotent, so re-analysis would
        corrupt the terms."""
        a = self.analyzer
        if isinstance(q, ParsedQuery):
            if q.kind == RANK and not q.analyzed and a is not None:
                terms = a.query_terms(q.terms)
                if not terms:
                    raise ValueError(
                        f"the analyzer stripped every term from "
                        f"{unparse(q)!r} (stopwords / separators only); "
                        f"{GRAMMAR}")
                return ParsedQuery(RANK, terms, k=q.k, analyzed=True)
            return q
        return parse_query(q, analyzer=a)

    # -- planning -------------------------------------------------------
    def plan(self, q, prefer_device: bool = True) -> Route:
        """The (cached) routing decision for one query shape."""
        pq = self._parse(q)
        if not prefer_device:  # off-path (diagnostics): don't pollute the cache
            return route_query(self, pq, prefer_device=False)
        key = plan_key(self, pq)
        rt = self._plan_cache.get(key)
        if rt is None:
            rt = route_query(self, pq)
            self._plan_cache[key] = rt
            self.plans_compiled += 1
        else:
            self.plan_cache_hits += 1
        return rt

    def explain(self, q, fmt: str = "text", extract: int | None = None):
        """The costed physical plan for ``q`` — ``fmt="text"`` (operator
        tree, one node per line) or ``"json"`` (nested dict).  Does not
        execute the query and does not touch the execution counters."""
        raw = q if isinstance(q, str) else None
        cq = compile_query(self, self._parse(q), extract=extract)
        if fmt == "json":
            return explain_json(cq, raw=raw)
        if fmt != "text":
            raise ValueError(f"unknown explain format {fmt!r}; use 'text' or 'json'")
        return explain_text(cq, raw=raw)

    # -- metrics --------------------------------------------------------
    @property
    def jit_traces(self) -> int:
        """Device steps built across the attached servers: each server
        counts its step-cache misses per (kind, width, k, doclist) shape —
        the quantity the plan/batch bucketing minimizes.  (PyTorch runs
        eagerly, so there is no compile to count; the name is the one the
        metrics surface has always used.)"""
        return sum(int(getattr(s, "trace_count", 0))
                   for s in (self.server, self.positional_server) if s is not None)

    def metrics(self) -> dict:
        compiled, hits = self.plans_compiled, self.plan_cache_hits
        total = compiled + hits
        out = {
            "queries_executed": self.queries_executed,
            "device_batches": self.device_batches,
            "plans_compiled": compiled,
            "plan_cache_hits": hits,
            "plan_cache_hit_rate": round(hits / total, 4) if total else 0.0,
            "jit_traces": self.jit_traces,
        }
        rank = {
            "postings_scored": self.rank_postings_scored,
            "postings_skipped": self.rank_postings_skipped,
            "lists_scored": self.rank_lists_scored,
            "lists_skipped": self.rank_lists_skipped,
        }
        if any(rank.values()):
            scanned = rank["postings_scored"] + rank["postings_skipped"]
            rank["skip_fraction"] = (
                round(rank["postings_skipped"] / scanned, 4) if scanned else 0.0)
            out["ranked"] = rank
        return out

    # -- execution ------------------------------------------------------
    def execute(self, queries):
        """Serve one query (string / ``ParsedQuery`` → one array) or a
        heterogeneous batch (list/tuple of queries → list of arrays, in
        the original order).  Device-routed queries are grouped by
        physical-plan shape so each shape runs as one padded device batch
        through one cached step; host-routed queries run through the
        capability-selected operators."""
        single = isinstance(queries, (str, ParsedQuery))
        batch = [queries] if single else list(queries)
        parsed = [self._parse(q) for q in batch]
        routes = [self.plan(pq) for pq in parsed]
        self.queries_executed += len(batch)
        out: list[np.ndarray | None] = [None] * len(batch)
        groups: dict[tuple, list[int]] = {}
        for i, (pq, rt) in enumerate(zip(parsed, routes)):
            if rt.route == "device":
                key = (rt.index, pq.kind, pq.k, pq.phrase, rt.width)
                groups.setdefault(key, []).append(i)
            else:
                out[i] = self._execute_host(pq)
        for (index_name, kind, k, phrase, width), idxs in groups.items():
            server = self.server if index_name == "nonpositional" else self.positional_server
            sub = [list(parsed[i].terms) for i in idxs]
            if kind == TOPK:
                res = server.topk(sub, k=k or 10, width=width)
            elif kind == DOCS:
                res = server.doclist(sub, phrase=phrase, width=width)
            elif kind == PHRASE:
                res = server.phrase(sub, width=width)
            else:
                res = server.conjunctive(sub, width=width)
            self.device_batches += 1
            for i, r in zip(idxs, res):
                out[i] = r
        return out[0] if single else out

    def _doc_topk_scored(self, terms: list[str], k: int = 10,
                         phrase: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Top-``k`` docs by pattern frequency *with their scores* — the
        per-segment half of the segmented ``docs-top<k>`` merge."""
        docs = self._doc_list(terms, phrase=phrase)
        if len(docs) == 0:
            return docs, np.zeros(0, dtype=np.int64)
        if self.positional is None:
            docs = docs[:k]
            return docs, np.ones(len(docs), dtype=np.int64)
        if phrase and len(terms) > 1:
            pdocs, counts = positions_to_doc_counts(self._phrase(terms),
                                                    self.positional.doc_starts)
        else:
            runs = self.doc_runs()
            pdocs, counts = docs, np.zeros(len(docs), dtype=np.int64)
            for t in terms:
                tid = self.positional.lookup(t)
                if tid is not None:
                    counts = counts + runs.term_frequencies(tid, docs)
        top = rank_docs(pdocs, counts, k)
        pos = {int(d): i for i, d in enumerate(pdocs.tolist())}
        return top, np.asarray([counts[pos[int(d)]] for d in top.tolist()],
                               dtype=np.int64)

    def _execute_host(self, pq: ParsedQuery) -> np.ndarray:
        if pq.kind in (SIMILAR, VERSIONS):  # term-less by construction
            return self._similar(pq)
        if not pq.terms:  # defensive: manually built ParsedQuery
            return np.zeros(0, dtype=np.int64)
        if pq.kind == WORD:
            return self._word(pq.terms[0])
        if pq.kind == AND:
            return self._conjunctive(list(pq.terms))
        if pq.kind == PHRASE:
            return self._phrase(list(pq.terms))
        if pq.kind == TOPK:
            return self._ranked_and(list(pq.terms), k=pq.k or 10)
        if pq.kind == DOCS:
            return self._doc_list(list(pq.terms), phrase=pq.phrase)
        if pq.kind == DOCS_TOPK:
            return self._doc_topk(list(pq.terms), k=pq.k or 10, phrase=pq.phrase)
        if pq.kind == RANK:
            return self._rank(list(pq.terms), k=pq.k or 10)
        raise ValueError(pq.kind)

    # -- host physical operators (the paper's sequential algorithms) ----
    def _similar(self, pq: ParsedQuery) -> np.ndarray:
        """``similar:`` / ``versions-of:`` from the mined signature index
        (version-structure mining, ``repro_torch.core.similarity``)."""
        if self.index is None:
            raise ValueError(f"{unparse(pq)!r} requires the nonpositional "
                             f"index")
        sim = getattr(self.index, "similarity", None)
        if sim is None:
            raise ValueError(
                f"cannot answer {unparse(pq)!r}: the served index has no "
                f"similarity index — build with mine_similarity=True "
                f"(NonPositionalIndex.build / IndexWriter) so version "
                f"structure is mined and persisted")
        if not 0 <= pq.doc < sim.n_docs:
            raise ValueError(
                f"doc id {pq.doc} in {unparse(pq)!r} is out of range: the "
                f"collection has {sim.n_docs} documents (valid ids "
                f"0..{sim.n_docs - 1}); {GRAMMAR}")
        return (sim.versions_of(pq.doc) if pq.kind == VERSIONS
                else sim.similar(pq.doc))

    def _word(self, w: str) -> np.ndarray:
        if self.index is None:
            raise ValueError("word queries require the nonpositional index")
        return np.asarray(self.index.query_word(w))

    def _conjunctive(self, words: list[str]) -> np.ndarray:
        if self.index is None:
            raise ValueError("AND queries require the nonpositional index")
        return np.asarray(self.index.query_and(words))

    def _phrase(self, tokens: list[str]) -> np.ndarray:
        """Positions of the first token of each phrase occurrence (§5.2)."""
        if self.positional is None:
            raise ValueError("phrase queries require a PositionalIndex")
        return np.asarray(self.positional.query_phrase(list(tokens)))

    def _ranked_and(self, words: list[str], k: int = 10) -> np.ndarray:
        """Google-style ranked AND: intersect, then rank by term frequency
        proxy (shorter lists = rarer terms weigh more)."""
        docs = self._conjunctive(words)
        if len(docs) == 0:
            return docs
        weights = np.zeros(len(docs))
        for w in words:
            wid = self.index.word_id(w)
            if wid is None:
                continue
            ell = max(1, self.index.store.list_length(wid))
            weights += np.log1p(self.index.n_docs / ell)
        order = np.argsort(-weights, kind="stable")
        return docs[order][:k]

    # -- ranked retrieval (BM25 disjunction, MaxScore pruning) ----------
    def _rank(self, terms: list[str], k: int = 10) -> np.ndarray:
        docs, _ = self._rank_scored(terms, k=k)
        return docs

    def _rank_scored(self, terms: list[str],
                     k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """Top-``k`` docs by BM25 over the OR of ``terms`` with their
        scores, ties broken by lowest doc id.  Unknown terms contribute
        nothing.  With :attr:`rank_pruning` the term lists are visited in
        descending upper-bound order and traversal stops once the summed
        bounds of the remaining lists cannot displace the current k-th
        score (MaxScore) — every visited candidate is still scored against
        *all* query terms, so pruning never changes the answer."""
        if self.index is None:
            raise ValueError("rank queries require the nonpositional index")
        scoring = self.index.scoring
        if scoring is None:
            raise ValueError(
                f"rank queries need scoring statistics; the "
                f"{self.index.store_name!r} index was opened without them — "
                f"rebuild (or re-save) the index to record doc lengths and "
                f"term frequencies")
        empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64))
        n_docs, avgdl = scoring.n_docs, scoring.avgdl
        dl = scoring.doc_lengths
        lists = []  # (docs, tfs, idf, upper_bound) per known term
        for t in dict.fromkeys(terms):  # dedup, keep order
            tid = self.index.vocab.get(t)
            if tid is None:
                continue
            docs_t, tfs_t = scoring.term_runs(tid)
            if len(docs_t) == 0:
                continue
            df = len(docs_t)
            lists.append((docs_t, tfs_t.astype(np.float64), bm25_idf(df, n_docs),
                          bm25_upper_bound(df, scoring.term_max_tf(tid), n_docs)))
        if not lists:
            return empty
        lists.sort(key=lambda x: -x[3])
        n_terms = len(lists)
        suffix_ub = np.zeros(n_terms + 1)  # suffix_ub[j] = Σ ub of lists j..
        for j in range(n_terms - 1, -1, -1):
            suffix_ub[j] = suffix_ub[j + 1] + lists[j][3]
        prune = self.rank_pruning and n_terms > 1

        def score_all_terms(docs: np.ndarray) -> np.ndarray:
            """Full BM25 of each doc across every query term (float64)."""
            norm = BM25_K1 * (1.0 - BM25_B + BM25_B * dl[docs] / max(avgdl, 1e-9))
            s = np.zeros(len(docs))
            for docs_t, tfs_t, idf, _ in lists:
                pos = np.minimum(np.searchsorted(docs_t, docs), len(docs_t) - 1)
                hit = docs_t[pos] == docs
                tf = np.where(hit, tfs_t[pos], 0.0)
                s += idf * tf * (BM25_K1 + 1.0) / (tf + norm)
            return s

        cands = np.zeros(0, dtype=np.int64)
        cscores = np.zeros(0)
        theta = -np.inf  # current k-th best full score
        for j, (docs_t, _tfs, _idf, _ub) in enumerate(lists):
            if prune and j > 0 and len(cands) >= k and suffix_ub[j] < theta:
                # no doc appearing only in the remaining lists can reach the
                # top k: its score is ≤ suffix_ub[j] < theta (strictly below
                # the k-th best, so exact even under doc-id tie-breaks)
                self.rank_lists_skipped += n_terms - j
                self.rank_postings_skipped += int(
                    sum(len(rest[0]) for rest in lists[j:]))
                break
            self.rank_lists_scored += 1
            self.rank_postings_scored += len(docs_t)
            new = np.setdiff1d(docs_t, cands, assume_unique=True)
            if len(new):
                merged = np.concatenate([cands, new])
                merged_s = np.concatenate([cscores, score_all_terms(new)])
                order = np.argsort(merged, kind="stable")
                cands, cscores = merged[order], merged_s[order]
            if len(cands) >= k:
                theta = float(np.partition(cscores, len(cscores) - k)[len(cscores) - k])
        top = rank_docs(cands, cscores, k)
        return top, cscores[np.searchsorted(cands, top)]

    # -- document listing (the docs: / docs-top<k>: workload) -----------
    def doc_runs(self) -> DocRunIndex:
        """The ILCP-style per-term document-run structure over the
        positional store (built lazily, cached; see ``core.doclist``)."""
        if self.positional is None:
            raise ValueError("the doc-run structure requires the PositionalIndex")
        if self._doc_run_index is None:
            self._doc_run_index = DocRunIndex(self.positional.store,
                                              self.positional.doc_starts)
        return self._doc_run_index

    def _doc_list(self, terms: list[str], phrase: bool = False) -> np.ndarray:
        """Distinct (sorted) doc ids containing all ``terms`` (``phrase`` —
        containing the exact phrase).  Phrase listing runs on the positional
        index: the pattern's positions reduce to documents through the
        doc-boundary array, with the run / grammar fast paths for
        single-term patterns.  Word listing uses the non-positional index
        when present (its postings *are* doc ids) and falls back to
        intersecting per-term document runs for positional-only sessions."""
        terms = list(terms)
        if not terms:
            return np.zeros(0, dtype=np.int64)
        if phrase or self.index is None:
            if self.positional is None:
                raise ValueError("phrase document listing requires the PositionalIndex")
            ids = [self.positional.lookup(t) for t in terms]
            if any(i is None for i in ids):
                return np.zeros(0, dtype=np.int64)
            if phrase and len(terms) > 1:
                return positions_to_docs(self._phrase(terms),
                                         self.positional.doc_starts)
            # single token, or positional-only conjunction: per-term runs
            return doc_list_terms(self.doc_runs(), ids)
        docs = self._conjunctive(terms) if len(terms) > 1 else self._word(terms[0])
        return positions_to_docs(docs, None)

    def _doc_topk(self, terms: list[str], k: int = 10, phrase: bool = False) -> np.ndarray:
        """Ranked document retrieval: top-``k`` docs by pattern frequency
        (phrase occurrences, or summed term frequencies for conjunctions),
        ties broken by lowest doc id.  Frequencies come from the positional
        doc-run structure; without a positional index every document counts
        once and the ranking degenerates to doc-id order."""
        docs, _ = self._doc_topk_scored(list(terms), k=k or 10, phrase=phrase)
        return docs

    # -- snippet extraction (the Extract logical operator) --------------
    def extract(self, q, context: int = 2) -> list[np.ndarray]:
        """Token-id windows of ``context`` tokens around every occurrence
        of a word or phrase query.  Requires a positional index whose
        backend declares the ``extract`` capability (self-indexes
        reproduce the stream from the index) or that kept its token
        stream (``keep_text=True``)."""
        pq = parse_query(q)
        if pq.kind not in (WORD, PHRASE):
            raise ValueError(f"extract serves word/phrase queries, not {pq.kind}")
        if self.positional is None:
            raise ValueError("extract requires a PositionalIndex")
        pos = np.asarray(self.positional.query_phrase(list(pq.terms)))
        store, stream = self.positional.store, self.positional.token_stream
        n, m = int(self.positional.n_tokens), len(pq.terms)
        out = []
        for p in pos.tolist():
            lo, hi = max(0, p - context), min(n, p + m + context)
            if hasattr(store, "extract"):  # self-index: stream[x..y] inclusive
                out.append(np.asarray(store.extract(lo, hi - 1), dtype=np.int64))
            elif stream is not None:
                out.append(np.asarray(stream[lo:hi], dtype=np.int64))
            else:
                raise ValueError(
                    f"backend {self.positional.store_name!r} lacks the "
                    f"'extract' capability and the index kept no token "
                    f"stream (build with keep_text=True)")
        return out
