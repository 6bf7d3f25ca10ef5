"""Batched device serving: the device steps, the windowed-exact host loop,
and the legacy engine shims.

The serving stack is plan-first:

* ``serving.plan`` — `parse_query` → logical plan → cost-aware compiler →
  physical plan (`route_query` / `compile_query` / EXPLAIN rendering).
* ``serving.session.Session`` — the entry point: plan-cached,
  shape-grouped `execute`, plus `explain` and `metrics`.
* this module — the device-side batched steps (:func:`make_serve_step`,
  the BM25 step :func:`make_ranked_step`), the windowed-exact host loop
  around them (:class:`BatchedServer`), and thin **deprecation shims**
  (:class:`QueryEngine`, :class:`QueryPlanner`) that keep the old per-kind
  call sites working.

Device-step geometry: padded (batch, width) term-id matrices; each step
generates candidates from the query's first list (dense expand rows, or rows
decoded from the rule pool in the fused layout) and probes the remaining
terms through the anchored binary search.  Phrase queries probe *shifted*
candidates (offset-shifted intersection, paper §3): term ``t`` of a phrase
must hold ``position + t``.  Candidate generation is **windowed**: the host
loop sweeps ``row_start`` over the driving list's C-entries so arbitrarily
long lists are served exactly.  Ranked top-k computes idf-proxy weights on
device and reduces with a stable descending sort; document listing maps
matches to doc ids and dedups on device with a running maximum.  BM25
``rank<k>:`` scores the whole collection in one step: each term's padded
(doc, tf) run row scatter-adds into a dense (batch, n_docs) matrix.

Everything runs on the server's ``device``: ``"cuda"`` unless the caller asks
for ``"cpu"``.  ``probe="kernel"`` routes the probes (and the fused decode)
through the CUDA kernels of ``repro_torch.kernels``; ``probe="torch"`` is the
same step in plain tensor code.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.anchors import (
    AnchoredIndex,
    CompressedAnchoredIndex,
    build_anchored,
    build_compressed_anchored,
    member_batch,
    member_batch_compressed,
)
from ..core.device import resolve_device
from ..core.doclist import BM25_B, BM25_K1, bm25_idf
from ..core.index import NonPositionalIndex, PositionalIndex
from ..core.registry import CAP_DEVICE_RESIDENT, capabilities_of
from .plan import (  # noqa: F401  (re-exported: the legacy import surface)
    AND,
    DOCS,
    DOCS_TOPK,
    MAX_CAND_ROWS,
    PHRASE,
    RANK,
    SERVER_KINDS,
    TOPK,
    WORD,
    ParsedQuery,
    parse_query,
    route_query,
    width_bucket,
)
from .session import Session

PROBES = ("kernel", "torch")


@dataclass(frozen=True)
class QueryPlan:
    """Legacy plan record (the pre-IR surface): see ``serving.plan.Route``
    and ``Session.explain`` for the first-class replacement."""

    query: ParsedQuery
    index: str  # "nonpositional" | "positional"
    route: str  # "host" | "device"
    strategy: str  # host physical operator or device step name


class QueryPlanner:
    """Deprecated routing shim: ``plan`` wraps the plan compiler's
    :func:`repro_torch.serving.plan.route_query` decision into the legacy
    :class:`QueryPlan` record.  Use ``Session.explain`` / ``Session.plan``."""

    def __init__(self, engine: "QueryEngine"):
        self.engine = engine

    def plan(self, q, prefer_device: bool = True) -> QueryPlan:
        pq = parse_query(q)
        rt = route_query(self.engine, pq, prefer_device=prefer_device)
        return QueryPlan(pq, rt.index, rt.route, rt.strategy)


# ----------------------------------------------------------------------
# legacy host engine (deprecation shim over Session)
# ----------------------------------------------------------------------
_DEPRECATION_WARNED = False


def _warn_deprecated(method: str) -> None:
    global _DEPRECATION_WARNED
    if not _DEPRECATION_WARNED:
        _DEPRECATION_WARNED = True
        warnings.warn(
            f"QueryEngine.{method} (and the other per-kind QueryEngine "
            f"methods) are deprecated: build a repro_torch.serving.session.Session "
            f"and go through Session.execute / Session.explain",
            DeprecationWarning, stacklevel=3)


@dataclass
class QueryEngine:
    """Deprecated facade: every call delegates to an owned
    :class:`~repro_torch.serving.session.Session` (``.session``) over the
    given indexes and servers — the servers, built by the caller, carry the
    device (``BatchedServer.from_index(..., device=)``); with none the
    session is host-only.  ``execute`` / ``batch`` stay silent for
    migration; the per-kind methods emit one ``DeprecationWarning`` per
    process."""

    # a positional-only engine (index=None) still serves phrase and document
    # listing queries through the doc-run / grammar structures
    index: NonPositionalIndex | None
    positional: PositionalIndex | None = None
    server: "BatchedServer | None" = None  # device path over `index`
    positional_server: "BatchedServer | None" = None  # device path over `positional`

    def __post_init__(self):
        self.session = Session(index=self.index, positional=self.positional,
                               server=self.server,
                               positional_server=self.positional_server)
        self.planner = QueryPlanner(self)

    def __setattr__(self, name, value):
        # keep the owned Session live: old call sites attach servers (or swap
        # indexes) after construction, and routes planned under the previous
        # configuration must not be served from the cache
        object.__setattr__(self, name, value)
        if (name in ("index", "positional", "server", "positional_server")
                and getattr(self, "session", None) is not None):
            setattr(self.session, name, value)
            self.session._plan_cache.clear()

    def execute(self, q) -> np.ndarray:
        """Plan and run one query (a list of words is the legacy AND form)."""
        return self.session.execute(parse_query(q))

    def batch(self, queries: list) -> list[np.ndarray]:
        """Serve a mixed batch in original order (see ``Session.execute``)."""
        return self.session.execute(list(queries))

    def doc_runs(self):
        return self.session.doc_runs()

    # -- deprecated per-kind surface ------------------------------------
    def word(self, w: str) -> np.ndarray:
        _warn_deprecated("word")
        return self.session._word(w)

    def conjunctive(self, words: list[str]) -> np.ndarray:
        _warn_deprecated("conjunctive")
        return self.session._conjunctive(words)

    and_ = conjunctive

    def phrase(self, tokens: list[str]) -> np.ndarray:
        _warn_deprecated("phrase")
        return self.session._phrase(tokens)

    def ranked_and(self, words: list[str], k: int = 10) -> np.ndarray:
        _warn_deprecated("ranked_and")
        return self.session._ranked_and(words, k=k)

    topk = ranked_and

    def doc_list(self, terms: list[str], phrase: bool = False) -> np.ndarray:
        _warn_deprecated("doc_list")
        return self.session._doc_list(terms, phrase=phrase)

    def doc_topk(self, terms: list[str], k: int = 10, phrase: bool = False) -> np.ndarray:
        _warn_deprecated("doc_topk")
        return self.session._doc_topk(terms, k=k, phrase=phrase)


def _lookup(index, term: str):
    return index.lookup(term)


def resolve_probe(probe: str | None, device: torch.device) -> str:
    """Default probe per device ("kernel" on CUDA, "torch" on the CPU); the
    CUDA kernels cannot run on CPU tensors, so asking for them there raises."""
    if probe is None:
        return "kernel" if device.type == "cuda" else "torch"
    if probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}; use one of {PROBES}")
    if probe == "kernel" and device.type != "cuda":
        raise ValueError(
            f"probe='kernel' runs the CUDA kernels and needs a CUDA device, "
            f"got device={str(device)!r}; use probe='torch' on the CPU")
    return probe


def encode_queries(host_index, lengths: np.ndarray, queries: list[list[str]],
                   sort_by_length: bool = False, width: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad term lists to (B, width) id matrices — the encode step of the
    batched server.

    ``width`` defaults to the batch's longest query; the Session passes its
    power-of-two bucket so equal shapes share one cached step.  Queries with
    any unknown term are marked invalid (their result is empty; the padded
    row — term id 0, length 1 — still flows through the step so shapes stay
    rectangular).  With ``sort_by_length`` (AND / top-k only — order matters
    for phrases) the rarest term under ``lengths`` drives candidate
    generation, which minimizes the window sweep."""
    longest = max(len(q) for q in queries)
    if width is None:
        width = max(2, longest)
    elif width < longest:
        raise ValueError(f"width {width} < longest query ({longest} terms)")
    qt = np.zeros((len(queries), width), np.int32)
    ql = np.ones(len(queries), np.int32)
    ok = np.ones(len(queries), bool)
    for i, q in enumerate(queries):
        ids = [host_index.lookup(t) for t in q]
        if any(v is None for v in ids):
            ok[i] = False
            continue
        if sort_by_length:
            ids = sorted(ids, key=lambda w: lengths[w])
        qt[i, : len(ids)] = ids
        ql[i] = len(ids)
    return qt, ql, ok


# ----------------------------------------------------------------------
# device-side batched steps
# ----------------------------------------------------------------------
def _window_rows(c_offsets: torch.Tensor, list_ids: torch.Tensor, row_start: int,
                 n_entries: int):
    """C-entry rows of the MAX_CAND_ROWS window starting at ``row_start`` of
    each list: (rows (B, ROWS) clamped into the table, valid_rows)."""
    ids = list_ids.long()
    lo = c_offsets[ids] + row_start
    hi = c_offsets[ids + 1]
    rows = lo[:, None] + torch.arange(MAX_CAND_ROWS, dtype=torch.int32,
                                      device=lo.device)[None, :]
    valid_rows = rows < hi[:, None]
    # explicit clamp: an out-of-range gather reads garbage or faults on CUDA
    return rows.clamp(max=max(n_entries - 1, 0)), valid_rows


def candidates_for(idx: AnchoredIndex, list_ids: torch.Tensor,
                   row_start: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """MAX_CAND_ROWS * expand_len absolute values of each list, starting at
    C-entry ``row_start`` of the list (the windowed candidate generator —
    sweeping ``row_start`` covers lists of any length exactly).

    Returns (values (B, C), valid (B, C)) in cumulative-gap space.
    """
    rows, valid_rows = _window_rows(idx.c_offsets, list_ids, row_start,
                                    idx.expand.shape[0])
    rows = rows.long()
    vals = idx.expand[rows]  # (B, ROWS, L)
    valid = idx.expand_valid[rows] & valid_rows[:, :, None]
    b = list_ids.shape[0]
    return vals.reshape(b, -1), valid.reshape(b, -1)


_PAD_VAL = 2**31 - 1  # int32 top: shifted phrase targets stay strictly below


def fused_candidates_for(idx: CompressedAnchoredIndex, list_ids: torch.Tensor,
                         row_start: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused-layout counterpart of :func:`candidates_for`: the same
    MAX_CAND_ROWS window, but each C entry decodes from the shared
    prefix-summed pool (bounded by ``max_phrase``) instead of reading a
    dense expand row.  The read ``pool[c_ptr[j] : c_ptr[j] + max_phrase]``
    relies on the pool's ``max_phrase`` zeros of tail padding.

    Plain tensor code (``probe="torch"``); ``probe="kernel"`` runs the same
    function as one ``fused_decode.decode_window`` launch.  Returns (values
    (B, C), valid (B, C)) in cumulative-gap space — identical to the dense
    generator's output for the same store.
    """
    from ..kernels.fused_decode.ops import decode_rows_torch as decode

    rows, valid_rows = _window_rows(idx.c_offsets, list_ids, row_start,
                                    idx.anchors.shape[0])
    flat = rows.reshape(-1).long()
    L = max(int(idx.max_phrase), 1)
    base = idx.anchors[flat]
    lens = torch.where(valid_rows.reshape(-1), idx.c_len[flat],
                       torch.zeros((), dtype=torch.int32, device=flat.device))
    vals, valid = decode(idx.pool, idx.c_ptr[flat], base, lens, L)
    b = list_ids.shape[0]
    return vals.reshape(b, -1), valid.reshape(b, -1)


def _probe_terms(idx, query_terms, query_lens, cand_vals, cand_valid,
                 max_terms: int, phrase: bool, member=None):
    """AND / phrase probe loop shared by the plain steps.  For phrase
    queries term ``t`` probes candidate + t (offset-shifted intersection,
    §3).  ``member`` is the probe implementation (the plain batched binary
    search by default, picked by index layout).  The kernel steps run this
    loop as one launch a window instead: ``fused_decode.probe_window`` on
    the fused layout, ``anchor_intersect.dense_probe_window`` on the dense
    one."""
    if member is None:
        member = (member_batch_compressed
                  if isinstance(idx, CompressedAnchoredIndex) else member_batch)
    b, nc = cand_vals.shape
    match = cand_valid
    for t in range(1, max_terms):
        term = query_terms[:, t]
        active = (t < query_lens)[:, None]
        flat_ids = torch.repeat_interleave(term, nc)
        if phrase:
            # shifted target is cand_vals + t in cumulative-gap space; clamp
            # so postings near the top of the universe can neither wrap int32
            # nor reach the int32 top value
            safe = cand_vals <= _PAD_VAL - 1 - t
            shifted = torch.where(safe, cand_vals, torch.zeros_like(cand_vals)) - 1 + t
        else:
            safe = None
            shifted = cand_vals - 1
        hit = member(idx, flat_ids, shifted.reshape(-1)).reshape(b, nc)
        if safe is not None:
            hit = hit & safe
        match = match & (hit | ~active)
    return match


def _idf_weights(idx, query_terms, query_lens, max_terms: int,
                 n_docs: float) -> torch.Tensor:
    """Per-query idf-proxy weight: sum over active terms of
    log1p(n_docs / list_len) — the device form of ranked_and's host loop.

    Note this is one scalar per *query* (the non-positional index has no
    per-document frequencies), so among a query's matches the ranking
    degenerates to doc-id order — exactly like host ``ranked_and``, whose
    weight vector is constant too.  The score is still attached to every
    hit so a downstream per-document ranker can slot in here."""
    w = torch.zeros(query_terms.shape[0], dtype=torch.float32,
                    device=query_terms.device)
    for t in range(max_terms):
        ell = idx.lengths[query_terms[:, t].long()].clamp(min=1).to(torch.float32)
        w = w + torch.where(t < query_lens, torch.log1p(n_docs / ell),
                            torch.zeros_like(w))
    return w


def _as_anchored(index: dict) -> AnchoredIndex:
    return AnchoredIndex(
        anchors=index["anchors"],
        c_offsets=index["c_offsets"],
        expand=index["expand"],
        expand_valid=index["expand_valid"],
        lengths=index["lengths"],
        expand_len=index["expand"].shape[-1],
    )


def _as_compressed(index: dict, max_phrase: int) -> CompressedAnchoredIndex:
    # max_phrase is a static decode bound, not an array — the step closure
    # carries it
    return CompressedAnchoredIndex(
        anchors=index["anchors"],
        c_offsets=index["c_offsets"],
        c_ptr=index["c_ptr"],
        c_len=index["c_len"],
        pool=index["pool"],
        lengths=index["lengths"],
        max_phrase=max_phrase,
    )


def make_serve_step(max_terms: int = 8, mode: str = AND, topk: int = 0,
                    n_docs: float = 0.0, probe: str = "torch",
                    doclist: bool = False, layout: str = "dense",
                    max_phrase: int = 0):
    """Build a batched device step.

    ``mode`` is "and" (conjunctive doc queries) or "phrase" (offset-shifted
    positional probes).  With ``topk == 0`` the step returns
    ``(candidate postings (B, C), match mask (B, C))`` for the window at
    ``row_start``; with ``topk == k`` it additionally ranks on device and
    returns ``(top postings (B, k), top scores (B, k), top valid (B, k))``.
    With ``doclist=True`` the step returns ``(doc ids (B, C), keep (B, C))``:
    matching positions map to documents through the ``doc_starts`` array in
    ``index`` (identity when absent — non-positional postings are doc ids)
    and duplicates are dropped *on device* by a running maximum — matched
    values are sorted within a window, so an entry is the first of its
    document iff its doc id exceeds the running maximum of everything
    before it.  ``probe="kernel"`` routes the probes (and the fused
    layout's candidate generation) through the CUDA kernels, a fixed number
    of launches a window whatever the width: for the dense layout one
    ``anchor_intersect.dense_probe_window`` (every term's anchor search and
    row compare, the AND of the terms; the candidates are a gather of
    expand rows in torch ops); for the fused one two —
    ``fused_decode.decode_window`` (the window's rows derived and decoded)
    and ``fused_decode.probe_window`` (every term's anchor search and row
    probe, the AND of the terms).

    ``layout`` selects the device memory model: "dense" reads the
    ``(n_c, expand_len)`` expand tables; "fused" keeps only the compressed
    arrays (anchors + rule-pool pointers, bound ``max_phrase``) on the
    device and decodes inside the sweep — byte-identical results either way.
    """
    if probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}; use one of {PROBES}")
    phrase = mode == PHRASE
    fused = layout == "fused"
    window = None  # (decode_window, probe_window): the fused kernel step
    dense_window = None  # dense_probe_window: the dense kernel step's probes
    if probe == "kernel":
        if fused:
            from ..kernels.fused_decode.ops import decode_window, probe_window

            window = (decode_window, probe_window)
        else:
            from ..kernels.anchor_intersect.ops import dense_probe_window as dense_window

    def serve(index: dict, query_terms: torch.Tensor, query_lens: torch.Tensor,
              row_start: int = 0):
        idx = _as_compressed(index, max_phrase) if fused else _as_anchored(index)
        if window is not None:
            decode_window, probe_window = window
            cand_vals, cand_valid = decode_window(
                idx.pool, idx.c_offsets, idx.anchors, idx.c_ptr, idx.c_len,
                query_terms[:, 0], row_start, MAX_CAND_ROWS,
                max(int(max_phrase), 1))
            match = probe_window(cand_vals, cand_valid, query_terms[:, :max_terms],
                                 query_lens, idx.c_offsets, idx.anchors, idx.c_ptr,
                                 idx.c_len, idx.pool, phrase)
        else:
            generate = fused_candidates_for if fused else candidates_for
            cand_vals, cand_valid = generate(idx, query_terms[:, 0], row_start)
            if dense_window is not None:
                match = dense_window(cand_vals, cand_valid, query_terms[:, :max_terms],
                                     query_lens, idx.c_offsets, idx.anchors, idx.expand,
                                     idx.expand_valid, phrase)
            else:
                match = _probe_terms(idx, query_terms, query_lens, cand_vals, cand_valid,
                                     max_terms, phrase)
        if doclist:
            vals = cand_vals - 1
            ds = index.get("doc_starts")
            if ds is None:
                doc = vals
            else:
                doc = (torch.searchsorted(ds, vals, right=True) - 1).to(torch.int32)
            doc = torch.where(match, doc, torch.full_like(doc, -1))
            prev = torch.cummax(doc, dim=1).values
            prev = torch.cat([torch.full_like(doc[:, :1], -1), prev[:, :-1]], dim=1)
            return doc, match & (doc > prev)
        if not topk:
            return cand_vals - 1, match
        w = _idf_weights(idx, query_terms, query_lens, max_terms, n_docs)
        scores = torch.where(match, w[:, None],
                             torch.full((), float("-inf"), device=w.device))
        # stable descending sort: among equal scores candidate (doc-id) order
        # decides, which torch.topk does not promise
        order = torch.sort(scores, dim=1, descending=True, stable=True)
        top_scores, top_i = order.values[:, :topk], order.indices[:, :topk]
        top_vals = torch.gather(cand_vals - 1, 1, top_i)
        return top_vals, top_scores, top_scores > float("-inf")

    return serve


def make_ranked_step(max_terms: int = 8, topk: int = 10):
    """Batched device BM25 top-k over the scoring-run arrays.

    Geometry: per query slot ``t`` the step gathers that term's padded
    (doc, tf) run row, computes the BM25 contribution against the
    precomputed per-document length norm, and scatter-adds it into a dense
    ``(batch, n_docs)`` score matrix, one slot at a time; a stable
    descending sort then reduces each row (ties → lowest doc id: scores are
    indexed by doc id, and ``torch.topk`` promises no order among ties).
    Within one slot each (query, doc) gets at most one nonzero addend — a
    run holds a doc once and the server deduplicates query terms — and the
    padding lanes add 0.0 to doc 0, so the scatter (``index_add_`` into the
    flattened matrix: atomic adds on a GPU) is exact in any order, and the
    slots add in the reference's order.  A zero score means no query term
    occurs in the doc — BM25 contributions are strictly positive (log1p
    idf) — so ``scores > 0`` is the validity mask and padding rows never
    surface.
    """

    def serve(index: dict, query_terms: torch.Tensor, query_lens: torch.Tensor,
              row_start: int = 0):
        del row_start  # dense scoring has no candidate window to sweep
        b = query_terms.shape[0]
        doc_norm = index["rank_doc_norm"]  # (n_docs,) k1*(1-b+b*dl/avgdl)
        n_docs = doc_norm.shape[0]
        scores = torch.zeros(b * n_docs, dtype=torch.float32, device=doc_norm.device)
        row_base = torch.arange(b, device=doc_norm.device)[:, None] * n_docs
        n_terms = index["rank_idf"].shape[0]
        for t in range(max_terms):
            # term ids index the rank arrays: a padded slot holds id 0, a
            # real row whose lanes `live` masks out; the clamp is the
            # reference's gather semantics (an out-of-range id reads the
            # last row there, and never reads past the table here)
            term = query_terms[:, t].long().clamp(0, n_terms - 1)
            docs = index["rank_run_docs"][term].long()  # (B, Lmax)
            tfs = index["rank_run_tfs"][term]
            live = index["rank_run_valid"][term] & (t < query_lens)[:, None]
            contrib = (index["rank_idf"][term][:, None] * tfs * (BM25_K1 + 1.0)
                       / (tfs + doc_norm[docs]))
            scores.index_add_(0, (row_base + docs).reshape(-1),
                              torch.where(live, contrib, torch.zeros_like(contrib)).reshape(-1))
        order = torch.sort(scores.view(b, n_docs), dim=1, descending=True, stable=True)
        top_scores = order.values[:, :topk]
        top_docs = order.indices[:, :topk].to(torch.int32)
        return top_docs, top_scores, top_scores > 0.0

    return serve


def make_uihrdc_serve_step(max_terms: int = 8):
    """The AND-only step of the ``uihrdc`` dry-run arch (kept as an entry
    point; see :func:`make_serve_step` for phrase/top-k)."""
    return make_serve_step(max_terms=max_terms, mode=AND)


#: the ranked step's arrays and their dtypes (the reference's)
RANK_ARRAYS = {"rank_run_docs": np.int32, "rank_run_tfs": np.float32,
               "rank_run_valid": bool, "rank_doc_norm": np.float32,
               "rank_idf": np.float32}


def rank_arrays(index: NonPositionalIndex, device) -> dict[str, torch.Tensor]:
    """The scoring runs of ``index`` as the padded dense arrays the ranked
    step reads: a row per term, one (doc, tf) slot per posting, with the
    per-document length norm and the per-term idf — int32 / float32 / bool
    as in the reference, each copied onto ``device`` from a fresh array."""
    scoring = index.scoring
    n_lists = len(scoring.max_tf)
    n_docs = scoring.n_docs
    offsets = np.asarray(scoring.run_offsets, dtype=np.int64)
    lens = np.diff(offsets)
    lmax = max(1, int(lens.max()) if n_lists else 1)
    rows = np.repeat(np.arange(n_lists), lens)
    cols = np.arange(int(offsets[-1]) if n_lists else 0) - np.repeat(offsets[:-1], lens)
    out = {k: np.zeros((n_lists, lmax), RANK_ARRAYS[k])
           for k in ("rank_run_docs", "rank_run_tfs", "rank_run_valid")}
    out["rank_run_docs"][rows, cols] = scoring.run_docs
    out["rank_run_tfs"][rows, cols] = scoring.run_tfs
    out["rank_run_valid"][rows, cols] = True
    dl = scoring.doc_lengths.astype(np.float32)
    avgdl = max(scoring.avgdl, 1e-9)
    out["rank_doc_norm"] = BM25_K1 * (1.0 - BM25_B + BM25_B * dl / avgdl)
    out["rank_idf"] = np.asarray([bm25_idf(int(ell), n_docs) for ell in lens]).reshape(n_lists)
    return {k: torch.as_tensor(np.asarray(v, RANK_ARRAYS[k]), device=device)
            for k, v in out.items()}


# ----------------------------------------------------------------------
# BatchedServer: windowed-exact host loop around the device steps
# ----------------------------------------------------------------------
@dataclass
class BatchedServer:
    """Owns the device-resident anchored arrays for one index plus a cache
    of device steps, and drives the candidate-window sweep so results are
    exact for lists of any length (no 64-candidate truncation).

    ``trace_count`` counts step-cache misses, one per
    ``(kind, width, topk, doclist)`` shape — the quantity `Session.metrics`
    reports: a repeated traffic shape builds no new step.  The ``width``
    argument of the batched entry points lets the Session pad term matrices
    to shared buckets so equal-shaped traffic reuses one step."""

    host_index: NonPositionalIndex | PositionalIndex
    arrays: dict[str, torch.Tensor]
    n_docs: float  # idf denominator (docs, or tokens for positional)
    probe: str = "torch"  # "torch" | "kernel" (CUDA anchor_intersect / fused_decode)
    layout: str = "dense"  # "dense" (expand tables) | "fused" (decode-on-device)
    max_phrase: int = 0  # fused layout's static decode bound (longest rule)
    #: device-step kinds this server can run (Session routes through this);
    #: "rank" where the index carries scoring statistics
    kinds: frozenset = SERVER_KINDS
    _steps: dict = field(default_factory=dict)
    trace_events: int = 0
    windows_swept: int = 0  # window steps run (one per window per batch)
    ranked_steps: int = 0  # BM25 steps run (one per rank batch: no windows)
    # host-side copies of the immutable planning arrays, so encode /
    # window counting never does a device->host transfer per batch
    _lengths_np: np.ndarray | None = None
    _c_offsets_np: np.ndarray | None = None

    def __post_init__(self):
        if self._lengths_np is None:
            self._lengths_np = self.arrays["lengths"].cpu().numpy()
        if self._c_offsets_np is None:
            self._c_offsets_np = self.arrays["c_offsets"].cpu().numpy()

    #: posting-layout array names (device-memory accounting; rank_* and
    #: doc_starts are layout-independent extras)
    _LAYOUT_ARRAYS = {
        "dense": ("anchors", "c_offsets", "expand", "expand_valid", "lengths"),
        "fused": ("anchors", "c_offsets", "c_ptr", "c_len", "pool", "lengths"),
    }

    @classmethod
    def from_index(cls, index: NonPositionalIndex | PositionalIndex,
                   expand_len: int = 32, probe: str | None = None,
                   layout: str = "auto", device="cuda") -> "BatchedServer":
        dev = resolve_device(device)
        probe = resolve_probe(probe, dev)
        store = index.store
        resident = CAP_DEVICE_RESIDENT in capabilities_of(store)
        if layout == "auto":
            # device-resident (Re-Pair) stores ship their compressed arrays
            # to the device and decode inside the sweep; everything else
            # re-anchors into the dense expand tables
            layout = "fused" if resident else "dense"
        if layout not in cls._LAYOUT_ARRAYS:
            raise ValueError(f"unknown layout {layout!r}")
        max_phrase = 0
        if layout == "fused":
            if resident:  # the backend's own grammar compresses directly
                cidx = CompressedAnchoredIndex.from_store(store, device=dev)
            else:  # re-compress from decoded lists (any registered backend)
                lists = [store.get_list(i) for i in range(store.n_lists)]
                cidx = build_compressed_anchored(lists, device=dev)
            arrays = {"anchors": cidx.anchors, "c_offsets": cidx.c_offsets,
                      "c_ptr": cidx.c_ptr, "c_len": cidx.c_len,
                      "pool": cidx.pool, "lengths": cidx.lengths}
            max_phrase = cidx.max_phrase
        else:
            if resident:  # the backend's own arrays anchor directly
                aidx = AnchoredIndex.from_store(store, expand_len=expand_len,
                                                device=dev)
            else:  # re-anchor from decoded lists (any registered backend)
                lists = [store.get_list(i) for i in range(store.n_lists)]
                aidx = build_anchored(lists, expand_len=expand_len, device=dev)
            arrays = {"anchors": aidx.anchors, "c_offsets": aidx.c_offsets,
                      "expand": aidx.expand, "expand_valid": aidx.expand_valid,
                      "lengths": aidx.lengths}
        if isinstance(index, PositionalIndex):
            # device-side position -> document mapping for doc listing
            arrays["doc_starts"] = torch.from_numpy(
                np.asarray(index.doc_starts).astype(np.int32)).to(dev)
        kinds = SERVER_KINDS
        if (isinstance(index, NonPositionalIndex)
                and getattr(index, "scoring", None) is not None):
            # scoring runs as padded dense matrices: the device ranked step
            # gathers rows, scatter-adds BM25 contributions, reduces per row
            arrays.update(rank_arrays(index, dev))
            kinds = SERVER_KINDS | {RANK}
        return cls(host_index=index, arrays=arrays,
                   n_docs=float(index.universe_size), probe=probe,
                   layout=layout, max_phrase=max_phrase, kinds=kinds)

    @classmethod
    def from_arrays(cls, host_index, arrays: dict, layout: str, max_phrase: int = 0,
                    n_docs: float | None = None, device="cuda",
                    probe: str | None = None) -> "BatchedServer":
        """A server over device state carried across as NumPy arrays (keys
        as in ``_LAYOUT_ARRAYS[layout]``, plus ``doc_starts`` for a
        positional index and the ``rank_*`` arrays where the source server
        had them; any other key is ignored)."""
        dev = resolve_device(device)
        probe = resolve_probe(probe, dev)
        if layout not in cls._LAYOUT_ARRAYS:
            raise ValueError(f"unknown layout {layout!r}")
        keys = cls._LAYOUT_ARRAYS[layout] + (
            ("doc_starts",) if "doc_starts" in arrays else ())
        tensors = {}
        for k in keys:
            a = np.asarray(arrays[k])
            a = a.astype(bool if k == "expand_valid" else np.int32)
            tensors[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        kinds = SERVER_KINDS
        if all(k in arrays for k in RANK_ARRAYS):
            for k, dtype in RANK_ARRAYS.items():
                tensors[k] = torch.as_tensor(np.array(arrays[k], dtype=dtype), device=dev)
            kinds = SERVER_KINDS | {RANK}
        if n_docs is None:
            n_docs = float(host_index.universe_size)
        return cls(host_index=host_index, arrays=tensors, n_docs=float(n_docs),
                   probe=probe, layout=layout, max_phrase=int(max_phrase),
                   kinds=kinds)

    @property
    def device(self) -> torch.device:
        return self.arrays["anchors"].device

    @property
    def trace_count(self) -> int:
        return self.trace_events

    def device_bytes(self) -> int:
        """Device bytes of the posting-layout arrays (the quantity the fused
        layout shrinks; the doc-mapping extra is layout-independent)."""
        return sum(self.arrays[k].numel() * self.arrays[k].element_size()
                   for k in self._LAYOUT_ARRAYS[self.layout])

    def c_entries(self, list_id: int) -> int:
        """C-entry count of one list (window-sweep length; cost model)."""
        c = self._c_offsets_np
        return int(c[list_id + 1] - c[list_id])

    # -- encoding -------------------------------------------------------
    def encode(self, queries: list[list[str]], sort_by_length: bool = False,
               width: int | None = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """See :func:`encode_queries`."""
        return encode_queries(self.host_index, self._lengths_np, queries,
                              sort_by_length=sort_by_length, width=width)

    def _step(self, kind: str, width: int, topk: int = 0, doclist: bool = False):
        key = (kind, width, topk, doclist)
        if key not in self._steps:
            self.trace_events += 1  # a step-cache miss: a new traffic shape
            if kind == RANK:
                self._steps[key] = make_ranked_step(max_terms=width, topk=topk)
            else:
                mode = PHRASE if kind == PHRASE else AND
                self._steps[key] = make_serve_step(
                    max_terms=width, mode=mode, topk=topk, n_docs=self.n_docs,
                    probe=self.probe, doclist=doclist, layout=self.layout,
                    max_phrase=self.max_phrase)
        return self._steps[key]

    def _n_windows(self, qt: np.ndarray, ok: np.ndarray) -> int:
        c_off = self._c_offsets_np
        first = qt[:, 0][ok] if ok.any() else qt[:1, 0]
        rows = c_off[first + 1] - c_off[first]
        return max(1, int(-(-int(rows.max()) // MAX_CAND_ROWS)))

    def _windows(self, step, qt: np.ndarray, ql: np.ndarray, ok: np.ndarray):
        """Run ``step`` over every candidate window of the batch, yielding
        each window's outputs as NumPy arrays (one device->host copy per
        output per window, never per query)."""
        dev = self.device
        qt_d = torch.from_numpy(qt).to(dev)
        ql_d = torch.from_numpy(ql).to(dev)
        with torch.no_grad():
            for w in range(self._n_windows(qt, ok)):
                out = step(self.arrays, qt_d, ql_d, w * MAX_CAND_ROWS)
                self.windows_swept += 1
                yield tuple(o.cpu().numpy() for o in out)

    def _collect(self, step, qt, ql, ok) -> list[np.ndarray]:
        """Union of the masked values of every window, per query (sorted,
        distinct); empty for queries with an unknown term."""
        hits: list[list[np.ndarray]] = [[] for _ in range(len(ok))]
        for vals, mask in self._windows(step, qt, ql, ok):
            for i in np.flatnonzero(ok):
                hits[i].append(vals[i][mask[i]])
        empty = np.zeros(0, np.int64)
        return [np.unique(np.concatenate(h)).astype(np.int64) if (o and h) else empty
                for h, o in zip(hits, ok)]

    def _sweep(self, kind: str, queries: list[list[str]],
               width: int | None = None) -> list[np.ndarray]:
        qt, ql, ok = self.encode(queries, sort_by_length=(kind != PHRASE),
                                 width=width)
        return self._collect(self._step(kind, qt.shape[1]), qt, ql, ok)

    # -- public batched entry points ------------------------------------
    def conjunctive(self, queries: list[list[str]],
                    width: int | None = None) -> list[np.ndarray]:
        """Batched AND: sorted doc ids per query, exact for any list length."""
        return self._sweep(AND, queries, width=width)

    def phrase(self, queries: list[list[str]],
               width: int | None = None) -> list[np.ndarray]:
        """Batched phrase: sorted start positions per query (positional
        index).  Use ``positions_to_docs`` on the host index for (doc, off)."""
        return self._sweep(PHRASE, queries, width=width)

    def doclist(self, queries: list[list[str]], phrase: bool = False,
                width: int | None = None) -> list[np.ndarray]:
        """Batched document listing: sorted distinct doc ids per query.

        The position->document mapping and the per-window dedup (running
        maximum over candidate doc ids) run *inside* the device step, so only
        the distinct survivors of each window are kept on the host, which
        unions them across windows — exact for lists of any length."""
        kind = PHRASE if phrase else AND
        qt, ql, ok = self.encode(queries, sort_by_length=not phrase, width=width)
        return self._collect(self._step(kind, qt.shape[1], doclist=True), qt, ql, ok)

    def topk(self, queries: list[list[str]], k: int = 10,
             width: int | None = None) -> list[np.ndarray]:
        """Batched ranked AND: first k matches under the idf-proxy weight
        (matches the host ``ranked_and`` order).  Ranking runs on device;
        the window sweep stops as soon as every query has k hits."""
        qt, ql, ok = self.encode(queries, sort_by_length=True, width=width)
        step = self._step(AND, qt.shape[1], topk=int(k))
        got: list[list[np.ndarray]] = [[] for _ in queries]
        counts = np.zeros(len(queries), np.int64)
        for vals, _scores, valid in self._windows(step, qt, ql, ok):
            for i in np.flatnonzero(ok):
                got[i].append(vals[i][valid[i]])
            counts[ok] += valid[ok].sum(axis=1)
            if (counts >= k)[ok].all():
                break
        empty = np.zeros(0, np.int64)
        return [np.concatenate(g)[:k].astype(np.int64) if (o and g) else empty
                for g, o in zip(got, ok)]

    def ranked(self, queries: list[list[str]], k: int = 10,
               width: int | None = None) -> list[np.ndarray]:
        """Batched BM25 ranked disjunction: top-``k`` doc ids per query,
        scored and reduced on device (see :func:`make_ranked_step`).  One
        step covers the whole collection — dense scoring has no candidate
        window — so a warmed (width, k) shape builds no new step."""
        if "rank_doc_norm" not in self.arrays:
            raise ValueError(
                f"this server holds no scoring arrays "
                f"({self.host_index.store_name!r}): rebuild the index with "
                f"scoring statistics to serve rank queries on device")
        # duplicate query terms would scatter-add twice; the host scorer
        # dedups, so dedup here for identical answers
        queries = [list(dict.fromkeys(q)) for q in queries]
        qt, ql, ok = self.encode(queries, width=width)
        eff_k = min(int(k), int(self.arrays["rank_doc_norm"].shape[0]))
        step = self._step(RANK, qt.shape[1], topk=eff_k)
        dev = self.device
        with torch.no_grad():
            docs, _scores, valid = step(self.arrays, torch.from_numpy(qt).to(dev),
                                        torch.from_numpy(ql).to(dev))
        self.ranked_steps += 1
        docs, valid = docs.cpu().numpy(), valid.cpu().numpy()
        empty = np.zeros(0, np.int64)
        return [docs[i][valid[i]].astype(np.int64) if ok[i] else empty
                for i in range(len(queries))]
