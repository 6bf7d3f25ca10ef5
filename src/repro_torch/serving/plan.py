"""First-class query plans: the logical → physical plan IR.

Queries flow through two explicit levels before execution:

* :func:`parse_query` validates the surface grammar and produces a
  :class:`ParsedQuery`; :func:`logical_plan` turns it into a **logical
  plan** — a typed dataclass tree over six operators:

  ==============  ======================================================
  logical op      meaning
  ==============  ======================================================
  ``TermScan``    one posting list (non-positional: doc ids; positional:
                  token offsets)
  ``Intersect``   conjunction of its children (AND)
  ``PhraseMatch`` offset-shifted conjunction: term *t* must hold
                  ``position + t`` (paper §3)
  ``DocReduce``   positions/postings → distinct documents (optionally
                  with per-document pattern frequencies)
  ``TopK``        keep the k best under a scoring rule (``idf`` query
                  proxy, or ``tf`` pattern frequency for ``docs-top<k>``)
  ``Extract``     snippet windows around each match (self-index
                  ``extract`` capability, or the stored token stream)
  ==============  ======================================================

* :func:`compile_query` lowers a logical plan to a **physical plan**
  (:class:`PhysicalOp` tree): the route (host vs batched device sweep) and
  per-node physical operator are chosen from the backend's **registry
  capabilities** (``repro_torch.core.registry.intersect_operator`` /
  ``doclist_operator``), with estimated list lengths from the index stats
  surface (``Index.stats()`` / ``Index.term_length()``) as the cost signal.

Cost model (deterministic integer proxies; ``lg x = bitlength(x)``):

* ``TermScan``: rows = ℓ (list length), cost = ℓ (decode).
* ``Intersect`` / ``PhraseMatch`` over lengths ℓ₁…ℓₙ in universe U:
  rows ≈ min ℓ · Π(ℓⱼ/U) (independence estimate); cost by operator —
  ``svs-merge`` Σℓ, ``compressed-skip`` minℓ·(n-1)·lg maxℓ,
  ``sampled-seek`` half the skip probe depth, ``self-locate`` rows + n,
  ``device-windowed-sweep`` windows·MAX_CAND_ROWS·n (each window probes
  every candidate against every further term).
* ``DocReduce``: rows = min(child rows, n_docs); run/grammar structures
  cost ~rows, generic reduce costs child rows.
* ``TopK``: rows = min(k, child rows), cost = child rows · lg k.

:func:`route_query` is the pure routing decision (shared by
``Session`` and the legacy ``QueryPlanner``); it is a function of the
query *shape*, not the concrete terms, except for the all-terms-known
check — :func:`plan_key` captures exactly that shape, so compiled routes
are cacheable per (structure, backend, batch bucket).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from ..core.analyzer import get_analyzer
from ..core.doclist import bm25_upper_bound
from ..core.registry import (
    CAP_SHIFTED_INTERSECT,
    OP_CLUSTER_VERSIONS,
    OP_DEVICE_RANKED,
    OP_DEVICE_SWEEP,
    OP_LSH_SIMILAR,
    OP_RANKED_TOPK,
    OP_SCORED_REDUCE,
    OP_SCORED_RUNS,
    OP_WAND_TOPK,
    capabilities_of,
    doclist_operator,
    intersect_operator,
)

# candidate C-entries taken from the driving list per device window (the
# geometry of the windowed sweep; re-exported by serving.engine)
MAX_CAND_ROWS = 64

# query kinds
WORD = "word"
AND = "and"
PHRASE = "phrase"
TOPK = "topk"
DOCS = "docs"
DOCS_TOPK = "docs_topk"
RANK = "rank"
SIMILAR = "similar"
VERSIONS = "versions"

_TOPK_RE = re.compile(r"^top(\d+):\s*(.+)$")
_DOCS_RE = re.compile(r"^docs(?:-top(\d+))?:\s*(.+)$")
_RANK_RE = re.compile(r"^rank(\d+):\s*(.+)$")
_SIMILAR_RE = re.compile(r"^(similar|versions-of):\s*(.*)$")

GRAMMAR = (
    "accepted query grammar: 'w' (word) | 'w1 w2 ...' (AND) | "
    "'\"w1 w2 ...\"' (phrase) | 'top<k>: w1 w2' (ranked AND) | "
    "'rank<k>: w1 w2' (BM25 ranked disjunction) | "
    "'docs: ...' / 'docs-top<k>: ...' (document listing) | "
    "'similar:<doc_id>' / 'versions-of:<doc_id>' (version mining, doc_id "
    "a non-negative integer), with k >= 1 and at least one non-empty term"
)


@dataclass(frozen=True)
class ParsedQuery:
    """A classified query: ``kind`` in {word, and, phrase, topk, docs,
    docs_topk, rank, similar, versions}.  ``phrase`` marks doc-listing
    queries whose terms form a contiguous phrase (``docs: "a b"``) rather
    than a conjunction.  ``analyzed`` marks ``rank`` queries whose terms
    already went through the index analyzer (analysis is not idempotent
    under stemming, so the session must not re-apply it).  ``doc`` is the
    subject doc id of the version-mining kinds (``similar:`` /
    ``versions-of:``), -1 otherwise."""

    kind: str
    terms: tuple[str, ...]
    k: int = 0
    phrase: bool = False
    analyzed: bool = False
    doc: int = -1


def parse_query(q, analyzer=None) -> ParsedQuery:
    """Classify and validate a raw query.

    * ``list[str]`` — legacy batch form: one word → word, several → AND;
    * ``"w"`` — single word;
    * ``"w1 w2 ..."`` — conjunctive (AND);
    * ``'"w1 w2 ..."'`` (quoted) — phrase;
    * ``"top<k>: w1 w2"`` — ranked AND, top-k by idf proxy;
    * ``"docs: w1 w2"`` / ``'docs: "w1 w2"'`` — document listing: distinct
      docs containing all words (resp. the exact phrase);
    * ``"docs-top<k>: ..."`` — ranked document retrieval: top-k docs by
      pattern frequency;
    * ``"rank<k>: w1 w2"`` — BM25 ranked disjunction: top-k docs matching
      *any* term, scored by BM25 over the index scoring statistics;
    * ``"similar:<doc_id>"`` — near-copies of a document (mined MinHash
      signatures, estimated Jaccard >= the mining threshold);
    * ``"versions-of:<doc_id>"`` — the document's mined version cluster.

    ``analyzer`` (optional) runs ``rank`` query terms through the index
    analysis chain at parse time — a query the chain strips to zero terms
    (all stopwords) is malformed.

    Malformed inputs — empty / whitespace-only queries, empty phrases
    (``""``), zero-k ranked forms (``top0:`` / ``docs-top0:`` /
    ``rank0:``), and analyzer-emptied ``rank`` queries — raise
    ``ValueError`` naming the accepted grammar.
    """
    if isinstance(q, ParsedQuery):
        return q
    if isinstance(q, (list, tuple)):
        terms = tuple(q)
        if not terms:
            raise ValueError(f"empty query {q!r}; {GRAMMAR}")
        return ParsedQuery(WORD if len(terms) == 1 else AND, terms)
    s = q.strip()
    if not s:
        raise ValueError(f"empty query {q!r}; {GRAMMAR}")
    m = _DOCS_RE.match(s)
    if m:
        k = m.group(1)
        if k is not None and int(k) == 0:
            raise ValueError(f"docs-top0 in {q!r}: k must be >= 1; {GRAMMAR}")
        body = m.group(2).strip()
        phrase = len(body) >= 2 and body[0] == '"' and body[-1] == '"'
        terms = tuple((body[1:-1] if phrase else body).split())
        if not terms:
            raise ValueError(f"empty {'phrase' if phrase else 'term list'} "
                             f"in {q!r}; {GRAMMAR}")
        if k is None:
            return ParsedQuery(DOCS, terms, phrase=phrase)
        return ParsedQuery(DOCS_TOPK, terms, k=int(k), phrase=phrase)
    m = _TOPK_RE.match(s)
    if m:
        if int(m.group(1)) == 0:
            raise ValueError(f"top0 in {q!r}: k must be >= 1; {GRAMMAR}")
        return ParsedQuery(TOPK, tuple(m.group(2).split()), k=int(m.group(1)))
    m = _RANK_RE.match(s)
    if m:
        if int(m.group(1)) == 0:
            raise ValueError(f"rank0 in {q!r}: k must be >= 1; {GRAMMAR}")
        terms = tuple(m.group(2).split())
        analyzed = False
        if analyzer is not None:
            terms2 = get_analyzer(analyzer).query_terms(terms)
            if not terms2:
                raise ValueError(
                    f"the analyzer stripped every term from {q!r} "
                    f"(stopwords / separators only); {GRAMMAR}")
            terms, analyzed = terms2, True
        return ParsedQuery(RANK, terms, k=int(m.group(1)), analyzed=analyzed)
    m = _SIMILAR_RE.match(s)
    if m:
        kind = SIMILAR if m.group(1) == "similar" else VERSIONS
        body = m.group(2).strip()
        if not body.isdigit():
            raise ValueError(
                f"{m.group(1)}: takes a single non-negative integer doc id, "
                f"got {body!r} in {q!r}; {GRAMMAR}")
        return ParsedQuery(kind, (), doc=int(body))
    if re.match(r"^(docs(-top\d+)?|top\d+|rank\d+):", s):  # prefix, no terms
        raise ValueError(f"no terms after {s.split(':')[0] + ':'!r} in {q!r}; "
                         f"{GRAMMAR}")
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        terms = tuple(s[1:-1].split())
        if not terms:
            raise ValueError(f"empty phrase query {q!r}; {GRAMMAR}")
        return ParsedQuery(PHRASE, terms)
    return ParsedQuery(WORD if len(s.split()) == 1 else AND, tuple(s.split()))


def unparse(pq: ParsedQuery) -> str:
    """The canonical surface string of a parsed query."""
    body = " ".join(pq.terms)
    if pq.kind == SIMILAR:
        return f"similar:{pq.doc}"
    if pq.kind == VERSIONS:
        return f"versions-of:{pq.doc}"
    if pq.kind == PHRASE:
        return f'"{body}"'
    if pq.kind == TOPK:
        return f"top{pq.k}: {body}"
    if pq.kind == RANK:
        return f"rank{pq.k}: {body}"
    if pq.kind in (DOCS, DOCS_TOPK):
        head = "docs:" if pq.kind == DOCS else f"docs-top{pq.k}:"
        return f'{head} "{body}"' if pq.phrase else f"{head} {body}"
    return body


# ----------------------------------------------------------------------
# logical plan: a typed operator tree
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class Logical:
    """Base class of logical plan nodes."""


@dataclass(frozen=True)
class TermScan(Logical):
    term: str


@dataclass(frozen=True)
class Intersect(Logical):
    children: tuple[Logical, ...]


@dataclass(frozen=True)
class PhraseMatch(Logical):
    terms: tuple[str, ...]


@dataclass(frozen=True)
class DocReduce(Logical):
    child: Logical
    counts: bool = False  # also produce per-document pattern frequencies


@dataclass(frozen=True)
class ScoredReduce(Logical):
    """Disjunctive scored retrieval: the union of the terms' documents,
    each with its BM25 score over the index scoring statistics."""

    terms: tuple[str, ...]


@dataclass(frozen=True)
class SimilarLookup(Logical):
    """Version-mining lookup: answered from the persisted signature index,
    never from posting lists.  ``versions=False`` is the LSH candidate
    scan (``similar:``), ``versions=True`` the mined cluster membership
    (``versions-of:``)."""

    doc: int
    versions: bool = False


@dataclass(frozen=True)
class TopK(Logical):
    child: Logical
    k: int
    score: str = "idf"  # "idf" proxy | "tf" pattern freq | "bm25" relevance


@dataclass(frozen=True)
class Extract(Logical):
    child: Logical
    context: int = 2  # tokens kept on each side of a match


def logical_plan(q, extract: int | None = None) -> Logical:
    """Build the logical operator tree for a query (optionally wrapped in
    an :class:`Extract` of ``context=extract`` tokens per side)."""
    pq = parse_query(q)
    terms = pq.terms
    if pq.kind in (SIMILAR, VERSIONS):  # signature-index lookup, no postings
        return SimilarLookup(pq.doc, versions=(pq.kind == VERSIONS))
    if pq.kind == RANK:  # disjunctive: no intersection subtree
        root: Logical = TopK(ScoredReduce(terms), k=pq.k or 10, score="bm25")
        return Extract(root, context=extract) if extract is not None else root
    if pq.kind == PHRASE or (pq.phrase and len(terms) > 1):
        match: Logical = PhraseMatch(terms)
    elif len(terms) == 1:
        match = TermScan(terms[0])
    else:
        match = Intersect(tuple(TermScan(t) for t in terms))
    if pq.kind in (WORD, AND, PHRASE):
        root = match
    elif pq.kind == TOPK:
        root = TopK(match, k=pq.k or 10, score="idf")
    elif pq.kind == DOCS:
        root = DocReduce(match)
    else:  # DOCS_TOPK: rank distinct docs by pattern frequency
        root = TopK(DocReduce(match, counts=True), k=pq.k or 10, score="tf")
    return Extract(root, context=extract) if extract is not None else root


# ----------------------------------------------------------------------
# routing: the shape-level decision shared by Session and QueryPlanner
# ----------------------------------------------------------------------
#: device-step kinds a full BatchedServer can serve; partial servers (the
#: partitioned server) declare their own ``kinds`` subset
SERVER_KINDS = frozenset({AND, PHRASE, TOPK, DOCS})


@dataclass(frozen=True)
class Route:
    """Where one query shape executes: which index, host or device, the
    strategy label (legacy ``QueryPlan.strategy`` vocabulary), and — for
    device routes — the padded term-matrix width bucket."""

    index: str  # "nonpositional" | "positional"
    route: str  # "host" | "device"
    strategy: str
    width: int = 0  # device bucket: terms padded to this width
    layout: str = ""  # device memory model ("dense" | "fused"; "" = host /
    # layout-independent step)


def width_bucket(n_terms: int) -> int:
    """Pad device term matrices to power-of-two widths (min 2) so nearby
    query sizes share one jit trace."""
    return max(2, 1 << max(0, n_terms - 1).bit_length())


def _needs_positional(ctx, pq: ParsedQuery) -> bool:
    return pq.kind == PHRASE or (
        pq.kind in (DOCS, DOCS_TOPK) and (pq.phrase or ctx.index is None))


def _target(ctx, pq: ParsedQuery):
    """(index_name, index, server) the query must run against."""
    if _needs_positional(ctx, pq):
        return "positional", ctx.positional, ctx.positional_server
    return "nonpositional", ctx.index, ctx.server


def plan_key(ctx, pq: ParsedQuery) -> tuple:
    """Hashable *shape* of a query's plan: everything :func:`route_query`
    depends on, with the concrete terms reduced to (count class,
    all-known?), plus the index's analyzer signature (two sessions over
    differently-analyzed indexes never share plans or cached results).
    Queries sharing a key share a compiled route and — on the device — a
    jit-stable batch bucket."""
    index_name, idx, server = _target(ctx, pq)
    known = idx is not None and all(idx.lookup(t) is not None for t in pq.terms)
    analyzer = getattr(idx, "analyzer", None)
    return (pq.kind, index_name, min(len(pq.terms), 2), pq.k, pq.phrase,
            known, width_bucket(len(pq.terms)),
            None if analyzer is None else analyzer.signature(),
            getattr(server, "layout", ""))


def result_cache_key(ctx, pq: ParsedQuery) -> tuple:
    """Structural **result**-cache key: the routing shape (:func:`plan_key`)
    plus the concrete terms — everything that determines a query's *answer*
    against a fixed collection.  Unlike :func:`plan_key` (shared by every
    query of one shape) this key is per-distinct-query: ``top3:`` and
    ``top5:`` over the same terms differ (``k`` is part of the shape), and
    the serving frontend appends the session's segment shape so an answer
    computed against one segment set is never served against another.

    The subject doc id of ``similar:``/``versions-of:`` rides in the
    *structure* component (the cache contract downstream is the 3-tuple
    ``(structure, terms, shape)``); those entries have no terms, so any
    appended segment invalidates them."""
    return (plan_key(ctx, pq) + (pq.doc,), pq.terms)


def route_query(ctx, pq: ParsedQuery, prefer_device: bool = True) -> Route:
    """Route one parsed query against ``ctx`` (anything with ``index`` /
    ``positional`` / ``server`` / ``positional_server`` attributes).

    Phrase queries need the positional index; everything else runs on the
    non-positional one.  Multi-term queries go to the device path when a
    batched server is attached for that index; single words and
    unknown-term queries stay on the host (a word query is a pure list
    decode — no intersection to batch).  Self-index backends serve through
    the host route: their native ``locate`` answers the whole pattern at
    once (strategy "self-locate"), so there is no per-term probe loop to
    batch onto the device.
    """
    index_name, idx, server = _target(ctx, pq)
    if idx is None:
        raise ValueError(f"{pq.kind} query requires the {index_name} index")
    if pq.kind in (SIMILAR, VERSIONS):
        # answered from the persisted signature index — always host-side
        return Route(index_name, "host",
                     OP_CLUSTER_VERSIONS if pq.kind == VERSIONS
                     else OP_LSH_SIMILAR)
    # single-word reads are a pure list decode — nothing to batch — except
    # phrase doc listing (device dedup collapses occurrences) and ranked
    # retrieval (device scoring + top-k is the batched work)
    multi_ok = (len(pq.terms) > 1 or (pq.kind == DOCS and pq.phrase)
                or pq.kind == RANK)
    # non-phrase doc listing on the positional index (positional-only
    # engines) intersects per-term *document runs*, not positions — the
    # device AND step would intersect disjoint position lists
    doc_route_ok = (pq.kind not in (DOCS, DOCS_TOPK)
                    or pq.phrase or index_name == "nonpositional")
    device_ok = (
        prefer_device
        and server is not None
        and pq.kind != DOCS_TOPK  # ranking needs the host tf structure
        and pq.kind in getattr(server, "kinds", SERVER_KINDS)
        and multi_ok
        and doc_route_ok
        and all(idx.lookup(t) is not None for t in pq.terms)
    )
    if device_ok:
        strategy = ("device-ranked" if pq.kind == RANK
                    else f"anchored-{pq.kind}")  # rank scores dense runs,
        # not anchored candidate windows
        # the posting layout only shapes anchored sweeps; ranked scoring
        # reads the dense (doc, tf) run arrays under either layout
        layout = "" if pq.kind == RANK else getattr(server, "layout", "")
        return Route(index_name, "device", strategy,
                     width=width_bucket(len(pq.terms)), layout=layout)
    caps = capabilities_of(idx.store)
    if pq.kind == RANK:
        # pruned when term upper bounds exist and there is more than one
        # list to skip; a single list is fully scored either way
        pruned = (getattr(idx, "scoring", None) is not None
                  and len(pq.terms) > 1)
        return Route(index_name, "host",
                     "wand-maxscore" if pruned else "ranked-exhaustive")
    if pq.kind in (DOCS, DOCS_TOPK):
        return Route(index_name, "host",
                     doclist_operator(caps, index_name == "positional",
                                      len(pq.terms)))
    return Route(index_name, "host", intersect_operator(caps))


# ----------------------------------------------------------------------
# physical plan + cost model
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class PhysicalOp:
    """One node of the compiled physical plan."""

    op: str
    rows: int  # estimated output cardinality
    cost: int  # estimated work units (see the module cost model)
    detail: str = ""
    children: tuple["PhysicalOp", ...] = ()


@dataclass(frozen=True)
class CompiledQuery:
    """A fully lowered query: routing decision + costed operator tree."""

    query: ParsedQuery
    index: str
    backend: str
    route: str
    strategy: str
    root: PhysicalOp
    layout: str = ""  # device posting layout ("dense" | "fused")


def _lg(x: int) -> int:
    return max(1, int(x).bit_length())


def _and_rows(lens: list[int], universe: int) -> int:
    """Independence estimate of an intersection's cardinality."""
    if not lens or min(lens) == 0:
        return 0
    r = float(min(lens))
    rest = sorted(lens)[1:]
    for ell in rest:
        r *= ell / max(1, universe)
    return max(1, round(r)) if r >= 0.5 else 0


def _match_cost(op: str, lens: list[int], n_windows: int) -> int:
    n = len(lens)
    lo, hi = min(lens), max(lens)
    if op == OP_DEVICE_SWEEP:
        return n_windows * MAX_CAND_ROWS * n
    if op == "self-locate":
        return max(1, lo) + n
    if op == "compressed-skip":
        return lo * max(1, n - 1) * _lg(hi)
    if op == "sampled-seek":
        return lo * max(1, n - 1) * max(1, _lg(hi) // 2)
    return sum(lens)  # svs-merge: decode everything, galloping merge


def _term_node(term: str, rows: int, caps) -> PhysicalOp:
    op = "locate" if CAP_SHIFTED_INTERSECT in caps else "list-decode"
    return PhysicalOp(op=op, rows=rows, cost=rows, detail=f"term {term!r}")


def rank_pruning_estimate(idx, terms, k: int):
    """Static MaxScore estimate for a ranked query: ``(n_full, n_prunable,
    est_skip_fraction)`` — how many lists (sorted by descending BM25 upper
    bound) must be fully scored, how many can only be probed for already-
    seen candidates, and the fraction of total postings that skips full
    traversal.  ``None`` when the index has no scoring statistics.

    A list at position ``j`` is prunable once the preceding lists supply at
    least ``k`` candidates (``cum_df >= k``) and the summed upper bound of
    lists ``j..`` stays below the best list's bound — the execution-time
    threshold θ (the k-th best full score) is at least one full best-list
    contribution, so these lists cannot introduce a new top-k document.
    """
    scoring = getattr(idx, "scoring", None)
    if scoring is None:
        return None
    n = scoring.n_docs
    info = []
    for t in terms:
        tid = idx.lookup(t)
        if tid is None:
            continue
        df = scoring.df(tid)
        info.append((bm25_upper_bound(df, scoring.term_max_tf(tid), n), df))
    if len(info) < 2:
        return (len(info), 0, 0.0)
    info.sort(key=lambda x: -x[0])
    ubs = [u for u, _ in info]
    dfs = [d for _, d in info]
    total = sum(dfs)
    cum = 0
    for j in range(1, len(info)):
        cum += dfs[j - 1]
        if cum >= k and sum(ubs[j:]) < ubs[0]:
            return (j, len(info) - j, sum(dfs[j:]) / max(1, total))
    return (len(info), 0, 0.0)


def _match_terms(node: Logical) -> tuple[str, ...]:
    """The leaf terms of a match subtree (TermScan/Intersect/PhraseMatch)."""
    if isinstance(node, TermScan):
        return (node.term,)
    if isinstance(node, PhraseMatch):
        return node.terms
    return tuple(c.term for c in node.children)


def compile_query(ctx, q, prefer_device: bool = True,
                  extract: int | None = None) -> CompiledQuery:
    """Lower a query to its costed physical plan against ``ctx``: the
    logical tree from :func:`logical_plan` is walked bottom-up, each node
    lowered to the physical operator the route + backend capabilities
    select, with rows/cost estimated from the index stats surface."""
    pq = parse_query(q)
    rt = route_query(ctx, pq, prefer_device=prefer_device)
    idx = ctx.index if rt.index == "nonpositional" else ctx.positional
    caps = capabilities_of(idx.store)
    universe = int(idx.universe_size)
    n_docs = int(getattr(idx, "n_docs", 0) or len(getattr(idx, "doc_starts", ())))

    def lower_match(node: Logical) -> PhysicalOp:
        terms = _match_terms(node)
        lens = [idx.term_length(t) for t in terms]
        leaves = tuple(_term_node(t, r, caps) for t, r in zip(terms, lens))
        if isinstance(node, TermScan) and rt.route != "device":
            return leaves[0]  # a host word query is the bare list decode
        shifted = isinstance(node, PhraseMatch)
        if rt.route == "device":
            server = ctx.server if rt.index == "nonpositional" else ctx.positional_server
            drive = lens[0] if shifted else min(lens)
            c_entries = drive  # length as proxy when the server can't say
            if hasattr(server, "c_entries"):
                tid = idx.lookup(terms[0 if shifted else lens.index(drive)])
                c_entries = server.c_entries(tid)
            n_windows = max(1, -(-c_entries // MAX_CAND_ROWS))
            op, detail = OP_DEVICE_SWEEP, (
                f"{n_windows} window(s) x {MAX_CAND_ROWS} candidates, "
                f"{'shifted ' if shifted else ''}probes on device, "
                f"width={rt.width}"
                + (f", layout={rt.layout}" if rt.layout else ""))
        else:
            op = "self-locate" if CAP_SHIFTED_INTERSECT in caps and shifted \
                else intersect_operator(caps)
            n_windows = 0
            detail = "offset-shifted intersection" if shifted else ""
            if op == "self-locate":
                detail = ("one native locate of the whole pattern" if shifted
                          else "native per-word locates, intersected")
        return PhysicalOp(op=op, rows=_and_rows(lens, universe),
                          cost=_match_cost(op, lens, n_windows),
                          detail=detail, children=leaves)

    def lower(node: Logical) -> PhysicalOp:
        if isinstance(node, (TermScan, Intersect, PhraseMatch)):
            return lower_match(node)
        if isinstance(node, SimilarLookup):
            sim = getattr(idx, "similarity", None)
            if sim is None:
                rows, detail = 0, "no similarity index mined"
            else:
                rows = max(1, sim.n_docs // max(1, sim.n_clusters))
                detail = (f"doc={node.doc}; {sim.n_clusters} mined "
                          f"cluster(s), {sim.config.num_perm} perms x "
                          f"{sim.config.bands} bands")
            op = OP_CLUSTER_VERSIONS if node.versions else OP_LSH_SIMILAR
            cost = rows if node.versions else \
                rows * (0 if sim is None else sim.config.num_perm)
            return PhysicalOp(op=op, rows=rows, cost=max(1, cost),
                              detail=detail)
        if isinstance(node, ScoredReduce):
            lens = [idx.term_length(t) for t in node.terms]
            leaves = tuple(_term_node(t, r, caps)
                           for t, r in zip(node.terms, lens))
            rows = min(n_docs, sum(lens)) if n_docs else sum(lens)
            if getattr(idx, "scoring", None) is not None:
                op = OP_SCORED_RUNS
                detail = "BM25 over per-term (doc, tf) runs + doc lengths"
            else:
                op = OP_SCORED_REDUCE
                detail = "no scoring stats: decode postings, reduce to docs"
            return PhysicalOp(op=op, rows=rows,
                              cost=rows * max(1, len(node.terms)),
                              detail=detail, children=leaves)
        child = lower(node.child)
        if isinstance(node, DocReduce):
            rows = min(child.rows, n_docs) if n_docs else child.rows
            if rt.route == "device":
                op, cost, detail = "device-dedup", child.cost, \
                    "segment-max over doc ids inside the jitted step"
            elif rt.index == "nonpositional":
                op, cost, detail = "distinct-docs", child.cost + child.rows, \
                    "postings are doc ids already"
            else:
                op = doclist_operator(caps, True, len(_match_terms(node.child)))
                # grammar-doclist / doc-runs are sub-occurrence paths: they
                # *replace* the child's decode, so their cost is not cumulative
                cost = {"self-doclist": child.cost + rows,
                        "grammar-doclist": rows + _lg(child.rows + 1),
                        "doc-runs": rows}.get(op, child.cost + child.rows)
                detail = {"self-doclist": "locate whole pattern, reduce to docs",
                          "grammar-doclist": "phrase-sum walk, unexpanded runs",
                          "doc-runs": "per-term (doc, tf) run structure",
                          "reduce-doclist": "run intersect + reduce"}[op]
            return PhysicalOp(op=op, rows=rows, cost=cost, detail=detail,
                              children=(child,))
        if isinstance(node, TopK):
            rows = min(node.k, child.rows) if child.rows else 0
            if node.score == "bm25":
                if rt.route == "device":
                    return PhysicalOp(
                        op=OP_DEVICE_RANKED, rows=rows,
                        cost=child.cost + n_docs * _lg(node.k),
                        detail=f"k={node.k} score=bm25; dense scatter-add "
                               f"+ lax.top_k, width={rt.width}",
                        children=(child,))
                est = rank_pruning_estimate(idx, pq.terms, node.k)
                if est is not None and est[1] > 0:
                    n_full, n_prun, frac = est
                    saved = round(child.cost * frac)
                    return PhysicalOp(
                        op=OP_WAND_TOPK, rows=rows,
                        cost=max(1, child.cost - saved) + rows * _lg(node.k),
                        detail=f"k={node.k} score=bm25; {n_full} fully-scored"
                               f" + {n_prun} prunable list(s), est skip "
                               f"{round(100 * frac)}%",
                        children=(child,))
                why = ("no scoring stats" if est is None
                       else "upper bounds leave no list prunable")
                return PhysicalOp(
                    op=OP_RANKED_TOPK, rows=rows,
                    cost=child.cost + child.rows * _lg(node.k),
                    detail=f"k={node.k} score=bm25; exhaustive ({why})",
                    children=(child,))
            op = "device-topk" if rt.route == "device" else f"topk-{node.score}"
            return PhysicalOp(op=op, rows=rows,
                              cost=child.cost + child.rows * _lg(node.k),
                              detail=f"k={node.k} score={node.score}",
                              children=(child,))
        assert isinstance(node, Extract), node
        return PhysicalOp(
            op="extract-direct" if "extract" in caps else "stored-text-slice",
            rows=child.rows,
            cost=child.cost + child.rows * (2 * node.context + len(pq.terms)),
            detail=f"context={node.context} tokens per side", children=(child,))

    root = lower(logical_plan(pq, extract=extract))
    return CompiledQuery(query=pq, index=rt.index,
                         backend=getattr(idx, "store_name", "?"),
                         route=rt.route, strategy=rt.strategy, root=root,
                         layout=rt.layout)


# ----------------------------------------------------------------------
# EXPLAIN rendering
# ----------------------------------------------------------------------
def _render(node: PhysicalOp, out: list[str], prefix: str = "",
            last: bool = True, root: bool = False) -> None:
    label = f"{node.op}  rows~{node.rows} cost~{node.cost}"
    if node.detail:
        label += f"  ({node.detail})"
    if root:
        out.append(label)
        child_prefix = ""
    else:
        out.append(prefix + ("└─ " if last else "├─ ") + label)
        child_prefix = prefix + ("   " if last else "│  ")
    for i, ch in enumerate(node.children):
        _render(ch, out, child_prefix, last=(i == len(node.children) - 1))


def explain_text(cq: CompiledQuery, raw: str | None = None) -> str:
    lines = [
        f"query: {raw if raw is not None else unparse(cq.query)}",
        f"kind={cq.query.kind} index={cq.index} backend={cq.backend} "
        f"route={cq.route} strategy={cq.strategy}"
        + (f" layout={cq.layout}" if cq.layout else ""),
    ]
    _render(cq.root, lines, root=True)
    return "\n".join(lines)


def _node_dict(node: PhysicalOp) -> dict:
    d = {"op": node.op, "rows": node.rows, "cost": node.cost}
    if node.detail:
        d["detail"] = node.detail
    if node.children:
        d["children"] = [_node_dict(c) for c in node.children]
    return d


def explain_json(cq: CompiledQuery, raw: str | None = None) -> dict:
    d = {
        "query": raw if raw is not None else unparse(cq.query),
        "kind": cq.query.kind,
        "index": cq.index,
        "backend": cq.backend,
        "route": cq.route,
        "strategy": cq.strategy,
        "plan": _node_dict(cq.root),
    }
    if cq.layout:
        d["layout"] = cq.layout
    return d
