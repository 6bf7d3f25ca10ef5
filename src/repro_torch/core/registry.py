"""Capability-based backend registry: one store namespace, one query protocol.

The paper's central comparison puts inverted-index stores (§5) and
compressed self-indexes (§6 / Appendix A) side by side as interchangeable
search backends.  This module is the API that makes them interchangeable in
code:

* :class:`SearchBackend` — the protocol every backend speaks: posting-list
  access (``get_list`` / ``list_length``) plus candidate-driven intersection
  (``intersect_candidates`` / ``intersect_multi`` / ``intersect_shifted``)
  and exact bit-level size accounting.  Concrete behavior is selected by
  **declared capabilities**, never by concrete types:

  ========================  ====================================================
  capability                meaning
  ========================  ====================================================
  ``seek``                  sampled seek into a compressed list (§2.2 CM/ST,
                            §4.2 Re-Pair sampling) — candidates start
                            mid-stream instead of at the list head
  ``intersect_candidates``  compressed-domain candidate intersection without
                            full decode (Re-Pair skipping §4.1/§4.3, sampled
                            Vbyte chunks §2.2)
  ``shifted_intersect``     native offset-shifted (phrase) search — the
                            backend answers a whole phrase pattern in one
                            ``locate`` instead of per-term probes (self-
                            indexes, Appendix A)
  ``device_resident``       the backend's own arrays anchor directly onto the
                            device (``AnchoredIndex.from_store``) — no
                            decode-and-re-anchor pass is needed
  ``extract``               snippet extraction: the backend can reproduce the
                            underlying token stream (self-index property)
  ``doc_list``              native document listing: distinct documents
                            containing a pattern in time proportional to the
                            number of distinct documents, not total
                            occurrences (grammar phrase-sum skipping for the
                            Re-Pair stores; one whole-pattern ``locate`` for
                            the self-indexes) — see ``repro_torch.core.doclist``
  ``persist``               the backend round-trips through the on-disk
                            artifact format (``repro_torch.core.artifact``):
                            ``to_arrays()`` exports pure array/bytes
                            components, the registered restore hook
                            reconstructs a byte-identical backend from them
  ``referential``           lists are stored as differences against mined
                            cluster heads (version-structure mining,
                            ``repro_torch.core.similarity``) — decoding a list
                            may decode its head first (``rlz``)
  ========================  ====================================================

* :func:`register_backend` — decorator placing a build function in the registry
  with per-backend metadata (family, benchmark group, capability set,
  accepted build kwargs).  Unknown names and unknown kwargs raise
  ``ValueError`` naming the alternatives; ``**store_kw`` forwards uniformly.

* :class:`BuildSource` — everything a build function may consume, derived once from
  the document collection by the index build: per-term posting lists for the
  inverted family, the token-id stream + document boundaries for the
  self-index family.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Protocol, runtime_checkable

import numpy as np

# ----------------------------------------------------------------------
# capability flags
# ----------------------------------------------------------------------
CAP_SEEK = "seek"
CAP_INTERSECT_CANDIDATES = "intersect_candidates"
CAP_SHIFTED_INTERSECT = "shifted_intersect"
CAP_DEVICE_RESIDENT = "device_resident"
CAP_EXTRACT = "extract"
CAP_DOC_LIST = "doc_list"
CAP_PERSIST = "persist"
CAP_REFERENTIAL = "referential"

ALL_CAPABILITIES = frozenset({
    CAP_SEEK, CAP_INTERSECT_CANDIDATES, CAP_SHIFTED_INTERSECT,
    CAP_DEVICE_RESIDENT, CAP_EXTRACT, CAP_DOC_LIST, CAP_PERSIST,
    CAP_REFERENTIAL,
})

# backend families
FAMILY_INVERTED = "inverted"
FAMILY_SELFINDEX = "selfindex"


@runtime_checkable
class SearchBackend(Protocol):
    """What the indexes, planner, and serving layers require of a backend.

    ``repro_torch.core.codecs.base.ListStore`` provides capability-aware default
    implementations of the intersection methods, so a backend only overrides
    what its declared capabilities improve on.
    """

    capabilities: frozenset[str]

    @property
    def n_lists(self) -> int: ...

    def get_list(self, i: int) -> np.ndarray: ...

    def list_length(self, i: int) -> int: ...

    def intersect_candidates(self, i: int, cand: np.ndarray) -> np.ndarray: ...

    def intersect_multi(self, list_ids: list[int]) -> np.ndarray: ...

    def intersect_shifted(self, list_ids: list[int], shifts: list[int]) -> np.ndarray: ...

    @property
    def size_in_bits(self) -> int: ...


# ----------------------------------------------------------------------
# build-time input
# ----------------------------------------------------------------------
@dataclass
class BuildSource:
    """Input bundle handed to backend build functions by the index build.

    The inverted family consumes ``lists``; the self-index family consumes
    ``stream`` (+ ``doc_starts`` when doc-granularity answers are needed).
    """

    lists: list[np.ndarray]
    stream: np.ndarray | None = None  # token-id sequence over the collection
    doc_starts: np.ndarray | None = None  # stream offset where each doc begins
    n_docs: int = 0
    sep_id: int | None = None  # document-separator token id in `stream`
    doc_lists: bool = False  # True: answers are doc ids, not stream positions

    @classmethod
    def from_lists(cls, lists: Iterable[np.ndarray]) -> "BuildSource":
        return cls(lists=[np.asarray(l, dtype=np.int64) for l in lists])


# ----------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class BackendSpec:
    """Registry metadata for one backend."""

    name: str
    family: str  # FAMILY_INVERTED | FAMILY_SELFINDEX
    builder: Callable[..., Any]  # fn(source: BuildSource, **kw) -> backend
    capabilities: frozenset[str]
    group: str  # benchmark grouping: "traditional" | "ours" | "selfindex"
    build_kwargs: tuple[str, ...]  # kwarg names the build function accepts
    defaults: dict[str, Any] = field(default_factory=dict)
    doc: str = ""
    paper: str = ""  # paper section the method comes from
    #: restore(arrays, **store_kw) -> backend, inverting ``to_arrays()``;
    #: None selects the generic decoded-postings rebuild (see
    #: :func:`restore_backend`)
    restore: Callable[..., Any] | None = None


_REGISTRY: dict[str, BackendSpec] = {}
_builtin_loaded = False


def _ensure_builtin() -> None:
    """Import the module that registers the built-in backends (lazily, so
    `registry` itself stays import-cycle free)."""
    global _builtin_loaded
    if not _builtin_loaded:
        from . import backends  # noqa: F401  (registers on import)

        _builtin_loaded = True


def register_backend(name: str, *, family: str, capabilities: Iterable[str] = (),
                     group: str = "ours", doc: str = "", paper: str = "",
                     restore: Callable[..., Any] | None = None):
    """Decorator: place the decorated ``build(source, **kw)`` in the registry.

    The build function's keyword parameters (with their defaults) become the
    backend's declared build kwargs; anything else passed at build time is a
    ``ValueError``.  ``restore`` inverts the backend's ``to_arrays()``
    export (true compiled-state reload); without one the generic
    decoded-postings rebuild applies.  Either way the backend persists, so
    every spec carries the ``persist`` capability.
    """
    caps = frozenset(capabilities) | {CAP_PERSIST}
    unknown = caps - ALL_CAPABILITIES
    if unknown:
        raise ValueError(f"unknown capabilities {sorted(unknown)}; "
                         f"valid: {sorted(ALL_CAPABILITIES)}")
    if family == FAMILY_SELFINDEX and restore is None:
        raise ValueError(
            f"backend {name!r}: self-index backends build from a token "
            f"stream, not posting lists, so the generic restore path does "
            f"not apply — pass an explicit restore hook")

    def deco(builder):
        params = inspect.signature(builder).parameters
        kw_names = tuple(p.name for p in params.values()
                         if p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD)
                         and p.name != "source")
        defaults = {p.name: p.default for p in params.values()
                    if p.name in kw_names and p.default is not p.empty}
        if name in _REGISTRY:
            raise ValueError(f"backend {name!r} already registered")
        doc_lines = (doc or builder.__doc__ or "").strip().splitlines()
        _REGISTRY[name] = BackendSpec(
            name=name, family=family, builder=builder, capabilities=caps,
            group=group, build_kwargs=kw_names, defaults=defaults,
            doc=doc_lines[0] if doc_lines else "", paper=paper,
            restore=restore)
        return builder

    return deco


def backend_names(family: str | None = None, group: str | None = None) -> list[str]:
    """Registered backend names, in registration order, optionally filtered."""
    _ensure_builtin()
    return [n for n, s in _REGISTRY.items()
            if (family is None or s.family == family)
            and (group is None or s.group == group)]


def backend_specs(family: str | None = None) -> list[BackendSpec]:
    _ensure_builtin()
    return [s for s in _REGISTRY.values() if family is None or s.family == family]


def get_backend_spec(name: str) -> BackendSpec:
    """Spec for ``name``; unknown names raise ValueError listing the registry."""
    _ensure_builtin()
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(
            f"unknown backend {name!r}; registered backends: "
            f"{', '.join(sorted(_REGISTRY))}")
    return spec


def build_backend(name: str, source: "BuildSource | list[np.ndarray]", **store_kw):
    """Build backend ``name`` from ``source`` (a :class:`BuildSource`, or a
    plain list of posting arrays for the inverted family).

    Raises ``ValueError`` for unknown backend names (listing registered
    ones) and for build kwargs the backend does not accept (listing the
    accepted ones).
    """
    spec = get_backend_spec(name)
    if not isinstance(source, BuildSource):
        source = BuildSource.from_lists(source)
    bad = set(store_kw) - set(spec.build_kwargs)
    if bad:
        accepted = ", ".join(spec.build_kwargs) or "(none)"
        raise ValueError(
            f"backend {name!r} got unexpected build kwargs {sorted(bad)}; "
            f"accepted: {accepted}")
    if spec.family == FAMILY_SELFINDEX and source.stream is None:
        raise ValueError(
            f"backend {name!r} is a self-index: it builds from the token "
            f"stream of a document collection, not from raw posting lists "
            f"(build it through NonPositionalIndex.build / "
            f"PositionalIndex.build)")
    return spec.builder(source, **store_kw)


def capabilities_of(backend) -> frozenset[str]:
    """The backend's declared capability set (empty when undeclared)."""
    return getattr(backend, "capabilities", frozenset())


# ----------------------------------------------------------------------
# persistence: to_arrays() export / restore_backend() reload
# ----------------------------------------------------------------------
def lists_to_arrays(lists: Iterable[np.ndarray]) -> dict[str, np.ndarray]:
    """Pack posting lists into the two-array concat layout the generic
    persistence path stores (``postings`` + ``offsets``)."""
    lists = [np.asarray(l, dtype=np.int64) for l in lists]
    offsets = np.zeros(len(lists) + 1, dtype=np.int64)
    for i, l in enumerate(lists):
        offsets[i + 1] = offsets[i] + len(l)
    concat = (np.concatenate(lists) if lists else np.zeros(0, dtype=np.int64))
    return {"postings": concat, "offsets": offsets}


def lists_from_arrays(arrays: dict) -> list[np.ndarray]:
    """Inverse of :func:`lists_to_arrays`."""
    concat = np.asarray(arrays["postings"], dtype=np.int64)
    offsets = np.asarray(arrays["offsets"], dtype=np.int64)
    return [concat[int(offsets[i]):int(offsets[i + 1])]
            for i in range(len(offsets) - 1)]


def backend_arrays(name: str, backend) -> dict:
    """The backend's persistable components via ``to_arrays()`` —
    ``ListStore`` supplies the generic decoded-postings default, so every
    registered backend exports; a protocol-only custom backend must
    implement it to persist."""
    get_backend_spec(name)  # unknown name -> ValueError up front
    if not hasattr(backend, "to_arrays"):
        raise ValueError(
            f"backend {name!r} ({type(backend).__name__}) exports no "
            f"persistable arrays — inherit ListStore or implement "
            f"to_arrays()")
    return backend.to_arrays()


def restore_backend(name: str, arrays: dict, **store_kw):
    """Reconstruct backend ``name`` from its persisted component arrays.

    Backends registered with a ``restore`` hook reload their compiled state
    directly (no recompression); everything else rebuilds through the
    registered build function from the stored posting lists — deterministic, so
    the restored backend answers byte-identically either way.
    """
    spec = get_backend_spec(name)
    bad = set(store_kw) - set(spec.build_kwargs)
    if bad:
        accepted = ", ".join(spec.build_kwargs) or "(none)"
        raise ValueError(
            f"backend {name!r} got unexpected build kwargs {sorted(bad)}; "
            f"accepted: {accepted}")
    if spec.restore is not None:
        return spec.restore(arrays, **store_kw)
    source = BuildSource(lists=lists_from_arrays(arrays))
    return spec.builder(source, **store_kw)


# ----------------------------------------------------------------------
# capability → physical operator mapping (the plan compiler's vocabulary)
# ----------------------------------------------------------------------
OP_SELF_LOCATE = "self-locate"
OP_COMPRESSED_SKIP = "compressed-skip"
OP_SAMPLED_SEEK = "sampled-seek"
OP_SVS_MERGE = "svs-merge"
OP_DEVICE_SWEEP = "device-windowed-sweep"
OP_SELF_DOCLIST = "self-doclist"
OP_GRAMMAR_DOCLIST = "grammar-doclist"
OP_DOC_RUNS = "doc-runs"
OP_REDUCE_DOCLIST = "reduce-doclist"
OP_SCORED_RUNS = "scored-doc-runs"
OP_SCORED_REDUCE = "scored-reduce"
OP_WAND_TOPK = "wand-topk"
OP_RANKED_TOPK = "ranked-topk"
OP_DEVICE_RANKED = "device-ranked"
OP_REFERENTIAL_MERGE = "referential-merge"
OP_LSH_SIMILAR = "lsh-similar"
OP_CLUSTER_VERSIONS = "cluster-versions"

#: physical operator → (capability requirement, one-line description); the
#: matrix ``serving.plan`` lowers through (also rendered by scripts/explain.py)
PHYSICAL_OPERATORS = {
    OP_SELF_LOCATE: ("shifted_intersect",
                     "one native locate answers the whole pattern (self-indexes)"),
    OP_SAMPLED_SEEK: ("intersect_candidates + seek",
                      "compressed-domain candidate probes starting at samples"),
    OP_COMPRESSED_SKIP: ("intersect_candidates",
                         "compressed-domain candidate probes from the list head"),
    OP_SVS_MERGE: ("(fallback)", "decode lists, galloping set-vs-set merge"),
    OP_DEVICE_SWEEP: ("device server attached",
                      "anchored binary-search probes, windowed-exact, jitted"),
    OP_SELF_DOCLIST: ("shifted_intersect",
                      "whole-pattern locate, positions reduced to documents"),
    OP_GRAMMAR_DOCLIST: ("doc_list",
                         "grammar phrase-sum walk; in-document phrases stay unexpanded"),
    OP_DOC_RUNS: ("(fallback, single term)",
                  "ILCP-style per-term (doc, tf) run structure"),
    OP_REDUCE_DOCLIST: ("(fallback, multi-term)",
                        "shifted/run intersection, then reduce to documents"),
    OP_SCORED_RUNS: ("scoring stats present",
                     "BM25 over the per-term (doc, tf) run structure"),
    OP_SCORED_REDUCE: ("(fallback)",
                       "decode postings, reduce positions to scored documents"),
    OP_WAND_TOPK: ("scoring stats present",
                   "MaxScore top-k: term upper bounds skip unreachable lists"),
    OP_RANKED_TOPK: ("(fallback)",
                     "exhaustive BM25 top-k over every matching document"),
    OP_DEVICE_RANKED: ("device server + scoring stats",
                       "device-side dense BM25 scatter-add + lax.top_k"),
    OP_REFERENTIAL_MERGE: ("referential",
                           "decode head + diff records, galloping set-vs-set merge"),
    OP_LSH_SIMILAR: ("similarity index present",
                     "LSH bucket candidates filtered by estimated Jaccard"),
    OP_CLUSTER_VERSIONS: ("similarity index present",
                          "mined union-find cluster membership lookup"),
}


def intersect_operator(caps: frozenset[str]) -> str:
    """The host intersection operator a capability set selects.

    Self-indexes locate whole patterns natively; ``intersect_candidates``
    backends intersect in the compressed domain (with or without sampled
    seeks); everything else decodes and merges.
    """
    if CAP_SHIFTED_INTERSECT in caps:
        return OP_SELF_LOCATE
    if CAP_INTERSECT_CANDIDATES in caps:
        return OP_SAMPLED_SEEK if CAP_SEEK in caps else OP_COMPRESSED_SKIP
    if CAP_REFERENTIAL in caps:
        return OP_REFERENTIAL_MERGE
    return OP_SVS_MERGE


def doclist_operator(caps: frozenset[str], positional: bool, n_terms: int) -> str:
    """The host document-listing operator (``docs:`` / ``docs-top<k>:``).

    On the positional index, self-indexes reduce one whole-pattern locate;
    single-term patterns use the grammar walk (``doc_list`` capability) or
    the run structure; conjunctions intersect per-term document runs.  On
    the non-positional index the postings *are* doc ids, so the listing is
    the store's own intersection path.
    """
    if positional:
        if CAP_SHIFTED_INTERSECT in caps:
            return OP_SELF_DOCLIST
        if n_terms == 1:
            return OP_GRAMMAR_DOCLIST if CAP_DOC_LIST in caps else OP_DOC_RUNS
        return OP_REDUCE_DOCLIST
    return "doclist+" + intersect_operator(caps)
