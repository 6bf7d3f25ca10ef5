"""Batched device serving: the device steps and the windowed-exact host loop.

The serving stack is plan-first:

* ``serving.plan`` — `parse_query` → logical plan → cost-aware compiler →
  physical plan (`route_query` / `compile_query` / EXPLAIN rendering).
* ``serving.session.Session`` — the entry point: plan-cached,
  shape-grouped `execute`, plus `explain` and `metrics`.
* this module — the device-side batched steps (:func:`make_serve_step`) and
  the windowed-exact host loop around them (:class:`BatchedServer`).

Device-step geometry: padded (batch, width) term-id matrices; each step
generates candidates from the query's first list (dense expand rows, or rows
decoded from the rule pool in the fused layout) and probes the remaining
terms through the anchored binary search.  Phrase queries probe *shifted*
candidates (offset-shifted intersection, paper §3): term ``t`` of a phrase
must hold ``position + t``.  Candidate generation is **windowed**: the host
loop sweeps ``row_start`` over the driving list's C-entries so arbitrarily
long lists are served exactly.  Ranked top-k computes idf-proxy weights on
device and reduces with a stable descending sort; document listing maps
matches to doc ids and dedups on device with a running maximum.

Everything runs on the server's ``device``: ``"cuda"`` unless the caller asks
for ``"cpu"``.  ``probe="kernel"`` routes the probes (and the fused decode)
through the CUDA kernels of ``repro_torch.kernels``; ``probe="torch"`` is the
same step in plain tensor code.
"""

from __future__ import annotations

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
from ..core.index import NonPositionalIndex, PositionalIndex
from ..core.registry import CAP_DEVICE_RESIDENT, capabilities_of
from .plan import (
    AND,
    MAX_CAND_ROWS,
    PHRASE,
    SERVER_KINDS,
)

PROBES = ("kernel", "torch")


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
    """AND / phrase probe loop shared by all steps.  For phrase queries term
    ``t`` probes candidate + t (offset-shifted intersection, §3).  ``member``
    is the probe implementation (the plain batched binary search by default —
    picked by index layout — or the dense layout's CUDA kernel via
    ``probe="kernel"``; the fused layout's kernel step runs this loop as one
    ``fused_decode.probe_window`` launch instead)."""
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


def _kernel_member():
    from ..kernels.anchor_intersect.ops import member_batch_kernel

    def member(idx: AnchoredIndex, list_ids, values):
        return member_batch_kernel(idx.anchors, idx.c_offsets, idx.expand,
                                   idx.expand_valid, list_ids, values)

    return member


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
    before it.  ``probe="kernel"`` routes candidate generation and the
    probes through the CUDA kernels: for the dense layout
    ``anchor_intersect``'s sliced lower bound once per probed term; for the
    fused one two launches a window whatever the width —
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
    member = None
    window = None  # (decode_window, probe_window): the fused kernel step
    if probe == "kernel":
        if fused:
            from ..kernels.fused_decode.ops import decode_window, probe_window

            window = (decode_window, probe_window)
        else:
            member = _kernel_member()

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
            match = _probe_terms(idx, query_terms, query_lens, cand_vals, cand_valid,
                                 max_terms, phrase, member=member)
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
    #: no "rank": BM25 queries run on the host scorer
    kinds: frozenset = SERVER_KINDS
    _steps: dict = field(default_factory=dict)
    trace_events: int = 0
    windows_swept: int = 0  # device steps run (one per window per batch)
    # host-side copies of the immutable planning arrays, so encode /
    # window counting never does a device->host transfer per batch
    _lengths_np: np.ndarray | None = None
    _c_offsets_np: np.ndarray | None = None

    def __post_init__(self):
        if self._lengths_np is None:
            self._lengths_np = self.arrays["lengths"].cpu().numpy()
        if self._c_offsets_np is None:
            self._c_offsets_np = self.arrays["c_offsets"].cpu().numpy()

    #: posting-layout array names (device-memory accounting; doc_starts is a
    #: layout-independent extra)
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
        return cls(host_index=index, arrays=arrays,
                   n_docs=float(index.universe_size), probe=probe,
                   layout=layout, max_phrase=max_phrase)

    @classmethod
    def from_arrays(cls, host_index, arrays: dict, layout: str, max_phrase: int = 0,
                    n_docs: float | None = None, device="cuda",
                    probe: str | None = None) -> "BatchedServer":
        """A server over device state carried across as NumPy arrays (keys
        as in ``_LAYOUT_ARRAYS[layout]``, plus ``doc_starts`` for a
        positional index; any other key is ignored)."""
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
        if n_docs is None:
            n_docs = float(host_index.universe_size)
        return cls(host_index=host_index, arrays=tensors, n_docs=float(n_docs),
                   probe=probe, layout=layout, max_phrase=int(max_phrase))

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
