"""Segmented index lifecycle: append-only commits, explicit compaction.

The paper's collections grow by near-copy versions; re-indexing the world
per new version is exactly what a universal index must avoid.
:class:`IndexWriter` makes ingestion incremental the LSM way:

* :meth:`IndexWriter.add_documents` buffers raw documents;
* :meth:`IndexWriter.commit` builds a **full mini-index over just the
  buffered slice** (non-positional + positional, any registered backend)
  and persists it as one immutable segment artifact with a *doc-id base
  offset* — committing a new version batch costs the batch, never the
  collection, and needs no knowledge of the versioning structure
  (universality: linear / tree / chaotic all look the same);
* :meth:`IndexWriter.compact` merges every live segment into one — vocab
  ids remapped in first-occurrence order and posting lists shifted by the
  segment bases, so the compacted index is **identical to a from-scratch
  one-shot build** of the same document sequence (asserted in the
  differential suite);
* :meth:`IndexWriter.compact_async` runs the same merge on a background
  thread while the old segments keep serving, then swaps the merged
  segment in atomically (rename + manifest write under the writer lock)
  and fires an ``on_swap`` hook exactly once — the serving layer's
  refresh point.

Every mutation is crash-consistent: segments build inside dot-prefixed
temp directories (``.tmp-*`` for commits, ``.compact-*`` for
compactions) and are renamed into place before the atomically-replaced
``writer.json`` adopts them, so an interruption at any instant leaves
either the old manifest state or the new — never a half-segment a
reader could open.  Resume discards orphaned build directories.

A writer directory is a ``writer.json`` manifest (store, build kwargs,
version counter, per-segment bases) plus ``segments/<name>/`` artifact
directories (:mod:`repro_torch.core.artifact`).  ``Session.open`` serves the
directory segment-aware, merging per-kind answers on the recorded offsets.

The work a kernel does — mining at commit (``mine_similarity=True``,
``cluster_placement=True``), an ``rlz`` build or restore — runs on the
writer's ``device``: the GPU unless the caller asks for ``"cpu"``.  Every
other build runs on the host and needs no GPU.  The device is not part of
the collection, so ``writer.json`` never records it, and a directory written
on one device opens on any other.
"""

from __future__ import annotations

import json
import shutil
import threading
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np

from ..data.text import Vocabulary
from .analyzer import get_analyzer
from .artifact import ArtifactError, open_index, save_index
from .storage import CompactionHandle
from .index import (
    DOC_SEP,
    NonPositionalIndex,
    PositionalIndex,
    ScoringStats,
    _build_store,
)
from .registry import (
    FAMILY_SELFINDEX,
    BuildSource,
    get_backend_spec,
)

WRITER_MANIFEST = "writer.json"
WRITER_FORMAT_VERSION = 1


@dataclass(frozen=True)
class SegmentMeta:
    """Manifest record of one immutable segment."""

    name: str
    n_docs: int
    doc_base: int  # global doc-id offset of this segment's doc 0
    n_tokens: int  # positional-stream length (0 when positional=False)
    token_base: int  # global token-offset of this segment's position 0
    collection_bytes: int


def is_writer_dir(path) -> bool:
    """True when ``path`` holds a segmented writer layout."""
    return (Path(path) / WRITER_MANIFEST).is_file()


class IndexWriter:
    """Segmented, persistent index builder over one directory.

    Opening an existing directory resumes it (the manifest pins the
    backend and build kwargs; a mismatch is an error, not a silent
    reconfiguration).  ``store_kw`` forwards to the registered backend
    builder exactly like ``Index.build``; ``device`` is where mining and an
    ``rlz`` build run (see the module docstring).
    """

    def __init__(self, path, store: str = "repair_skip", positional: bool = True,
                 keep_text: bool = False, analyzer=None, mine_similarity: bool = False,
                 cluster_placement: bool = False, device="cuda", **store_kw):
        get_backend_spec(store)  # unknown name -> ValueError up front
        self.analyzer = get_analyzer(analyzer)
        self.path = Path(path)
        self.device = device
        self._pending: list[str] = []
        self._lock = threading.RLock()  # segment list + manifest mutations
        self._compaction: CompactionHandle | None = None
        manifest_path = self.path / WRITER_MANIFEST
        if manifest_path.is_file():
            m = json.loads(manifest_path.read_text())
            if m.get("format_version") != WRITER_FORMAT_VERSION:
                raise ArtifactError(
                    f"writer at {self.path} has format_version "
                    f"{m.get('format_version')!r}; this writer understands "
                    f"{WRITER_FORMAT_VERSION}")
            recorded_analyzer = get_analyzer(m.get("analyzer")).config()
            recorded = (m["store"], m.get("store_kw", {}),
                        bool(m["positional"]), bool(m.get("keep_text", False)),
                        recorded_analyzer,
                        bool(m.get("mine_similarity", False)),
                        bool(m.get("cluster_placement", False)))
            if recorded != (store, store_kw, positional, keep_text,
                            self.analyzer.config(), mine_similarity,
                            cluster_placement):
                raise ValueError(
                    f"writer at {self.path} was created with "
                    f"store={m['store']!r} store_kw={m.get('store_kw', {})} "
                    f"positional={recorded[2]} keep_text={recorded[3]} "
                    f"analyzer={recorded_analyzer} "
                    f"mine_similarity={recorded[5]} "
                    f"cluster_placement={recorded[6]}; got "
                    f"store={store!r} store_kw={store_kw} "
                    f"positional={positional} keep_text={keep_text} "
                    f"analyzer={self.analyzer.config()} "
                    f"mine_similarity={mine_similarity} "
                    f"cluster_placement={cluster_placement} — "
                    f"segments of one writer share one configuration "
                    f"(IndexWriter.open resumes with the recorded one)")
            self.store = m["store"]
            self.store_kw = dict(m.get("store_kw", {}))
            self.positional = bool(m["positional"])
            self.keep_text = bool(m.get("keep_text", False))
            self.mine_similarity = bool(m.get("mine_similarity", False))
            self.cluster_placement = bool(m.get("cluster_placement", False))
            self.version = int(m["version"])
            self.segments = [SegmentMeta(**s) for s in m["segments"]]
            # an interrupted commit/compaction leaves build dirs the
            # manifest never adopted — resume discards them so no
            # half-segment is ever served and no name can collide
            self._clean_orphans()
        else:
            self.path.mkdir(parents=True, exist_ok=True)
            self.store = store
            self.store_kw = dict(store_kw)
            self.positional = positional
            self.keep_text = keep_text
            self.mine_similarity = mine_similarity
            self.cluster_placement = cluster_placement
            self.version = 0
            self.segments: list[SegmentMeta] = []
            self._write_manifest()

    @classmethod
    def open(cls, path, device="cuda") -> "IndexWriter":
        """Resume an existing writer directory with its own recorded
        configuration (no need to repeat store / build kwargs); ``device``
        is the new writer's own."""
        manifest_path = Path(path) / WRITER_MANIFEST
        if not manifest_path.is_file():
            raise ArtifactError(f"no writer at {path}: {WRITER_MANIFEST} "
                                f"not found")
        m = json.loads(manifest_path.read_text())
        return cls(path, store=m["store"], positional=bool(m["positional"]),
                   keep_text=bool(m.get("keep_text", False)),
                   analyzer=m.get("analyzer"),
                   mine_similarity=bool(m.get("mine_similarity", False)),
                   cluster_placement=bool(m.get("cluster_placement", False)),
                   device=device, **m.get("store_kw", {}))

    # ------------------------------------------------------------------
    @property
    def n_docs(self) -> int:
        return sum(s.n_docs for s in self.segments)

    @property
    def n_tokens(self) -> int:
        return sum(s.n_tokens for s in self.segments)

    def segment_dir(self, seg: SegmentMeta) -> Path:
        return self.path / "segments" / seg.name

    @property
    def compacting(self) -> bool:
        """True while a background compaction is in flight."""
        handle = self._compaction
        return handle is not None and not handle.done

    def _require_quiesced_writer(self, what: str) -> None:
        if self.compacting:
            raise RuntimeError(
                f"cannot {what} while a background compaction is in "
                f"flight — wait() on the compact_async handle first")

    def _clean_orphans(self) -> None:
        """Remove segment directories the manifest does not reference:
        interrupted-commit ``.tmp-*`` builds, interrupted-compaction
        ``.compact-*`` builds, and renamed-but-never-adopted dirs."""
        seg_root = self.path / "segments"
        if not seg_root.is_dir():
            return
        live = {s.name for s in self.segments}
        for child in seg_root.iterdir():
            if child.is_dir() and child.name not in live:
                shutil.rmtree(child, ignore_errors=True)

    def _write_manifest(self) -> None:
        manifest = {
            "format_version": WRITER_FORMAT_VERSION,
            "store": self.store,
            "store_kw": self.store_kw,
            "positional": self.positional,
            "keep_text": self.keep_text,
            "analyzer": self.analyzer.config(),
            "mine_similarity": self.mine_similarity,
            "cluster_placement": self.cluster_placement,
            "version": self.version,
            "segments": [asdict(s) for s in self.segments],
        }
        tmp = self.path / (WRITER_MANIFEST + ".tmp")
        tmp.write_text(json.dumps(manifest, indent=2))
        tmp.replace(self.path / WRITER_MANIFEST)

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------
    def add_documents(self, docs) -> None:
        """Buffer documents for the next :meth:`commit`."""
        docs = list(docs)
        if any(not isinstance(d, str) for d in docs):
            raise TypeError("add_documents takes an iterable of document strings")
        self._pending.extend(docs)

    def commit(self) -> SegmentMeta:
        """Build + persist one immutable segment over the buffered docs.

        Cost is proportional to the committed batch: the existing segments
        are never touched, so appending a new version of a document is a
        small commit regardless of collection size.

        Crash-consistent: the segment is built inside a ``.tmp-*``
        directory and atomically renamed into place before the manifest
        adopts it — an interrupted commit leaves no half-segment the
        manifest could ever reference (resume discards the orphaned build
        directory).
        """
        self._require_quiesced_writer("commit")
        if not self._pending:
            raise ValueError("nothing to commit: add_documents first")
        docs, self._pending = self._pending, []
        if self.cluster_placement:
            # group near-copies onto adjacent doc ids before the store
            # build: global compressors (Re-Pair, LZ-End) then see version
            # runs even when the ingest order was chaotic
            order = _mine_buffer(docs, self.analyzer,
                                 self.device).cluster_order()
            docs = [docs[int(i)] for i in order]
        name = f"seg-{self.version:06d}"
        seg_dir = self.path / "segments" / name
        tmp_dir = self.path / "segments" / f".tmp-{name}"
        if tmp_dir.exists():
            shutil.rmtree(tmp_dir)
        try:
            idx = NonPositionalIndex.build(docs, store=self.store,
                                           analyzer=self.analyzer,
                                           mine_similarity=self.mine_similarity,
                                           device=self.device, **self.store_kw)
            save_index(idx, tmp_dir / "nonpositional")
            n_tokens = 0
            if self.positional:
                pidx = PositionalIndex.build(docs, store=self.store,
                                             keep_text=self.keep_text,
                                             device=self.device, **self.store_kw)
                save_index(pidx, tmp_dir / "positional")
                n_tokens = int(pidx.n_tokens)
        except BaseException:
            # best-effort cleanup; a hard crash leaves the .tmp dir for
            # resume to discard — the manifest never saw it either way
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
        with self._lock:
            meta = SegmentMeta(name=name, n_docs=len(docs),
                               doc_base=self.n_docs, n_tokens=n_tokens,
                               token_base=self.n_tokens,
                               collection_bytes=sum(len(d) for d in docs))
            tmp_dir.rename(seg_dir)
            self.segments.append(meta)
            self.version += 1
            self._write_manifest()
        return meta

    # ------------------------------------------------------------------
    # compaction
    # ------------------------------------------------------------------
    def open_segment(self, seg: SegmentMeta, *, mmap: bool = False,
                     verify: str | None = None):
        """(nonpositional, positional | None) indexes of one segment.

        ``mmap`` / ``verify`` forward to :func:`repro_torch.core.artifact.open_index`
        — ``Session.open(..., mmap=True)`` threads them through here so a
        multi-segment open stays near-instant."""
        seg_dir = self.segment_dir(seg)
        np_idx = open_index(seg_dir / "nonpositional", mmap=mmap, verify=verify,
                            device=self.device)
        pos_idx = (open_index(seg_dir / "positional", mmap=mmap, verify=verify,
                              device=self.device)
                   if self.positional else None)
        return np_idx, pos_idx

    def _merged_indexes(self, segments: list[SegmentMeta]):
        """Merge the given segments into (nonpositional, positional | None)
        in-memory indexes — the read-only half of a compaction, safe to run
        off-thread while the segments keep serving."""
        opened = [self.open_segment(s) for s in segments]
        merged_np = _merge_nonpositional([o[0] for o in opened], self.store,
                                         self.store_kw, analyzer=self.analyzer,
                                         device=self.device)
        merged_pos = None
        if self.positional:
            merged_pos = _merge_positional([o[1] for o in opened], self.store,
                                           self.store_kw, self.keep_text,
                                           device=self.device)
        return merged_np, merged_pos

    def _write_merged(self, merged_np, merged_pos, name: str) -> Path:
        """Persist the merged indexes into a ``.compact-*`` build directory
        the manifest does not reference yet; returns that directory."""
        tmp_dir = self.path / "segments" / f".compact-{name}"
        if tmp_dir.exists():
            shutil.rmtree(tmp_dir)
        save_index(merged_np, tmp_dir / "nonpositional")
        if merged_pos is not None:
            save_index(merged_pos, tmp_dir / "positional")
        return tmp_dir

    def _swap_merged(self, old: list[SegmentMeta], name: str, tmp_dir: Path,
                     merged_np, merged_pos, on_swap=None) -> SegmentMeta:
        """Atomically adopt the merged segment: rename the build directory
        into place, replace the segment list, persist the manifest, then
        fire ``on_swap`` (the serving layer's refresh hook) and only then
        delete the old segment directories — in-flight readers holding the
        old segments keep their mappings (the inodes outlive the unlink)."""
        with self._lock:
            tmp_dir.rename(self.path / "segments" / name)
            self.segments = [SegmentMeta(
                name=name, n_docs=int(merged_np.n_docs), doc_base=0,
                n_tokens=0 if merged_pos is None else int(merged_pos.n_tokens),
                token_base=0,
                collection_bytes=int(merged_np.collection_bytes))]
            self.version += 1
            self._write_manifest()
            meta = self.segments[0]
        if on_swap is not None:
            on_swap()
        for seg in old:
            shutil.rmtree(self.path / "segments" / seg.name,
                          ignore_errors=True)
        return meta

    def compact(self) -> SegmentMeta:
        """Merge every live segment into one.

        Vocab ids remap in first-occurrence order and postings shift by
        the segment bases, so the result equals a from-scratch build over
        the same document sequence; the merged store is rebuilt once from
        the merged lists/stream through the registered builder.
        """
        self._require_quiesced_writer("compact")
        if not self.segments:
            raise ValueError("nothing to compact: no segments committed")
        old = list(self.segments)
        name = f"seg-{self.version:06d}"
        merged_np, merged_pos = self._merged_indexes(old)
        tmp_dir = self._write_merged(merged_np, merged_pos, name)
        return self._swap_merged(old, name, tmp_dir, merged_np, merged_pos)

    def compact_async(self, on_swap=None) -> CompactionHandle:
        """Start :meth:`compact` on a background thread and return a
        :class:`~repro_torch.core.storage.CompactionHandle`.

        The merge + write run against a snapshot of the current segment
        set while those segments keep serving; the swap is the same
        atomic rename + manifest write as the synchronous path, taken
        under the writer lock.  ``on_swap`` fires exactly once, after the
        manifest adopts the merged segment and before the old directories
        are deleted — ``Session.refresh`` / frontend drain hooks go here
        so new queries see the merged segment while in-flight ones finish
        on the old mappings.

        One compaction at a time: ``commit`` / ``compact`` /
        ``compact_async`` raise while a handle is in flight.  On worker
        failure the ``.compact-*`` build directory is removed and the
        pre-compaction segment set is untouched.
        """
        self._require_quiesced_writer("start another compaction")
        if not self.segments:
            raise ValueError("nothing to compact: no segments committed")
        with self._lock:
            old = list(self.segments)
            name = f"seg-{self.version:06d}"

        def _work() -> SegmentMeta:
            tmp_dir = None
            try:
                merged_np, merged_pos = self._merged_indexes(old)
                tmp_dir = self._write_merged(merged_np, merged_pos, name)
                return self._swap_merged(old, name, tmp_dir, merged_np,
                                         merged_pos, on_swap=on_swap)
            except BaseException:
                if tmp_dir is not None:
                    shutil.rmtree(tmp_dir, ignore_errors=True)
                raise

        handle = CompactionHandle(_work, name=f"compact-{name}")
        self._compaction = handle
        return handle.start()


# ----------------------------------------------------------------------
# placement mining (commit internals)
# ----------------------------------------------------------------------
def _mine_buffer(docs: list[str], analyzer, device):
    """Mine version structure over a buffered batch without building an
    index: term ids are batch-local, which is all shingle hashing needs.
    The signatures are computed on ``device``."""
    from ..data.text import tokenize
    from .similarity import SimilarityIndex

    ids: dict[str, int] = {}
    seqs = []
    for doc in docs:
        seq = []
        for tok in tokenize(doc):
            w = analyzer.normalize(tok)
            if w is not None:
                seq.append(ids.setdefault(w, len(ids)))
        seqs.append(np.asarray(seq, dtype=np.int64))
    return SimilarityIndex.mine(seqs, device=device)


# ----------------------------------------------------------------------
# segment merging (compaction internals)
# ----------------------------------------------------------------------
def _remap_vocab(vocab: Vocabulary, seg_vocab: Vocabulary) -> np.ndarray:
    """Merge ``seg_vocab`` into ``vocab`` (first-occurrence order — the
    same id assignment a one-shot build over the concatenated docs makes)
    and return the old-id -> new-id map."""
    return np.asarray([vocab.add(t) for t in seg_vocab.id_to_token],
                      dtype=np.int64)


def _scatter_lists(stream: np.ndarray, n_lists: int,
                   skip_id: int | None = None) -> list[np.ndarray]:
    """Per-token sorted position lists of ``stream`` (one stable argsort,
    no per-token scan); ``skip_id``'s list is left empty."""
    order = np.argsort(stream, kind="stable")
    counts = np.bincount(stream, minlength=n_lists)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    lists = [order[int(bounds[w]):int(bounds[w + 1])].astype(np.int64)
             for w in range(n_lists)]
    if skip_id is not None:
        lists[skip_id] = np.zeros(0, dtype=np.int64)
    return lists


def _segment_stream(pidx: PositionalIndex) -> np.ndarray:
    """The token-id stream of one positional segment, without stored text:
    kept stream if present, the self-index extract otherwise, else a
    scatter of the posting lists (separator positions are exactly the
    positions no list covers)."""
    if pidx.token_stream is not None:
        return np.asarray(pidx.token_stream, dtype=np.int64)
    store = pidx.store
    if hasattr(store, "to_arrays") and get_backend_spec(pidx.store_name).family == FAMILY_SELFINDEX:
        return np.asarray(store.to_arrays()["stream"], dtype=np.int64)
    sep_id = pidx.vocab.get(DOC_SEP)
    stream = np.full(int(pidx.n_tokens), sep_id, dtype=np.int64)
    for tid in range(store.n_lists):
        if tid == sep_id:
            continue
        pos = np.asarray(store.get_list(tid), dtype=np.int64)
        stream[pos] = tid
    return stream


def _merge_nonpositional(seg_indexes: list[NonPositionalIndex], store: str,
                         store_kw: dict, analyzer=None,
                         device="cuda") -> NonPositionalIndex:
    spec = get_backend_spec(store)
    vocab = Vocabulary()
    need_stream = spec.family == FAMILY_SELFINDEX
    chunks: dict[int, list[np.ndarray]] = {}
    stream_parts: list[np.ndarray] = []
    doc_starts_parts: list[np.ndarray] = []
    # scoring runs merge alongside the postings: segment doc-ids are
    # disjoint ascending ranges, so concatenated per-term runs stay sorted
    have_scoring = all(s.scoring is not None for s in seg_indexes)
    run_chunks: dict[int, list[np.ndarray]] = {}
    tf_chunks: dict[int, list[np.ndarray]] = {}
    dl_parts: list[np.ndarray] = []
    doc_base = word_base = 0
    for seg in seg_indexes:
        idmap = _remap_vocab(vocab, seg.vocab)
        for old_id in range(len(seg.vocab)):
            lst = np.asarray(seg.store.get_list(old_id), dtype=np.int64)
            if len(lst):
                chunks.setdefault(int(idmap[old_id]), []).append(lst + doc_base)
        if have_scoring:
            dl_parts.append(np.asarray(seg.scoring.doc_lengths, dtype=np.int64))
            for old_id in range(len(seg.vocab)):
                rd, rt = seg.scoring.term_runs(old_id)
                if len(rd):
                    nid = int(idmap[old_id])
                    run_chunks.setdefault(nid, []).append(rd + doc_base)
                    tf_chunks.setdefault(nid, []).append(rt)
        if need_stream:
            seg_stream = np.asarray(seg.store.to_arrays()["stream"], dtype=np.int64)
            stream_parts.append(idmap[seg_stream])
            doc_starts_parts.append(np.asarray(seg.doc_starts, dtype=np.int64)
                                    + word_base)
            word_base += len(seg_stream)
        doc_base += seg.n_docs
    lists = [np.concatenate(chunks[w]) if w in chunks else np.zeros(0, dtype=np.int64)
             for w in range(len(vocab))]
    stream = np.concatenate(stream_parts) if stream_parts else None
    doc_starts = (np.concatenate(doc_starts_parts) if doc_starts_parts else None)
    scoring = None
    if have_scoring:
        zero = np.zeros(0, dtype=np.int64)
        run_offsets = np.zeros(len(vocab) + 1, dtype=np.int64)
        max_tf = np.zeros(len(vocab), dtype=np.int64)
        rd_flat: list[np.ndarray] = []
        rt_flat: list[np.ndarray] = []
        for w in range(len(vocab)):
            rd = np.concatenate(run_chunks[w]) if w in run_chunks else zero
            rt = np.concatenate(tf_chunks[w]) if w in tf_chunks else zero
            run_offsets[w + 1] = run_offsets[w] + len(rd)
            max_tf[w] = int(rt.max()) if len(rt) else 0
            rd_flat.append(rd)
            rt_flat.append(rt)
        scoring = ScoringStats(
            doc_lengths=(np.concatenate(dl_parts) if dl_parts
                         else np.zeros(0, dtype=np.int64)),
            run_docs=np.concatenate(rd_flat) if rd_flat else zero,
            run_tfs=np.concatenate(rt_flat) if rt_flat else zero,
            run_offsets=run_offsets, max_tf=max_tf)
    source = BuildSource(lists=lists, n_docs=doc_base, stream=stream,
                         doc_starts=doc_starts, doc_lists=True)
    built = _build_store(spec, source, store_kw, device)
    similarity = None
    if all(s.similarity is not None for s in seg_indexes):
        from .similarity import SimilarityIndex

        similarity = SimilarityIndex.merge([s.similarity for s in seg_indexes])
    return NonPositionalIndex(
        vocab=vocab, store=built, n_docs=doc_base,
        collection_bytes=sum(s.collection_bytes for s in seg_indexes),
        store_name=store, doc_starts=doc_starts, store_kw=dict(store_kw),
        analyzer=None if analyzer is None else get_analyzer(analyzer),
        scoring=scoring, similarity=similarity)


def _merge_positional(seg_indexes: list[PositionalIndex], store: str,
                      store_kw: dict, keep_text: bool,
                      device="cuda") -> PositionalIndex:
    spec = get_backend_spec(store)
    vocab = Vocabulary()
    sep_id = vocab.add(DOC_SEP)
    stream_parts: list[np.ndarray] = []
    doc_starts_parts: list[np.ndarray] = []
    token_base = 0
    for seg in seg_indexes:
        idmap = _remap_vocab(vocab, seg.vocab)
        assert int(idmap[seg.vocab.get(DOC_SEP)]) == sep_id
        stream_parts.append(idmap[_segment_stream(seg)])
        doc_starts_parts.append(np.asarray(seg.doc_starts, dtype=np.int64)
                                + token_base)
        token_base += int(seg.n_tokens)
    stream = (np.concatenate(stream_parts) if stream_parts
              else np.zeros(0, dtype=np.int64))
    doc_starts = (np.concatenate(doc_starts_parts) if doc_starts_parts
                  else np.zeros(0, dtype=np.int64))
    lists = _scatter_lists(stream, len(vocab), skip_id=sep_id)
    source = BuildSource(
        lists=lists, n_docs=len(doc_starts),
        stream=stream if spec.family == FAMILY_SELFINDEX else None,
        doc_starts=doc_starts, sep_id=sep_id)
    built = _build_store(spec, source, store_kw, device)
    return PositionalIndex(
        vocab=vocab, store=built, doc_starts=doc_starts, n_tokens=len(stream),
        collection_bytes=sum(s.collection_bytes for s in seg_indexes),
        store_name=store, token_stream=stream if keep_text else None,
        store_kw=dict(store_kw))
