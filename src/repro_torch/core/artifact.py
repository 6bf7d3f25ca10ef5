"""Versioned on-disk index artifacts: build once, persist, reopen anywhere.

The paper's setting is collections that persist and grow; an index that
lives only in process memory forces the rebuild-the-world workflow the
universal-index premise rejects.  This module is the persistence layer
under :mod:`repro_torch.core.writer` (segments) and ``Session.open``:

* :func:`save_index` writes a built :class:`NonPositionalIndex` /
  :class:`PositionalIndex` as one artifact directory — a ``manifest.json``
  plus one blob per component (``.npy`` arrays / ``.bin`` bytes), each
  sha256-checksummed in the manifest.  Backend state comes from the
  registry persistence surface (``to_arrays()`` or the generic decoded-
  postings layout — see :func:`repro_torch.core.registry.backend_arrays`).

* :func:`open_index` verifies checksums (per the ``verify`` policy),
  reconstructs the vocabulary, and reloads the backend through its
  registered restore hook (:func:`repro_torch.core.registry.restore_backend`) —
  Re-Pair grammars reload their packed rule arrays without recompressing;
  self-indexes rebuild from the persisted token stream.  The reopened
  index answers every query kind byte-identically to the index that was
  saved (asserted per backend in ``tests/test_differential.py``).

* ``open_index(..., mmap=True)`` is the scale path
  (:mod:`repro_torch.core.storage`): array components open as memory maps, the
  generic posting layout is served in place, and checksum verification
  defers to first use — opening a collection larger than RAM is
  near-instant and resident bytes track the queried working set.

Corruption is a first-class error path: a blob whose checksum no longer
matches its manifest entry raises :class:`ArtifactError` naming the bad
component, never a silently wrong index.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from ..data.text import Vocabulary
from .analyzer import Analyzer, get_analyzer
from .index import NonPositionalIndex, PositionalIndex, ScoringStats
from .registry import (
    FAMILY_INVERTED,
    backend_arrays,
    get_backend_spec,
    restore_backend,
)
from .storage import ArtifactError, BlobStore, MappedListStore

FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"

KIND_NONPOSITIONAL = "nonpositional"
KIND_POSITIONAL = "positional"

__all__ = ["ArtifactError", "save_index", "open_index", "read_manifest",
           "FORMAT_VERSION", "MANIFEST_NAME"]


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _write_component(root: Path, name: str, value) -> dict:
    """Write one component blob and return its manifest entry."""
    if isinstance(value, (bytes, bytearray)):
        fname = f"{name}.bin"
        payload = bytes(value)
        (root / fname).write_bytes(payload)
        kind = "bytes"
    else:
        fname = f"{name}.npy"
        arr = np.asarray(value)
        with open(root / fname, "wb") as f:
            np.save(f, arr, allow_pickle=False)
        payload = (root / fname).read_bytes()
        kind = "array"
    return {"file": fname, "kind": kind, "nbytes": len(payload),
            "sha256": _sha256(payload)}


# ----------------------------------------------------------------------
# save
# ----------------------------------------------------------------------
def save_index(index: NonPositionalIndex | PositionalIndex, path) -> Path:
    """Persist a built index as an artifact directory; returns the path.

    Layout: ``manifest.json`` (format version, kind, backend name + build
    kwargs, scalar metadata, per-component checksums) next to one blob per
    component — the vocabulary, document boundaries, the optional kept
    token stream, and the backend's ``store.*`` arrays.
    """
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    if isinstance(index, PositionalIndex):
        kind = KIND_POSITIONAL
        meta = {"n_tokens": int(index.n_tokens)}
    elif isinstance(index, NonPositionalIndex):
        kind = KIND_NONPOSITIONAL
        meta = {"n_docs": int(index.n_docs)}
    else:
        raise ArtifactError(f"cannot persist {type(index).__name__}: "
                            f"save_index covers the two built index classes")
    meta["collection_bytes"] = int(index.collection_bytes)

    components: dict[str, dict] = {}
    vocab_blob = json.dumps(index.vocab.id_to_token).encode("utf-8")
    components["vocab"] = _write_component(root, "vocab", vocab_blob)
    if index.doc_starts is not None:
        components["doc_starts"] = _write_component(
            root, "doc_starts", np.asarray(index.doc_starts, dtype=np.int64))
    if getattr(index, "token_stream", None) is not None:
        components["token_stream"] = _write_component(
            root, "token_stream", np.asarray(index.token_stream, dtype=np.int64))
    if kind == KIND_NONPOSITIONAL:
        # pin the analysis chain: reopening with a different query-time
        # analyzer must be refused, not silently mis-ranked
        meta["analyzer"] = (index.analyzer or Analyzer()).config()
        scoring = index.scoring
        if scoring is not None:
            for key in ("doc_lengths", "run_docs", "run_tfs",
                        "run_offsets", "max_tf"):
                components[f"scoring.{key}"] = _write_component(
                    root, f"scoring.{key}",
                    np.asarray(getattr(scoring, key), dtype=np.int64))
        similarity = getattr(index, "similarity", None)
        if similarity is not None:
            # pin the mining parameters alongside the signature arrays so
            # similar:/versions-of: answers reopen byte-identically
            meta["similarity"] = similarity.config.config()
            for key, value in similarity.to_arrays().items():
                components[f"similarity.{key}"] = _write_component(
                    root, f"similarity.{key}", value)
    for key, value in backend_arrays(index.store_name, index.store).items():
        components[f"store.{key}"] = _write_component(root, f"store.{key}", value)

    manifest = {
        "format_version": FORMAT_VERSION,
        "kind": kind,
        "store": index.store_name,
        "store_kw": dict(index.store_kw),
        "meta": meta,
        "components": components,
    }
    (root / MANIFEST_NAME).write_text(json.dumps(manifest, indent=2))
    return root


# ----------------------------------------------------------------------
# open
# ----------------------------------------------------------------------
def read_manifest(path) -> dict:
    """The parsed, version-checked manifest of an artifact directory."""
    root = Path(path)
    mpath = root / MANIFEST_NAME
    if not mpath.is_file():
        raise ArtifactError(f"no index artifact at {root}: {MANIFEST_NAME} "
                            f"not found")
    try:
        manifest = json.loads(mpath.read_text())
    except json.JSONDecodeError as e:
        raise ArtifactError(f"malformed {MANIFEST_NAME} at {root}: {e}") from e
    version = manifest.get("format_version")
    if version != FORMAT_VERSION:
        raise ArtifactError(
            f"artifact at {root} has format_version {version!r}; this "
            f"reader understands {FORMAT_VERSION}")
    return manifest


def open_index(path, analyzer=None, *, mmap: bool = False,
               verify: str | None = None, device="cuda"
               ) -> NonPositionalIndex | PositionalIndex:
    """Reopen a persisted index: verify checksums per the ``verify``
    policy, rebuild the vocabulary, restore the backend through its
    registered hook.

    ``analyzer`` asserts the query-time analysis chain: if it differs from
    the chain recorded at build time the open is refused with an
    :class:`ArtifactError` (the index terms would not match the query
    terms).  Omit it to adopt the recorded chain.

    ``mmap=True`` opens array components via ``np.load(mmap_mode="r")``
    instead of reading them whole; backends without a compiled-state
    restore hook are then served *in place* through
    :class:`~repro_torch.core.storage.MappedListStore` — no decode, no rebuild,
    resident bytes scale with the queried working set.  ``verify``
    defaults to ``"eager"`` (``"lazy"`` under mmap): with ``"lazy"`` the
    deferred components are hash-checked before the first posting is
    served rather than at open (see :class:`~repro_torch.core.storage.BlobStore`).
    The opened index carries its store as ``index.blobstore`` for
    resident-bytes accounting.

    ``device`` goes only to a backend whose restore builds on one (``rlz``
    re-mines its lists, a kernel's work); every other open ignores it and
    needs no GPU.  A device is not part of an index: it never enters the
    manifest's ``store_kw``."""
    root = Path(path)
    manifest = read_manifest(root)
    if verify is None:
        verify = "lazy" if mmap else "eager"
    blobs = BlobStore(root, manifest["components"], mmap=mmap, verify=verify)

    tokens = json.loads(blobs.get("vocab").decode("utf-8"))
    vocab = Vocabulary(token_to_id={t: i for i, t in enumerate(tokens)},
                       id_to_token=list(tokens))
    loaded = blobs.get_all()
    doc_starts = loaded.get("doc_starts")
    if doc_starts is not None:
        doc_starts = np.asarray(doc_starts, dtype=np.int64)
    store_arrays = {name[len("store."):]: value
                    for name, value in loaded.items()
                    if name.startswith("store.")}
    store_name = manifest["store"]
    store_kw = dict(manifest.get("store_kw", {}))
    spec = get_backend_spec(store_name)
    if mmap and spec.restore is None and spec.family == FAMILY_INVERTED:
        # generic persisted layout: serve the mapped arrays in place (the
        # registered builder would re-encode every list); the first
        # posting touch settles any deferred checksums
        store = MappedListStore(store_arrays["postings"],
                                store_arrays["offsets"],
                                verify_hook=blobs.verify_pending)
    else:
        extra = {"device": device} if "device" in spec.build_kwargs else {}
        store = restore_backend(store_name, store_arrays, **store_kw, **extra)
        blobs.verify_pending()  # the restore consumed the arrays: check now

    meta = manifest["meta"]
    if manifest["kind"] == KIND_POSITIONAL:
        if doc_starts is None:
            raise ArtifactError(
                f"positional artifact at {root} has no doc_starts component")
        stream = loaded.get("token_stream")
        idx = PositionalIndex(
            vocab=vocab, store=store, doc_starts=doc_starts,
            n_tokens=int(meta["n_tokens"]),
            collection_bytes=int(meta["collection_bytes"]),
            store_name=store_name,
            token_stream=None if stream is None else np.asarray(stream, dtype=np.int64),
            store_kw=store_kw)
        idx.blobstore = blobs
        return idx
    if manifest["kind"] == KIND_NONPOSITIONAL:
        recorded = Analyzer.from_config(meta.get("analyzer"))
        if analyzer is not None:
            requested = get_analyzer(analyzer)
            if requested.config() != recorded.config():
                raise ArtifactError(
                    f"analyzer mismatch at {root}: artifact was built with "
                    f"{recorded.config()} but the query-time analyzer is "
                    f"{requested.config()} — reopen with the recorded "
                    f"analyzer or rebuild the index")
        scoring = None
        if "scoring.doc_lengths" in loaded:
            scoring = ScoringStats(
                doc_lengths=np.asarray(loaded["scoring.doc_lengths"], dtype=np.int64),
                run_docs=np.asarray(loaded["scoring.run_docs"], dtype=np.int64),
                run_tfs=np.asarray(loaded["scoring.run_tfs"], dtype=np.int64),
                run_offsets=np.asarray(loaded["scoring.run_offsets"], dtype=np.int64),
                max_tf=np.asarray(loaded["scoring.max_tf"], dtype=np.int64))
        similarity = None
        if "similarity.sigs" in loaded:
            from .similarity import MinHashConfig, SimilarityIndex

            similarity = SimilarityIndex.from_arrays(
                {name[len("similarity."):]: value
                 for name, value in loaded.items()
                 if name.startswith("similarity.")},
                MinHashConfig.from_config(meta.get("similarity")))
        idx = NonPositionalIndex(
            vocab=vocab, store=store, n_docs=int(meta["n_docs"]),
            collection_bytes=int(meta["collection_bytes"]),
            store_name=store_name, doc_starts=doc_starts,
            store_kw=store_kw, analyzer=recorded, scoring=scoring,
            similarity=similarity)
        idx.blobstore = blobs
        return idx
    raise ArtifactError(f"artifact at {root} has unknown kind "
                        f"{manifest['kind']!r}")
