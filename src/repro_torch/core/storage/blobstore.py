"""Per-component blob access with a checksum policy and optional mmap.

One :class:`BlobStore` wraps one artifact directory's component table (the
``components`` section of ``manifest.json``).  It decides *when* a blob's
bytes enter memory and *when* its sha256 is checked:

* ``verify="eager"`` — every component is hash-checked when the store is
  constructed (the pre-existing ``open_index`` behavior: corruption can
  never reach a query answer, at the price of reading every byte up
  front).
* ``verify="lazy"`` — a component is hash-checked the first time it is
  read.  Combined with ``mmap=True``, array components defer further: the
  map is handed out unverified and the whole pending set is checked on the
  consumer's first data access (:meth:`verify_pending` — wired to the
  first posting touch by :class:`~repro_torch.core.storage.mapped.MappedListStore`),
  so opening costs the manifest and the small eager components only.
* ``verify="off"`` — never checked (trusted local artifacts, benchmarks).

Hashing always streams the file in chunks — a verification pass never
materializes a blob into process memory, so checking a memory-mapped
component costs one sequential read, not resident bytes.

``ArtifactError`` lives here (re-exported by :mod:`repro_torch.core.artifact`)
so the storage layer has no import cycle with the artifact reader.
"""

from __future__ import annotations

import hashlib
import threading
from pathlib import Path

import numpy as np

VERIFY_MODES = ("eager", "lazy", "off")

_HASH_CHUNK = 1 << 20


class ArtifactError(RuntimeError):
    """A persisted index artifact is missing, malformed, or corrupted."""


def sha256_file(path: Path) -> str:
    """Streaming sha256 of a file (chunked; never loads it whole)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_HASH_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


class BlobStore:
    """Lazily loaded, checksum-policed view of one artifact directory.

    ``components`` is the manifest's component table: ``name -> {file,
    kind, nbytes, sha256}``.  :meth:`get` returns ``bytes`` for byte
    components and an ``np.ndarray`` for array components (an
    ``np.memmap`` when ``mmap=True``).  Accounting properties expose how
    much of the artifact was actually materialized — the quantity the
    scale benchmarks report as resident bytes.
    """

    def __init__(self, root, components: dict, *, mmap: bool = False,
                 verify: str = "eager"):
        if verify not in VERIFY_MODES:
            raise ValueError(f"unknown verify mode {verify!r}; "
                             f"valid: {', '.join(VERIFY_MODES)}")
        self.root = Path(root)
        self.components = components
        self.mmap = bool(mmap)
        self.verify = verify
        self._lock = threading.Lock()
        self._verified: set[str] = set()
        self._pending: set[str] = set()
        self._cache: dict[str, object] = {}
        self.loaded_nbytes = 0  # bytes materialized into process memory
        if verify == "eager":
            for name in components:
                self.verify_component(name)

    # -- accounting -----------------------------------------------------
    @property
    def total_nbytes(self) -> int:
        """Total blob bytes recorded in the manifest."""
        return sum(int(e["nbytes"]) for e in self.components.values())

    @property
    def loaded_fraction(self) -> float:
        """Materialized bytes / total bytes — 0.0 for a fully mapped open."""
        total = self.total_nbytes
        return self.loaded_nbytes / total if total else 0.0

    # -- verification ---------------------------------------------------
    def _blob_path(self, name: str) -> Path:
        entry = self.components.get(name)
        if entry is None:
            raise ArtifactError(
                f"artifact at {self.root} has no component {name!r}")
        path = self.root / entry["file"]
        if not path.is_file():
            raise ArtifactError(
                f"artifact at {self.root} is missing component {name!r} "
                f"(expected blob {entry['file']})")
        return path

    def verify_component(self, name: str) -> None:
        """Hash-check one component now (idempotent; no-op when
        ``verify='off'``).  Raises :class:`ArtifactError` naming the
        component on a mismatch."""
        if self.verify == "off":
            return
        with self._lock:
            if name in self._verified:
                return
        entry = self.components[name]
        path = self._blob_path(name)
        digest = sha256_file(path)
        if digest != entry["sha256"]:
            raise ArtifactError(
                f"checksum mismatch in component {name!r} of artifact "
                f"{self.root}: blob {entry['file']} hashes to "
                f"{digest[:12]}…, manifest records {entry['sha256'][:12]}… "
                f"— the artifact is corrupted")
        with self._lock:
            self._verified.add(name)
            self._pending.discard(name)

    def verify_pending(self) -> int:
        """Hash-check every component whose verification was deferred by a
        mapped :meth:`get`; returns how many were checked.  The
        :class:`~repro_torch.core.storage.mapped.MappedListStore` first-touch
        hook calls this, so with ``verify="lazy"`` integrity is settled
        before the first answer is served instead of at open."""
        with self._lock:
            pending = sorted(self._pending)
        for name in pending:
            self.verify_component(name)
        return len(pending)

    @property
    def pending_verification(self) -> frozenset[str]:
        with self._lock:
            return frozenset(self._pending)

    # -- access ---------------------------------------------------------
    def get(self, name: str):
        """The component's value: ``bytes``, or an array (a read-only
        ``np.memmap`` when the store maps)."""
        cached = self._cache.get(name)
        if cached is not None:
            return cached
        entry = self.components[name] if name in self.components else None
        path = self._blob_path(name)  # raises with the component named
        if entry["kind"] == "bytes":
            if self.verify == "lazy":
                self.verify_component(name)
            value = path.read_bytes()
            self.loaded_nbytes += len(value)
        elif self.mmap:
            if self.verify == "lazy":
                with self._lock:
                    if name not in self._verified:
                        self._pending.add(name)
            value = np.load(path, mmap_mode="r", allow_pickle=False)
        else:
            if self.verify == "lazy":
                self.verify_component(name)
            with open(path, "rb") as f:
                value = np.load(f, allow_pickle=False)
            self.loaded_nbytes += value.nbytes
        self._cache[name] = value
        return value

    def get_all(self, prefix: str = "") -> dict:
        """Every component whose name starts with ``prefix``, keyed with
        the prefix stripped."""
        return {name[len(prefix):]: self.get(name)
                for name in self.components if name.startswith(prefix)}
