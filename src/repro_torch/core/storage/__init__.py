"""Scale-hardened storage: lazy blob access, mapped stores, background
compaction.

The paper's collections "may reach huge sizes"; an index that must be read
whole into RAM before the first query caps the reachable scale at memory.
This package is the storage layer under :mod:`repro_torch.core.artifact` and
:class:`repro_torch.core.writer.IndexWriter` that removes that cap:

* :class:`BlobStore` — per-component access to one artifact directory with
  a checksum-verification policy (``verify="eager" | "lazy" | "off"``) and
  optional memory mapping: ``.npy`` components open via
  ``np.load(mmap_mode="r")``, so resident bytes scale with the touched
  working set, not the artifact.

* :class:`MappedListStore` — the generic persisted posting layout
  (``postings`` + ``offsets``) served *in place*: posting lists are slices
  of the mapped concat array, so ``Session.open(..., mmap=True)`` on a
  backend without a compiled-state restore hook skips the rebuild entirely.

* :class:`CompactionHandle` — the observable half of
  :meth:`~repro_torch.core.writer.IndexWriter.compact_async`: background segment
  merging on a worker thread with an atomic swap, while serving continues
  on the old segment set.
"""

from .blobstore import ArtifactError, BlobStore, VERIFY_MODES
from .compaction import CompactionHandle
from .mapped import MappedListStore

__all__ = [
    "ArtifactError",
    "BlobStore",
    "CompactionHandle",
    "MappedListStore",
    "VERIFY_MODES",
]
