"""The generic persisted posting layout served in place.

Backends without a compiled-state restore hook persist through the generic
concat layout (``postings`` + ``offsets`` — see
:func:`repro_torch.core.registry.lists_to_arrays`) and reopen by *rebuilding*
through their registered builder — for a per-list codec that means
re-encoding every posting list, which reads and materializes the whole
collection at open time.

:class:`MappedListStore` is the mmap-mode alternative: it implements the
full :class:`~repro_torch.core.codecs.base.ListStore` protocol directly over the
persisted arrays, so ``get_list(i)`` is a slice of the (memory-mapped)
concat array and nothing is decoded, re-encoded, or copied at open.  The
OS pages postings in on first touch, so resident bytes track the queried
working set.  Answers are byte-identical to the rebuilt store — the
persisted lists *are* the lists the original store decodes to (asserted in
``tests/test_storage.py``).

The trade is in-memory compression: a mapped store holds raw int64
postings on disk instead of the codec's encoding in RAM.  That is the
point of the mode — for collections larger than memory the paging, not
the encoding, is what keeps the index servable.
"""

from __future__ import annotations

import numpy as np

from ..codecs.base import ListStore
from ..registry import CAP_PERSIST


class MappedListStore(ListStore):
    """A :class:`ListStore` over the persisted concat layout, served
    without a rebuild.  ``verify_hook`` (optional) runs once before the
    first posting access — the lazy-checksum trigger wired up by
    ``open_index(..., mmap=True, verify="lazy")``."""

    name = "mapped"
    capabilities = frozenset({CAP_PERSIST})

    def __init__(self, postings: np.ndarray, offsets: np.ndarray,
                 verify_hook=None):
        self._postings = postings
        self._offsets = offsets
        self._verify_hook = verify_hook

    def _touch(self) -> None:
        if self._verify_hook is not None:
            hook, self._verify_hook = self._verify_hook, None
            hook()

    @property
    def n_lists(self) -> int:
        return max(0, len(self._offsets) - 1)

    def get_list(self, i: int) -> np.ndarray:
        self._touch()
        lo, hi = int(self._offsets[i]), int(self._offsets[i + 1])
        return self._postings[lo:hi]

    def list_length(self, i: int) -> int:
        self._touch()
        return int(self._offsets[i + 1] - self._offsets[i])

    @property
    def size_in_bits(self) -> int:
        # honest raw accounting: the mapped layout stores postings
        # uncompressed, and its size report says so
        return 8 * (self._postings.nbytes + self._offsets.nbytes)

    def to_arrays(self) -> dict[str, np.ndarray]:
        self._touch()
        return {"postings": np.asarray(self._postings, dtype=np.int64),
                "offsets": np.asarray(self._offsets, dtype=np.int64)}
