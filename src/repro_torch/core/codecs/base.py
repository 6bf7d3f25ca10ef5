"""Codec interfaces.

Two tiers (paper §3):

* :class:`Codec` — per-list compressor.  ``encode`` takes the *d-gap* array of
  one posting list (all values >= 1), ``decode`` inverts it.  Used by the
  classical baselines (Vbyte, Rice, Simple9, PForDelta, EF, interpolative,
  Rice-Runs, Vbyte-LZMA).

* :class:`ListStore` — whole-index compressor over the *concatenation* of all
  d-gap lists (Vbyte-LZend, Re-Pair variants).  These are the paper's
  universal representations: they capture inter-list regularities.

Sizes are accounted in *bits*, exactly, including per-list pointers for the
stores, so the space columns of the benchmarks are faithful to the paper's
accounting (index_size / collection_size).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ..registry import CAP_PERSIST

CODEC_REGISTRY: dict[str, Callable[..., "Codec"]] = {}
STORE_REGISTRY: dict[str, Callable[..., "ListStore"]] = {}


def register_codec(name: str):
    def deco(cls):
        CODEC_REGISTRY[name] = cls
        cls.name = name
        return cls

    return deco


def register_store(name: str):
    def deco(cls):
        STORE_REGISTRY[name] = cls
        cls.name = name
        return cls

    return deco


@dataclass
class EncodedList:
    """One compressed posting list."""

    n: int  # number of postings
    nbits: int  # exact payload size in bits
    data: bytes
    meta: dict[str, Any] = field(default_factory=dict)


class Codec:
    """Per-list codec over d-gaps (values >= 1)."""

    name: str = "abstract"

    def encode(self, gaps: np.ndarray) -> EncodedList:
        raise NotImplementedError

    def decode(self, enc: EncodedList) -> np.ndarray:
        raise NotImplementedError

    # Some codecs (EF, interpolative) natively store absolute values and can
    # answer successor queries without full decode; default path decodes.
    def decode_absolute(self, enc: EncodedList) -> np.ndarray:
        from ..dgaps import from_dgaps

        return from_dgaps(self.decode(enc))


class ListStore:
    """Whole-index list representation (built over all lists at once).

    Every store is a ``SearchBackend`` (see ``repro_torch.core.registry``): it
    declares a capability set and inherits capability-aware default
    implementations of the intersection protocol.  The defaults decode and
    merge; backends with ``intersect_candidates`` / ``shifted_intersect``
    capabilities override exactly the method their capability names.
    Every store persists (``to_arrays`` below), so ``persist`` is in the
    base capability set; subclasses that redeclare the set keep it.
    """

    name: str = "abstract"
    capabilities: frozenset[str] = frozenset({CAP_PERSIST})

    @classmethod
    def build(cls, lists: list[np.ndarray], **kw) -> "ListStore":
        """``lists`` are the raw (absolute, strictly increasing) postings."""
        raise NotImplementedError

    @property
    def n_lists(self) -> int:
        raise NotImplementedError

    def get_list(self, i: int) -> np.ndarray:
        """Return the absolute postings of list ``i``."""
        raise NotImplementedError

    def list_length(self, i: int) -> int:
        raise NotImplementedError

    # -- the unified query protocol -------------------------------------
    def intersect_candidates(self, i: int, cand: np.ndarray) -> np.ndarray:
        """Members of sorted ``cand`` that occur in list ``i``.

        Default: decode the list, galloping set-vs-set (§2.1).  Backends
        with the ``intersect_candidates`` capability answer in the
        compressed domain instead.
        """
        from ..intersect import intersect_svs

        return intersect_svs(cand, self.get_list(i))

    def intersect_multi(self, list_ids: list[int]) -> np.ndarray:
        """AND of several lists: shortest list drives candidate generation,
        the rest are probed via :meth:`intersect_candidates` (paper §2.1 /
        §4.3 — the same loop for every backend, the per-list probe is what
        the capability set changes)."""
        if not list_ids:
            return np.zeros(0, dtype=np.int64)
        order = sorted(list_ids, key=self.list_length)
        cand = self.get_list(order[0])
        for li in order[1:]:
            if len(cand) == 0:
                break
            cand = self.intersect_candidates(li, cand)
        return cand

    def intersect_shifted(self, list_ids: list[int], shifts: list[int]) -> np.ndarray:
        """Offset-shifted intersection (phrase queries, §3): positions p
        with ``p + shifts[i]`` in list i for all i.  Backends with the
        ``shifted_intersect`` capability (self-indexes) answer the whole
        pattern natively instead."""
        order = sorted(range(len(list_ids)), key=lambda k: self.list_length(list_ids[k]))
        k0 = order[0]
        cand = self.get_list(list_ids[k0]) - shifts[k0]
        for k in order[1:]:
            if len(cand) == 0:
                break
            li, sh = list_ids[k], shifts[k]
            cand = self.intersect_candidates(li, cand + sh) - sh
        return cand

    # -- persistence (the `persist` capability) -------------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        """Persistable components of this store, as pure arrays/bytes.

        Default: the decoded posting lists in the concat layout — the
        registered build function rebuilds the store from them deterministically
        on ``restore_backend`` (byte-identical answers).  Stores whose
        construction is expensive (Re-Pair grammars, self-indexes) override
        this with their actual compiled state so opening skips the build.
        """
        from ..registry import lists_to_arrays

        return lists_to_arrays(
            np.asarray(self.get_list(i), dtype=np.int64)
            for i in range(self.n_lists))

    @property
    def size_in_bits(self) -> int:
        raise NotImplementedError


POINTER_BITS = 32  # per-list pointer into the compressed stream (vocabulary side)


class PerListStore(ListStore):
    """Adapter: a per-list :class:`Codec` applied to every list."""

    def __init__(self, codec: Codec, encoded: list[EncodedList]):
        self.codec = codec
        self.encoded = encoded

    @classmethod
    def build(cls, lists: list[np.ndarray], codec: Codec | None = None, **kw) -> "PerListStore":
        from ..dgaps import to_dgaps

        assert codec is not None
        encoded = [codec.encode(to_dgaps(np.asarray(l))) for l in lists]
        return cls(codec, encoded)

    @property
    def n_lists(self) -> int:
        return len(self.encoded)

    def get_list(self, i: int) -> np.ndarray:
        return self.codec.decode_absolute(self.encoded[i])

    def get_gaps(self, i: int) -> np.ndarray:
        return self.codec.decode(self.encoded[i])

    def list_length(self, i: int) -> int:
        return self.encoded[i].n

    @property
    def size_in_bits(self) -> int:
        payload = sum(e.nbits for e in self.encoded)
        return payload + POINTER_BITS * len(self.encoded)
