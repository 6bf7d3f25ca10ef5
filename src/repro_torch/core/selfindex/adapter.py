"""Self-indexes as SearchBackends (paper §6: self-indexes vs inverted indexes
behind one query interface).

:class:`SelfIndexBackend` wraps a self-index (RLCSA/WCSA over Psi, or the
LZ77/LZEnd parse indexes) built over the collection's *token-id stream* and
exposes the same protocol as the inverted list stores:

* ``get_list(t)``       — ``locate`` of the single-symbol pattern ``[t]``:
  all stream positions of token ``t`` (or, in doc-granularity mode, the
  sorted ids of documents containing it — the non-positional answer);
* ``intersect_shifted`` — a phrase is one ``locate`` of the whole pattern
  (capability ``shifted_intersect``): the self-index searches the sequence
  directly instead of shifting and intersecting per-term posting lists;
* ``extract``           — the self-index property: the token stream is
  recoverable from the index, no stored text needed.

Per-term lengths (used for intersection ordering and idf weights) are kept
as a plain array so planning matches the inverted stores exactly.
"""

from __future__ import annotations

import numpy as np

from ..codecs.base import ListStore
from ..registry import (
    CAP_DOC_LIST,
    CAP_EXTRACT,
    CAP_PERSIST,
    CAP_SHIFTED_INTERSECT,
    BuildSource,
)


class SelfIndexBackend(ListStore):
    # doc_list: a whole pattern is one native `locate`, so document listing
    # is locate + reduce — no per-term posting intersection is ever needed
    capabilities = frozenset({CAP_SHIFTED_INTERSECT, CAP_EXTRACT, CAP_DOC_LIST,
                              CAP_PERSIST})

    def __init__(self, inner, lengths: np.ndarray, doc_starts: np.ndarray | None = None,
                 doc_lists: bool = False, exclude_ids: frozenset[int] = frozenset()):
        self.inner = inner  # the wrapped self-index (locate/count/extract)
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.doc_starts = None if doc_starts is None else np.asarray(doc_starts, dtype=np.int64)
        self.doc_lists = doc_lists
        self.exclude_ids = frozenset(exclude_ids)
        self.name = getattr(inner, "name", type(inner).__name__)

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, source: BuildSource, index_cls, **kw) -> "SelfIndexBackend":
        if source.stream is None:
            raise ValueError(f"{index_cls.__name__} builds from a token stream")
        stream = np.asarray(source.stream, dtype=np.int64)
        inner = index_cls(stream, **kw)
        # per-term answer lengths: identical to the inverted stores' stored
        # lengths (docs per word, or positions per token)
        lengths = np.asarray([len(l) for l in source.lists], dtype=np.int64)
        exclude = frozenset() if source.sep_id is None else frozenset({source.sep_id})
        return cls(inner, lengths,
                   doc_starts=source.doc_starts if source.doc_lists else None,
                   doc_lists=source.doc_lists, exclude_ids=exclude)

    # ------------------------------------------------------------------
    # persistence: the token stream is recoverable from the index (the
    # self-index property), so the artifact stores it plus the planning
    # metadata; restore rebuilds the inner index from the stream
    # ------------------------------------------------------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        n = int(self.inner.n)
        stream = (self.inner.extract(0, n - 1) if n
                  else np.zeros(0, dtype=np.int64))
        out = {"stream": np.asarray(stream, dtype=np.int64),
               "lengths": self.lengths,
               "doc_lists": np.asarray([int(self.doc_lists)], dtype=np.int64),
               "exclude_ids": np.asarray(sorted(self.exclude_ids), dtype=np.int64)}
        if self.doc_starts is not None:
            out["doc_starts"] = self.doc_starts
        return out

    @classmethod
    def from_arrays(cls, arrays: dict, index_cls, **kw) -> "SelfIndexBackend":
        inner = index_cls(np.asarray(arrays["stream"], dtype=np.int64), **kw)
        doc_starts = arrays.get("doc_starts")
        return cls(inner, np.asarray(arrays["lengths"], dtype=np.int64),
                   doc_starts=doc_starts,
                   doc_lists=bool(np.asarray(arrays["doc_lists"])[0]),
                   exclude_ids=frozenset(
                       int(x) for x in np.asarray(arrays["exclude_ids"])))

    # ------------------------------------------------------------------
    def _positions_to_docs(self, pos: np.ndarray) -> np.ndarray:
        d = np.searchsorted(self.doc_starts, pos, side="right") - 1
        return np.unique(d)

    def get_list(self, i: int) -> np.ndarray:
        if i in self.exclude_ids or i < 0 or i >= len(self.lengths):
            return np.zeros(0, dtype=np.int64)
        pos = self.inner.locate(np.asarray([i], dtype=np.int64))
        if self.doc_lists:
            return self._positions_to_docs(pos)
        return pos

    def list_length(self, i: int) -> int:
        return int(self.lengths[i])

    @property
    def n_lists(self) -> int:
        return len(self.lengths)

    # ------------------------------------------------------------------
    def intersect_shifted(self, list_ids: list[int], shifts: list[int]) -> np.ndarray:
        """Contiguous shifts = a phrase pattern: one native ``locate`` of the
        token sequence (§6 — this is where self-indexes shine).  Any other
        shift geometry falls back to the generic candidate loop."""
        shifts = list(shifts)
        contiguous = shifts == list(range(shifts[0], shifts[0] + len(shifts)))
        if contiguous and not self.doc_lists:
            pat = np.asarray(list(list_ids), dtype=np.int64)
            return self.inner.locate(pat) - shifts[0]
        return super().intersect_shifted(list_ids, shifts)

    def extract(self, x: int, y: int) -> np.ndarray:
        """Token-stream snippet ``stream[x..y]`` recovered from the index."""
        return self.inner.extract(x, y)

    # ------------------------------------------------------------------
    @property
    def size_in_bits(self) -> int:
        bits = int(self.inner.size_in_bits)
        bits += 32 * len(self.lengths)  # stored lengths (planning metadata)
        if self.doc_lists and self.doc_starts is not None:
            bits += 32 * len(self.doc_starts)  # position -> doc mapping
        return bits
