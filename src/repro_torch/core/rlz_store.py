"""RLZ referential list store: posting lists encoded against mined heads.

The structure-*aware* counterpoint to the paper's universal stores: instead
of letting a global compressor (LZ-End, Re-Pair) discover inter-list
regularity implicitly, this backend mines it explicitly.  Every posting
list is MinHash-signed (1-shingles over its doc ids, batched through the
``minhash_sig`` kernel family), LSH-bucketed, and assigned to a *head*
list by :func:`~repro_torch.core.similarity.leader_assign` — non-transitive
leader clustering with an exact bit-cost gate, so a list only joins a head
when the differential encoding is actually smaller than standing alone.

Stream layout (one MSB-first bit stream, Elias gamma throughout):

* header — ``gamma(n_lists+1)``, ``gamma(n_heads+1)``, then per head in
  increasing id: the head-id gap, ``gamma(n_members+1)``, and the member
  ids as gamma gaps.  The header *is* the reference structure; records
  carry no head/member tag.
* head record — ``gamma(len+1)`` then the postings as (gap, run-length)
  pairs: maximal runs of consecutive doc ids cost two gammas regardless
  of length, which is what versioned collections produce.
* member record — ``gamma(n_adds+1)``, ``gamma(n_dels+1)``, the *adds*
  (postings absent from the head) run-coded with the first run start
  zigzag-coded relative to the head's first posting, and the *dels* as
  run-coded **indices into the head's list** — a deleted doc costs
  ~``gamma`` of its local position, not of a doc-id gap.

References are depth 1 by construction (heads are never members), so
``get_list`` decodes at most two records.  Size accounting follows the
store convention: payload bits + ``POINTER_BITS`` per list; the in-memory
``lengths`` array is vocabulary-side metadata, as in the other stores.
The signatures are computed on the ``device`` the build is given.
"""

from __future__ import annotations

import numpy as np

from .codecs.base import POINTER_BITS, ListStore, register_store
from .codecs.bitio import BitReader, BitWriter
from .registry import CAP_REFERENTIAL
from .similarity import MinHashConfig, element_hashes, leader_assign, signature_matrix

#: list-level mining parameters: 32 bands x 2 rows catches J = 0.5 pairs
#: with probability ~0.9999; the exact cost gate below does the real work.
RLZ_MINING = MinHashConfig(num_perm=64, shingle=1, bands=32,
                           threshold=0.5, seed=0)

#: estimated header bits a membership costs (its id gap in the head's
#: member list) — charged by the assignment gate before the header exists.
_REF_EST_BITS = 7


def _gamma_bits(v: int) -> int:
    return 2 * (int(v).bit_length() - 1) + 1


def _zigzag(d: int) -> int:
    return 2 * d if d >= 0 else -2 * d - 1


def _unzigzag(z: int) -> int:
    return z >> 1 if z % 2 == 0 else -((z + 1) >> 1)


def _run_split(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Starts and lengths of the maximal consecutive runs of sorted ``arr``."""
    if len(arr) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    breaks = np.flatnonzero(np.diff(arr) != 1)
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [len(arr) - 1]))
    return arr[starts], ends - starts + 1


def _runs_bits(arr: np.ndarray, first_rel: int | None = None) -> int:
    """Bit cost of run-coding ``arr`` without materializing the stream."""
    starts, lens = _run_split(arr)
    bits = 0
    last = -1
    for k in range(len(starts)):
        if k == 0 and first_rel is not None:
            bits += _gamma_bits(_zigzag(int(starts[0]) - first_rel) + 1)
        else:
            bits += _gamma_bits(int(starts[k]) - last)
        bits += _gamma_bits(int(lens[k]))
        last = int(starts[k]) + int(lens[k]) - 1
    return bits


def _write_runs(w: BitWriter, arr: np.ndarray,
                first_rel: int | None = None) -> None:
    starts, lens = _run_split(arr)
    last = -1
    for k in range(len(starts)):
        if k == 0 and first_rel is not None:
            w.write_gamma(_zigzag(int(starts[0]) - first_rel) + 1)
        else:
            w.write_gamma(int(starts[k]) - last)
        w.write_gamma(int(lens[k]))
        last = int(starts[k]) + int(lens[k]) - 1


def _read_runs(r: BitReader, n: int, first_rel: int | None = None) -> np.ndarray:
    out = np.empty(n, dtype=np.int64)
    k = 0
    last = -1
    first = True
    while k < n:
        if first and first_rel is not None:
            start = first_rel + _unzigzag(r.read_gamma() - 1)
        else:
            start = last + r.read_gamma()
        run = r.read_gamma()
        out[k:k + run] = np.arange(start, start + run)
        k += run
        last = start + run - 1
        first = False
    return out


def _full_cost(lst: np.ndarray) -> int:
    return _gamma_bits(len(lst) + 1) + _runs_bits(lst)


def _diff(lst: np.ndarray, head: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(adds, del-indices-into-head) turning ``head`` into ``lst``."""
    adds = np.setdiff1d(lst, head, assume_unique=True)
    dels = np.flatnonzero(~np.isin(head, lst, assume_unique=True))
    return adds, dels


def _member_cost(lst: np.ndarray, head: np.ndarray) -> int:
    adds, dels = _diff(lst, head)
    base = int(head[0]) if len(head) else None
    return (_gamma_bits(len(adds) + 1) + _gamma_bits(len(dels) + 1)
            + _runs_bits(adds, first_rel=base) + _runs_bits(dels))


@register_store("rlz")
class RLZStore(ListStore):
    capabilities = ListStore.capabilities | {CAP_REFERENTIAL}

    def __init__(self, data: bytes, payload_bits: int, bit_offsets: np.ndarray,
                 lengths: np.ndarray):
        self._data = data
        self._payload_bits = payload_bits
        self.bit_offsets = bit_offsets  # len n_lists; counted as the pointers
        self.lengths = lengths
        self._reader = BitReader(data, payload_bits)
        self.head_ref = self._parse_header()  # -1 = head, else head list id
        self._head_cache: dict[int, np.ndarray] = {}

    # -- construction ---------------------------------------------------
    @classmethod
    def build(cls, lists: list[np.ndarray], config: MinHashConfig = RLZ_MINING,
              device="cuda", **kw) -> "RLZStore":
        lists = [np.asarray(l, dtype=np.int64) for l in lists]
        ref = cls._mine_refs(lists, config, device)
        return cls(*cls._encode(lists, ref))

    @staticmethod
    def _mine_refs(lists: list[np.ndarray], config: MinHashConfig,
                   device) -> np.ndarray:
        """Head assignment: LSH proposes, the exact bit cost disposes."""
        sets = [element_hashes(l) for l in lists]
        n_shingles = np.asarray([len(s) for s in sets], dtype=np.int64)
        sigs = signature_matrix(sets, config, device=device)
        weights = np.asarray([len(l) for l in lists], dtype=np.int64)

        def cost(i: int, leader: int) -> float:
            if leader < 0:
                return _full_cost(lists[i])
            return _member_cost(lists[i], lists[leader]) + _REF_EST_BITS

        return leader_assign(sigs, n_shingles, config, weights, cost=cost)

    @staticmethod
    def _encode(lists: list[np.ndarray], ref: np.ndarray):
        n = len(lists)
        w = BitWriter()
        # header: the mined reference structure
        heads = np.flatnonzero(ref < 0)
        w.write_gamma(n + 1)
        w.write_gamma(len(heads) + 1)
        last_h = -1
        for h in heads.tolist():
            w.write_gamma(h - last_h)
            last_h = h
            members = np.flatnonzero(ref == h)
            w.write_gamma(len(members) + 1)
            last_m = -1
            for m in members.tolist():
                w.write_gamma(m - last_m)
                last_m = m
        # per-list records
        bit_offsets = np.zeros(n, dtype=np.int64)
        for i, lst in enumerate(lists):
            bit_offsets[i] = w.nbits
            if ref[i] < 0:
                w.write_gamma(len(lst) + 1)
                _write_runs(w, lst)
            else:
                head = lists[int(ref[i])]
                adds, dels = _diff(lst, head)
                w.write_gamma(len(adds) + 1)
                w.write_gamma(len(dels) + 1)
                _write_runs(w, adds,
                            first_rel=int(head[0]) if len(head) else None)
                _write_runs(w, dels)
        lengths = np.asarray([len(l) for l in lists], dtype=np.int64)
        return w.getvalue(), w.nbits, bit_offsets, lengths

    def _parse_header(self) -> np.ndarray:
        r = self._reader
        r.pos = 0
        n = r.read_gamma() - 1
        n_heads = r.read_gamma() - 1
        ref = np.full(n, -1, dtype=np.int64)
        last_h = -1
        for _ in range(n_heads):
            h = last_h + r.read_gamma()
            last_h = h
            n_members = r.read_gamma() - 1
            last_m = -1
            for _ in range(n_members):
                m = last_m + r.read_gamma()
                last_m = m
                ref[m] = h
        return ref

    # -- access ---------------------------------------------------------
    @property
    def n_lists(self) -> int:
        return len(self.lengths)

    @property
    def n_heads(self) -> int:
        return int(np.sum(self.head_ref < 0))

    def list_length(self, i: int) -> int:
        return int(self.lengths[i])

    def _decode_head(self, i: int) -> np.ndarray:
        got = self._head_cache.get(i)
        if got is None:
            r = self._reader
            r.pos = int(self.bit_offsets[i])
            n = r.read_gamma() - 1
            got = self._head_cache[i] = _read_runs(r, n)
        return got

    def get_list(self, i: int) -> np.ndarray:
        h = int(self.head_ref[i])
        if h < 0:
            return self._decode_head(i).copy()
        head = self._decode_head(h)
        r = self._reader
        r.pos = int(self.bit_offsets[i])
        n_adds = r.read_gamma() - 1
        n_dels = r.read_gamma() - 1
        adds = _read_runs(r, n_adds,
                          first_rel=int(head[0]) if len(head) else None)
        dels = _read_runs(r, n_dels)
        return np.union1d(np.delete(head, dels), adds)

    @property
    def size_in_bits(self) -> int:
        return self._payload_bits + POINTER_BITS * self.n_lists
