"""Re-Pair compressed posting lists with skipping data (paper §4).

The whole set of d-gap lists is concatenated with unique separators and
grammar-compressed.  Phrases never span lists (separators occur once, so no
pair containing one ever repeats).  The rule DAG is packed into the paper's
``(R_B, R_S)`` forest format; nonterminals are enriched with *phrase sums*
(the total d-gap a nonterminal spans) enabling intersection that skips
compressed phrases without expanding them (§4.1), plus optional sampling
(§4.2: ``cm`` = positional samples of C, ``st`` = domain samples).

Construction note (DESIGN.md A4): instead of strict one-pair-at-a-time
Re-Pair we run *batched rounds*: each round replaces, simultaneously, a set
of frequent pairs with pairwise-disjoint symbol support (so no two selected
pairs can interact in the sequence).  This keeps construction fully
numpy-vectorized; the emitted grammar format and all query-time structures
are exactly the paper's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .codecs.base import ListStore, register_store
from .dgaps import to_dgaps
from .registry import (
    CAP_DEVICE_RESIDENT,
    CAP_DOC_LIST,
    CAP_INTERSECT_CANDIDATES,
    CAP_PERSIST,
    CAP_SEEK,
)

DEAD = np.int64(-(1 << 62))


# ----------------------------------------------------------------------
# grammar construction
# ----------------------------------------------------------------------
@dataclass
class Grammar:
    """Rules over symbol space: [1, u] terminals (gap values);
    u+1+k = nonterminal k (k-th created rule)."""

    u: int  # largest terminal value
    rules: list[tuple[int, int]] = field(default_factory=list)  # rhs pairs

    def n_rules(self) -> int:
        return len(self.rules)

    def is_terminal(self, sym: int) -> bool:
        return sym <= self.u


def _greedy_nonoverlap(pos: np.ndarray) -> np.ndarray:
    """Leftmost-greedy selection of non-overlapping occurrences of a
    self-pair (x,x): within a maximal run of consecutive positions keep
    every other one."""
    if len(pos) <= 1:
        return pos
    new_run = np.ones(len(pos), dtype=bool)
    new_run[1:] = pos[1:] != pos[:-1] + 1
    run_id = np.cumsum(new_run) - 1
    run_start = pos[new_run][run_id]
    keep = ((pos - run_start) % 2) == 0
    return pos[keep]


def repair_compress(
    seq: np.ndarray,
    u: int,
    max_batch: int = 64,
    min_count: int = 2,
    max_rules: int | None = None,
) -> tuple[np.ndarray, Grammar]:
    """Compress ``seq`` (values in [1,u] plus negative separators).

    Returns the reduced sequence (separators still in place) and the grammar.
    """
    s = np.asarray(seq, dtype=np.int64).copy()
    g = Grammar(u=u)
    next_sym = u + 1
    min_count = max(2, min_count)
    # pairs whose raw count >= min_count but whose non-overlapping occurrence
    # count is < 2 (pure-overlap self pairs like (x,x) in "xxx"); retrying
    # them forever would spin, so they are excluded until the sequence changes
    dead_pairs: set[tuple[int, int]] = set()
    while True:
        if max_rules is not None and g.n_rules() >= max_rules:
            break
        if len(s) < 2:
            break
        valid = (s[:-1] > 0) & (s[1:] > 0)
        if not np.any(valid):
            break
        a = s[:-1][valid]
        b = s[1:][valid]
        key = a * np.int64(next_sym) + b  # symbols < next_sym
        keys, counts = np.unique(key, return_counts=True)
        if counts.max(initial=0) < min_count:
            break
        # pick up to max_batch frequent pairs with disjoint symbol support;
        # disjointness makes same-round replacements order-independent
        order = np.argsort(counts)[::-1]
        used: set[int] = set()
        picked: list[tuple[int, int]] = []
        for idx in order.tolist():
            if counts[idx] < min_count:
                break
            k = int(keys[idx])
            pa, pb = k // next_sym, k % next_sym
            if (pa, pb) in dead_pairs or pa in used or pb in used:
                continue
            used.add(pa)
            used.add(pb)
            picked.append((pa, pb))
            if len(picked) >= max_batch:
                break
        if not picked:
            break
        appended = 0
        for pa, pb in picked:
            pos = np.flatnonzero((s[:-1] == pa) & (s[1:] == pb))
            if pa == pb:
                pos = _greedy_nonoverlap(pos)
            if len(pos) < 2:
                dead_pairs.add((pa, pb))
                continue
            s[pos] = next_sym
            s[pos + 1] = DEAD
            g.rules.append((int(pa), int(pb)))
            next_sym += 1
            appended += 1
        if appended:
            dead_pairs.clear()  # sequence changed; staleness possible
            s = s[s != DEAD]
    return s, g


# ----------------------------------------------------------------------
# packed (R_B, R_S) forest + phrase sums
# ----------------------------------------------------------------------
@dataclass
class PackedRules:
    """Paper §2.3/§4: forest bitmap R_B + aligned values R_S.

    ``rs`` has one entry per R_B bit: at 1-positions the *phrase sum* of the
    nonterminal rooted there (skip data, §4.1); at 0-positions the leaf value
    (a terminal gap, or ``u + 1 + pos`` referencing the R_B position of
    another rule's 1).  ``rs_leaf`` is the plain variant: leaf values only
    (indexed by rank0), with no phrase sums.
    """

    u: int
    rb: np.ndarray  # uint8, tree shape bits
    rs: np.ndarray  # int64, values aligned with rb (skip variant)
    rs_leaf: np.ndarray  # int64, leaf values only (plain variant)
    rank0: np.ndarray  # zeros strictly before each R_B position
    rule_pos: np.ndarray  # R_B position of each rule's 1
    pos_sorted: np.ndarray  # sorted rule positions (for pos -> rule lookup)
    rule_by_pos: np.ndarray  # argsort of rule_pos
    sums: np.ndarray  # phrase sum per rule
    lens: np.ndarray  # expansion length per rule
    depth: np.ndarray  # DAG depth per rule
    max_depth: int

    def rule_of_pos(self, pos: int) -> int:
        k = int(np.searchsorted(self.pos_sorted, pos))
        return int(self.rule_by_pos[k])

    def sum_at(self, pos: int) -> int:
        return int(self.rs[pos])

    def len_at(self, pos: int) -> int:
        return int(self.lens[self.rule_of_pos(pos)])


def pack_rules(g: Grammar) -> PackedRules:
    nr = g.n_rules()
    u = g.u
    # per-rule phrase sums / expansion lengths / depths (rules reference only
    # earlier rules, so one forward pass suffices)
    sums = np.zeros(nr, dtype=np.int64)
    lens = np.zeros(nr, dtype=np.int64)
    depth = np.zeros(nr, dtype=np.int64)
    for k, (a, b) in enumerate(g.rules):
        sa, la, da = (a, 1, 0) if a <= u else (int(sums[a - u - 1]), int(lens[a - u - 1]), int(depth[a - u - 1]))
        sb, lb, db = (b, 1, 0) if b <= u else (int(sums[b - u - 1]), int(lens[b - u - 1]), int(depth[b - u - 1]))
        sums[k] = sa + sb
        lens[k] = la + lb
        depth[k] = 1 + max(da, db)

    # pack DAG into forest: reverse creation order; a rule is inlined as a
    # subtree at its first reference, later references are leaf pointers to
    # the position of its 1 in R_B (paper Fig. 1)
    rb_bits: list[int] = []
    rs_vals: list[int] = []
    rule_pos = np.full(nr, -1, dtype=np.int64)

    def emit(root: int) -> None:
        stack: list[tuple[str, int]] = [("rule", root)]
        while stack:
            kind, val = stack.pop()
            if kind == "rule":
                rule_pos[val] = len(rb_bits)
                rb_bits.append(1)
                rs_vals.append(int(sums[val]))
                a, b = g.rules[val]
                stack.append(("child", b))
                stack.append(("child", a))
            else:
                if val <= u:
                    rb_bits.append(0)
                    rs_vals.append(int(val))
                else:
                    ck = val - u - 1
                    if rule_pos[ck] < 0:
                        stack.append(("rule", ck))
                    else:
                        rb_bits.append(0)
                        rs_vals.append(u + 1 + int(rule_pos[ck]))

    for k in range(nr - 1, -1, -1):
        if rule_pos[k] < 0:
            emit(k)

    rb = np.asarray(rb_bits, dtype=np.uint8)
    rs = np.asarray(rs_vals, dtype=np.int64)
    rs_leaf = rs[rb == 0] if len(rb) else np.zeros(0, dtype=np.int64)
    rank0 = np.zeros(len(rb), dtype=np.int64)
    if len(rb):
        rank0[1:] = np.cumsum(rb[:-1] == 0)
    rule_by_pos = np.argsort(rule_pos) if nr else np.zeros(0, dtype=np.int64)
    pos_sorted = rule_pos[rule_by_pos] if nr else np.zeros(0, dtype=np.int64)
    return PackedRules(
        u=u,
        rb=rb,
        rs=rs,
        rs_leaf=rs_leaf,
        rank0=rank0,
        rule_pos=rule_pos,
        pos_sorted=pos_sorted,
        rule_by_pos=rule_by_pos,
        sums=sums,
        lens=lens,
        depth=depth,
        max_depth=int(depth.max(initial=0)),
    )


# ----------------------------------------------------------------------
# the list store
# ----------------------------------------------------------------------
@register_store("repair")
class RePairStore(ListStore):
    """Re-Pair compressed d-gap lists.

    ``variant``: "plain" (no skip data; intersection = full decompress +
    merge) or "skip" (phrase sums, paper §4.1).  ``sampling``: None,
    ("cm", k) or ("st", B), see §4.2.
    """

    def __init__(
        self,
        c: np.ndarray,
        c_offsets: np.ndarray,
        lengths: np.ndarray,
        packed: PackedRules,
        variant: str = "skip",
        sampling: tuple[str, int] | None = None,
        memoize: bool = False,
    ):
        self.c = c
        self.c_offsets = c_offsets
        self.lengths = lengths
        self.packed = packed
        self.variant = variant
        self.sampling = sampling
        self.memoize = memoize
        self._memo: dict[int, np.ndarray] = {}
        self._samples: list[tuple[np.ndarray, np.ndarray]] | None = None
        if sampling is not None:
            self._build_samples()
        # operation counter for the Theorem-1 property test
        self.op_counter = 0
        # declared capabilities depend on the variant: the (R_B, R_S) arrays
        # anchor directly onto the device either way; skipping search and
        # sampled seeks are per-variant.  Phrase sums also bound the absolute
        # range of every compressed phrase, which is what the grammar-aware
        # document-listing walk needs (repro_torch.core.doclist.grammar_doc_runs)
        caps = {CAP_DEVICE_RESIDENT, CAP_DOC_LIST, CAP_PERSIST}
        if variant == "skip":
            caps.add(CAP_INTERSECT_CANDIDATES)
        if sampling is not None:
            caps.add(CAP_SEEK)
        self.capabilities = frozenset(caps)

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        lists: list[np.ndarray],
        variant: str = "skip",
        sampling: tuple[str, int] | None = None,
        max_batch: int = 64,
        min_count: int = 2,
        memoize: bool = False,
        max_rules: int | None = None,
        **kw,
    ) -> "RePairStore":
        gap_lists = [to_dgaps(np.asarray(l, dtype=np.int64)) for l in lists]
        lengths = np.asarray([len(l) for l in gap_lists], dtype=np.int64)
        u = int(max((int(g.max()) for g in gap_lists if len(g)), default=1))
        # interleave unique separators: -1, -2, ...
        parts: list[np.ndarray] = []
        for i, gl in enumerate(gap_lists):
            parts.append(np.asarray([-(i + 1)], dtype=np.int64))
            parts.append(gl)
        seq = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)
        cseq, grammar = repair_compress(
            seq, u, max_batch=max_batch, min_count=min_count, max_rules=max_rules
        )
        packed = pack_rules(grammar)
        # remap nonterminal ids in C to R_B positions and drop separators
        sep_pos = np.flatnonzero(cseq < 0)
        assert len(sep_pos) == len(lists)
        c_offsets = np.zeros(len(lists) + 1, dtype=np.int64)
        pieces: list[np.ndarray] = []
        for i in range(len(lists)):
            lo = sep_pos[i] + 1
            hi = sep_pos[i + 1] if i + 1 < len(lists) else len(cseq)
            piece = cseq[lo:hi].copy()
            nt = piece > u
            if np.any(nt):
                piece[nt] = u + 1 + packed.rule_pos[piece[nt] - u - 1]
            pieces.append(piece)
            c_offsets[i + 1] = c_offsets[i] + len(piece)
        c = np.concatenate(pieces) if pieces else np.zeros(0, dtype=np.int64)
        return cls(c, c_offsets, lengths, packed, variant, sampling, memoize)

    # ------------------------------------------------------------------
    # persistence: the compiled grammar state round-trips as pure arrays,
    # so `restore_backend` reloads without re-running Re-Pair compression
    # ------------------------------------------------------------------
    _PACKED_FIELDS = ("rb", "rs", "rs_leaf", "rank0", "rule_pos",
                      "pos_sorted", "rule_by_pos", "sums", "lens", "depth")

    def to_arrays(self) -> dict[str, np.ndarray]:
        out = {"c": self.c, "c_offsets": self.c_offsets,
               "lengths": self.lengths,
               "u": np.asarray([self.packed.u], dtype=np.int64)}
        for f in self._PACKED_FIELDS:
            out["packed_" + f] = getattr(self.packed, f)
        return out

    @classmethod
    def from_arrays(cls, arrays: dict, variant: str = "skip",
                    sampling: tuple[str, int] | None = None,
                    memoize: bool = False) -> "RePairStore":
        fields = {f: np.asarray(arrays["packed_" + f],
                                dtype=np.uint8 if f == "rb" else np.int64)
                  for f in cls._PACKED_FIELDS}
        packed = PackedRules(u=int(np.asarray(arrays["u"])[0]), **fields,
                             max_depth=int(fields["depth"].max(initial=0)))
        return cls(np.asarray(arrays["c"], dtype=np.int64),
                   np.asarray(arrays["c_offsets"], dtype=np.int64),
                   np.asarray(arrays["lengths"], dtype=np.int64),
                   packed, variant, sampling, memoize)

    # ------------------------------------------------------------------
    # expansion
    # ------------------------------------------------------------------
    def _leaf_value(self, i: int) -> int:
        p = self.packed
        if self.variant == "skip":
            return int(p.rs[i])
        return int(p.rs_leaf[p.rank0[i]])

    def _expand_tree_pos(self, pos: int) -> np.ndarray:
        """Expand the subtree rooted at R_B position ``pos`` into gap values."""
        if self.memoize and pos in self._memo:
            return self._memo[pos]
        p = self.packed
        out: list = []
        ones = 0
        zeros = 0
        i = pos
        while zeros <= ones:
            if p.rb[i]:
                ones += 1
            else:
                zeros += 1
                v = self._leaf_value(i)
                if v <= p.u:
                    out.append(v)
                else:
                    out.append(self._expand_tree_pos(v - p.u - 1))
            i += 1
        arrs = [np.asarray([x], dtype=np.int64) if isinstance(x, int) else x for x in out]
        res = np.concatenate(arrs) if arrs else np.zeros(0, dtype=np.int64)
        if self.memoize:
            self._memo[pos] = res
        return res

    def expand_symbol(self, sym: int) -> np.ndarray:
        if sym <= self.packed.u:
            return np.asarray([sym], dtype=np.int64)
        return self._expand_tree_pos(sym - self.packed.u - 1)

    def symbol_sum(self, sym: int) -> int:
        """Phrase sum of a C symbol (terminal value or nonterminal sum)."""
        if sym <= self.packed.u:
            return int(sym)
        return self.packed.sum_at(sym - self.packed.u - 1)

    def symbol_len(self, sym: int) -> int:
        if sym <= self.packed.u:
            return 1
        return self.packed.len_at(sym - self.packed.u - 1)

    # ------------------------------------------------------------------
    def get_gaps(self, i: int) -> np.ndarray:
        lo, hi = int(self.c_offsets[i]), int(self.c_offsets[i + 1])
        parts = [self.expand_symbol(int(s)) for s in self.c[lo:hi]]
        return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)

    def get_list(self, i: int) -> np.ndarray:
        return np.cumsum(self.get_gaps(i)) - 1

    @property
    def n_lists(self) -> int:
        return len(self.lengths)

    def list_length(self, i: int) -> int:
        return int(self.lengths[i])

    # ------------------------------------------------------------------
    # the unified query protocol
    # ------------------------------------------------------------------
    def intersect_candidates(self, i: int, cand: np.ndarray) -> np.ndarray:
        """Skip variant: compressed-domain candidate intersection via phrase
        sums (§4.3); plain variant: the decode-and-merge default."""
        if self.variant == "skip":
            from .intersect import intersect_repair_skip

            return intersect_repair_skip(self, i, cand)
        return super().intersect_candidates(i, cand)

    # ------------------------------------------------------------------
    # skip search (§4.1): is value x in list i?
    # ------------------------------------------------------------------
    def _descend(self, pos: int, s: int, x: int) -> tuple[bool, int]:
        """Scan leaf values of subtree at R_B ``pos`` from cumulative sum s.

        Only called when the subtree is known to reach x (s + sum >= x), so
        the answer is decided inside.  Returns (found, cumsum at decision).
        """
        p = self.packed
        ones = 0
        zeros = 0
        i = pos
        while zeros <= ones:
            self.op_counter += 1
            if p.rb[i]:
                ones += 1
            else:
                zeros += 1
                v = int(p.rs[i])
                if v <= p.u:
                    s += v
                    if s == x:
                        return True, s
                    if s > x:
                        return False, s
                else:
                    ref = v - p.u - 1
                    ssum = int(p.rs[ref])
                    if s + ssum < x:
                        s += ssum  # skip the whole nested phrase
                    else:
                        return self._descend(ref, s, x)
            i += 1
        return False, s

    def contains(self, i: int, x: int) -> bool:
        """Membership of absolute posting ``x`` in list ``i`` (skip search)."""
        if self.variant != "skip":
            lst = self.get_list(i)
            j = np.searchsorted(lst, x)
            return bool(j < len(lst) and lst[j] == x)
        target = x + 1  # gaps cumulate to posting + 1 (see dgaps.to_dgaps)
        lo, hi = int(self.c_offsets[i]), int(self.c_offsets[i + 1])
        s = 0
        for ci in range(lo, hi):
            self.op_counter += 1
            sym = int(self.c[ci])
            if sym <= self.packed.u:
                s += sym
                if s == target:
                    return True
                if s > target:
                    return False
            else:
                ref = sym - self.packed.u - 1
                ssum = int(self.packed.rs[ref])
                if s + ssum < target:
                    s += ssum
                else:
                    found, _ = self._descend(ref, s, target)
                    return found
        return False

    # ------------------------------------------------------------------
    # sampling (§4.2)
    # ------------------------------------------------------------------
    def _build_samples(self) -> None:
        kind, param = self.sampling
        self._samples = []
        for i in range(self.n_lists):
            lo, hi = int(self.c_offsets[i]), int(self.c_offsets[i + 1])
            syms = self.c[lo:hi]
            if len(syms) == 0:
                self._samples.append((np.zeros(0, np.int64), np.zeros(0, np.int64)))
                continue
            sums = np.asarray([self.symbol_sum(int(t)) for t in syms], dtype=np.int64)
            prefix = np.concatenate([[0], np.cumsum(sums)])  # cumsum before entry j
            if kind == "cm":
                # absolute value preceding every param-th entry of C [21]
                idx = np.arange(0, len(syms), max(1, param), dtype=np.int64)
                self._samples.append((prefix[idx], idx))
            elif kind == "st":
                # domain sampling [60]: universe split at steps
                # 2^ceil(log2(u*B/l)) over the *uncompressed* length l
                total = int(prefix[-1])
                ell = max(1, int(self.lengths[i]))
                raw = max(1.0, total * param / ell)
                step = 1 << int(np.ceil(np.log2(raw)))
                marks = np.arange(0, total + step, step, dtype=np.int64)
                idx = np.searchsorted(prefix[1:], marks, side="left")
                idx = np.minimum(idx, len(syms) - 1)
                self._samples.append((prefix[idx], idx))
            else:
                raise ValueError(f"unknown sampling kind {kind}")

    def sample_seek(self, i: int, x: int) -> tuple[int, int]:
        """Return (C entry index, cumsum before it) to start scanning for x.

        Uses the samples when present, else the list start.
        """
        if self._samples is None:
            return int(self.c_offsets[i]), 0
        vals, idx = self._samples[i]
        if len(vals) == 0:
            return int(self.c_offsets[i]), 0
        j = int(np.searchsorted(vals, x + 1, side="right")) - 1
        j = max(0, j)
        return int(self.c_offsets[i] + idx[j]), int(vals[j])

    # ------------------------------------------------------------------
    # sizes
    # ------------------------------------------------------------------
    @property
    def size_in_bits(self) -> int:
        p = self.packed
        n_syms = int(p.u) + len(p.rb) + 2
        w_c = max(1, int(n_syms).bit_length())
        bits = len(self.c) * w_c  # C entries, fixed width
        bits += len(p.rb)  # R_B bitmap
        w_rs = max(w_c, int(max(1, int(p.rs.max(initial=1)))).bit_length())
        if self.variant == "skip":
            bits += len(p.rs) * w_rs
        else:
            bits += len(p.rs_leaf) * w_rs
            bits += len(p.rb) // 4  # rank0 directory overhead (o(n) term)
        bits += 32 * self.n_lists  # vocabulary pointers into C
        bits += 32 * self.n_lists  # stored uncompressed lengths (svs ordering)
        if self._samples is not None:
            for vals, idx in self._samples:
                bits += 64 * len(vals)
        return bits
