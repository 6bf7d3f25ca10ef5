"""LSH banding, near-copy clustering, and the persisted signature index.

Two clustering disciplines share the LSH candidate machinery, because two
different consumers need them:

* :func:`cluster_union` — union-find over bucket candidate pairs gated on
  estimated Jaccard.  Transitive: a chain v0 ~ v1 ~ ... ~ vn links the
  whole version history of an article even when the endpoints have
  drifted below the pair threshold.  This is what ``versions-of:``
  answers and what the purity tests score against ``article_of``.

* :func:`leader_assign` — order rows by decreasing weight; each row joins
  the best *existing leader* found through the shared buckets, else
  becomes a leader itself.  Non-transitive by construction: every member
  is directly similar to its head, which is what a referential encoder
  (the ``rlz`` backend) needs — a member's diff against its cluster head
  stays small.

Both run in time proportional to bucket collisions, never a pairwise
scan over all rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .minhash import (
    MinHashConfig,
    est_jaccard,
    est_jaccard_many,
    shingle_hashes,
    signature_matrix,
)


def lsh_band_keys(sigs: np.ndarray, n_shingles: np.ndarray,
                  bands: int) -> list[list[bytes]]:
    """Per-row LSH bucket keys: one ``bytes`` key per band (the band index
    prefixed to the band's signature slice).  Rows with no shingles get no
    keys — empty documents never collide."""
    d, p = sigs.shape
    rows = p // bands
    out: list[list[bytes]] = []
    for i in range(d):
        if n_shingles[i] == 0:
            out.append([])
            continue
        row = sigs[i]
        out.append([bytes([b]) + row[b * rows:(b + 1) * rows].tobytes()
                    for b in range(bands)])
    return out


def _build_buckets(keys: list[list[bytes]]) -> dict[bytes, list[int]]:
    buckets: dict[bytes, list[int]] = {}
    for i, ks in enumerate(keys):
        for k in ks:
            buckets.setdefault(k, []).append(i)
    return buckets


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = int(p[x])
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def cluster_union(sigs: np.ndarray, n_shingles: np.ndarray,
                  config: MinHashConfig) -> np.ndarray:
    """Dense cluster labels (int64, first-document order) from union-find
    over LSH candidate pairs with estimated Jaccard >= ``threshold``."""
    d = len(sigs)
    uf = _UnionFind(d)
    buckets = _build_buckets(lsh_band_keys(sigs, n_shingles, config.bands))
    for members in buckets.values():
        for a_pos in range(len(members)):
            a = members[a_pos]
            for b in members[a_pos + 1:]:
                if uf.find(a) == uf.find(b):
                    continue
                if est_jaccard(sigs, a, b) >= config.threshold:
                    uf.union(a, b)
    labels = np.full(d, -1, dtype=np.int64)
    next_label = 0
    for i in range(d):
        r = uf.find(i)
        if labels[r] < 0:
            labels[r] = next_label
            next_label += 1
        labels[i] = labels[r]
    return labels


def leader_assign(sigs: np.ndarray, n_shingles: np.ndarray,
                  config: MinHashConfig, weights: np.ndarray,
                  cost: "callable | None" = None) -> np.ndarray:
    """Reference assignment for referential encoding: ``ref[i]`` is the
    leader row ``i`` encodes against, or ``-1`` when ``i`` is itself a
    leader.  Rows are visited in decreasing ``weights`` order; candidates
    are the leaders sharing an LSH bucket with estimated Jaccard >=
    ``threshold``.  With ``cost(i, leader) -> float`` the cheapest
    candidate wins and only if it beats ``cost(i, -1)`` (the cost of
    standing alone); without it the most-similar candidate wins."""
    d = len(sigs)
    keys = lsh_band_keys(sigs, n_shingles, config.bands)
    ref = np.full(d, -1, dtype=np.int64)
    buckets: dict[bytes, list[int]] = {}
    for i in np.argsort(-np.asarray(weights), kind="stable").tolist():
        cands: list[int] = []
        seen = set()
        for k in keys[i]:
            for L in buckets.get(k, ()):
                if L not in seen:
                    seen.add(L)
                    cands.append(L)
        if cands:
            cand_arr = np.asarray(cands, dtype=np.int64)
            sims = est_jaccard_many(sigs, i, cand_arr)
            ok = cand_arr[sims >= config.threshold]
        else:
            ok = np.zeros(0, dtype=np.int64)
        best = -1
        if len(ok):
            if cost is None:
                best = int(ok[np.argmax(est_jaccard_many(sigs, i, ok))])
            else:
                best_c = cost(i, -1)
                for L in ok.tolist():
                    c = cost(i, int(L))
                    if c < best_c:
                        best_c, best = c, int(L)
        ref[i] = best
        if best < 0:  # a new leader: advertise its buckets
            for k in keys[i]:
                buckets.setdefault(k, []).append(i)
    return ref


def cluster_purity(labels: np.ndarray, truth: np.ndarray) -> float:
    """Fraction of rows whose cluster's majority ground-truth label is
    their own: ``sum over clusters of max truth count / n``."""
    labels = np.asarray(labels)
    truth = np.asarray(truth)
    if len(labels) == 0:
        return 1.0
    correct = 0
    for c in np.unique(labels):
        _, counts = np.unique(truth[labels == c], return_counts=True)
        correct += int(counts.max())
    return correct / len(labels)


# ----------------------------------------------------------------------
@dataclass
class SimilarityIndex:
    """The persisted product of version-structure mining over one
    collection: signatures, transitive cluster labels, and the elected
    head (medoid) per cluster.  Answers ``similar:<doc>`` (LSH candidates
    above the threshold) and ``versions-of:<doc>`` (the mined cluster)
    without touching the documents again."""

    config: MinHashConfig
    sigs: np.ndarray         # (D, num_perm) uint32
    n_shingles: np.ndarray   # int64[D]; 0 marks an empty document
    labels: np.ndarray       # int64[D] dense cluster labels
    heads: np.ndarray        # int64[n_clusters] head doc per cluster

    def __post_init__(self):
        self._buckets: dict[bytes, list[int]] | None = None
        self._keys: list[list[bytes]] | None = None

    # -- construction ---------------------------------------------------
    @classmethod
    def mine(cls, doc_terms: list[np.ndarray],
             config: MinHashConfig | None = None,
             device="cuda") -> "SimilarityIndex":
        """Mine the version structure of a collection given each
        document's analyzed term-id sequence (labels are never read); the
        signatures are computed on ``device``."""
        config = config or MinHashConfig()
        sets = [shingle_hashes(t, config.shingle) for t in doc_terms]
        n_shingles = np.asarray([len(s) for s in sets], dtype=np.int64)
        sigs = signature_matrix(sets, config, device=device)
        labels = cluster_union(sigs, n_shingles, config)
        heads = _elect_heads(sigs, labels)
        return cls(config=config, sigs=sigs, n_shingles=n_shingles,
                   labels=labels, heads=heads)

    @classmethod
    def merge(cls, parts: list["SimilarityIndex"]) -> "SimilarityIndex":
        """Merge segment indexes (compaction): signatures concatenate as-is
        (one pinned config means one hash family), then clusters and heads
        are recomputed globally so cross-segment near-copies link up."""
        configs = {p.config for p in parts}
        if len(configs) != 1:
            raise ValueError(f"cannot merge similarity indexes mined with "
                             f"different configs: {sorted(map(str, configs))}")
        config = parts[0].config
        sigs = np.vstack([p.sigs for p in parts])
        n_shingles = np.concatenate([p.n_shingles for p in parts])
        labels = cluster_union(sigs, n_shingles, config)
        heads = _elect_heads(sigs, labels)
        return cls(config=config, sigs=sigs, n_shingles=n_shingles,
                   labels=labels, heads=heads)

    # -- queries --------------------------------------------------------
    @property
    def n_docs(self) -> int:
        return len(self.labels)

    @property
    def n_clusters(self) -> int:
        return len(self.heads)

    def _check(self, doc: int) -> int:
        doc = int(doc)
        if not 0 <= doc < self.n_docs:
            raise ValueError(f"doc id {doc} out of range: the mined "
                             f"collection has {self.n_docs} documents "
                             f"(valid ids 0..{self.n_docs - 1})")
        return doc

    def _ensure_buckets(self):
        if self._buckets is None:
            self._keys = lsh_band_keys(self.sigs, self.n_shingles,
                                       self.config.bands)
            self._buckets = _build_buckets(self._keys)
        return self._keys, self._buckets

    def similar(self, doc: int, threshold: float | None = None) -> np.ndarray:
        """Sorted doc ids whose estimated Jaccard with ``doc`` reaches
        ``threshold`` (the config threshold by default), found through the
        LSH buckets — ``doc`` itself excluded."""
        doc = self._check(doc)
        th = self.config.threshold if threshold is None else threshold
        keys, buckets = self._ensure_buckets()
        cands = {j for k in keys[doc] for j in buckets[k]} - {doc}
        if not cands:
            return np.zeros(0, dtype=np.int64)
        cand_arr = np.asarray(sorted(cands), dtype=np.int64)
        sims = est_jaccard_many(self.sigs, doc, cand_arr)
        return cand_arr[sims >= th]

    def versions_of(self, doc: int) -> np.ndarray:
        """Sorted members of ``doc``'s mined cluster, ``doc`` included."""
        doc = self._check(doc)
        return np.flatnonzero(self.labels == self.labels[doc]).astype(np.int64)

    def head_of(self, doc: int) -> int:
        """The elected head (medoid) of ``doc``'s cluster."""
        return int(self.heads[self.labels[self._check(doc)]])

    def est_similarity(self, a: int, b: int) -> float:
        return est_jaccard(self.sigs, self._check(a), self._check(b))

    def cluster_order(self) -> np.ndarray:
        """A doc-id permutation grouping each cluster contiguously (head
        first, then members ascending), clusters in label order — the
        placement an index writer applies so near-copies land on adjacent
        doc ids."""
        head_mark = (np.arange(self.n_docs) != self.heads[self.labels])
        return np.lexsort((np.arange(self.n_docs), head_mark.astype(np.int64),
                           self.labels)).astype(np.int64)

    def purity(self, truth) -> float:
        """Cluster purity against ground-truth labels (test surface only —
        mining itself never reads them)."""
        return cluster_purity(self.labels, np.asarray(truth))

    # -- persistence ----------------------------------------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        return {"sigs": self.sigs.astype(np.uint32),
                "n_shingles": self.n_shingles.astype(np.int64),
                "labels": self.labels.astype(np.int64),
                "heads": self.heads.astype(np.int64)}

    @classmethod
    def from_arrays(cls, arrays: dict, config: MinHashConfig) -> "SimilarityIndex":
        return cls(config=config,
                   sigs=np.asarray(arrays["sigs"], dtype=np.uint32),
                   n_shingles=np.asarray(arrays["n_shingles"], dtype=np.int64),
                   labels=np.asarray(arrays["labels"], dtype=np.int64),
                   heads=np.asarray(arrays["heads"], dtype=np.int64))

    @property
    def size_in_bits(self) -> int:
        return (32 * self.sigs.size
                + 64 * (len(self.n_shingles) + len(self.labels)
                        + len(self.heads)))


def _elect_heads(sigs: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Medoid head per cluster: the member maximizing summed estimated
    similarity to the others (lowest doc id on ties)."""
    heads = np.zeros(int(labels.max()) + 1 if len(labels) else 0,
                     dtype=np.int64)
    for c in np.unique(labels):
        members = np.flatnonzero(labels == c)
        if len(members) == 1:
            heads[c] = members[0]
            continue
        sub = sigs[members]  # (m, P)
        agree = (sub[:, None, :] == sub[None, :, :]).mean(axis=2)
        totals = agree.sum(axis=1)
        heads[c] = members[int(np.argmax(totals))]
    return heads


__all__ = ["SimilarityIndex", "cluster_purity", "cluster_union",
           "leader_assign", "lsh_band_keys"]
