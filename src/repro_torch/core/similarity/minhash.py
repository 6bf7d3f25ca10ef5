"""MinHash over token shingles: config, shingling, signature matrices.

The version-structure miner never reads ``article_of`` labels: near-copy
structure is recovered from content alone.  Each document's analyzed
term-id sequence is reduced to its set of ``k``-shingle hashes (rolling
multiply-add over a window of ``k`` term ids, wraparound uint32), and the
MinHash signature of that set estimates Jaccard similarity between any
two documents in ``O(num_perm)`` — ``P(sig_a[p] == sig_b[p]) =
J(A, B)`` for a random hash permutation, so the match fraction is an
unbiased estimator with standard error ``sqrt(J(1-J)/num_perm)``.

Signature computation batches on the device through the ``minhash_sig``
kernel (``repro_torch.kernels``): the (D, L) shingle matrix × P hash
permutations min-reduction is embarrassingly parallel.  It runs on the GPU
unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...kernels.minhash_sig.ops import hash_params, minhash_signatures
from ...kernels.minhash_sig.ref import EMPTY_SIG

#: Fibonacci-hash multiplier for the rolling shingle hash (odd -> bijective
#: per step mod 2^32)
SHINGLE_MULT = np.uint32(0x9E3779B1)


@dataclass(frozen=True)
class MinHashConfig:
    """Mining parameters (persisted with the signature index).

    ``num_perm`` hash permutations split into ``bands`` LSH bands of
    ``num_perm // bands`` rows each; two documents share a bucket with
    probability ``1 - (1 - J^rows)^bands`` — the s-curve threshold is
    ``(1/bands)^(1/rows)`` (≈ 0.5 at the 16 × 4 default).  ``threshold``
    is the estimated-Jaccard gate applied to bucket candidates before any
    pair is linked.
    """

    num_perm: int = 64
    shingle: int = 3
    bands: int = 16
    threshold: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.num_perm < 1 or self.bands < 1 or self.shingle < 1:
            raise ValueError(f"MinHashConfig needs num_perm/bands/shingle "
                             f">= 1, got {self}")
        if self.num_perm % self.bands:
            raise ValueError(f"num_perm={self.num_perm} must be divisible "
                             f"by bands={self.bands}")
        if not 0.0 < self.threshold <= 1.0:
            raise ValueError(f"threshold={self.threshold} must be in (0, 1]")

    @property
    def rows(self) -> int:
        return self.num_perm // self.bands

    def config(self) -> dict:
        return {"num_perm": self.num_perm, "shingle": self.shingle,
                "bands": self.bands, "threshold": self.threshold,
                "seed": self.seed}

    @classmethod
    def from_config(cls, cfg: dict | None) -> "MinHashConfig":
        return cls(**cfg) if cfg else cls()


def shingle_hashes(seq, k: int) -> np.ndarray:
    """Sorted unique uint32 hashes of the ``k``-shingles of ``seq`` (an
    int sequence).  Sequences shorter than ``k`` use their whole length as
    one shingle; the empty sequence has no shingles."""
    s = np.asarray(seq, dtype=np.int64)
    n = len(s)
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    k = min(k, n)
    vals = (s + 1).astype(np.uint32)  # +1 keeps term id 0 distinct from "none"
    with np.errstate(over="ignore"):
        h = np.zeros(n - k + 1, dtype=np.uint32)
        for j in range(k):
            h = h * SHINGLE_MULT + vals[j:n - k + 1 + j]
    return np.unique(h)


def element_hashes(values) -> np.ndarray:
    """Shingle view of a plain integer *set* (1-shingles): used by the RLZ
    store, whose "documents" are posting lists of doc ids."""
    v = np.asarray(values, dtype=np.int64)
    return np.unique((v + 1).astype(np.uint32))


def pack_shingles(sets: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad per-row shingle sets into one (D, Lmax) uint32 matrix +
    the (D,) live-length vector the signature kernel consumes."""
    d = len(sets)
    lens = np.asarray([len(s) for s in sets], dtype=np.int64)
    mat = np.zeros((d, int(lens.max()) if d else 0), dtype=np.uint32)
    for i, s in enumerate(sets):
        mat[i, :len(s)] = s
    return mat, lens


def signature_matrix(sets: list[np.ndarray], config: MinHashConfig,
                     device="cuda") -> np.ndarray:
    """(D, num_perm) uint32 MinHash signatures of per-row shingle sets,
    computed on ``device``.

    Rows with no shingles sign as all-:data:`EMPTY_SIG` (2^32 - 1); they
    are treated as singletons by the clustering pass, never bucketed.
    """
    mat, lens = pack_shingles(sets)
    a, b = hash_params(config.num_perm, config.seed)
    return minhash_signatures(mat, lens, a, b, device=device)


def est_jaccard(sigs: np.ndarray, i: int, j: int) -> float:
    """MinHash Jaccard estimate between signature rows ``i`` and ``j``
    (standard error ``sqrt(J(1-J)/num_perm)``)."""
    return float(np.mean(sigs[i] == sigs[j]))


def est_jaccard_many(sigs: np.ndarray, i: int, others: np.ndarray) -> np.ndarray:
    """Vectorized :func:`est_jaccard` of row ``i`` against ``others``."""
    if len(others) == 0:
        return np.zeros(0, dtype=np.float64)
    return np.mean(sigs[others] == sigs[i][None, :], axis=1)


__all__ = ["EMPTY_SIG", "MinHashConfig", "SHINGLE_MULT", "element_hashes",
           "est_jaccard", "est_jaccard_many", "pack_shingles",
           "shingle_hashes", "signature_matrix"]
