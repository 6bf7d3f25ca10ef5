"""Version-structure mining: MinHash–LSH near-copy discovery (ROADMAP 3).

The paper's universal indexes need no knowledge of a collection's
versioning structure; the canonical structure-*aware* competitor (Navarro
2020, §RLZ) first discovers that structure.  This package is the
discovery half: MinHash signatures over document token streams, batched on
the GPU (``device="cpu"`` runs their plain version), LSH banding to bucket near-copies without a pairwise scan, and
a clustering pass electing a reference head per cluster.  Its consumers:

* ``NonPositionalIndex.build(..., mine_similarity=True)`` attaches a
  :class:`SimilarityIndex` that persists with the artifact and answers
  the ``similar:<doc>`` / ``versions-of:<doc>`` query kinds;
* the ``rlz`` backend (``repro_torch.core.rlz_store``) runs the same
  machinery over posting lists to pick referential-encoding heads;
* :meth:`SimilarityIndex.cluster_order` gives the placement that
  co-locates near-copies before a store build.
"""

from .cluster import (
    SimilarityIndex,
    cluster_purity,
    cluster_union,
    leader_assign,
    lsh_band_keys,
)
from .minhash import (
    EMPTY_SIG,
    MinHashConfig,
    element_hashes,
    est_jaccard,
    est_jaccard_many,
    shingle_hashes,
    signature_matrix,
)

__all__ = [
    "EMPTY_SIG",
    "MinHashConfig",
    "SimilarityIndex",
    "cluster_purity",
    "cluster_union",
    "element_hashes",
    "est_jaccard",
    "est_jaccard_many",
    "leader_assign",
    "lsh_band_keys",
    "shingle_hashes",
    "signature_matrix",
]
