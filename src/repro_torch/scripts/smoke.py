"""Smoke of the port's serving stack in one process: the counterpart of the
reference's ``scripts/smoke.sh`` (without its pytest stage) and of the
non-benchmark stages of ``scripts/ci.sh`` (registry, explain, lifecycle,
version mining).  Every device stage runs on ``--device`` (``cuda`` unless
the caller asks for ``cpu``).  Exits non-zero on any failure.

    PYTHONPATH=src python -m repro_torch.scripts.smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
import tempfile

import numpy as np

from ..core.device import resolve_device
from ..core.index import NonPositionalIndex, PositionalIndex
from ..data import generate_collection
from ..data.text import tokenize
from ..examples import serve_queries
from ..serving.session import Session
from . import explain, lifecycle_smoke, list_backends


def _require(cap: str) -> None:
    """``list_backends --require cap`` with its table dropped, as a gate."""
    with contextlib.redirect_stdout(io.StringIO()):
        rc = list_backends.main(["--require", cap])
    if rc != 0:
        raise SystemExit(f"no backend declares {cap!r}")


def unified_session() -> None:
    """One inverted and one self-index backend agree on a mixed batch."""
    col = generate_collection(n_articles=3, versions_per_article=5,
                              words_per_doc=60, seed=7)
    ph = tokenize(col.docs[0])[2:4]
    sessions = {}
    for store in ("repair_skip", "rlcsa"):  # one inverted, one self-index
        sessions[store] = Session(
            NonPositionalIndex.build(col.docs, store=store),
            positional=PositionalIndex.build(col.docs, store=store))
    words = [w for w in sessions["repair_skip"].index.vocab.id_to_token[:12]]
    batch = [words[1], f"{words[1]} {words[4]}", '"' + " ".join(ph) + '"',
             f"docs: {words[1]} {words[4]}", 'docs: "' + " ".join(ph) + '"']
    results = {s: sess.execute(batch) for s, sess in sessions.items()}
    for q, a, b in zip(batch, results["repair_skip"], results["rlcsa"]):
        if not np.array_equal(np.sort(np.asarray(a)), np.sort(np.asarray(b))):
            raise AssertionError(q)
        rt = sessions["rlcsa"].plan(q)
        print(f"  {q!r:32s} -> {len(np.asarray(a)):3d} hits "
              f"(rlcsa strategy: {rt.strategy})")
    m = sessions["rlcsa"].metrics()
    if m["plans_compiled"] > len(batch):
        raise AssertionError(m)
    print("inverted/self-index answers agree on the mixed batch")


def version_mining(device: str) -> None:
    """Clusters mined on the device -> rlz backend -> ``similar:`` queries."""
    col = generate_collection(n_articles=3, versions_per_article=6,
                              words_per_doc=80, structure="tree", seed=5)
    idx = NonPositionalIndex.build(col.docs, store="rlz", mine_similarity=True, device=device)
    if idx.similarity.purity(col.article_of) < 0.9:
        raise AssertionError("mined clusters impure")
    s = Session(idx)
    hits = s.execute("similar: 0")
    if not len(hits) or 0 in hits:
        raise AssertionError(f"similar:0 smoke answer {hits}")
    versions = s.execute("versions-of: 0")
    if 0 not in versions or not set(hits) <= set(versions.tolist()):
        raise AssertionError(f"versions-of:0 {versions} does not cover similar:0 {hits}")
    print(f"version mining OK: {idx.similarity.n_clusters} clusters, "
          f"{idx.store.n_heads} rlz heads, similar:0 -> {len(hits)} docs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no GPU for a cuda run: raise before any work
    dev = ["--device", args.device]

    print("== backend registry ==")
    if list_backends.main([]) != 0:
        raise SystemExit("list_backends failed")

    print("== unified Session: one backend per family, mixed query batch ==")
    unified_session()

    print("== explain CLI: physical plans against one backend per family ==")
    explain.main(["top5: alpha beta", "--store", "repair_skip", *dev])
    explain.main(["--sample", "docs-phrase", "--store", "rlcsa", "--json", *dev])
    explain.main(["--operators"])

    print("== index lifecycle: build -> persist -> open -> serve -> ingest ==")
    _require("persist")
    with tempfile.TemporaryDirectory(prefix="lifecycle_") as d:
        if lifecycle_smoke.main([d, *dev]) != 0:
            raise SystemExit("lifecycle smoke failed")

    print("== version mining: clusters -> rlz backend -> similar: queries ==")
    _require("referential")
    version_mining(args.device)

    print("== end-to-end: serve_queries ==")
    serve_queries.main(dev)

    print("smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
