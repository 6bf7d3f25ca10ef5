"""The full index lifecycle in one pass, in a throwaway directory.

    PYTHONPATH=src python -m repro_torch.scripts.lifecycle_smoke /tmp/workdir [--device cpu]

Stages (each prints one OK line; any failure is a non-zero exit):
  1. build   — segmented IndexWriter over a synthetic versioned collection
  2. persist — two commits, then a third (the "new version batch")
  3. open    — Session.open on the writer dir, its servers on ``--device``
               (``cuda`` unless the caller asks for ``cpu``); answers ==
               in-memory build
  4. serve   — all six query kinds, repeated batch must re-plan nothing
  5. ingest  — live commit + refresh picks up the new segment
  6. gate    — manifest checksums verify; a corrupted blob must fail
               naming the bad component (and the artifact must still open
               after the corruption is restored)
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..core.artifact import ArtifactError, open_index, read_manifest
from ..core.device import resolve_device
from ..core.index import NonPositionalIndex, PositionalIndex
from ..core.writer import IndexWriter
from ..data import generate_collection
from ..serving.session import Session

STORE = "repair_skip"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("workdir")
    ap.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    dev = args.device
    resolve_device(dev)  # no GPU for a cuda run: raise before any work
    root = Path(args.workdir)
    col = generate_collection(n_articles=2, versions_per_article=5,
                              words_per_doc=40, seed=7)
    docs = col.docs
    writer = IndexWriter(root / "ix", store=STORE, positional=True, device=dev)
    writer.add_documents(docs[:5])
    writer.commit()
    writer.add_documents(docs[5:])
    writer.commit()
    print(f"build+persist OK: {len(writer.segments)} segments, "
          f"{writer.n_docs} docs")

    session = Session.open(root / "ix", device=dev)
    one = Session(NonPositionalIndex.build(docs, store=STORE),
                  positional=PositionalIndex.build(docs, store=STORE))
    words = one.index.vocab.id_to_token[:4]
    queries = [words[0], f"{words[0]} {words[1]}", f'"{words[0]} {words[1]}"',
               f"top3: {words[0]} {words[1]}", f"docs: {words[0]}",
               f"docs-top2: {words[0]} {words[1]}"]
    got = session.execute(queries)
    want = one.execute(queries)
    for q, g, w in zip(queries, got, want):
        if not np.array_equal(np.asarray(g), np.asarray(w)):
            raise AssertionError(f"open/serve drift on {q!r}: {np.asarray(g)} != {np.asarray(w)}")
    warm = session.metrics()
    session.execute(queries)
    m = session.metrics()
    if m["plans_compiled"] != warm["plans_compiled"] or m["jit_traces"] != warm["jit_traces"]:
        raise AssertionError((warm, m))
    print(f"open+serve OK: {len(queries)} kinds byte-identical, "
          f"0 re-plans / 0 retraces on the repeated batch")

    live = IndexWriter.open(root / "ix", device=dev)
    live.add_documents(docs[:2])
    seg = live.commit()
    if session.refresh() != 1:
        raise AssertionError("refresh did not pick up the one new segment")
    full = Session(NonPositionalIndex.build(docs + docs[:2], store=STORE),
                   positional=PositionalIndex.build(docs + docs[:2], store=STORE))
    for q, g, w in zip(queries, session.execute(queries), full.execute(queries)):
        if not np.array_equal(np.asarray(g), np.asarray(w)):
            raise AssertionError(f"post-ingest drift on {q!r}")
    print(f"ingest OK: {seg.name} committed live, answers match a full rebuild")

    # checksum gate: verify-all passes, then corrupt one store blob and
    # require the error path to name the component
    art_dir = live.segment_dir(live.segments[0]) / "nonpositional"
    manifest = read_manifest(art_dir)
    open_index(art_dir)  # all checksums verify
    name = sorted(n for n in manifest["components"] if n.startswith("store."))[0]
    blob = art_dir / manifest["components"][name]["file"]
    payload = blob.read_bytes()
    blob.write_bytes(payload[:-1] + bytes([payload[-1] ^ 0xFF]))
    try:
        open_index(art_dir)
    except ArtifactError as e:
        if name not in str(e):
            raise AssertionError(f"corruption error does not name {name!r}: {e}") from e
    else:
        raise AssertionError("corrupted blob opened without error")
    finally:
        blob.write_bytes(payload)
    open_index(art_dir)  # restored artifact opens again
    print(f"checksum gate OK: corruption of {name!r} detected and named")
    return 0


if __name__ == "__main__":
    sys.exit(main())
