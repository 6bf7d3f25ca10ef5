"""Quickstart: build a compressed inverted index over a highly repetitive
versioned collection and query it, all on the host (the stores and a host
``Session``; no device).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.index import NonPositionalIndex, PositionalIndex
from ..data import generate_collection
from ..data.text import tokenize
from ..serving.session import Session


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    # a wiki-like collection: 10 articles x 30 near-identical versions
    col = generate_collection(n_articles=10, versions_per_article=30,
                              words_per_doc=200, edit_rate=0.01, seed=1)
    print(f"collection: {col.n_docs} docs, {col.total_bytes/1e6:.2f} MB")

    print("\nnon-positional index sizes (% of collection):")
    for store in ["vbyte", "rice", "ef_opt", "rice_runs", "vbyte_lzma",
                  "repair_skip", "vbyte_lzend"]:
        idx = NonPositionalIndex.build(col.docs, store=store)
        print(f"  {store:14s} {100 * idx.space_fraction:7.3f}%")

    idx = NonPositionalIndex.build(col.docs, store="repair_skip")
    words = [w for w in idx.vocab.id_to_token[:40]]
    q = [words[3], words[11]]
    docs = idx.query_and(q)
    print(f"\nAND query {q}: {len(docs)} docs -> {docs[:12].tolist()}...")

    pos = PositionalIndex.build(col.docs, store="repair_skip")
    phrase = tokenize(col.docs[0])[4:7]
    hits = pos.query_phrase(phrase)
    d, off = pos.positions_to_docs(hits)
    print(f"phrase {phrase}: {len(hits)} occurrences; "
          f"first at doc {int(d[0])} word-offset {int(off[0])}" if len(hits)
          else f"phrase {phrase}: no hits")

    # verify one hit by eye
    if len(hits):
        doc_tokens = tokenize(col.docs[int(d[0])])
        print("  context:", " ".join(doc_tokens[int(off[0]) - 2 : int(off[0]) + 5]))

    # document listing: distinct documents containing a pattern — on a
    # repetitive collection far fewer docs than occurrences.  Session is
    # the one serving entry point (execute + explain).
    session = Session(idx, positional=pos)
    dq = 'docs: "' + " ".join(phrase) + '"'
    listed = session.execute(dq)
    print(f"\n{dq!r}: {len(hits)} occurrences in {len(listed)} distinct docs "
          f"-> {listed[:10].tolist()}...")
    top = session.execute(f"docs-top3: {q[0]} {q[1]}")
    print(f"docs-top3 for {q}: {top.tolist()} (ranked by term frequency)")
    print("\nEXPLAIN " + dq)
    print(session.explain(dq))

    # self-indexes answer the same queries through the same API (the
    # backend registry: word/AND/phrase against `store="rlcsa"` etc.)
    sub = col.docs[:30]
    si = PositionalIndex.build(sub, store="rlcsa")
    pv = PositionalIndex.build(sub, store="repair_skip")
    same = np.array_equal(np.sort(si.query_phrase(phrase)), np.sort(pv.query_phrase(phrase)))
    print(f"\nself-index backend (rlcsa): {100 * si.space_fraction:.2f}% of collection, "
          f"phrase answers match repair_skip: {same}")


if __name__ == "__main__":
    main()
