"""EXPLAIN a query against any registered backend.

Builds a small versioned collection, the indexes the query needs, and a
``Session`` with device servers on ``--device`` (``cuda`` unless the
caller asks for ``cpu``; ``--no-device`` plans against a host-only
session), then prints ``Session.explain`` — the compiled physical operator
tree with cost estimates (text, or ``--json``).

    PYTHONPATH=src python -m repro_torch.scripts.explain "top5: w1 w2"
    PYTHONPATH=src python -m repro_torch.scripts.explain 'docs: "w1 w2"' --store rlcsa --json
    PYTHONPATH=src python -m repro_torch.scripts.explain --sample phrase --store repair_skip
    PYTHONPATH=src python -m repro_torch.scripts.explain --operators   # capability matrix

Unknown terms are fine — the plan shows the host route an
unknown-term query takes (the device path needs every term in
vocabulary).  ``--sample <kind>`` draws a real query of that kind from the
generated collection instead, so the plan reflects in-vocabulary traffic.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..core.device import resolve_device
from ..core.index import NonPositionalIndex, PositionalIndex
from ..core.registry import PHYSICAL_OPERATORS, backend_names
from ..data import generate_collection
from ..data.queries import sample_traffic
from ..serving.session import Session


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("query", nargs="?", default=None,
                    help="query in the Session grammar (see README)")
    ap.add_argument("--sample", type=str, default=None,
                    choices=["word", "and", "phrase", "topk", "docs",
                             "docs-phrase", "docs-topk"],
                    help="explain a sampled in-vocabulary query of this kind")
    ap.add_argument("--store", type=str, default="repair_skip",
                    choices=backend_names())
    ap.add_argument("--articles", type=int, default=4)
    ap.add_argument("--versions", type=int, default=6)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--no-device", action="store_true",
                    help="plan against a host-only session")
    ap.add_argument("--device", type=str, default="cuda",
                    help="device of the session's servers (cuda | cpu)")
    ap.add_argument("--operators", action="store_true",
                    help="print the capability -> physical operator matrix and exit")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.operators:
        w = max(len(op) for op in PHYSICAL_OPERATORS)
        for op, (req, desc) in PHYSICAL_OPERATORS.items():
            print(f"{op:<{w}}  requires: {req:<32}  {desc}")
        return
    if args.query is None and args.sample is None:
        raise SystemExit("pass a query, --sample <kind>, or --operators")
    if not args.no_device:
        resolve_device(args.device)  # no GPU for a cuda run: raise before any work

    col = generate_collection(n_articles=args.articles,
                              versions_per_article=args.versions,
                              words_per_doc=80, seed=args.seed)
    idx = NonPositionalIndex.build(col.docs, store=args.store, device=args.device)
    pidx = PositionalIndex.build(col.docs, store=args.store, device=args.device)
    session = Session.build(idx, positional=pidx, device=args.device,
                            attach=not args.no_device)
    if not args.json:
        for name, ix in (("nonpositional", idx), ("positional", pidx)):
            st = ix.stats()  # the cost-model catalog, summarized
            print(f"# {name}: {st.n_lists} lists, {st.n_postings} postings, "
                  f"universe {st.universe_size}, avg/max list "
                  f"{st.avg_list_length}/{st.max_list_length}")

    query = args.query
    if query is None:
        rng = np.random.default_rng(args.seed)
        words = [w for w in idx.vocab.id_to_token[:100]]
        query = sample_traffic(args.sample, 1, col.docs, words, rng)[0]

    if args.json:
        print(json.dumps(session.explain(query, fmt="json"), indent=2))
    else:
        print(session.explain(query))


if __name__ == "__main__":
    main()
