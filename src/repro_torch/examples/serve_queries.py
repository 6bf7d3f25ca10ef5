"""Batched query serving: the paper's compressed index as a service.

Builds the Re-Pair indexes (non-positional + positional), then serves a
mixed batch of word / AND / phrase / ranked top-k queries through one
plan-compiled ``Session`` two ways — host-only (paper's sequential
skipping) and attached to ``--device`` (``cuda`` unless the caller asks for
``cpu``: anchored batched steps, windowed so results are exact; on a card
the fused layout's ``decode_window`` / ``probe_window`` kernels) — checks
they agree, and prints an EXPLAIN plus the plan-cache / step-cache metrics.

    PYTHONPATH=src python -m repro_torch.examples.serve_queries [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..core.device import resolve_device
from ..core.index import NonPositionalIndex, PositionalIndex
from ..data import generate_collection
from ..data.queries import sample_traffic
from ..serving.session import Session


def main(argv=None) -> dict:
    """Returns the host and device answers and the device session's
    metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no GPU for a cuda run: raise before any work
    col = generate_collection(n_articles=10, versions_per_article=25,
                              words_per_doc=200, seed=4)
    idx = NonPositionalIndex.build(col.docs, store="repair_skip")
    pidx = PositionalIndex.build(col.docs, store="repair_skip")
    print(f"non-positional index: {idx.store.n_lists} terms, "
          f"{100*idx.space_fraction:.3f}% of collection")
    print(f"positional index: {pidx.store.n_lists} tokens, "
          f"{100*pidx.space_fraction:.3f}% of collection")

    rng = np.random.default_rng(0)
    words = [w for w in idx.vocab.id_to_token[:200]]
    # word / AND / phrase / topk round-robin over real collection text
    queries = sample_traffic("mixed", 32, col.docs, words, rng, n_terms=2, k=5)

    # host path: one Session, no device servers
    host = Session(idx, positional=pidx)
    t0 = time.perf_counter()
    host_results = host.execute(queries)
    host_ms = 1e3 * (time.perf_counter() - t0)
    print(f"host session: 32 mixed queries in {host_ms:.1f} ms")

    # device path: anchored arrays + plan-compiled batched buckets
    session = Session.build(idx, positional=pidx, device=args.device)
    routes = [session.plan(q) for q in queries]
    n_dev = sum(1 for rt in routes if rt.route == "device")
    print(f"plan compiler: {n_dev}/32 routed to device "
          f"({sorted(set(rt.strategy for rt in routes))})")
    dev_results = session.execute(queries)  # build the steps + serve
    t0 = time.perf_counter()
    dev_results = session.execute(queries)  # answers on the host: the device is done
    dev_ms = 1e3 * (time.perf_counter() - t0)
    print(f"device (anchored, jitted, windowed): 32 mixed queries in {dev_ms:.1f} ms")
    m = session.metrics()
    print(f"plan cache hit rate {m['plan_cache_hit_rate']:.2f} "
          f"({m['plans_compiled']} plans for {m['queries_executed']} queries), "
          f"jit traces {m['jit_traces']}")

    # exact agreement (no candidate cap: windows cover full lists)
    agree = sum(1 for h, d in zip(host_results, dev_results)
                if np.array_equal(np.asarray(h), np.asarray(d)))
    print(f"host/device agreement: {agree}/32 queries")

    # EXPLAIN: the costed physical operator tree of one phrase query
    pq = next(q for q in queries if q.startswith('"'))
    print("\n" + session.explain(pq) + "\n")

    # phrase answers translate to (doc, offset) pairs
    pos = session.execute([pq])[0]
    docs, offs = pidx.positions_to_docs(np.asarray(pos))
    print(f"phrase {pq}: {len(pos)} occurrences, first at "
          f"doc {docs[0] if len(docs) else '-'} offset {offs[0] if len(offs) else '-'}")
    if agree != 32:
        raise AssertionError("host/device mismatch")
    return {"host": host_results, "device": dev_results, "metrics": m,
            "host_ms": host_ms, "device_ms": dev_ms}


if __name__ == "__main__":
    main()
