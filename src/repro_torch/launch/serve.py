"""Serving driver: build (or reopen) the compressed indexes over a
collection and serve batched word / AND / phrase / top-k / document-listing
traffic through one plan-compiled :class:`~repro_torch.serving.session.Session`
(host operators + the anchored device steps on ``--device``, windowed-exact,
plan-cached).  ``--device`` is ``cuda`` unless the caller asks for ``cpu``;
``--probe`` is ``kernel`` (the CUDA kernels, the default on a GPU) or
``torch`` (plain tensor code, the default on the CPU).

The index lifecycle flags cover build→persist→open→serve→ingest:
``--save-dir`` writes the collection through a segmented
:class:`~repro_torch.core.writer.IndexWriter` (``--commits`` batches);
``--index-dir`` opens a persisted artifact or writer directory instead of
rebuilding; ``--ingest N`` commits a batch of N new version documents
against the live directory and refreshes the running session in place.

``--frontend`` pushes the same traffic through the async micro-batch
frontend (:mod:`repro_torch.serving.frontend`) with open-loop arrivals
(``--rate`` q/s Poisson, 0 = burst) and reports the serving-frontier
metrics: p50/p95/p99 tail latency, reject rate, queue depth, result-cache
hit rate; ``--replicas N --shards M`` replicate the device path behind
least-loaded dispatch.

    PYTHONPATH=src python -m repro_torch.launch.serve --articles 10 --queries 64
    PYTHONPATH=src python -m repro_torch.launch.serve --mode mixed --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --save-dir ix --commits 4
    PYTHONPATH=src python -m repro_torch.launch.serve --index-dir ix --ingest 8
    PYTHONPATH=src python -m repro_torch.launch.serve --frontend --rate 500 --replicas 2
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..core.analyzer import analyzer_names, get_analyzer
from ..core.index import NonPositionalIndex, PositionalIndex
from ..core.registry import backend_names, get_backend_spec
from ..core.writer import IndexWriter
from ..data import generate_collection
from ..data.queries import sample_traffic
from ..serving.session import Session


def main(argv: list[str] | None = None) -> None:
    """Parse ``argv`` (the process's arguments when ``None``) and serve."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--articles", type=int, default=10)
    ap.add_argument("--versions", type=int, default=25)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--terms", type=int, default=2)
    ap.add_argument("--store", type=str, default="repair_skip",
                    choices=backend_names(),
                    help="any registered backend — inverted store or self-index")
    ap.add_argument("--mode", type=str, default="and",
                    choices=["and", "phrase", "topk", "rank", "docs",
                             "docs-phrase", "docs-topk", "mixed"])
    ap.add_argument("--analyzer", type=str, default="default",
                    choices=analyzer_names(),
                    help="analysis chain pinned into the non-positional "
                         "index (build/save paths; --index-dir adopts the "
                         "chain recorded in the artifact)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the device servers run (cuda or cpu)")
    ap.add_argument("--probe", type=str, default=None, choices=["kernel", "torch"],
                    help="kernel: the CUDA kernels (default on cuda); torch: "
                         "plain tensor code (default on cpu)")
    ap.add_argument("--explain", action="store_true",
                    help="print the physical plan of one query per distinct shape")
    ap.add_argument("--frontend", action="store_true",
                    help="serve the traffic through the async micro-batch "
                         "frontend (open-loop arrivals, result cache, "
                         "p50/p95/p99 tail latency)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="--frontend offered load in q/s (0 = burst arrival)")
    ap.add_argument("--max-batch", type=int, default=32,
                    help="--frontend micro-batch size trigger")
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="--frontend micro-batch deadline trigger")
    ap.add_argument("--replicas", type=int, default=1,
                    help="device-path replicas behind least-loaded dispatch "
                         "(build path only)")
    ap.add_argument("--shards", type=int, default=1,
                    help="document-partitioned shards per replica")
    ap.add_argument("--save-dir", type=str, default=None,
                    help="persist the build as a segmented writer directory "
                         "and serve from disk")
    ap.add_argument("--commits", type=int, default=1,
                    help="number of IndexWriter commits --save-dir splits "
                         "the collection into")
    ap.add_argument("--index-dir", type=str, default=None,
                    help="open a persisted artifact / writer directory "
                         "instead of rebuilding")
    ap.add_argument("--ingest", type=int, default=0, metavar="N",
                    help="after serving, commit N new version documents "
                         "against the live directory and re-serve")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.ingest and not (args.index_dir or args.save_dir):
        ap.error("--ingest needs a live directory (--index-dir or --save-dir)")

    spec = get_backend_spec(args.store)
    print(f"backend {spec.name}: family={spec.family} "
          f"caps=[{','.join(sorted(spec.capabilities)) or '-'}]")
    print(f"analyzer {args.analyzer}: {get_analyzer(args.analyzer).config()}")
    col = generate_collection(n_articles=args.articles, versions_per_article=args.versions,
                              words_per_doc=200, seed=args.seed)
    # non-phrase docs: serves from the non-positional index; only phrase
    # listing and tf ranking need the positional one
    need_positional = args.mode in ("phrase", "mixed", "docs-phrase", "docs-topk")

    if args.index_dir:
        t0 = time.perf_counter()
        session = Session.open(args.index_dir, device=args.device, probe=args.probe)
        m = session.metrics()
        print(f"opened {args.index_dir} ({m.get('segments', 1)} segment(s)) "
              f"in {time.perf_counter()-t0:.2f}s — no rebuild")
        live_dir = args.index_dir
    elif args.save_dir:
        from ..core.writer import is_writer_dir

        if is_writer_dir(args.save_dir):
            ap.error(f"--save-dir {args.save_dir} already holds a writer — "
                     f"serve it with --index-dir (and grow it with "
                     f"--ingest) or pick a fresh directory")
        writer = IndexWriter(args.save_dir, store=args.store, positional=True,
                             analyzer=args.analyzer, device=args.device)
        per = max(1, -(-col.n_docs // max(1, args.commits)))
        t0 = time.perf_counter()
        for c in range(0, col.n_docs, per):
            writer.add_documents(col.docs[c:c + per])
            seg = writer.commit()
            print(f"committed {seg.name}: {seg.n_docs} docs at base {seg.doc_base}")
        print(f"persisted {len(writer.segments)} segment(s) to {args.save_dir} "
              f"in {time.perf_counter()-t0:.2f}s")
        session = Session.open(args.save_dir, device=args.device, probe=args.probe)
        live_dir = args.save_dir
    else:
        t0 = time.perf_counter()
        idx = NonPositionalIndex.build(col.docs, store=args.store,
                                       analyzer=args.analyzer, device=args.device)
        print(f"built {args.store} non-positional index over {col.n_docs} docs "
              f"({100 * idx.space_fraction:.3f}% of collection) in {time.perf_counter()-t0:.2f}s")
        pidx = None
        if need_positional:
            t0 = time.perf_counter()
            pidx = PositionalIndex.build(col.docs, store=args.store, device=args.device)
            print(f"built {args.store} positional index ({100 * pidx.space_fraction:.3f}% "
                  f"of collection) in {time.perf_counter()-t0:.2f}s")
        # Session.build attaches device servers except for self-indexes (their
        # native locate serves whole patterns on the host)
        session = Session.build(idx, positional=pidx, device=args.device,
                                probe=args.probe)
        live_dir = None

    rng = np.random.default_rng(args.seed)
    words = [w for w in session.primary_index.vocab.id_to_token[:300]]
    queries = sample_traffic(args.mode, args.queries, col.docs, words, rng,
                             n_terms=args.terms)
    by_route: dict[str, int] = {}
    for q in queries:
        rt = session.plan(q)
        by_route[f"{rt.route}:{rt.strategy}"] = by_route.get(f"{rt.route}:{rt.strategy}", 0) + 1
    print(f"planner: {by_route}")
    if args.explain:
        seen = set()
        for q in queries:
            rt = session.plan(q)
            if rt.strategy not in seen:
                seen.add(rt.strategy)
                print("\n" + session.explain(q))
        print()

    # host-only baseline (no device servers, same plan compiler)
    host_session = (Session.open(live_dir, device=args.device, attach=False)
                    if live_dir else Session(idx, positional=pidx))
    t0 = time.perf_counter()
    host_results = host_session.execute(queries)
    dt = time.perf_counter() - t0
    n_hits = sum(len(r) for r in host_results)
    print(f"host session: {args.queries} queries, {n_hits} hits, "
          f"{1e3 * dt / args.queries:.2f} ms/query ({args.queries / dt:.0f} q/s)")

    # planned path (device batches, windowed exact) — warm up then time
    results = session.execute(queries)
    warm = session.metrics()
    t0 = time.perf_counter()
    results = session.execute(queries)
    dt = time.perf_counter() - t0
    print(f"planned batched path: {1e3 * dt / args.queries:.2f} ms/query "
          f"({args.queries / dt:.0f} q/s)")
    m = session.metrics()
    print(f"plan cache: {m['plan_cache_hits']} hits / {m['plans_compiled']} compiles "
          f"(hit rate {m['plan_cache_hit_rate']:.2f}); device steps {m['jit_traces']} "
          f"({m['jit_traces'] - warm['jit_traces']} new, "
          f"{m['plans_compiled'] - warm['plans_compiled']} re-plans "
          f"on the repeated batch)")
    if "ranked" in m:
        r = m["ranked"]
        print(f"ranked pruning: {r['postings_scored']} postings scored, "
              f"{r['postings_skipped']} skipped "
              f"(skip fraction {r['skip_fraction']:.2f}; "
              f"{r['lists_skipped']} list(s) skipped)")

    agree = sum(1 for h, d in zip(host_results, results)
                if np.array_equal(np.asarray(h), np.asarray(d)))
    print(f"host/planned agreement: {agree}/{args.queries} queries")

    if args.frontend:
        import asyncio

        from ..serving.frontend import (FrontendConfig, MicroBatchFrontend,
                                        replicated_session, run_open_loop)

        fe_session = session
        if args.replicas > 1 or args.shards > 1:
            if live_dir is not None:
                ap.error("--replicas/--shards replicate the in-memory build "
                         "path (drop --index-dir/--save-dir)")
            fe_session = replicated_session(idx, positional=pidx,
                                            n_replicas=args.replicas,
                                            n_shards=args.shards,
                                            probe=args.probe, device=args.device)
            print(f"replicated device path: {args.replicas} replica(s) "
                  f"x {args.shards} shard(s), least-loaded dispatch")
        cfg = FrontendConfig(max_batch=args.max_batch,
                             max_delay=args.max_delay_ms / 1e3)
        fe = MicroBatchFrontend(fe_session, cfg)
        # cold pass builds the device steps; the warm pass is the
        # measurement (and shows the result cache absorbing repeats)
        run_open_loop(fe_session, queries, rate_qps=args.rate,
                      frontend=fe, seed=args.seed)
        fe_results, rep = run_open_loop(fe_session, queries,
                                        rate_qps=args.rate, frontend=fe,
                                        seed=args.seed + 1)
        lat, m = rep["latency"], fe.metrics()
        arrivals = (f"{args.rate:.0f} q/s Poisson" if args.rate else "burst")
        print(f"frontend ({arrivals}, max_batch={args.max_batch}, "
              f"deadline={args.max_delay_ms}ms): "
              f"p50 {lat['p50_ms']}ms p95 {lat['p95_ms']}ms "
              f"p99 {lat['p99_ms']}ms; achieved {rep['achieved_qps']} q/s")
        print(f"frontend admission: {m['rejected']} rejected "
              f"(reject rate {m['reject_rate']:.2f}), max queue depth "
              f"{lat.get('queue_depth_max', 0)}; cache hit rate "
              f"{m['cache']['hit_rate']:.2f} ({m['coalesced']} coalesced); "
              f"mean batch {m['mean_batch']} over {m['batches']} flushes "
              f"{m['flushes']}")
        fe_agree = sum(
            1 for h, d in zip(host_results, fe_results)
            if d is not None and np.array_equal(np.asarray(h), np.asarray(d)))
        print(f"host/frontend agreement: {fe_agree}/{args.queries} queries")
        asyncio.run(fe.close())

    if args.ingest:
        # commit a new version batch against the live directory, then
        # refresh the running session in place — no rebuild, no restart
        new_docs = generate_collection(
            n_articles=1, versions_per_article=args.ingest,
            words_per_doc=200, seed=args.seed + 1).docs
        writer = IndexWriter.open(live_dir, device=args.device)
        t0 = time.perf_counter()
        writer.add_documents(new_docs)
        seg = writer.commit()
        commit_s = time.perf_counter() - t0
        opened = session.refresh()
        print(f"ingested {seg.name}: {seg.n_docs} docs at base {seg.doc_base} "
              f"(commit {commit_s:.2f}s, {opened} segment(s) opened live)")
        before = session.metrics()
        t0 = time.perf_counter()
        session.execute(queries)
        dt = time.perf_counter() - t0
        after = session.metrics()
        print(f"post-ingest batch: {1e3 * dt / args.queries:.2f} ms/query "
              f"({args.queries / dt:.0f} q/s); "
              f"{after['plans_compiled'] - before['plans_compiled']} re-plans "
              f"(segment shape changed), total segments "
              f"{after.get('segments', 1)}")


if __name__ == "__main__":
    main()
