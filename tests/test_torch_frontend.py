"""The serving frontier on the port, held against the reference.

The scenarios of the reference's ``tests/test_frontend.py`` on
``repro_torch`` with ``device="cpu"``: randomized concurrent arrival orders,
interleaved query kinds and burst traffic through
:class:`~repro_torch.serving.frontend.MicroBatchFrontend` must give answers
byte-identical to the port's host-only session, to the reference's host-only
session and to the reference frontend on the same queries; plus the fault
surface (typed queue-full rejection, deadline flush, whole-batch replica
failover), the replicated ``n_shards=2`` layout over the partitioned
server, ``rank<k>:`` through replicas (a reference fault, pinned), and the
serving driver ``repro_torch.launch.serve.main`` at a small size.
"""

import asyncio
import os
import threading

import numpy as np
import pytest
import torch

from repro.core.index import NonPositionalIndex as RefNonPositional
from repro.core.index import PositionalIndex as RefPositional
from repro.serving import frontend as ref_frontend
from repro.serving.session import Session as RefSession
from repro_torch.core.index import NonPositionalIndex, PositionalIndex
from repro_torch.data import generate_collection
from repro_torch.data.queries import sample_traffic
from repro_torch.serving.engine import BatchedServer
from repro_torch.serving.frontend import (
    AllReplicasFailed,
    FrontendClosed,
    FrontendConfig,
    FrontendError,
    FrontendOverloaded,
    MicroBatchFrontend,
    ReplicatedServer,
    replicated_session,
    run_open_loop,
)
from repro_torch.serving.partitioned import PartitionedServer
from repro_torch.serving.session import Session

BASE_SEED = int(os.environ.get("REPRO_DIFF_SEED", "20260727"))

# one backend per family (run-length / LZ / grammar / self-index), as in the
# reference's frontier tests
FAMILY_REPS = ("rice_runs", "vbyte_lzend", "repair_skip", "rlcsa")


@pytest.fixture(scope="module")
def collection():
    return generate_collection(n_articles=2, versions_per_article=4,
                               words_per_doc=45, seed=BASE_SEED % 10_000)


@pytest.fixture(scope="module", params=FAMILY_REPS)
def family_case(request, collection):
    """(store, card-style session on the CPU, host session, reference host
    session) per backend family."""
    store = request.param
    docs = collection.docs
    idx = NonPositionalIndex.build(docs, store=store)
    pidx = PositionalIndex.build(docs, store=store)
    ref = RefSession(RefNonPositional.build(docs, store=store),
                     positional=RefPositional.build(docs, store=store))
    return (store, Session.build(idx, positional=pidx, device="cpu"),
            Session(idx, positional=pidx), ref)


@pytest.fixture(scope="module")
def vbyte_case(collection):
    """A cheap inverted backend for the scheduler / fault tests, with the
    reference's indexes over the same documents."""
    docs = collection.docs
    return (NonPositionalIndex.build(docs, store="vbyte"),
            PositionalIndex.build(docs, store="vbyte"),
            RefNonPositional.build(docs, store="vbyte"),
            RefPositional.build(docs, store="vbyte"))


def mixed_queries(collection, session, rng, n=24):
    """All query kinds, sampled from the collection (duplicates likely)."""
    words = [w for w in session.primary_index.vocab.id_to_token[:60]]
    out = sample_traffic("mixed", n - 4, collection.docs, words, rng)
    out += [f"docs-top3: {words[0]} {words[1]}", f"top3: {words[0]} {words[1]}",
            f"top5: {words[0]} {words[1]}", "docs: qqqzz unknownzz"]
    return out


def drive_concurrent(session, queries, seed, config=None, frontend_cls=MicroBatchFrontend,
                     config_cls=FrontendConfig):
    """Submit ``queries`` in a random arrival order with random delays;
    results come back indexed by original position."""
    rng = np.random.default_rng(seed)
    config = config or config_cls(max_batch=8, max_delay=0.002)

    async def main():
        async with frontend_cls(session, config) as fe:
            results = [None] * len(queries)

            async def one(i: int) -> None:
                await asyncio.sleep(float(rng.random()) * 0.004)
                results[i] = await fe.submit(queries[i])

            order = [int(i) for i in rng.permutation(len(queries))]
            await asyncio.gather(*(one(i) for i in order))
            return results, fe.metrics()

    return asyncio.run(main())


def assert_same(queries, got, *wants, what=""):
    for i, q in enumerate(queries):
        assert got[i] is not None, f"{what} query={q!r}: no result"
        for want in wants:
            assert np.array_equal(np.asarray(got[i]), np.asarray(want[i])), \
                f"{what} query={q!r}: {np.asarray(got[i])} != {np.asarray(want[i])}"


# ----------------------------------------------------------------------
# differential correctness under concurrency (>= 4 backend families)
# ----------------------------------------------------------------------
def test_frontend_differential_concurrent(family_case, collection):
    store, session, host, ref = family_case
    for round_ in range(3):
        seed = BASE_SEED + 31 * round_
        rng = np.random.default_rng(seed)
        queries = mixed_queries(collection, session, rng)
        got, metrics = drive_concurrent(session, queries, seed)
        assert_same(queries, got, host.execute(queries), ref.execute(queries),
                    what=f"(seed={seed}, store={store})")
        if round_ == 0:  # the reference frontend, same arrivals
            ref_got, _ = drive_concurrent(ref, queries, seed,
                                          frontend_cls=ref_frontend.MicroBatchFrontend,
                                          config_cls=ref_frontend.FrontendConfig)
            assert_same(queries, got, ref_got, what=f"(seed={seed}, store={store}) ref frontend")
        assert metrics["rejected"] == 0
        assert metrics["batches"] >= 1


def test_frontend_burst_traffic(family_case, collection):
    """Everything submitted at once: size-triggered flushes, same answers."""
    store, session, host, ref = family_case
    seed = BASE_SEED + 7
    rng = np.random.default_rng(seed)
    queries = mixed_queries(collection, session, rng, n=32)

    async def main():
        async with MicroBatchFrontend(
                session, FrontendConfig(max_batch=4, max_delay=0.05)) as fe:
            results = await asyncio.gather(*(fe.submit(q) for q in queries))
            return results, fe.metrics()

    got, metrics = asyncio.run(main())
    assert_same(queries, got, host.execute(queries), ref.execute(queries),
                what=f"(seed={seed}, store={store}) burst")
    assert metrics["flushes"]["size"] >= 1, metrics


# ----------------------------------------------------------------------
# scheduler behavior: deadline straggler, size trigger, queue bound
# ----------------------------------------------------------------------
def test_deadline_flush_single_straggler(vbyte_case):
    idx, pidx, _, _ = vbyte_case
    session = Session.build(idx, positional=pidx, device="cpu")
    host = Session(idx, positional=pidx)
    q = f"{idx.vocab.id_to_token[1]} {idx.vocab.id_to_token[2]}"

    async def main():
        async with MicroBatchFrontend(
                session, FrontendConfig(max_batch=64, max_delay=0.01)) as fe:
            res = await fe.submit(q)  # nothing else arrives: deadline fires
            return res, fe.metrics()

    res, metrics = asyncio.run(main())
    assert np.array_equal(np.asarray(res), host.execute(q))
    assert metrics["flushes"]["deadline"] == 1, metrics
    assert metrics["flushes"]["size"] == 0, metrics


def test_size_trigger_fills_bucket(vbyte_case):
    idx, pidx, _, _ = vbyte_case
    session = Session.build(idx, positional=pidx, device="cpu")
    words = idx.vocab.id_to_token
    queries = [f"{words[i]} {words[i + 1]}" for i in range(1, 9)]

    async def main():
        async with MicroBatchFrontend(
                session, FrontendConfig(max_batch=8, max_delay=5.0)) as fe:
            results = await asyncio.gather(*(fe.submit(q) for q in queries))
            return results, fe.metrics()

    results, metrics = asyncio.run(main())
    assert_same(queries, results, Session(idx, positional=pidx).execute(queries))
    # the deadline was 5s: only the size trigger can have flushed
    assert metrics["flushes"]["size"] == 1, metrics
    assert metrics["flushes"]["deadline"] == 0, metrics
    assert metrics["max_batch"] == 8, metrics


def test_queue_full_typed_rejection(vbyte_case):
    """Admission control rejects immediately with a typed error — no hang."""
    idx, pidx, _, _ = vbyte_case
    session = Session.build(idx, positional=pidx, device="cpu")
    words = idx.vocab.id_to_token
    config = FrontendConfig(max_batch=100, max_delay=5.0, max_pending=4)

    async def main():
        async with MicroBatchFrontend(session, config) as fe:
            tasks = [asyncio.ensure_future(
                fe.submit(f"{words[i]} {words[i + 1]}")) for i in range(1, 5)]
            await asyncio.sleep(0)  # let the four submissions enqueue
            assert fe.depth == 4
            with pytest.raises(FrontendOverloaded) as err:
                await fe.submit(f"{words[9]} {words[10]}")
            assert err.value.pending == 4
            assert err.value.limit == 4
            assert isinstance(err.value, FrontendError)
            assert fe.metrics()["rejected"] == 1
            # draining completes the queued four without waiting out the
            # 5s deadline — rejection sheds load, it never cancels work
            await fe.drain()
            results = await asyncio.gather(*tasks)
            assert all(len(np.asarray(r).shape) == 1 for r in results)

    asyncio.run(main())


def test_closed_frontend_rejects(vbyte_case):
    idx, pidx, _, _ = vbyte_case
    session = Session.build(idx, positional=pidx, device="cpu")

    async def main():
        fe = MicroBatchFrontend(session, FrontendConfig())
        await fe.close()
        with pytest.raises(FrontendClosed):
            await fe.submit(idx.vocab.id_to_token[1])

    asyncio.run(main())


# ----------------------------------------------------------------------
# replica fan-out: least-loaded dispatch, mid-batch failover
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 2])
def test_replicated_differential(vbyte_case, collection, n_shards):
    """N replicas x M shards answers == the host session's == the
    reference's replicated session's (M = 2: partitioned shard sets)."""
    idx, pidx, ref_idx, ref_pidx = vbyte_case
    host = Session(idx, positional=pidx)
    rng = np.random.default_rng(BASE_SEED + 5)
    words = idx.vocab.id_to_token[:40]
    queries = (sample_traffic("and", 8, collection.docs, words, rng)
               + sample_traffic("phrase", 8, collection.docs, words, rng))
    session = replicated_session(idx, positional=pidx, n_replicas=2, n_shards=n_shards,
                                 device="cpu")
    ref = ref_frontend.replicated_session(ref_idx, positional=ref_pidx, n_replicas=2,
                                          n_shards=n_shards)
    got = session.execute(queries)
    assert_same(queries, got, host.execute(queries), ref.execute(queries),
                what=f"(store=vbyte, shards={n_shards})")
    want_type = PartitionedServer if n_shards > 1 else BatchedServer
    for rs, ref_rs in ((session.server, ref.server),
                       (session.positional_server, ref.positional_server)):
        assert all(type(r.server) is want_type for r in rs._replicas)
        assert rs.kinds == ref_rs.kinds
    assert session.server.batches_dispatched >= 1
    assert session.positional_server.batches_dispatched >= 1
    assert all(r["healthy"] for r in session.server.replica_status())


def test_replicated_build_arguments(vbyte_case):
    """``device`` / ``probe`` / ``layout`` reach every replica; ``probe``
    defaults by device and ``probe="kernel"`` is refused on the CPU."""
    idx, _, _, _ = vbyte_case
    rs = ReplicatedServer.build(idx, n_replicas=3, device="cpu", layout="fused")
    assert [(r.server.probe, r.server.layout, r.server.device.type)
            for r in rs._replicas] == [("torch", "fused", "cpu")] * 3
    assert rs.layout == "fused"
    rs = ReplicatedServer.build(idx, n_replicas=2, n_shards=3, device="cpu")
    assert all(r.server.pidx.n_shards == 3 and r.server.probe == "torch"
               for r in rs._replicas)
    assert rs.kinds == frozenset({"and", "phrase"})
    for n_shards in (1, 2):
        with pytest.raises(ValueError, match="probe='kernel'"):
            ReplicatedServer.build(idx, n_shards=n_shards, device="cpu", probe="kernel")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            ReplicatedServer.build(idx)  # device defaults to "cuda"


def test_rank_through_replicas_mends_the_reference_fault(vbyte_case, collection):
    """``rank<k>:`` through ``replicated_session``: the replicas list
    ``"rank"`` in their kinds, so the plan routes it to the device.  The
    reference's ``ReplicatedServer`` has no ``ranked`` and raises
    ``AttributeError`` (Queue C of ``ROADMAP.md``); the port dispatches it
    to a replica and answers as the host session does."""
    idx, pidx, ref_idx, ref_pidx = vbyte_case
    words = idx.vocab.id_to_token
    queries = [f"rank5: {words[1]} {words[2]}", f"rank3: {words[3]} {words[4]} {words[5]}",
               f"{words[1]} {words[2]}", f"rank2: {words[6]} qqqzz"]
    ref = ref_frontend.replicated_session(ref_idx, positional=ref_pidx, n_replicas=2)
    assert "rank" in ref.server.kinds
    with pytest.raises(AttributeError, match="ranked"):
        ref.execute(queries)
    session = replicated_session(idx, positional=pidx, n_replicas=2, device="cpu")
    assert "rank" in session.server.kinds
    assert session.plan(queries[0]).route == "device"
    host = Session(idx, positional=pidx)
    got = session.execute(queries)
    assert_same(queries, got, host.execute(queries), RefSession(ref_idx).execute(queries))
    # one ranked step a (k, width) group, each on a replica
    groups = {(session.plan(q).width, q.split(":")[0]) for q in queries
              if q.startswith("rank") and session.plan(q).route == "device"}
    assert sum(r.server.ranked_steps for r in session.server._replicas) == len(groups) >= 2
    # and through the frontend
    results, report = run_open_loop(session, queries, rate_qps=0.0,
                                    config=FrontendConfig(max_batch=4))
    assert_same(queries, results, got)
    assert report["rejected"] == 0


def test_replica_failover_mid_batch(vbyte_case):
    """A replica raising mid-batch fails over: the whole bucket is
    re-dispatched, no query dropped, the bad replica marked unhealthy."""
    idx, pidx, _, _ = vbyte_case
    host = Session(idx, positional=pidx)
    words = idx.vocab.id_to_token
    queries = [f"{words[i]} {words[i + 1]}" for i in range(1, 7)]
    rs = ReplicatedServer.build(idx, n_replicas=2, device="cpu")

    victim = rs._replicas[0].server
    original = victim.conjunctive
    calls = {"n": 0}

    def exploding(queries, width=None):
        calls["n"] += 1
        raise RuntimeError("replica wedged mid-batch")

    victim.conjunctive = exploding
    session = Session(idx, server=rs)
    got = session.execute(queries)
    assert_same(queries, got, host.execute(queries), what="failover")
    assert calls["n"] == 1
    assert rs.failovers == 1
    status = rs.replica_status()
    assert [r["healthy"] for r in status] == [False, True], status
    assert status[1]["served"] == len(queries)
    victim.conjunctive = original


def test_all_replicas_failed_is_typed(vbyte_case):
    idx, _, _, _ = vbyte_case
    rs = ReplicatedServer.build(idx, n_replicas=2, device="cpu")
    for rep in rs._replicas:
        rep.server.conjunctive = lambda queries, width=None: (_ for _ in ()).throw(
            RuntimeError("down"))
    session = Session(idx, server=rs)
    words = idx.vocab.id_to_token
    with pytest.raises(AllReplicasFailed):
        session.execute(f"{words[1]} {words[2]}")

    # ... and through the frontend the typed error reaches the submitter
    async def main():
        async with MicroBatchFrontend(session, FrontendConfig(
                max_delay=0.001)) as fe:
            with pytest.raises(AllReplicasFailed):
                await fe.submit(f"{words[3]} {words[4]}")

    asyncio.run(main())


# ----------------------------------------------------------------------
# metrics surface, threads, open-loop driver
# ----------------------------------------------------------------------
def test_latency_metrics_through_session(vbyte_case, collection):
    idx, pidx, _, _ = vbyte_case
    session = Session.build(idx, positional=pidx, device="cpu")
    rng = np.random.default_rng(BASE_SEED + 11)
    queries = mixed_queries(collection, session, rng, n=12)
    results, report = run_open_loop(session, queries, rate_qps=0.0,
                                    config=FrontendConfig(max_batch=4))
    assert_same(queries, results, Session(idx, positional=pidx).execute(queries))
    assert report["rejected"] == 0
    for key in ("p50_ms", "p95_ms", "p99_ms", "queue_depth_max"):
        assert key in report["latency"], report
    assert session.frontend is not None  # run_open_loop's frontend attached itself

    # an attached frontend surfaces through Session.metrics()
    async def main():
        async with MicroBatchFrontend(session, FrontendConfig()) as fe:
            await fe.submit(queries[0])
            return session.metrics()

    m = asyncio.run(main())
    assert m["frontend"]["submitted"] == 1
    assert m["frontend"]["latency"]["count"] == 1
    assert "queue_depth_max" in m["frontend"]["latency"]
    assert "frontend" not in Session(idx, positional=pidx).metrics()


def test_batches_run_on_the_executor_thread_without_grad(vbyte_case):
    """The frontend runs ``Session.execute`` on its own executor thread,
    whose grad mode is its own: every device step runs under ``no_grad``
    entered by the server, and nothing it returns requires grad."""
    idx, pidx, _, _ = vbyte_case
    session = Session.build(idx, positional=pidx, device="cpu")
    seen = []
    for srv in (session.server, session.positional_server):
        real = srv._step

        def step(*a, _real=real, **kw):
            inner = _real(*a, **kw)

            def run(*sa, **skw):
                out = inner(*sa, **skw)
                seen.append((threading.current_thread().name, torch.is_grad_enabled(),
                             any(o.requires_grad for o in out)))
                return out
            return run

        srv._step = step
    words = idx.vocab.id_to_token
    queries = [f"{words[1]} {words[2]}", f'"{words[3]} {words[4]}"', f"top3: {words[1]}"]

    async def main():
        torch.set_grad_enabled(True)
        async with MicroBatchFrontend(session, FrontendConfig(max_delay=0.001)) as fe:
            return await asyncio.gather(*(fe.submit(q) for q in queries))

    got = asyncio.run(main())
    assert_same(queries, got, Session(idx, positional=pidx).execute(queries))
    assert seen and all(name.startswith("frontend-exec") and not grad and not req
                        for name, grad, req in seen), seen


def test_refresh_threadsafe_without_loop_falls_back_inline(tmp_path):
    """Before any traffic has touched the event loop, the compaction
    on_swap hook must still work: refresh_threadsafe degrades to an
    inline Session.refresh."""
    from repro_torch.core.writer import IndexWriter

    w = IndexWriter(tmp_path / "col", store="vbyte", positional=True, device="cpu")
    w.add_documents(["alpha beta gamma", "beta delta alpha"])
    w.commit()
    session = Session.open(w.path, device="cpu", attach=False)
    fe = MicroBatchFrontend(session, FrontendConfig())
    handle = w.compact_async(on_swap=fe.refresh_threadsafe)
    handle.wait(60)
    assert len(session._segments) == 1
    assert np.array_equal(np.asarray(session.execute("docs: alpha")),
                          np.asarray([0, 1]))


def test_mid_flight_refresh_never_caches_across_shapes(tmp_path):
    """A batch whose execution straddles a refresh must not deposit its
    answers under the new segment shape (the p.key guard): afterwards the
    cache serves only answers computed against the live shape."""
    from repro_torch.core.writer import IndexWriter

    w = IndexWriter(tmp_path / "col", store="vbyte", positional=True, device="cpu")
    w.add_documents(["alpha beta gamma", "beta delta alpha"])
    w.commit()
    session = Session.open(w.path, device="cpu")
    orig_execute = session.execute
    w.add_documents(["alpha zebra quartz"])
    w.commit()

    def refresh_mid_batch(queries):
        out = orig_execute(queries)
        session.refresh()  # the shape moves while the batch is in flight
        return out

    session.execute = refresh_mid_batch

    async def main():
        fe = MicroBatchFrontend(session,
                                FrontendConfig(max_batch=4, max_delay=0.001))
        stale = np.asarray(await fe.submit("docs: alpha"))
        session.execute = orig_execute
        fresh = np.asarray(await fe.submit("docs: alpha"))
        metrics = fe.cache.metrics()
        await fe.close()
        return stale, fresh, metrics

    stale, fresh, metrics = asyncio.run(main())
    assert np.array_equal(stale, np.asarray([0, 1]))  # pre-refresh snapshot
    assert np.array_equal(fresh, np.asarray([0, 1, 2]))  # live shape
    # the straddling answer was served but never cached: the second submit
    # was a miss, not a stale hit
    assert metrics["hits"] == 0, metrics


def test_open_loop_overload_rejects_not_hangs(vbyte_case, collection):
    """At an absurd offered load over a tiny queue the open-loop driver must come
    back with rejections recorded, not deadlock."""
    idx, pidx, ref_idx, ref_pidx = vbyte_case
    session = Session.build(idx, positional=pidx, device="cpu")
    rng = np.random.default_rng(BASE_SEED + 13)
    queries = mixed_queries(collection, session, rng, n=40)
    config = FrontendConfig(max_batch=4, max_delay=0.5, max_pending=2)
    results, report = run_open_loop(session, queries, rate_qps=0.0,
                                    config=config)
    assert report["rejected"] > 0
    assert report["rejected"] == sum(1 for r in results if r is None)
    served = [i for i, r in enumerate(results) if r is not None]
    sub = [queries[i] for i in served]
    assert_same(sub, [results[i] for i in served], Session(idx, positional=pidx).execute(sub),
                RefSession(ref_idx, positional=ref_pidx).execute(sub))
    # the reference's open-loop driver rejects the same queries
    ref_results, ref_report = ref_frontend.run_open_loop(
        RefSession(ref_idx, positional=ref_pidx), queries, rate_qps=0.0,
        config=ref_frontend.FrontendConfig(max_batch=4, max_delay=0.5, max_pending=2))
    assert [r is None for r in ref_results] == [r is None for r in results]
    assert ref_report["rejected"] == report["rejected"]


# ----------------------------------------------------------------------
# the serving driver
# ----------------------------------------------------------------------
def _agreement(out: str, label: str) -> tuple[int, int]:
    line, = [ln for ln in out.splitlines() if ln.startswith(f"{label} agreement")]
    got, total = line.split(": ")[1].split()[0].split("/")
    return int(got), int(total)


def test_serve_driver_frontend_replicas_shards(capsys):
    from repro_torch.launch.serve import main

    main(["--device", "cpu", "--articles", "3", "--versions", "5", "--queries", "24",
          "--mode", "mixed", "--frontend", "--replicas", "2", "--shards", "2"])
    out = capsys.readouterr().out
    assert _agreement(out, "host/planned") == (24, 24), out
    assert _agreement(out, "host/frontend") == (24, 24), out
    assert "replicated device path: 2 replica(s) x 2 shard(s)" in out
    assert "p99" in out and "cache hit rate" in out


def test_serve_driver_save_dir_ingest(tmp_path, capsys):
    from repro_torch.launch.serve import main

    main(["--device", "cpu", "--articles", "2", "--versions", "4", "--queries", "16",
          "--mode", "and", "--probe", "torch", "--save-dir", str(tmp_path / "ix"),
          "--commits", "2", "--ingest", "3"])
    out = capsys.readouterr().out
    assert _agreement(out, "host/planned") == (16, 16), out
    assert "persisted 2 segment(s)" in out
    assert "1 segment(s) opened live" in out
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--probe", "vmap"])  # the reference's choice is not one here
