"""The online serving frontier: async micro-batching, result caching,
admission control, and replica fan-out in front of a :class:`Session`.

The paper's bargain is space savings "at the price of moderate slowdowns";
a serving system pays that price back in front of the index — by batching
(amortize the device step over many queries), caching (repeated
traffic never touches the index), and replication (throughput past one
shard set).  This module is that front:

* :class:`MicroBatchFrontend` — accepts a **continuous query stream**
  (``await frontend.submit(q)``), coalesces pending queries into the same
  power-of-two **width buckets** the Session's plan cache and device steps
  are keyed on, and flushes a bucket on whichever fires first: the **size
  trigger** (``max_batch`` queries pending) or the **deadline**
  (``max_delay`` seconds after the bucket's first query arrived — a single
  straggler is never stranded).  Flushed batches run through
  ``Session.execute`` on a dedicated executor thread, so index access is
  serialized while the event loop keeps admitting traffic.

* **Admission control** — at most ``max_pending`` queries may be queued or
  in flight; past that, :meth:`~MicroBatchFrontend.submit` raises the
  typed :class:`FrontendOverloaded` *immediately* (explicit backpressure,
  never a hang).  Rejections are counted and reported.

* :class:`ResultCache` — answers memoized under ``Session.result_key``:
  (physical-plan structure, concrete terms, segment shape).  ``top3:`` and
  ``top5:`` over the same terms are distinct entries; an answer computed
  against one committed segment set is never served against another.
  :meth:`MicroBatchFrontend.refresh` (or any ``Session.refresh``) drives
  **precise invalidation** through the session's refresh hook: an
  append-only commit invalidates exactly the entries whose terms can
  occur in the new segments — everything else is migrated to the new
  segment shape and keeps serving from cache; a compaction drops all.

* :class:`ReplicatedServer` — N replicas × M shards behind the
  batched-server protocol: each replica is a
  :class:`~repro_torch.serving.engine.BatchedServer` (M=1) or
  :class:`~repro_torch.serving.partitioned.PartitionedServer` (M>1); every
  batch is dispatched to the **least-loaded healthy** replica, and a
  replica raising mid-batch is marked unhealthy and the *whole batch*
  fails over to the next replica — no query in the bucket is dropped.
  :class:`AllReplicasFailed` is the typed terminal error.  Failover covers
  a Python exception in a replica; a CUDA fault is sticky for the whole
  process's context, so replicas on one device do not survive it.

* :class:`LatencyRecorder` — per-query submit→answer latency (p50 / p95 /
  p99 / mean) and queue-depth samples, surfaced as
  ``Session.metrics()["frontend"]`` and by ``launch/serve.py --frontend``.

:func:`run_open_loop` drives a frontend with open-loop (Poisson) arrivals
— the open-loop latency measurement harness.

Everything here is host code: ``asyncio``, one executor thread and NumPy.
The device work happens inside the servers, which name their device on
every tensor they make and enter ``torch.no_grad()`` themselves, so the
executor thread's own grad mode and current device never matter.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from .plan import RANK, SERVER_KINDS, ParsedQuery, parse_query, width_bucket
from .session import Session


# ----------------------------------------------------------------------
# typed serving errors (backpressure / fault surface)
# ----------------------------------------------------------------------
class FrontendError(RuntimeError):
    """Base of the frontend's typed error surface."""


class FrontendOverloaded(FrontendError):
    """Admission control rejected a query: the bounded queue is full.

    Raised *immediately* at submit — the caller sheds load or retries;
    nothing ever blocks on a full queue."""

    def __init__(self, pending: int, limit: int):
        self.pending = pending
        self.limit = limit
        super().__init__(
            f"frontend overloaded: {pending} queries queued/in-flight "
            f">= max_pending={limit}; shed load or raise the bound")


class FrontendClosed(FrontendError):
    """The frontend was closed; no further queries are admitted."""


class AllReplicasFailed(FrontendError):
    """Every replica of a :class:`ReplicatedServer` is unhealthy."""


# ----------------------------------------------------------------------
# latency recorder: tail percentiles + queue depth
# ----------------------------------------------------------------------
class LatencyRecorder:
    """Submit→answer latency samples and queue-depth observations.

    ``snapshot`` reports p50/p95/p99/mean/max latency in milliseconds plus
    queue-depth mean/max — the tail-latency surface a production front is
    judged on (q/s alone hides the queueing)."""

    def __init__(self, capacity: int = 200_000):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._latencies: list[float] = []
        self._depths: list[int] = []

    def record(self, seconds: float, depth: int = 0) -> None:
        with self._lock:
            if len(self._latencies) < self._capacity:
                self._latencies.append(seconds)
                self._depths.append(depth)

    def snapshot(self) -> dict:
        with self._lock:
            lat = np.asarray(self._latencies, dtype=np.float64)
            dep = np.asarray(self._depths, dtype=np.int64)
        if len(lat) == 0:
            return {"count": 0}
        p50, p95, p99 = np.percentile(lat, (50, 95, 99))
        return {
            "count": int(len(lat)),
            "p50_ms": round(1e3 * float(p50), 3),
            "p95_ms": round(1e3 * float(p95), 3),
            "p99_ms": round(1e3 * float(p99), 3),
            "mean_ms": round(1e3 * float(lat.mean()), 3),
            "max_ms": round(1e3 * float(lat.max()), 3),
            "queue_depth_mean": round(float(dep.mean()), 2),
            "queue_depth_max": int(dep.max()),
        }


# ----------------------------------------------------------------------
# result cache: (plan structure, terms, segment shape) -> frozen answer
# ----------------------------------------------------------------------
@dataclass
class _CacheEntry:
    terms: tuple[str, ...]
    value: np.ndarray


class ResultCache:
    """Bounded LRU of query answers keyed by ``Session.result_key``.

    Stored arrays are frozen (``writeable=False``) so a cached answer can
    be handed to many callers byte-identically.  ``on_refresh`` implements
    the precise invalidation contract: given the appended segments'
    sessions, an entry is stale iff some new segment knows **all** of its
    terms (only then can that segment contribute matches — answers merge
    per segment, and existing doc/token bases never move on append); every
    other entry is *migrated* to the new segment shape.  Ranked
    (``rank<k>:``) entries are disjunctive, so a new segment knowing
    **any** of their terms invalidates them; an entry none of whose terms
    occur in the new segments keeps its candidate set and is migrated
    (global-statistics drift alone does not evict it — the cached
    ranking ages out when its terms' postings next change).  A rewrite
    (compaction: ``added is None``) invalidates everything."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, _CacheEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidated = 0
        self.migrated = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: tuple) -> np.ndarray | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry.value

    def put(self, key: tuple, terms: tuple[str, ...], value: np.ndarray) -> None:
        if self.capacity <= 0:
            return
        value = np.asarray(value)
        value.setflags(write=False)
        with self._lock:
            self._entries[key] = _CacheEntry(terms=terms, value=value)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self.invalidated += len(self._entries)
            self._entries.clear()

    def on_refresh(self, old_shape: tuple, new_shape: tuple, added) -> None:
        """See the class docstring.  ``added`` is the appended segments'
        child sessions, or ``None`` for a rewrite."""
        if added is None:
            self.clear()
            return

        def term_known(child: Session, t: str) -> bool:
            for ix in (child.index, child.positional):
                if ix is not None and ix.lookup(t) is not None:
                    return True
            return False

        with self._lock:
            fresh: OrderedDict[tuple, _CacheEntry] = OrderedDict()
            for key, entry in self._entries.items():
                structure, terms, shape = key
                # structure[0] is the query kind (see plan_key): ranked
                # disjunctions are stale as soon as ANY term occurs
                need = any if structure[0] == RANK else all
                affected = shape != old_shape or any(
                    need(term_known(child, t) for t in entry.terms)
                    for child in added)
                if affected:
                    self.invalidated += 1
                else:
                    fresh[(structure, terms, new_shape)] = entry
                    self.migrated += 1
            self._entries = fresh

    def metrics(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
                "invalidated": self.invalidated,
                "migrated": self.migrated,
            }


# ----------------------------------------------------------------------
# replica fan-out: least-loaded dispatch + whole-batch failover
# ----------------------------------------------------------------------
@dataclass
class _Replica:
    server: object
    name: str
    healthy: bool = True
    inflight: int = 0
    served_queries: int = 0
    failures: int = 0


class ReplicatedServer:
    """N replicas of one index's batched server behind least-loaded
    dispatch — implements the batched-server protocol (``conjunctive`` /
    ``phrase`` / ``topk`` / ``doclist`` / ``ranked`` / ``encode`` /
    ``kinds`` / ``trace_count``) so a :class:`Session` routes device
    traffic onto it exactly like onto a single server.  ``kinds`` is the
    intersection of the replicas' kinds, and every kind in it dispatches:
    ``rank`` included, which the fused and dense servers list.

    Dispatch picks the healthy replica with the fewest in-flight batches
    (ties: fewest queries served).  A replica raising mid-batch is marked
    unhealthy and the whole batch retries on the next replica, so no query
    in the bucket is lost; when every replica has failed the typed
    :class:`AllReplicasFailed` surfaces to the caller."""

    def __init__(self, replicas: list[object], names: list[str] | None = None):
        if not replicas:
            raise ValueError("ReplicatedServer needs at least one replica")
        names = names or [f"replica{r}" for r in range(len(replicas))]
        self._replicas = [_Replica(server=s, name=n)
                          for s, n in zip(replicas, names)]
        self.kinds = frozenset.intersection(
            *[frozenset(getattr(r, "kinds", SERVER_KINDS)) for r in replicas])
        # the replicas share one posting layout (plan keys / EXPLAIN read it)
        self.layout = getattr(replicas[0], "layout", "")
        self._lock = threading.Lock()
        self.failovers = 0
        self.batches_dispatched = 0

    @classmethod
    def build(cls, index, n_replicas: int = 2, n_shards: int = 1,
              expand_len: int = 32, probe: str | None = None,
              layout: str = "auto", device="cuda") -> "ReplicatedServer":
        """Stamp out ``n_replicas`` servers over one built index on
        ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``): plain
        :class:`~repro_torch.serving.engine.BatchedServer` replicas for
        ``n_shards == 1``, document-partitioned
        :class:`~repro_torch.serving.partitioned.PartitionedServer` shard
        sets otherwise (their ``kinds`` subset routes top-k / doc listing to
        the host, like a single partitioned deployment).  ``probe`` is
        ``"kernel"`` (the CUDA kernels; default on a GPU) or ``"torch"``
        (plain tensor code; default on the CPU); ``layout`` is the
        ``BatchedServer``'s (a shard set is always dense)."""
        from .engine import BatchedServer
        from .partitioned import PartitionedServer

        replicas: list[object] = []
        for _ in range(max(1, n_replicas)):
            if n_shards > 1:
                replicas.append(PartitionedServer.from_index(
                    index, n_shards=n_shards, expand_len=expand_len,
                    probe=probe, device=device))
            else:
                replicas.append(BatchedServer.from_index(
                    index, expand_len=expand_len, probe=probe, layout=layout,
                    device=device))
        return cls(replicas)

    # -- dispatch -------------------------------------------------------
    def _pick(self) -> _Replica:
        with self._lock:
            live = [r for r in self._replicas if r.healthy]
            if not live:
                raise AllReplicasFailed(
                    f"all {len(self._replicas)} replicas failed: "
                    + "; ".join(f"{r.name}: {r.failures} failure(s)"
                                for r in self._replicas))
            return min(live, key=lambda r: (r.inflight, r.served_queries))

    def _dispatch(self, method: str, queries: list, **kw):
        last_err: Exception | None = None
        while True:
            rep = self._pick()  # AllReplicasFailed when exhausted
            with self._lock:
                rep.inflight += 1
                self.batches_dispatched += 1
            try:
                out = getattr(rep.server, method)(queries, **kw)
            except AllReplicasFailed:
                raise
            except Exception as e:  # fail over: retry the whole batch
                last_err = e
                with self._lock:
                    rep.healthy = False
                    rep.failures += 1
                    self.failovers += 1
                continue
            finally:
                with self._lock:
                    rep.inflight -= 1
            with self._lock:
                rep.served_queries += len(queries)
            return out

    # -- batched-server protocol ----------------------------------------
    def conjunctive(self, queries, width=None):
        return self._dispatch("conjunctive", queries, width=width)

    def phrase(self, queries, width=None):
        return self._dispatch("phrase", queries, width=width)

    def topk(self, queries, k: int = 10, width=None):
        return self._dispatch("topk", queries, k=k, width=width)

    def doclist(self, queries, phrase: bool = False, width=None):
        return self._dispatch("doclist", queries, phrase=phrase, width=width)

    def ranked(self, queries, k: int = 10, width=None):
        return self._dispatch("ranked", queries, k=k, width=width)

    def encode(self, queries, sort_by_length: bool = False, width=None):
        return self._pick().server.encode(queries, sort_by_length=sort_by_length,
                                          width=width)

    def c_entries(self, list_id: int) -> int:
        return self._pick().server.c_entries(list_id)

    @property
    def trace_count(self) -> int:
        return sum(int(getattr(r.server, "trace_count", 0))
                   for r in self._replicas)

    def replica_status(self) -> list[dict]:
        with self._lock:
            return [{"name": r.name, "healthy": r.healthy,
                     "inflight": r.inflight, "served": r.served_queries,
                     "failures": r.failures} for r in self._replicas]


def replicated_session(index, positional=None, n_replicas: int = 2,
                       n_shards: int = 1, expand_len: int = 32,
                       probe: str | None = None, layout: str = "auto",
                       device="cuda") -> Session:
    """A :class:`Session` whose device path is a :class:`ReplicatedServer`
    per index — the N-replicas × M-shards serving layout behind one
    ``execute`` entry point, every replica on ``device`` (see
    :meth:`ReplicatedServer.build`)."""
    def rep(ix):
        if ix is None:
            return None
        return ReplicatedServer.build(ix, n_replicas=n_replicas,
                                      n_shards=n_shards,
                                      expand_len=expand_len, probe=probe,
                                      layout=layout, device=device)

    return Session(index=index, positional=positional, server=rep(index),
                   positional_server=rep(positional))


# ----------------------------------------------------------------------
# the async micro-batch frontend
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class FrontendConfig:
    """Scheduler knobs.  ``max_batch`` is the size trigger, ``max_delay``
    (seconds) the deadline trigger — a bucket flushes on whichever fires
    first.  ``max_pending`` bounds queued + in-flight queries (admission
    control); ``cache_entries`` sizes the result cache (0 disables it)."""

    max_batch: int = 64
    max_delay: float = 0.002
    max_pending: int = 1024
    cache_entries: int = 4096


@dataclass
class _Pending:
    pq: ParsedQuery
    key: tuple
    future: asyncio.Future
    submitted_at: float


class MicroBatchFrontend:
    """Async micro-batch scheduler over one :class:`Session` (module
    docstring has the full tour).  Use as an async context manager, or
    call :meth:`close` explicitly::

        async with MicroBatchFrontend(session, FrontendConfig()) as fe:
            hits = await fe.submit('top5: alpha beta')
    """

    def __init__(self, session: Session, config: FrontendConfig | None = None):
        self.session = session
        self.config = config or FrontendConfig()
        self.cache = ResultCache(self.config.cache_entries)
        self.recorder = LatencyRecorder()
        self._buckets: dict[tuple, list[_Pending]] = {}
        self._timers: dict[tuple, asyncio.TimerHandle] = {}
        self._pending_by_key: dict[tuple, _Pending] = {}
        self._queued = 0
        self._inflight = 0
        self._closed = False
        self._loop: asyncio.AbstractEventLoop | None = None
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="frontend-exec")
        self.submitted = 0
        self.cache_served = 0
        self.coalesced = 0
        self.rejected = 0
        self.batches = 0
        self.batched_queries = 0
        self.max_batch_seen = 0
        self.flushes = {"size": 0, "deadline": 0, "drain": 0}
        session.frontend = self
        session.add_refresh_hook(self.cache.on_refresh)

    async def __aenter__(self) -> "MicroBatchFrontend":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- the continuous-stream entry point ------------------------------
    async def submit(self, q) -> np.ndarray:
        """Admit one query into the stream and await its answer.

        Cache hits return immediately; otherwise the query joins its
        width bucket and rides the next micro-batch.  Raises
        :class:`FrontendOverloaded` when the bounded queue is full and
        :class:`FrontendClosed` after :meth:`close`."""
        if self._closed:
            raise FrontendClosed("frontend is closed")
        t0 = time.perf_counter()
        pq = parse_query(q)
        key = self.session.result_key(pq)
        self.submitted += 1
        cached = self.cache.get(key)
        if cached is not None:
            self.cache_served += 1
            self.recorder.record(time.perf_counter() - t0, depth=self.depth)
            return cached
        inflight = self._pending_by_key.get(key)
        if inflight is not None:  # identical query already pending: coalesce
            self.coalesced += 1
            result = await inflight.future
            self.recorder.record(time.perf_counter() - t0, depth=self.depth)
            return result
        if self.depth >= self.config.max_pending:
            self.rejected += 1
            raise FrontendOverloaded(self.depth, self.config.max_pending)
        self._loop = asyncio.get_running_loop()
        pend = _Pending(pq=pq, key=key, future=self._loop.create_future(),
                        submitted_at=t0)
        # the same power-of-two width buckets the Session's plan cache and
        # device steps are keyed on — a flushed bucket is one shape
        bucket = (pq.kind, pq.k, pq.phrase, width_bucket(len(pq.terms)))
        queue = self._buckets.setdefault(bucket, [])
        queue.append(pend)
        self._pending_by_key[key] = pend
        self._queued += 1
        if len(queue) >= self.config.max_batch:
            self._flush(bucket, "size")
        elif bucket not in self._timers:
            self._timers[bucket] = self._loop.call_later(
                self.config.max_delay, self._flush, bucket, "deadline")
        result = await pend.future
        self.recorder.record(time.perf_counter() - t0, depth=self.depth)
        return result

    @property
    def depth(self) -> int:
        """Queued + in-flight queries (the admission-control quantity)."""
        return self._queued + self._inflight

    # -- flushing -------------------------------------------------------
    def _flush(self, bucket: tuple, trigger: str) -> None:
        timer = self._timers.pop(bucket, None)
        if timer is not None:
            timer.cancel()
        pend = self._buckets.pop(bucket, None)
        if not pend:
            return
        self._queued -= len(pend)
        self._inflight += len(pend)
        self.flushes[trigger] += 1
        self.batches += 1
        self.batched_queries += len(pend)
        self.max_batch_seen = max(self.max_batch_seen, len(pend))
        self._loop.create_task(self._run_batch(pend))

    async def _run_batch(self, pend: list[_Pending]) -> None:
        try:
            results = await self._loop.run_in_executor(
                self._executor, self.session.execute, [p.pq for p in pend])
        except Exception as e:
            for p in pend:
                if not p.future.done():
                    p.future.set_exception(e)
        else:
            shape = self.session.segment_shape
            for p, r in zip(pend, results):
                r = np.asarray(r)
                if p.key[2] == shape:  # don't cache across a mid-flight refresh
                    self.cache.put(p.key, p.pq.terms, r)
                if not p.future.done():
                    p.future.set_result(r)
        finally:
            self._inflight -= len(pend)
            for p in pend:
                if self._pending_by_key.get(p.key) is p:
                    del self._pending_by_key[p.key]

    async def drain(self) -> None:
        """Flush every bucket now and wait until nothing is in flight."""
        while self._buckets or self._inflight:
            for bucket in list(self._buckets):
                self._flush(bucket, "drain")
            await asyncio.sleep(0.0005)

    async def refresh(self) -> int:
        """Drain, then ``Session.refresh()`` on the executor thread (so it
        never races an executing batch).  The session's refresh hook
        invalidates exactly the affected cache entries."""
        await self.drain()
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._executor, self.session.refresh)

    def refresh_threadsafe(self, timeout: float | None = 60.0) -> int:
        """:meth:`refresh` callable from a non-loop thread — the shape
        ``IndexWriter.compact_async(on_swap=...)`` needs: the compaction
        worker blocks here while the frontend drains its in-flight
        micro-batches, swaps the session onto the merged segment and
        invalidates the result cache, and only then returns to let the
        worker delete the old segment directories.  Falls back to an
        inline ``Session.refresh`` when no event loop has admitted
        traffic yet."""
        loop = self._loop
        if loop is None or not loop.is_running():
            return self.session.refresh()
        fut = asyncio.run_coroutine_threadsafe(self.refresh(), loop)
        return fut.result(timeout)

    async def close(self) -> None:
        """Drain outstanding work, then stop admitting queries."""
        if self._closed:
            return
        await self.drain()
        self._closed = True
        self._executor.shutdown(wait=True)

    # -- metrics --------------------------------------------------------
    def metrics(self) -> dict:
        served = self.submitted - self.rejected
        return {
            "submitted": self.submitted,
            "served": served,
            "rejected": self.rejected,
            "reject_rate": round(self.rejected / self.submitted, 4)
            if self.submitted else 0.0,
            "cache_served": self.cache_served,
            "coalesced": self.coalesced,
            "batches": self.batches,
            "mean_batch": round(self.batched_queries / self.batches, 2)
            if self.batches else 0.0,
            "max_batch": self.max_batch_seen,
            "flushes": dict(self.flushes),
            "queue_depth": self.depth,
            "cache": self.cache.metrics(),
            "latency": self.recorder.snapshot(),
        }


# ----------------------------------------------------------------------
# open-loop (Poisson) driver — the tail-latency measurement harness
# ----------------------------------------------------------------------
async def _open_loop(frontend: MicroBatchFrontend, queries: list,
                     rate_qps: float, rng: np.random.Generator,
                     recorder: LatencyRecorder):
    results: list[np.ndarray | None] = [None] * len(queries)
    rejected = 0
    gaps = (rng.exponential(1.0 / rate_qps, size=len(queries))
            if rate_qps > 0 else np.zeros(len(queries)))
    tasks = []

    async def fire(i: int, q) -> None:
        nonlocal rejected
        t0 = time.perf_counter()
        try:
            results[i] = await frontend.submit(q)
        except FrontendOverloaded:
            rejected += 1
        else:
            recorder.record(time.perf_counter() - t0, depth=frontend.depth)

    for i, q in enumerate(queries):
        if gaps[i]:
            await asyncio.sleep(float(gaps[i]))
        tasks.append(asyncio.ensure_future(fire(i, q)))
    await asyncio.gather(*tasks)
    await frontend.drain()
    return results, rejected


def run_open_loop(session: Session, queries: list, rate_qps: float,
                  config: FrontendConfig | None = None, seed: int = 0,
                  frontend: MicroBatchFrontend | None = None
                  ) -> tuple[list, dict]:
    """Drive ``queries`` through a micro-batch frontend with open-loop
    Poisson arrivals at ``rate_qps`` offered load (0 = burst: all at
    once).  Returns (per-query results — ``None`` where admission control
    rejected, report dict with latency percentiles / reject rate / cache
    hit rate / achieved q/s).  Pass an existing ``frontend`` to keep its
    cache warm across runs."""
    rng = np.random.default_rng(seed)

    async def drive():
        fe = frontend or MicroBatchFrontend(session, config)
        recorder = LatencyRecorder()  # this run's samples only
        t0 = time.perf_counter()
        results, rejected = await _open_loop(fe, queries, rate_qps, rng,
                                             recorder)
        wall = time.perf_counter() - t0
        if frontend is None:
            await fe.close()
        m = fe.metrics()
        report = {
            "offered_qps": round(rate_qps, 1),
            "achieved_qps": round((len(queries) - rejected) / wall, 1)
            if wall else 0.0,
            "queries": len(queries),
            "rejected": rejected,
            "reject_rate": round(rejected / len(queries), 4) if queries else 0.0,
            "cache_hit_rate": m["cache"]["hit_rate"],
            "mean_batch": m["mean_batch"],
            "latency": recorder.snapshot(),
        }
        return results, report

    return asyncio.run(drive())
