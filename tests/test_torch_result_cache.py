"""Result-cache correctness on the port: never a stale answer, precise
invalidation — the ten scenarios of the reference's
``tests/test_result_cache.py``.

Each scenario runs twice over the same documents and the same commit
sequence: on ``repro_torch`` (a writer with ``device="cpu"``, sessions with
their device servers on the CPU) and on the reference package (host-only
sessions, as its own tests open them).  The answers must be equal to each
other and to a cold open after every commit, and the cache's counters
(``invalidated`` / ``migrated`` / ``entries`` / ``hits``) equal between the
two packages.
"""

import asyncio
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core.writer import IndexWriter as RefWriter
from repro.serving import frontend as ref_frontend
from repro.serving.session import Session as RefSession
from repro_torch.core.writer import IndexWriter
from repro_torch.serving import frontend
from repro_torch.serving.session import Session

BASE_SEED = int(os.environ.get("REPRO_DIFF_SEED", "20260727"))

PORT = SimpleNamespace(name="port", Writer=IndexWriter, Session=Session,
                       Frontend=frontend.MicroBatchFrontend, Config=frontend.FrontendConfig,
                       writer_kw={"device": "cpu"}, open_kw={"device": "cpu"},
                       cold_kw={"device": "cpu", "attach": False})
REF = SimpleNamespace(name="ref", Writer=RefWriter, Session=RefSession,
                      Frontend=ref_frontend.MicroBatchFrontend,
                      Config=ref_frontend.FrontendConfig,
                      writer_kw={}, open_kw={"device": False}, cold_kw={"device": False})

# controlled vocabulary — none of these are tokenizer stopwords, none
# hyphenated, so each word is exactly one term in exactly the docs below
DOCS_V1 = [
    "alpha beta gamma alpha beta",
    "alpha gamma delta epsilon gamma",
    "zebra quartz zebra nickel quartz",
    "beta delta nickel epsilon beta",
]
DOCS_V2 = [  # second commit: mentions alpha/beta/gamma, never zebra/quartz
    "alpha beta alpha gamma beta",
    "delta alpha epsilon beta gamma",
]


def make_writer(pkg, tmp_path, docs=DOCS_V1, store="vbyte"):
    w = pkg.Writer(tmp_path / pkg.name / "col", store=store, positional=True,
                   **pkg.writer_kw)
    w.add_documents(docs)
    w.commit()
    return w


def open_session(pkg, w):
    return pkg.Session.open(w.path, **pkg.open_kw)


def cold_answers(pkg, path, queries):
    return [np.asarray(r) for r in pkg.Session.open(path, **pkg.cold_kw).execute(queries)]


def submit_all(pkg, session, queries, config=None):
    """One frontend lifetime: submit each query in order, return results
    plus the frontend (already closed) for metric inspection."""
    config = config or pkg.Config(max_batch=4, max_delay=0.001)

    async def main():
        async with pkg.Frontend(session, config) as fe:
            results = [np.asarray(await fe.submit(q)) for q in queries]
            return results, fe

    return asyncio.run(main())


def both(scenario, tmp_path):
    """Run ``scenario(pkg, tmp_path)`` on the port and on the reference;
    their returns (answers, counters) must be equal."""
    got, want = scenario(PORT, tmp_path), scenario(REF, tmp_path)
    assert_equal(got, want)
    return got


def assert_equal(got, want, where="result"):
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got), set(want))
        for k in want:
            assert_equal(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert np.array_equal(np.asarray(got), want), (where, got, want)
    else:
        assert got == want, (where, got, want)


def cache_counts(fe) -> dict:
    m = fe.cache.metrics()
    return {k: m[k] for k in ("entries", "hits", "misses", "invalidated", "migrated")}


# ----------------------------------------------------------------------
def test_repeat_traffic_hits_cache_and_matches_cold(tmp_path):
    queries = ["alpha beta", "docs: gamma", 'top3: alpha gamma',
               '"zebra quartz"', "docs: zebra"]
    traffic = queries * 3  # repeated pool, like real serving traffic

    def scenario(pkg, tmp):
        w = make_writer(pkg, tmp)
        results, fe = submit_all(pkg, open_session(pkg, w), traffic)
        cache = fe.metrics()["cache"]
        assert cache["hit_rate"] > 0, cache
        assert cache["hits"] >= 2 * len(queries), cache
        reference = cold_answers(pkg, w.path, traffic)
        for q, res, ref in zip(traffic, results, reference):
            assert np.array_equal(res, ref), \
                f"(seed={BASE_SEED}, {pkg.name}, query={q!r}): cached {res} != cold {ref}"
        return results, cache_counts(fe)

    both(scenario, tmp_path)


def test_topk_variants_are_distinct_entries(tmp_path):
    queries = ["top3: alpha beta", "top5: alpha beta",
               "docs-top3: alpha beta", "docs-top5: alpha beta"]

    def scenario(pkg, tmp):
        w = make_writer(pkg, tmp)
        session = open_session(pkg, w)
        keys = [session.result_key(q) for q in queries]
        assert len(set(keys)) == len(keys), keys  # four entries, no cross-talk
        results, fe = submit_all(pkg, session, queries * 2)
        assert fe.metrics()["cache"]["entries"] == len(queries)
        reference = cold_answers(pkg, w.path, queries * 2)
        for q, res, ref in zip(queries * 2, results, reference):
            assert np.array_equal(res, ref), f"query={q!r}: k-variant entries crossed"
        return results, cache_counts(fe)

    both(scenario, tmp_path)


def test_result_key_carries_segment_shape(tmp_path):
    def scenario(pkg, tmp):
        w = make_writer(pkg, tmp)
        session = open_session(pkg, w)
        before = session.result_key("docs: alpha")
        w.add_documents(DOCS_V2)
        w.commit()
        session.refresh()
        after = session.result_key("docs: alpha")
        assert before != after
        assert before[:2] == after[:2]  # same plan structure + terms
        assert before[2] != after[2]  # the segment shape moved
        return [before[1:], after[1:]]  # terms and shapes (the structure names the layout)

    both(scenario, tmp_path)


def test_commit_refresh_invalidates_exactly_affected_entries(tmp_path):
    """After a commit that mentions alpha but never zebra, the zebra entries
    keep serving from cache, the alpha entries are recomputed — and every
    answer equals a cold open of the committed state (zero stale serves)."""
    warm = ["docs: alpha", "docs: zebra", "alpha beta", '"zebra quartz"']

    def scenario(pkg, tmp):
        w = make_writer(pkg, tmp)
        session = open_session(pkg, w)

        async def main():
            fe = pkg.Frontend(session, pkg.Config(max_batch=4, max_delay=0.001))
            before = [np.asarray(await fe.submit(q)) for q in warm]
            assert len(fe.cache) == len(warm)
            w.add_documents(DOCS_V2)  # alpha/beta/gamma only — zebra untouched
            w.commit()
            opened = await fe.refresh()
            assert opened == 1  # one appended segment
            cache = fe.cache.metrics()
            assert (cache["invalidated"], cache["migrated"], cache["entries"]) == (2, 2, 2), cache
            hits0 = fe.cache.hits
            after = [np.asarray(await fe.submit(q)) for q in warm]
            assert fe.cache.hits >= hits0 + 2, fe.cache.metrics()
            counts = cache_counts(fe)
            await fe.close()
            return before, after, counts

        before, after, counts = asyncio.run(main())
        for q, a, ref in zip(warm, after, cold_answers(pkg, w.path, warm)):
            assert np.array_equal(a, ref), \
                f"(seed={BASE_SEED}, {pkg.name}, query={q!r}): stale serve after commit+refresh"
        assert not np.array_equal(before[0], after[0])  # alpha really moved
        assert set(after[0].tolist()) >= {4, 5}
        assert np.array_equal(before[1], after[1])  # zebra byte-identical
        return before, after, counts

    both(scenario, tmp_path)


def test_commit_invalidates_exactly_affected_ranked_entries(tmp_path):
    """Ranked entries are disjunctive: a commit mentioning any of a
    ``rank<k>:`` query's terms invalidates it, while a ranked entry over
    terms the new segment does not know keeps serving from cache."""
    warm = ["rank3: alpha zebra", "rank2: zebra quartz"]

    def scenario(pkg, tmp):
        w = make_writer(pkg, tmp)
        session = open_session(pkg, w)

        async def main():
            fe = pkg.Frontend(session, pkg.Config(max_batch=4, max_delay=0.001))
            before = [np.asarray(await fe.submit(q)) for q in warm]
            assert len(fe.cache) == len(warm)
            w.add_documents(DOCS_V2)
            w.commit()
            await fe.refresh()
            cache = fe.cache.metrics()
            assert (cache["invalidated"], cache["migrated"]) == (1, 1), cache
            hits0 = fe.cache.hits
            after = [np.asarray(await fe.submit(q)) for q in warm]
            assert fe.cache.hits == hits0 + 1, fe.cache.metrics()
            counts = cache_counts(fe)
            await fe.close()
            return before, after, counts

        before, after, counts = asyncio.run(main())
        for q, a, ref in zip(warm, after, cold_answers(pkg, w.path, warm)):
            assert np.array_equal(a, ref), f"({pkg.name}, query={q!r}): stale ranked serve"
        assert not np.array_equal(before[0], after[0])
        assert np.array_equal(before[1], after[1])
        return before, after, counts

    both(scenario, tmp_path)


def test_plain_refresh_drives_invalidation_too(tmp_path):
    """Invalidation hangs off Session.refresh() itself — a caller who
    never touches frontend.refresh() still gets a correct cache."""
    def scenario(pkg, tmp):
        w = make_writer(pkg, tmp)
        session = open_session(pkg, w)

        async def main():
            async with pkg.Frontend(session, pkg.Config(max_batch=2, max_delay=0.001)) as fe:
                await fe.submit("docs: alpha")
                await fe.submit("docs: zebra")
                w.add_documents(DOCS_V2)
                w.commit()
                session.refresh()  # NOT fe.refresh()
                m = fe.cache.metrics()
                assert m["invalidated"] == 1 and m["migrated"] == 1, m
                return np.asarray(await fe.submit("docs: alpha")), cache_counts(fe)

        res, counts = asyncio.run(main())
        assert np.array_equal(res, cold_answers(pkg, w.path, ["docs: alpha"])[0])
        return res, counts

    both(scenario, tmp_path)


def test_compaction_clears_all_entries(tmp_path):
    queries = ["docs: zebra", "docs: alpha", '"zebra quartz"']

    def scenario(pkg, tmp):
        w = make_writer(pkg, tmp)
        w.add_documents(DOCS_V2)
        w.commit()
        session = open_session(pkg, w)

        async def main():
            fe = pkg.Frontend(session, pkg.Config(max_batch=4, max_delay=0.001))
            before = [np.asarray(await fe.submit(q)) for q in queries]
            assert len(fe.cache) == len(queries)
            w.compact()  # rewrites the segment set: nothing may survive
            await fe.refresh()
            m = fe.cache.metrics()
            assert (m["entries"], m["migrated"], m["invalidated"]) == (0, 0, len(queries)), m
            after = [np.asarray(await fe.submit(q)) for q in queries]
            counts = cache_counts(fe)
            await fe.close()
            return before, after, counts

        before, after, counts = asyncio.run(main())
        for q, b, a, ref in zip(queries, before, after, cold_answers(pkg, w.path, queries)):
            assert np.array_equal(a, ref), f"query={q!r}"
            assert np.array_equal(b, a), f"query={q!r}: compaction changed data?"
        return before, after, counts

    both(scenario, tmp_path)


def test_cache_disabled_still_correct(tmp_path):
    queries = ["alpha beta", "docs: gamma"] * 2

    def scenario(pkg, tmp):
        w = make_writer(pkg, tmp)
        results, fe = submit_all(pkg, open_session(pkg, w), queries,
                                 pkg.Config(max_batch=4, max_delay=0.001, cache_entries=0))
        m = fe.metrics()["cache"]
        assert m["entries"] == 0 and m["hits"] == 0, m
        for q, res, ref in zip(queries, results, cold_answers(pkg, w.path, queries)):
            assert np.array_equal(res, ref), q
        return results, cache_counts(fe)

    both(scenario, tmp_path)


def test_cached_arrays_are_frozen(tmp_path):
    def scenario(pkg, tmp):
        w = make_writer(pkg, tmp)
        session = open_session(pkg, w)

        async def main():
            async with pkg.Frontend(session, pkg.Config(max_batch=4, max_delay=0.001)) as fe:
                return [await fe.submit(q) for q in ("docs: alpha", "docs: alpha")], fe

        results, fe = asyncio.run(main())
        assert results[1].flags.writeable is False
        with pytest.raises(ValueError):
            results[1][0] = 999  # a caller cannot corrupt the shared entry
        return [np.asarray(r) for r in results], cache_counts(fe)

    both(scenario, tmp_path)


def test_background_compaction_swap_under_live_traffic(tmp_path):
    """``compact_async`` swapping the segment set behind a frontend under
    continuous traffic serves zero stale entries and never drops an
    in-flight query; the result cache is invalidated exactly once, at the
    swap.  (How many rounds overlap the merge is timing, so the two
    packages are compared on answers, not on counters.)"""
    queries = ["docs: alpha", "docs: zebra", "alpha beta", '"zebra quartz"',
               "top3: alpha gamma"]

    def scenario(pkg, tmp):
        w = make_writer(pkg, tmp)
        w.add_documents(DOCS_V2)
        w.commit()
        session = open_session(pkg, w)
        reference = cold_answers(pkg, w.path, queries)
        orig_merge = w._merged_indexes

        def slow_merge(segments):  # several traffic rounds overlap the merge
            time.sleep(0.15)
            return orig_merge(segments)

        w._merged_indexes = slow_merge

        async def main():
            fe = pkg.Frontend(session, pkg.Config(max_batch=4, max_delay=0.001))
            for q in queries:
                await fe.submit(q)  # warm the cache: the swap must clear these
            version_before = session.data_version
            handle = w.compact_async(on_swap=fe.refresh_threadsafe)
            served = []
            while not handle.done:
                results = await asyncio.gather(*(fe.submit(q) for q in queries))
                served.append([np.asarray(r) for r in results])
            served.append([np.asarray(await fe.submit(q)) for q in queries])
            metrics = fe.cache.metrics()
            swaps = session.data_version - version_before
            await fe.close()
            return handle, served, metrics, swaps

        handle, served, metrics, swaps = asyncio.run(main())
        handle.wait(60)
        assert len(served) >= 2
        assert swaps == 1
        assert metrics["invalidated"] >= len(queries), metrics
        assert len(session._segments) == 1
        for round_i, results in enumerate(served):
            assert len(results) == len(queries)  # nothing dropped
            for q, res, ref in zip(queries, results, reference):
                assert np.array_equal(res, ref), \
                    (f"(seed={BASE_SEED}, {pkg.name}, round={round_i}, query={q!r}): "
                     f"stale serve across the compaction swap: {res} != {ref}")
        return reference, served[-1]

    both(scenario, tmp_path)
