"""The ranked BM25 device step and the engine's shims, against the reference.

The same seeded collections and queries go through the reference's
``make_ranked_step`` / ``BatchedServer.ranked`` (plain ``jnp``, no Pallas)
and the port's on CPU tensors.  Doc ids compare exactly; scores within
``SCORE_RTOL`` = 2**-20 relative (both sides compute in float32, but the
two libraries need not round a gather-scatter chain alike).  Every device
answer is also held against the host BM25 scorer (float64, MaxScore), which
breaks ties by the lowest doc id as the step must.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import NonPositionalIndex as RefNonPositional
from repro.core.index import PositionalIndex as RefPositional
from repro.data import generate_collection
from repro.serving import engine as ref_engine
from repro.serving.session import Session as RefSession
from repro_torch.core.index import NonPositionalIndex, PositionalIndex
from repro_torch.core.writer import IndexWriter
from repro_torch.serving import engine
from repro_torch.serving.plan import RANK, SERVER_KINDS
from repro_torch.serving.session import Session

SEED = 20260808
SCORE_RTOL = 2.0 ** -20
STORES = ("vbyte", "repair_skip")


@pytest.fixture(scope="module")
def col():
    return generate_collection(n_articles=2, versions_per_article=5,
                               words_per_doc=60, edit_rate=0.3, seed=SEED)


@pytest.fixture(scope="module")
def indexes(col):
    return {store: (NonPositionalIndex.build(col.docs, store=store),
                    RefNonPositional.build(col.docs, store=store)) for store in STORES}


def _rank_queries(idx, rng, n=12):
    vocab = idx.vocab.id_to_token
    out = []
    for i in range(n):
        w = [vocab[int(rng.integers(len(vocab)))] for _ in range(2 + i % 3)]
        out.append(f"rank{3 + i % 5}: " + " ".join(w))
    return out


def _servers(idx, ref_idx):
    return (engine.BatchedServer.from_index(idx, device="cpu"),
            ref_engine.BatchedServer.from_index(ref_idx))


@pytest.mark.parametrize("store", STORES)
def test_rank_arrays_equal_reference(indexes, store):
    """The padded run arrays, norm and idf: equal values, the reference's
    dtypes, outside ``device_bytes()``; "rank" joins the server's kinds."""
    port, ref = _servers(*indexes[store])
    assert port.kinds == ref.kinds == SERVER_KINDS | {RANK}
    for k, dtype in engine.RANK_ARRAYS.items():
        got, want = port.arrays[k].numpy(), np.asarray(ref.arrays[k])
        assert got.dtype == want.dtype == np.dtype(dtype), k
        assert np.array_equal(got, want), k
    assert port.device_bytes() == ref.device_bytes()


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("width,topk", [(2, 3), (4, 5), (4, 10), (8, 1)])
def test_ranked_step_equals_reference(indexes, store, width, topk):
    """One step on the same encoded batch: doc ids exact, scores within
    SCORE_RTOL, validity exact."""
    port, ref = _servers(*indexes[store])
    idx = indexes[store][0]
    rng = np.random.default_rng(SEED + width + topk)
    vocab = idx.vocab.id_to_token
    queries = [list(dict.fromkeys(vocab[int(i)] for i in
                                  rng.integers(len(vocab), size=int(rng.integers(1, width + 1)))))
               for _ in range(9)]
    qt, ql, _ = port.encode(queries, width=width)
    got = engine.make_ranked_step(max_terms=width, topk=topk)(
        port.arrays, torch.from_numpy(qt), torch.from_numpy(ql))
    want = ref_engine.make_ranked_step(max_terms=width, topk=topk)(
        ref.arrays, jnp.asarray(qt), jnp.asarray(ql))
    docs, scores, valid = (g.numpy() for g in got)
    rdocs, rscores, rvalid = (np.asarray(w) for w in want)
    assert docs.dtype == rdocs.dtype == np.int32
    assert scores.dtype == rscores.dtype == np.float32
    assert np.array_equal(valid, rvalid)
    assert np.array_equal(docs[valid], rdocs[rvalid])
    assert np.allclose(scores, rscores, rtol=SCORE_RTOL, atol=0.0)
    assert valid.any()


@pytest.mark.parametrize("store", STORES)
def test_ranked_batch_equals_reference_and_host(indexes, store):
    port, ref = _servers(*indexes[store])
    idx = indexes[store][0]
    host = Session(idx)
    qs = [q.split(": ")[1].split() for q in
          _rank_queries(idx, np.random.default_rng(SEED + 7), n=20)]
    for k in (1, 4, 10):
        got, want = port.ranked(qs, k=k), ref.ranked(qs, k=k)
        for q, g, w in zip(qs, got, want):
            assert g.dtype == np.int64 and np.array_equal(g, np.asarray(w)), (q, k)
            assert np.array_equal(g, host._rank(q, k=k)), (q, k)
    assert port.ranked_steps == 3 and port.windows_swept == 0


def test_forced_ties_go_to_the_lowest_doc_id():
    """Exact duplicates score alike; the step must list them in doc-id
    order, as ``lax.top_k`` and the host scorer do."""
    base = generate_collection(n_articles=1, versions_per_article=3,
                               words_per_doc=40, edit_rate=0.2, seed=5).docs
    docs = [base[0], base[1], base[0], base[2], base[0], base[1]]
    idx = NonPositionalIndex.build(docs, store="vbyte")
    port = Session.build(idx, device="cpu")
    ref = RefSession.build(RefNonPositional.build(docs, store="vbyte"))
    host = Session(idx)
    toks = base[0].split()
    qs = [f"rank3: {toks[0]} {toks[1]}", f"rank6: {toks[2]}", f"rank2: {toks[3]} {toks[5]}"]
    assert all(port.plan(q).route == "device" for q in qs)
    for q, g, w, h in zip(qs, port.execute(qs), ref.execute(qs), host.execute(qs)):
        assert np.array_equal(g, np.asarray(w)) and np.array_equal(g, h), q
    dup = port.execute(f"rank6: {toks[2]}")
    assert list(dup[:3]) == sorted(dup[:3].tolist()) and 0 in dup


def test_duplicate_query_terms_score_once(indexes):
    idx, ref_idx = indexes["vbyte"]
    port, ref = _servers(idx, ref_idx)
    vocab = idx.vocab.id_to_token
    qs = [[vocab[3], vocab[3]], [vocab[4], vocab[7], vocab[4], vocab[7]],
          [vocab[2], vocab[9], vocab[2]]]
    once = [list(dict.fromkeys(q)) for q in qs]
    got = port.ranked(qs, k=5)
    for q, g, w, o in zip(qs, got, ref.ranked(qs, k=5), port.ranked(once, k=5)):
        assert np.array_equal(g, np.asarray(w)) and np.array_equal(g, o), q
        assert np.array_equal(g, Session(idx)._rank(q, k=5)), q


@pytest.mark.parametrize("width", [4, 8, 16])
def test_padded_width_bucket(indexes, width):
    """Queries shorter than the bucket (and one with an unknown term) pad
    with term id 0 lanes that must add nothing."""
    idx, ref_idx = indexes["repair_skip"]
    port, ref = _servers(idx, ref_idx)
    vocab = idx.vocab.id_to_token
    qs = [[vocab[1]], [vocab[0], vocab[5]], [vocab[6], vocab[2], vocab[8]],
          ["zzz-missing", vocab[1]]]
    got, want = port.ranked(qs, k=4, width=width), ref.ranked(qs, k=4, width=width)
    for q, g, w in zip(qs, got, want):
        assert np.array_equal(g, np.asarray(w)), q
    assert len(got[-1]) == 0 and all(len(g) for g in got[:-1])
    assert np.array_equal(got[1], port.ranked([qs[1]], k=4)[0])


def test_rank_without_scoring_stats_is_a_clear_error(indexes):
    idx, ref_idx = indexes["vbyte"]
    bare = NonPositionalIndex(
        vocab=idx.vocab, store=idx.store, n_docs=idx.n_docs,
        collection_bytes=idx.collection_bytes, store_name=idx.store_name,
        doc_starts=idx.doc_starts, analyzer=idx.analyzer, scoring=None)
    ref_bare = RefNonPositional(
        vocab=ref_idx.vocab, store=ref_idx.store, n_docs=ref_idx.n_docs,
        collection_bytes=ref_idx.collection_bytes, store_name=ref_idx.store_name,
        doc_starts=ref_idx.doc_starts, analyzer=ref_idx.analyzer, scoring=None)
    srv = engine.BatchedServer.from_index(bare, device="cpu")
    ref_srv = ref_engine.BatchedServer.from_index(ref_bare)
    assert RANK not in srv.kinds and not any(k.startswith("rank_") for k in srv.arrays)
    with pytest.raises(ValueError, match="no scoring arrays") as got:
        srv.ranked([[idx.vocab.id_to_token[0]]])
    with pytest.raises(ValueError) as want:
        ref_srv.ranked([[idx.vocab.id_to_token[0]]])
    assert str(got.value) == str(want.value)
    sess = Session.build(bare, device="cpu")
    assert sess.plan("rank3: " + idx.vocab.id_to_token[0]).route == "host"
    with pytest.raises(ValueError, match="scoring statistics"):
        sess.execute("rank3: " + idx.vocab.id_to_token[0])


def test_device_rank_matches_host(indexes):
    idx, _ = indexes["vbyte"]
    dev = Session.build(idx, device="cpu")
    host = Session.build(idx, attach=False)
    queries = _rank_queries(idx, np.random.default_rng(SEED + 3))
    assert all(dev.plan(q).route == "device" for q in queries)
    for q, a, b in zip(queries, dev.execute(queries), host.execute(queries)):
        assert np.array_equal(a, b), (q, a.tolist(), b.tolist())
    assert dev.server.ranked_steps > 0


def test_segmented_rank_matches_one_shot(col, indexes, tmp_path):
    idx, _ = indexes["vbyte"]
    w = IndexWriter(tmp_path / "col", store="vbyte", positional=False, device="cpu")
    third = len(col.docs) // 3
    for lo in range(0, len(col.docs), third):
        w.add_documents(col.docs[lo:lo + third])
        w.commit()
    seg = Session.open(tmp_path / "col", device="cpu")
    one = Session.build(idx, device="cpu")
    ref_seg = RefSession.open(tmp_path / "col", device=False)
    queries = _rank_queries(idx, np.random.default_rng(SEED + 2))
    for q, a, b, c in zip(queries, seg.execute(queries), one.execute(queries),
                          ref_seg.execute(queries)):
        assert np.array_equal(a, b) and np.array_equal(a, np.asarray(c)), q
    assert seg.metrics()["ranked"]["postings_scored"] > 0


# ----------------------------------------------------------------------
# engine shims
# ----------------------------------------------------------------------
def _mixed(docs, idx):
    toks = docs[1].split()
    vocab = idx.vocab.id_to_token
    return [toks[0], f"{toks[0]} {toks[2]}", f'"{toks[3]} {toks[4]}"',
            f"top3: {toks[1]} {toks[5]}", f"docs: {toks[2]} {toks[6]}",
            f'docs: "{toks[0]} {toks[1]}"', f"docs-top2: {toks[3]}",
            f"rank4: {vocab[2]} {vocab[7]}", "zzz-missing " + toks[0]]


@pytest.mark.parametrize("attach", [False, True])
def test_query_engine_and_planner_equal_reference(col, attach):
    docs = col.docs
    idx, pidx = (NonPositionalIndex.build(docs, store="repair_skip"),
                 PositionalIndex.build(docs, store="repair_skip"))
    ref_idx, ref_pidx = (RefNonPositional.build(docs, store="repair_skip"),
                         RefPositional.build(docs, store="repair_skip"))
    servers = ({"server": engine.BatchedServer.from_index(idx, device="cpu"),
                "positional_server": engine.BatchedServer.from_index(pidx, device="cpu")}
               if attach else {})
    ref_servers = ({"server": ref_engine.BatchedServer.from_index(ref_idx),
                    "positional_server": ref_engine.BatchedServer.from_index(ref_pidx)}
                   if attach else {})
    eng = engine.QueryEngine(idx, positional=pidx, **servers)
    ref = ref_engine.QueryEngine(ref_idx, positional=ref_pidx, **ref_servers)
    batch = _mixed(docs, idx)
    for q in batch:
        got, want = eng.planner.plan(q), ref.planner.plan(q)
        assert (got.index, got.route, got.strategy) == (want.index, want.route, want.strategy), q
        assert got.query.kind == want.query.kind and got.query.terms == want.query.terms
        assert np.array_equal(eng.execute(q), np.asarray(ref.execute(q))), q
    for g, w in zip(eng.batch(batch), ref.batch(batch)):
        assert np.array_equal(g, np.asarray(w))
    assert (eng.session.device_batches > 0) == attach
    assert isinstance(eng.planner, engine.QueryPlanner)
    assert engine._lookup(idx, docs[1].split()[0]) == idx.lookup(docs[1].split()[0])


def test_query_engine_server_attached_after_construction(col):
    idx = NonPositionalIndex.build(col.docs, store="repair_skip")
    eng = engine.QueryEngine(idx)
    q = " ".join(col.docs[2].split()[:2])
    host = eng.execute(q)
    assert eng.planner.plan(q).route == "host"
    eng.server = engine.BatchedServer.from_index(idx, device="cpu")
    assert eng.planner.plan(q).route == "device"
    assert np.array_equal(eng.execute(q), host) and eng.session.device_batches > 0


def test_deprecation_warning_once_per_process(col):
    docs = col.docs
    eng = engine.QueryEngine(NonPositionalIndex.build(docs, store="vbyte"),
                             positional=PositionalIndex.build(docs, store="vbyte"))
    toks = docs[0].split()
    engine._DEPRECATION_WARNED = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng.word(toks[0])
        eng.conjunctive(toks[:2])
        eng.and_(toks[:2])
        eng.phrase(toks[1:3])
        eng.ranked_and(toks[:2], k=2)
        eng.topk(toks[:2], k=2)
        eng.doc_list([toks[0]])
        eng.doc_topk([toks[0]], k=2)
        eng.execute(" ".join(toks[:2]))  # not deprecated: no extra warning
        eng.batch([toks[0]])
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and "Session" in str(dep[0].message), [str(w.message) for w in caught]
    assert "repro_torch.serving.session.Session" in str(dep[0].message)


def test_uihrdc_step_equals_and_step(col):
    idx = NonPositionalIndex.build(col.docs, store="repair_skip")
    srv = engine.BatchedServer.from_index(idx, layout="dense", device="cpu")
    vocab = idx.vocab.id_to_token
    toks = col.docs[3].split()
    qt, ql, _ = srv.encode([[vocab[2], vocab[7]], toks[:3], [vocab[5]]], width=3)
    args = (srv.arrays, torch.from_numpy(qt), torch.from_numpy(ql))
    for row_start in (0, 64):
        got = engine.make_uihrdc_serve_step(max_terms=3)(*args, row_start)
        want = engine.make_serve_step(max_terms=3, mode=engine.AND)(*args, row_start)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
