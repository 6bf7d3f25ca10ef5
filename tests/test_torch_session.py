"""The slice as a whole: the same mixed, shuffled batch through the
reference ``Session.build(...)`` and the port's ``Session.build(...,
device="cpu")``, answers equal query for query (integers: tolerance 0; the
``top<k>:`` answers are doc ids, so they too compare exactly)."""

import numpy as np
import pytest
import torch

from repro.core.index import NonPositionalIndex as RefNonPositional
from repro.core.index import PositionalIndex as RefPositional
from repro.data import generate_collection
from repro.serving.session import Session as RefSession
from repro_torch.core.index import NonPositionalIndex, PositionalIndex
from repro_torch.data.queries import sample_traffic
from repro_torch.serving.plan import parse_query
from repro_torch.serving.session import Session

STORES = ("repair_skip", "repair", "vbyte", "vbyte_cm", "elias_fano")


@pytest.fixture(scope="module")
def collection():
    return generate_collection(n_articles=3, versions_per_article=6,
                               words_per_doc=60, edit_rate=0.1, seed=7)


@pytest.fixture(scope="module")
def built(collection):
    docs = collection.docs
    return {store: (NonPositionalIndex.build(docs, store=store),
                    PositionalIndex.build(docs, store=store),
                    RefNonPositional.build(docs, store=store),
                    RefPositional.build(docs, store=store)) for store in STORES}


def mixed_batch(docs, idx, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    words = sorted(idx.vocab.token_to_id)
    qs = []
    for mix in ("word", "and", "phrase", "topk", "docs", "docs-phrase", "docs-topk", "rank"):
        for n_terms in (2, 3, 4):
            qs += sample_traffic(mix, 3, docs, words, rng, n_terms=n_terms, k=3)
    # ANDs that do match (terms of one document), a single-token phrase
    # listing, and queries with an unknown term
    toks = docs[1].split()
    qs += [" ".join(toks[:2]), " ".join(toks[5:8]), f"top5: {toks[0]} {toks[3]}",
           f"docs: {toks[2]} {toks[4]}", f'docs: "{toks[6]}"', "zzz-missing " + toks[0],
           f'"{toks[0]} zzz-missing"', f"docs: zzz-missing {toks[1]}"]
    order = rng.permutation(len(qs))
    return [qs[i] for i in order]


@pytest.mark.parametrize("store,layout",
                         [(s, lay) for s in STORES for lay in ("fused", "dense")]
                         + [("repair_skip", "auto"), ("vbyte", "auto")])
def test_mixed_batch_equals_reference(collection, built, store, layout):
    idx, pidx, ref_idx, ref_pidx = built[store]
    batch = mixed_batch(collection.docs, idx, seed=31)
    port = Session.build(idx, positional=pidx, device="cpu", layout=layout)
    ref = RefSession.build(ref_idx, positional=ref_pidx, layout=layout)
    host = Session(idx, positional=pidx)  # the sequential algorithms
    assert port.server.layout == ref.server.layout
    assert port.server.device_bytes() == ref.server.device_bytes()
    assert port.positional_server.device_bytes() == ref.positional_server.device_bytes()
    got, want, seq = port.execute(batch), ref.execute(batch), host.execute(batch)
    for q, g, w, h in zip(batch, got, want, seq):
        assert isinstance(g, np.ndarray) and g.dtype == np.asarray(w).dtype, q
        assert np.array_equal(g, w), (store, layout, q, g.tolist(), np.asarray(w).tolist())
        assert np.array_equal(g, h), (store, layout, q)
    assert port.device_batches > 0
    assert sum(len(g) > 0 for g in got) > len(batch) // 3  # not vacuous
    # single-query form
    assert np.array_equal(port.execute(batch[0]), got[0])
    assert np.array_equal(port.execute(parse_query(batch[1])), got[1])


@pytest.mark.parametrize("store", STORES)
def test_explain_equals_reference(collection, built, store):
    idx, pidx, ref_idx, ref_pidx = built[store]
    port = Session.build(idx, positional=pidx, device="cpu")
    ref = RefSession.build(ref_idx, positional=ref_pidx)
    batch = [q for q in mixed_batch(collection.docs, idx, seed=5)
             if not q.startswith("rank")]
    for q in batch:
        assert port.explain(q) == ref.explain(q), q
        assert port.explain(q, fmt="json") == ref.explain(q, fmt="json"), q
    assert any("route=device" in port.explain(q) for q in batch)
    assert any(f"layout={port.server.layout}" in port.explain(q) for q in batch)
    toks = collection.docs[0].split()
    assert port.explain(f'"{toks[0]} {toks[1]}"', extract=2) == \
        ref.explain(f'"{toks[0]} {toks[1]}"', extract=2)
    with pytest.raises(ValueError, match="unknown explain format"):
        port.explain(batch[0], fmt="yaml")


def test_rank_routes_to_the_host_and_equals_reference(collection, built):
    """The server holds the scoring arrays and lists "rank", so ``rank<k>:``
    routes to the device ranked step, as in the reference; the answers equal
    the reference's device-ranked ones and the host scorer's.  (The name is
    kept from when this slice's server had no "rank" kind.)"""
    idx, pidx, ref_idx, ref_pidx = built["repair_skip"]
    port = Session.build(idx, positional=pidx, device="cpu")
    ref = RefSession.build(ref_idx, positional=ref_pidx)
    ref_host = RefSession(ref_idx, positional=ref_pidx)
    words = sorted(idx.vocab.token_to_id)
    rng = np.random.default_rng(3)
    qs = sample_traffic("rank", 8, collection.docs, words, rng, n_terms=3, k=4)
    assert "rank" in port.server.kinds and port.server.kinds == ref.server.kinds
    for q in qs:
        assert port.plan(q).route == "device" == ref.plan(q).route
        assert port.plan(q).strategy == ref.plan(q).strategy
        assert port.explain(q) == ref.explain(q)
        assert np.array_equal(port.execute(q), ref.execute(q)), q
        assert np.array_equal(port.execute(q), ref_host.execute(q)), q
    assert port.server.ranked_steps == port.device_batches == 2 * len(qs)
    assert "ranked" not in port.metrics()  # the host scorer did no work


def test_repeated_batch_zero_replans_zero_new_steps(collection, built):
    idx, pidx, _, _ = built["repair_skip"]
    sess = Session.build(idx, positional=pidx, device="cpu")
    batch = mixed_batch(collection.docs, idx, seed=23)
    first = sess.execute(batch)
    m1 = sess.metrics()
    assert m1["plans_compiled"] > 0 and m1["jit_traces"] > 0
    assert m1["queries_executed"] == len(batch)
    order = np.random.default_rng(1).permutation(len(batch))
    second = sess.execute([batch[i] for i in order])
    m2 = sess.metrics()
    assert m2["plans_compiled"] == m1["plans_compiled"], "re-planned a cached shape"
    assert m2["jit_traces"] == m1["jit_traces"], "built a step for a cached shape"
    assert m2["plan_cache_hits"] == m1["plan_cache_hits"] + len(batch)
    assert m2["device_batches"] == 2 * m1["device_batches"]
    for i, j in enumerate(order):
        assert np.array_equal(second[i], first[j])
    # a genuinely new shape does compile (counters are live, not frozen)
    sess.execute("docs-top2: " + batch[0].split()[-1].strip('"'))
    assert sess.metrics()["plans_compiled"] == m2["plans_compiled"] + 1


def test_width_bucketing_shares_steps_across_term_counts(built):
    idx, _, _, _ = built["repair_skip"]
    sess = Session.build(idx, device="cpu")
    vocab = idx.vocab.id_to_token
    sess.execute([f"{vocab[1]} {vocab[2]} {vocab[3]}"])  # 3 terms -> width 4
    t = sess.jit_traces
    assert t == 1
    sess.execute([f"{vocab[4]} {vocab[5]} {vocab[6]} {vocab[7]}"])  # 4 -> width 4
    assert sess.jit_traces == t, "3- and 4-term AND queries must share a step"
    sess.execute([f"{vocab[1]} {vocab[2]}"])  # width 2: a new shape
    assert sess.jit_traces == t + 1


def test_build_arguments(built):
    idx, pidx, _, _ = built["repair_skip"]
    host = Session.build(idx, positional=pidx, attach=False)
    assert host.server is None and host.positional_server is None
    cpu = Session.build(idx, positional=pidx, device="cpu")
    assert cpu.server.probe == "torch" and cpu.server.device.type == "cpu"
    layout_keys = cpu.server._LAYOUT_ARRAYS[cpu.server.layout] + ("doc_starts",)
    for srv in (cpu.server, cpu.positional_server):
        assert all(not t.is_cuda for t in srv.arrays.values())
        assert all(srv.arrays[k].dtype in (torch.int32, torch.bool)
                   for k in layout_keys if k in srv.arrays)
    # the ranked step's arrays carry the reference's dtypes (float32 among them)
    assert {k: cpu.server.arrays[k].dtype for k in cpu.server.arrays if k.startswith("rank_")} \
        == {"rank_run_docs": torch.int32, "rank_run_tfs": torch.float32,
            "rank_run_valid": torch.bool, "rank_doc_norm": torch.float32,
            "rank_idf": torch.float32}
    assert not any(k.startswith("rank_") for k in cpu.positional_server.arrays)
    with pytest.raises(ValueError, match="probe='kernel'"):
        Session.build(idx, device="cpu", probe="kernel")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            Session.build(idx, positional=pidx)  # device defaults to "cuda"


def test_later_slices_raise_not_implemented(built, tmp_path):
    """``Session.open`` / ``refresh`` raise the reference's errors: an
    ``ArtifactError`` for a path with nothing to open, a ``ValueError`` for
    ``refresh`` on a session not opened from a writer.  ``similar:`` /
    ``versions-of:`` over an index built without mining raise the
    reference's ``ValueError``.  (The name is kept from when open / refresh
    raised ``NotImplementedError``.)"""
    from repro.core.artifact import ArtifactError as RefArtifactError
    from repro_torch.core.artifact import ArtifactError

    idx, pidx, ref_idx, ref_pidx = built["repair_skip"]
    with pytest.raises(ArtifactError, match="nothing to open") as got:
        Session.open(tmp_path, device="cpu")
    with pytest.raises(RefArtifactError) as want:
        RefSession.open(tmp_path, device=False)
    assert str(got.value) == str(want.value)
    sess = Session(idx, positional=pidx)
    with pytest.raises(ValueError, match="writer directory") as got:
        sess.refresh()
    with pytest.raises(ValueError) as want:
        RefSession(ref_idx, positional=ref_pidx).refresh()
    assert str(got.value) == str(want.value)
    ref = RefSession(ref_idx, positional=ref_pidx)
    for q in ("similar:0", "versions-of:1"):
        with pytest.raises(ValueError, match="mine_similarity=True") as got:
            sess.execute(q)
        with pytest.raises(ValueError) as want:
            ref.execute(q)
        assert str(got.value) == str(want.value)


def test_extract_equals_reference(collection):
    docs = collection.docs
    port = Session(None, positional=PositionalIndex.build(docs, store="repair_skip",
                                                          keep_text=True))
    ref = RefSession(None, positional=RefPositional.build(docs, store="repair_skip",
                                                          keep_text=True))
    toks = docs[0].split()
    q = f'"{toks[2]} {toks[3]}"'
    got, want = port.extract(q, context=2), ref.extract(q, context=2)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
