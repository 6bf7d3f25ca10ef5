"""The port's device steps and batched server against the reference's, on
device state carried across with ``from_arrays`` (both packages compute on
identical arrays).  Integers and bools compare with tolerance 0; the only
floats are the ``top<k>:`` idf-proxy scores (float32 ``log1p`` sums over at
most 8 terms, evaluated by two different math libraries): ``rtol=1e-6``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.anchors import build_anchored as ref_build_anchored
from repro.core.anchors import build_compressed_anchored as ref_build_compressed
from repro.core.index import NonPositionalIndex as RefNonPositional
from repro.core.index import PositionalIndex as RefPositional
from repro.data import generate_collection
from repro.serving import engine as ref_engine
from repro_torch.core import anchors as port_anchors
from repro_torch.core.index import NonPositionalIndex, PositionalIndex
from repro_torch.serving import engine
from repro_torch.serving.plan import AND, MAX_CAND_ROWS, PHRASE
from repro_torch.serving.session import Session


def _docs():
    return generate_collection(n_articles=2, versions_per_article=6,
                               words_per_doc=50, edit_rate=0.2, seed=99).docs


@pytest.fixture(scope="module")
def servers():
    """Reference servers (dense, fused) over both indexes and the port's
    servers built from their arrays."""
    docs = _docs()
    out = {"docs": docs}
    for name, build, port_build in (("np", RefNonPositional.build, NonPositionalIndex.build),
                                    ("pos", RefPositional.build, PositionalIndex.build)):
        ref_idx = build(docs, store="repair_skip")
        port_idx = port_build(docs, store="repair_skip")
        for layout in ("dense", "fused"):
            ref = ref_engine.BatchedServer.from_index(ref_idx, layout=layout)
            arrays = {k: np.asarray(v) for k, v in ref.arrays.items()}
            port = engine.BatchedServer.from_arrays(
                port_idx, arrays, layout=layout, max_phrase=ref.max_phrase,
                n_docs=ref.n_docs, device="cpu")
            out[name, layout] = (ref, port)
    return out


def _queries(servers, name):
    docs = servers["docs"]
    if name == "pos":
        toks = docs[0].split()
        return [toks[:2], toks[3:6], toks[10:14], [toks[0]], ["zzz-missing", toks[0]],
                docs[5].split()[7:9]]
    vocab = sorted(servers["np", "dense"][0].host_index.vocab.token_to_id)
    return [[vocab[0]], [vocab[1], vocab[2]], vocab[:3], vocab[3:7], ["zzz-missing"],
            docs[2].split()[:2], docs[7].split()[4:7]]


MODES = [(AND, 0, False), (AND, 3, False), (AND, 0, True),
         (PHRASE, 0, False), (PHRASE, 0, True)]


@pytest.mark.parametrize("ref_probe", ["vmap", "kernel"])
@pytest.mark.parametrize("layout", ["dense", "fused"])
@pytest.mark.parametrize("mode,topk,doclist", MODES)
def test_serve_step_equals_reference(servers, mode, topk, doclist, layout, ref_probe):
    name = "pos" if mode == PHRASE else "np"
    ref, port = servers[name, layout]
    qt, ql, _ = ref.encode(_queries(servers, name), sort_by_length=(mode != PHRASE), width=4)
    pqt, pql, _ = port.encode(_queries(servers, name), sort_by_length=(mode != PHRASE), width=4)
    assert np.array_equal(qt, pqt) and np.array_equal(ql, pql)
    kw = dict(max_terms=4, mode=mode, topk=topk, n_docs=ref.n_docs, doclist=doclist,
              layout=layout, max_phrase=ref.max_phrase)
    ref_step = jax.jit(ref_engine.make_serve_step(probe=ref_probe, **kw))
    port_step = engine.make_serve_step(probe="torch", **kw)
    for row_start in (0, MAX_CAND_ROWS):
        want = ref_step(ref.arrays, jnp.asarray(qt), jnp.asarray(ql), row_start)
        got = port_step(port.arrays, torch.from_numpy(qt), torch.from_numpy(ql), row_start)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape, (g.shape, w.shape)
            if g.dtype.kind == "f":
                assert g.dtype == np.float32
                assert np.array_equal(np.isinf(g), np.isinf(w))
                fin = np.isfinite(w)
                np.testing.assert_allclose(g[fin], w[fin], rtol=1e-6)
            else:
                assert np.array_equal(g, w)


@pytest.mark.parametrize("layout", ["dense", "fused"])
@pytest.mark.parametrize("kind", ["conjunctive", "doclist", "topk", "phrase", "doclist_phrase"])
def test_batched_server_equals_reference(servers, layout, kind):
    name = "pos" if "phrase" in kind else "np"
    ref, port = servers[name, layout]
    qs = _queries(servers, name)
    if kind == "doclist_phrase":
        want, got = ref.doclist(qs, phrase=True), port.doclist(qs, phrase=True)
    elif kind == "topk":
        want, got = ref.topk(qs, k=3), port.topk(qs, k=3)
    else:
        want, got = getattr(ref, kind)(qs), getattr(port, kind)(qs)
    assert len(got) == len(want) == len(qs)
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and np.array_equal(g, w)
    assert port.device_bytes() == ref.device_bytes()
    assert all(port.c_entries(i) == ref.c_entries(i) for i in range(0, 20, 3))


def test_from_index_equals_from_arrays(servers):
    """Building the device state from the port's own index gives the arrays
    the reference built (both branches: resident store, re-anchored lists)."""
    docs = servers["docs"]
    for store in ("repair_skip", "vbyte"):
        ref_idx = RefPositional.build(docs, store=store)
        port_idx = PositionalIndex.build(docs, store=store)
        for layout in ("auto", "dense", "fused"):
            ref = ref_engine.BatchedServer.from_index(ref_idx, layout=layout)
            port = engine.BatchedServer.from_index(port_idx, layout=layout, device="cpu")
            assert port.layout == ref.layout and port.max_phrase == ref.max_phrase
            assert set(port.arrays) == set(ref.arrays)
            for k, v in ref.arrays.items():
                assert np.array_equal(port.arrays[k].numpy(), np.asarray(v)), (store, layout, k)
            assert port.device_bytes() == ref.device_bytes()
            assert port.n_docs == ref.n_docs
    with pytest.raises(ValueError, match="layout"):
        engine.BatchedServer.from_index(port_idx, layout="bogus", device="cpu")


def test_topk_is_stable_among_equal_scores():
    """All matches of one query carry the same idf-proxy score, so the top k
    must be the FIRST k matches in candidate (doc-id) order — what a stable
    top-k gives and ``torch.topk`` does not promise."""
    docs = [("common rare" if d % 2 == 0 else "common") + f" filler{d}" for d in range(40)]
    idx = NonPositionalIndex.build(docs, store="repair", max_rules=0)
    ref_idx = RefNonPositional.build(docs, store="repair", max_rules=0)
    port = engine.BatchedServer.from_index(idx, layout="dense", device="cpu")
    ref = ref_engine.BatchedServer.from_index(ref_idx, layout="dense")
    q = [["common", "rare"]]
    assert np.array_equal(port.topk(q, k=5)[0], np.asarray([0, 2, 4, 6, 8]))
    assert np.array_equal(port.topk(q, k=5)[0], ref.topk(q, k=5)[0])
    qt, ql, _ = port.encode(q, sort_by_length=True, width=2)
    step = engine.make_serve_step(max_terms=2, topk=7, n_docs=port.n_docs, layout="dense")
    vals, scores, valid = step(port.arrays, torch.from_numpy(qt), torch.from_numpy(ql), 0)
    assert valid.all() and vals[0].tolist() == [0, 2, 4, 6, 8, 10, 12]
    assert torch.all(scores[0] == scores[0, 0])
    ref_step = ref_engine.make_serve_step(max_terms=2, topk=7, n_docs=ref.n_docs,
                                          layout="dense")
    rv, rs, _ = ref_step(ref.arrays, jnp.asarray(qt), jnp.asarray(ql), 0)
    assert np.array_equal(vals.numpy(), np.asarray(rv))
    np.testing.assert_allclose(scores.numpy(), np.asarray(rs), rtol=1e-6)


@pytest.mark.parametrize("layout", ["dense", "fused"])
def test_phrase_probe_at_universe_top(layout):
    """A driving posting at the top of the int32 universe shifts past every
    legal posting: the shifted target must neither wrap int32 nor match —
    real pairs below it still do."""
    top = 2**31 - 3
    lists = [np.asarray([10, top - 3, top], dtype=np.int64),
             np.asarray([11, top - 2, top - 1], dtype=np.int64)]
    if layout == "fused":
        idx = port_anchors.build_compressed_anchored(lists, device="cpu")
        gen = engine.fused_candidates_for
        ref_idx, ref_gen = ref_build_compressed(lists), ref_engine.fused_candidates_for
    else:
        idx = port_anchors.build_anchored(lists, device="cpu")
        gen = engine.candidates_for
        ref_idx, ref_gen = ref_build_anchored(lists), ref_engine.candidates_for
    qt = torch.tensor([[0, 1]], dtype=torch.int32)
    ql = torch.tensor([2], dtype=torch.int32)
    cand_vals, cand_valid = gen(idx, qt[:, 0], 0)
    match = engine._probe_terms(idx, qt, ql, cand_vals, cand_valid, 2, phrase=True)
    got = np.unique(cand_vals.numpy()[match.numpy()]) - 1
    assert np.array_equal(got, np.asarray([10, top - 3])), got
    rv, rvalid = ref_gen(ref_idx, jnp.asarray(qt.numpy()[:, 0]), 0)
    rmatch = ref_engine._probe_terms(ref_idx, jnp.asarray(qt.numpy()), jnp.asarray(ql.numpy()),
                                     rv, rvalid, 2, phrase=True)
    assert np.array_equal(cand_vals.numpy(), np.asarray(rv))
    assert np.array_equal(match.numpy(), np.asarray(rmatch))


BOUNDARY_LENGTHS = (MAX_CAND_ROWS - 1, MAX_CAND_ROWS, MAX_CAND_ROWS + 1, 3 * MAX_CAND_ROWS)
N_DOCS = 3 * MAX_CAND_ROWS + 8


@pytest.fixture(scope="module")
def boundary():
    """Word ``w<L>`` occurs in exactly docs [0, L), ``common`` in every doc;
    ``max_rules=0`` makes every posting one C entry, so the sweep needs
    ceil(L / MAX_CAND_ROWS) windows."""
    docs = [" ".join(["common"] + [f"w{L}" for L in BOUNDARY_LENGTHS if d < L])
            for d in range(N_DOCS)]
    idx = NonPositionalIndex.build(docs, store="repair", max_rules=0)
    return idx, {lay: engine.BatchedServer.from_index(idx, layout=lay, device="cpu")
                 for lay in ("dense", "fused")}


@pytest.mark.parametrize("layout", ["dense", "fused"])
@pytest.mark.parametrize("length", BOUNDARY_LENGTHS)
def test_windows_beyond_the_first(boundary, length, layout):
    idx, by_layout = boundary
    server = by_layout[layout]
    assert server.c_entries(idx.word_id(f"w{length}")) == length
    host = Session(idx)
    q = [f"w{length}", "common"]
    before = server.windows_swept
    got = server.conjunctive([q])[0]
    assert server.windows_swept - before == -(-length // MAX_CAND_ROWS)
    assert np.array_equal(got, np.arange(length))
    assert np.array_equal(got, host._conjunctive(q))
    assert np.array_equal(server.doclist([q])[0], host._doc_list(q))
    assert np.array_equal(server.topk([q], k=70)[0], host._ranked_and(q, k=70))


def test_phrase_sweep_at_exact_window_multiple():
    """Phrase probing where the driving list is an exact multiple of the
    window (no partial final window to hide truncation)."""
    n = 4 * MAX_CAND_ROWS
    a = np.arange(n, dtype=np.int64) * 3
    b = a[::2] + 1
    for idx in (port_anchors.build_anchored([a, b], max_rules=0, device="cpu"),
                port_anchors.build_compressed_anchored([a, b], max_rules=0,
                                                       device="cpu")):
        qt = torch.tensor([[0, 1]], dtype=torch.int32)
        ql = torch.tensor([2], dtype=torch.int32)
        hits = []
        for w in range(4):
            gen = (engine.fused_candidates_for
                   if isinstance(idx, port_anchors.CompressedAnchoredIndex)
                   else engine.candidates_for)
            vals, valid = gen(idx, qt[:, 0], w * MAX_CAND_ROWS)
            match = engine._probe_terms(idx, qt, ql, vals, valid, 2, phrase=True)
            hits.append(vals[0][match[0]].numpy() - 1)
        assert np.array_equal(np.concatenate(hits), a[::2])


def test_step_cache_counts_shapes_not_calls(servers):
    _, shared = servers["np", "fused"]
    port = engine.BatchedServer(host_index=shared.host_index, arrays=shared.arrays,
                                n_docs=shared.n_docs, layout="fused",
                                max_phrase=shared.max_phrase)  # fresh step cache
    qs = _queries(servers, "np")
    start = port.trace_count
    port.conjunctive(qs, width=4)
    port.conjunctive(qs, width=4)
    assert port.trace_count == start + 1
    after = port.trace_count
    port.topk(qs, k=2, width=4)
    port.doclist(qs, width=4)
    assert port.trace_count == after + 2  # new (topk, doclist) shapes
    port.topk(qs, k=2, width=4)
    assert port.trace_count == after + 2


def test_encode_rejects_narrow_width(servers):
    _, port = servers["np", "dense"]
    with pytest.raises(ValueError, match="width 2 < longest"):
        port.encode([["a", "b", "c"]], width=2)
