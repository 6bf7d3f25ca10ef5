"""State built twice — by the JAX package and by the port — is the same
state: seeded collections, Re-Pair grammars, anchored device arrays and
their byte counts, element for element (tolerance 0)."""

import numpy as np
import pytest
import torch

from repro.core import anchors as ref_anchors
from repro.core.index import NonPositionalIndex as RefNonPositional
from repro.core.index import PositionalIndex as RefPositional
from repro.core.registry import backend_names as ref_backend_names
from repro.core.registry import build_backend as ref_build_backend
from repro.core.repair import RePairStore as RefRePairStore
from repro.data import generate_collection as ref_generate_collection
from repro.data.queries import sample_traffic as ref_sample_traffic
from repro_torch.core import anchors as port_anchors
from repro_torch.core.index import NonPositionalIndex, PositionalIndex
from repro_torch.core.registry import backend_names, build_backend, restore_backend
from repro_torch.core.repair import RePairStore
from repro_torch.data import generate_collection
from repro_torch.data.queries import sample_traffic

STORE_ARRAYS = ("c", "c_offsets", "lengths")


def _assert_same_arrays(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


@pytest.mark.parametrize("structure", ["linear", "tree", "chaotic"])
def test_generate_collection_same_documents(structure):
    kw = dict(n_articles=4, versions_per_article=6, words_per_doc=80,
              structure=structure, seed=11)
    a, b = generate_collection(**kw), ref_generate_collection(**kw)
    assert a.docs == b.docs
    assert np.array_equal(a.article_of, b.article_of)


@pytest.mark.parametrize("mix", ["word", "and", "phrase", "topk", "docs", "docs-phrase",
                                 "docs-topk", "rank", "mixed"])
def test_sample_traffic_same_queries(small_collection, mix):
    docs = small_collection.docs
    words = sorted({w for d in docs for w in d.split()})
    a = sample_traffic(mix, 12, docs, words, np.random.default_rng(4), n_terms=3, k=5)
    b = ref_sample_traffic(mix, 12, docs, words, np.random.default_rng(4), n_terms=3, k=5)
    assert a == b


@pytest.mark.parametrize("variant,kw", [("plain", {}), ("skip", {}),
                                        ("skip", {"sampling": ("cm", 8)}),
                                        ("skip", {"sampling": ("st", 64)}),
                                        ("skip", {"max_rules": 5})])
def test_repair_build_same_grammar(rep_lists, variant, kw):
    a = RePairStore.build(rep_lists, variant=variant, **kw)
    b = RefRePairStore.build(rep_lists, variant=variant, **kw)
    for name in STORE_ARRAYS:
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    _assert_same_arrays(a.to_arrays(), b.to_arrays())
    assert a.size_in_bits == b.size_in_bits
    for i in (0, 7, len(rep_lists) - 1):
        assert np.array_equal(a.get_list(i), rep_lists[i])


def test_repair_from_arrays_accepts_reference_export(rep_lists):
    ref = RefRePairStore.build(rep_lists, variant="skip")
    got = RePairStore.from_arrays(ref.to_arrays(), variant="skip")
    _assert_same_arrays(got.to_arrays(), ref.to_arrays())
    for i in range(len(rep_lists)):
        assert np.array_equal(got.get_list(i), rep_lists[i])
    assert np.array_equal(got.intersect_multi([0, 1, 2]), ref.intersect_multi([0, 1, 2]))


DENSE = ("anchors", "c_offsets", "expand", "expand_valid", "lengths")
FUSED = ("anchors", "c_offsets", "c_ptr", "c_len", "pool", "lengths")


def _same_index(port_idx, ref_idx, fields):
    for k in fields:
        x, y = getattr(port_idx, k), np.asarray(getattr(ref_idx, k))
        assert x.dtype == (torch.bool if k == "expand_valid" else torch.int32), k
        assert tuple(x.shape) == y.shape and np.array_equal(x.numpy(), y), k
    assert port_idx.device_bytes() == ref_idx.device_bytes()


@pytest.mark.parametrize("expand_len", [4, 32])
def test_anchored_from_store_same_arrays(rep_lists, expand_len):
    store = RePairStore.build(rep_lists, variant="skip")
    ref_store = RefRePairStore.build(rep_lists, variant="skip")
    a = port_anchors.AnchoredIndex.from_store(store, expand_len=expand_len,
                                              device="cpu")
    b = ref_anchors.AnchoredIndex.from_store(ref_store, expand_len=expand_len)
    _same_index(a, b, DENSE)
    assert a.expand_len == b.expand_len


def test_compressed_from_store_same_arrays(rep_lists):
    store = RePairStore.build(rep_lists, variant="skip")
    ref_store = RefRePairStore.build(rep_lists, variant="skip")
    a = port_anchors.CompressedAnchoredIndex.from_store(store, device="cpu")
    b = ref_anchors.CompressedAnchoredIndex.from_store(ref_store)
    _same_index(a, b, FUSED)
    assert a.max_phrase == b.max_phrase
    # the tail padding the in-kernel row read relies on
    assert a.pool[-a.max_phrase:].eq(0).all()
    assert int((a.c_ptr + a.c_len).max()) <= a.pool.shape[0] - a.max_phrase


def test_build_helpers_and_empty_lists():
    lists = [np.asarray([2, 5, 9], np.int64), np.zeros(0, np.int64),
             np.asarray([0, 1, 2, 3, 4, 5, 6, 7], np.int64)]
    _same_index(port_anchors.build_anchored(lists, device="cpu"),
                ref_anchors.build_anchored(lists), DENSE)
    _same_index(port_anchors.build_compressed_anchored(lists, device="cpu"),
                ref_anchors.build_compressed_anchored(lists), FUSED)


def test_from_numpy_round_trip(rep_lists):
    ref = ref_anchors.build_compressed_anchored(rep_lists[:8])
    arrays = {k: np.asarray(getattr(ref, k)) for k in FUSED}
    got = port_anchors.CompressedAnchoredIndex.from_numpy(
        {**arrays, "max_phrase": ref.max_phrase}, device="cpu")
    _same_index(got, ref, FUSED)
    refd = ref_anchors.build_anchored(rep_lists[:8])
    gotd = port_anchors.AnchoredIndex.from_numpy(
        {k: np.asarray(getattr(refd, k)) for k in DENSE}, device="cpu")
    _same_index(gotd, refd, DENSE)
    assert gotd.expand_len == refd.expand_len


@pytest.mark.parametrize("build", [port_anchors.AnchoredIndex.from_store,
                                   port_anchors.CompressedAnchoredIndex.from_store])
def test_from_store_keeps_store_state(rep_lists, build):
    store = RePairStore.build(rep_lists[:6], variant="skip")
    assert store.memoize is False and store._memo == {}
    build(store, device="cpu")
    assert store.memoize is False, "build leaked memoize=True into the store"
    assert store._memo == {}, "build leaked its expansion cache into the store"
    store.memoize = True
    store.expand_symbol(int(store.c[0]))
    cached = dict(store._memo)
    build(store, device="cpu")
    assert store.memoize is True
    assert set(cached).issubset(store._memo)


@pytest.mark.parametrize("store", ["repair", "repair_skip", "repair_skip_cm",
                                   "repair_skip_st", "vbyte", "vbyte_cm", "elias_fano",
                                   "rlcsa"])
def test_indexes_same_vocab_and_lists(small_collection, store):
    docs = small_collection.docs[:16]
    a, b = NonPositionalIndex.build(docs, store=store), RefNonPositional.build(docs, store=store)
    pa, pb = PositionalIndex.build(docs, store=store), RefPositional.build(docs, store=store)
    for x, y in ((a, b), (pa, pb)):
        assert x.vocab.id_to_token == y.vocab.id_to_token
        assert x.store.n_lists == y.store.n_lists
        assert x.size_in_bits == y.size_in_bits
        assert x.stats() == y.stats() or vars(x.stats()) == vars(y.stats())
        for i in range(0, x.store.n_lists, 7):
            assert np.array_equal(x.store.get_list(i), y.store.get_list(i))
    assert np.array_equal(pa.doc_starts, pb.doc_starts) and pa.n_tokens == pb.n_tokens
    for f in ("doc_lengths", "run_docs", "run_tfs", "run_offsets", "max_tf"):
        assert np.array_equal(getattr(a.scoring, f), getattr(b.scoring, f)), f


def test_registry_holds_this_slice_only(rep_lists):
    """The port registers the reference's 24 backends, in its order."""
    assert backend_names() == [
        "vbyte", "rice", "rice_runs", "simple9", "pfordelta", "opt_pfd", "elias_fano",
        "ef_opt", "interpolative", "vbyte_lzma", "vbyte_cm", "vbyte_st", "vbyte_cmb",
        "vbyte_stb", "repair", "repair_skip", "repair_skip_cm", "repair_skip_st",
        "vbyte_lzend", "rlz", "rlcsa", "wcsa", "lz77_idx", "lzend_idx"]
    assert backend_names() == ref_backend_names()
    with pytest.raises(ValueError, match="registered backends: ef_opt, elias_fano") as got:
        build_backend("no_such_store", rep_lists)
    with pytest.raises(ValueError) as want:
        ref_build_backend("no_such_store", rep_lists)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unexpected build kwargs"):
        build_backend("repair_skip", rep_lists, k=3)
    store = build_backend("repair_skip_cm", rep_lists, k=16)
    back = restore_backend("repair_skip_cm", store.to_arrays(), k=16)
    assert np.array_equal(back.get_list(3), rep_lists[3])
    # rlz mines on a device that its caller names: the generic restore
    # rebuilds (and so mines again) with the device it is given
    rlz = build_backend("rlz", rep_lists, device="cpu")
    back = restore_backend("rlz", rlz.to_arrays(), device="cpu")
    assert back._data == rlz._data and np.array_equal(back.head_ref, rlz.head_ref)
    with pytest.raises(TypeError, match="device"):
        restore_backend("rlz", rlz.to_arrays())


def test_mine_similarity_is_a_later_slice(small_collection):
    """Version mining came with this slice: the mined index equals the
    reference's, and the persisted ``store_kw`` holds no device."""
    docs = small_collection.docs[:16]
    got = NonPositionalIndex.build(docs, mine_similarity=True, device="cpu")
    want = RefNonPositional.build(docs, mine_similarity=True)
    for k in ("sigs", "n_shingles", "labels", "heads"):
        assert np.array_equal(getattr(got.similarity, k), getattr(want.similarity, k)), k
    assert got.store_kw == want.store_kw == {}
