"""Version mining and the ``rlz`` backend: the port against the JAX package
on the same seeded NumPy inputs, tolerance 0 throughout — LSH bucket keys,
cluster labels and heads, ``leader_assign`` and the ``rlz`` bit stream all
hang on bit-exact signatures, so one differing bit would show."""

import numpy as np
import pytest
import torch

from repro.core.index import NonPositionalIndex as RefNonPositional
from repro.core.rlz_store import RLZStore as RefRLZStore
from repro.core.similarity import MinHashConfig as RefMinHashConfig
from repro.core.similarity import SimilarityIndex as RefSimilarityIndex
from repro.core.similarity import minhash as ref_minhash
from repro.kernels.minhash_sig import ops as ref_ops
from repro.serving.session import Session as RefSession
from repro_torch.core.index import NonPositionalIndex
from repro_torch.core.rlz_store import RLZStore
from repro_torch.core.similarity import MinHashConfig, SimilarityIndex
from repro_torch.core.similarity import minhash
from repro_torch.data import generate_collection
from repro_torch.data.queries import sample_traffic
from repro_torch.data.text import tokenize
from repro_torch.kernels.minhash_sig import ops
from repro_torch.serving.session import Session


@pytest.fixture(scope="module")
def collection():
    return generate_collection(n_articles=6, versions_per_article=8,
                               words_per_doc=120, seed=5)


@pytest.fixture(scope="module")
def mined(collection):
    docs = collection.docs
    return (NonPositionalIndex.build(docs, mine_similarity=True, device="cpu"),
            RefNonPositional.build(docs, mine_similarity=True))


@pytest.fixture(scope="module")
def rlz(collection):
    docs = collection.docs
    return (NonPositionalIndex.build(docs, store="rlz", device="cpu"),
            RefNonPositional.build(docs, store="rlz"))


def _tile(d: int, l: int, p: int, seed: int):
    """A shingle tile with garbage past every row's length, rows with
    ``lens == 0``, the extreme shingles 0 and 0xFFFFFFFF, and an ``a`` with
    its top bit set."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2**32, (d, l), dtype=np.uint32)
    lens = rng.integers(0, l + 1, d)
    lens[::4] = 0
    if l:
        s[:, 0] = 0
        s[1::3, -1] = 0xFFFFFFFF
        lens[2::5] = l
    a, b = ops.hash_params(p, seed)
    a[0] |= np.uint32(0x80000000)
    return s, lens, a, b


@pytest.mark.parametrize("num_perm,seed", [(1, 0), (64, 0), (200, 9)])
def test_hash_params_equal(num_perm, seed):
    for x, y in zip(ops.hash_params(num_perm, seed), ref_ops.hash_params(num_perm, seed)):
        assert x.dtype == y.dtype == np.uint32 and np.array_equal(x, y)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_shingling_equal(k):
    rng = np.random.default_rng(k)
    seqs = [rng.integers(0, 50, n) for n in (0, 1, 2, 3, 4, 17, 200)]
    for seq in seqs:
        got, want = minhash.shingle_hashes(seq, k), ref_minhash.shingle_hashes(seq, k)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(minhash.element_hashes(seq), ref_minhash.element_hashes(seq))
    sets = [minhash.shingle_hashes(s, k) for s in seqs]
    for x, y in zip(minhash.pack_shingles(sets), ref_minhash.pack_shingles(sets)):
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize("p", [1, 64])
@pytest.mark.parametrize("l", [0, 1, 127, 128, 129])
@pytest.mark.parametrize("d", [0, 1, 63, 64, 65])
def test_signatures_equal_reference_oracle(d, l, p):
    s, lens, a, b = _tile(d, l, p, seed=d * 1000 + l * 10 + p)
    got = ops.minhash_signatures(s, lens, a, b, device="cpu")
    want = ref_ops.minhash_signatures(s, lens, a, b, backend="ref")
    assert got.dtype == np.uint32 and got.shape == (d, p)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("d,l,p", [(65, 129, 1), (1, 127, 64)])
def test_signatures_equal_pallas_kernel(d, l, p):
    """Against the Pallas kernel itself, in interpret mode on the CPU."""
    s, lens, a, b = _tile(d, l, p, seed=3)
    got = ops.minhash_signatures(s, lens, a, b, device="cpu")
    assert np.array_equal(got, ref_ops.minhash_signatures(s, lens, a, b, backend="kernel"))


def _skewed_tile(p: int):
    """One tile like the ``rlz`` call's: 40 rows of 1 to 30 lanes beside one
    of 650 (longer than one chunk of the kernel), with lens 0, 1, L and
    past L, garbage past every row's length."""
    rng = np.random.default_rng(p)
    d, l = 40, 700
    assert l > ops.CHUNK_LANES
    s = rng.integers(0, 2**32, (d, l), dtype=np.uint32)
    lens = rng.integers(1, 31, d)
    lens[0], lens[1:5] = 650, [0, 1, l, l + 9]
    s[2, 0] = 0xFFFFFFFF
    a, b = ops.hash_params(p, p)
    a[0] |= np.uint32(0x80000000)
    return s, lens, a, b


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("p", [1, 63, 65])
def test_skewed_tile_equals_reference(p, backend):
    """The plain version on a skewed tile equals the reference's oracle and
    its Pallas kernel (interpret mode on the CPU) bit for bit.  The Pallas
    op is handed lengths past L as L: it pads L to its lane tile and would
    read the zero padding as live lanes
    (``test_reference_kernel_reads_its_padding_past_l``)."""
    s, lens, a, b = _skewed_tile(p)
    got = ops.minhash_signatures(s, lens, a, b, device="cpu")
    ref_lens = np.minimum(lens, s.shape[1]) if backend == "kernel" else lens
    want = ref_ops.minhash_signatures(s, ref_lens, a, b, backend=backend)
    assert got.shape == (40, p) and np.array_equal(got, want)
    assert (got[1] == 0xFFFFFFFF).all()  # lens 0: the empty signature


def test_reference_kernel_reads_its_padding_past_l():
    """A fault of the reference: with lens[d] > L its Pallas op pads L to a
    multiple of its lane tile with zeros and reads them as live lanes, so a
    zero shingle enters the row's minimum; its own oracle, and the port,
    read the L lanes only."""
    s = np.full((1, 100), 3, dtype=np.uint32)  # a * 3 + 0 is odd, never 0
    lens = np.array([110])
    a, b = np.array([5], dtype=np.uint32), np.array([0], dtype=np.uint32)
    got = ops.minhash_signatures(s, lens, a, b, device="cpu")
    assert got[0, 0] == 15
    assert ref_ops.minhash_signatures(s, lens, a, b, backend="ref")[0, 0] == 15
    assert ref_ops.minhash_signatures(s, lens, a, b, backend="kernel")[0, 0] == 0


@pytest.mark.parametrize("l,route", [(0, "one_pass"), (455, "one_pass"),
                                     (ops.CHUNK_LANES, "one_pass"),
                                     (ops.CHUNK_LANES + 1, "chunked"), (4000, "chunked")])
def test_minhash_rows_route(l, route):
    """A tile whose rows all fit one chunk takes one launch; a wider one the
    clearing kernel and the chunked signature kernel."""
    assert ops.minhash_rows_route(torch.zeros((3, l), dtype=torch.int32)) == route


def test_plain_version_on_int32_bits():
    """The wrapper's own contract on int32 tensors: uint32 bits in and out,
    lengths past the row read as the whole row, negative ones as empty."""
    s, lens, a, b = _tile(9, 7, 5, seed=4)
    lens[3], lens[4] = 99, -2
    as_i32 = lambda x: torch.from_numpy(np.ascontiguousarray(x).view(np.int32))  # noqa: E731
    got = ops.minhash_rows(as_i32(s), torch.from_numpy(lens.astype(np.int32)),
                           as_i32(a), as_i32(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (9, 5)
    want = ref_ops.minhash_signatures(s, np.clip(lens, 0, None), a, b, backend="ref")
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert (got[4] == -1).all()  # 0xFFFFFFFF: the empty signature


def _same_similarity(got, want):
    for k in ("sigs", "n_shingles", "labels", "heads"):
        x, y = getattr(got, k), getattr(want, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert got.config.config() == want.config.config()
    assert np.array_equal(got.cluster_order(), want.cluster_order())
    for d in range(want.n_docs):
        assert np.array_equal(got.similar(d), want.similar(d)), d
        assert np.array_equal(got.versions_of(d), want.versions_of(d)), d
        assert got.head_of(d) == want.head_of(d), d
    assert got.size_in_bits == want.size_in_bits


def test_mined_index_equals_reference(mined, collection):
    got, want = mined[0].similarity, mined[1].similarity
    _same_similarity(got, want)
    assert got.n_clusters == want.n_clusters > 1
    assert got.purity(collection.article_of) == want.purity(collection.article_of)


@pytest.mark.parametrize("config", [dict(num_perm=32, shingle=2, bands=8, threshold=0.4,
                                         seed=3),
                                    dict(num_perm=64, shingle=1, bands=32, threshold=0.6,
                                         seed=1)])
def test_mine_and_merge_equal_reference(mined, collection, config):
    idx = mined[0]
    terms = []
    for doc in collection.docs:
        kept = (idx.analyzer.normalize(t) for t in tokenize(doc))
        terms.append(np.asarray([idx.vocab.get(w) for w in kept if w is not None],
                                dtype=np.int64))
    got = SimilarityIndex.mine(terms, MinHashConfig(**config), device="cpu")
    want = RefSimilarityIndex.mine(terms, RefMinHashConfig(**config))
    _same_similarity(got, want)
    half = len(terms) // 2
    got_m = SimilarityIndex.merge([
        SimilarityIndex.mine(terms[:half], MinHashConfig(**config), device="cpu"),
        SimilarityIndex.mine(terms[half:], MinHashConfig(**config), device="cpu")])
    want_m = RefSimilarityIndex.merge([
        RefSimilarityIndex.mine(terms[:half], RefMinHashConfig(**config)),
        RefSimilarityIndex.mine(terms[half:], RefMinHashConfig(**config))])
    _same_similarity(got_m, want_m)


def test_from_arrays_carries_reference_state(mined):
    want = mined[1].similarity
    got = SimilarityIndex.from_arrays(want.to_arrays(), MinHashConfig.from_config(
        want.config.config()))
    _same_similarity(got, want)
    for k, v in got.to_arrays().items():
        assert np.array_equal(v, want.to_arrays()[k]), k


def _same_rlz(got, want, lists):
    assert got._data == want._data
    assert got._payload_bits == want._payload_bits
    for k in ("bit_offsets", "head_ref", "lengths"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.size_in_bits == want.size_in_bits and got.n_heads == want.n_heads
    for i in range(len(lists)):
        assert np.array_equal(got.get_list(i), want.get_list(i)), i
        assert np.array_equal(got.get_list(i), lists[i]), i


def test_rlz_store_equals_reference_on_collection_lists(rlz):
    got, want = rlz[0].store, rlz[1].store
    lists = [want.get_list(i) for i in range(want.n_lists)]
    _same_rlz(got, want, lists)
    assert 0 < got.n_heads < got.n_lists  # some lists really are diffs
    assert rlz[0].store_kw == rlz[1].store_kw == {}
    assert rlz[0].size_in_bits == rlz[1].size_in_bits


@pytest.mark.parametrize("seed", [0, 1])
def test_rlz_store_equals_reference_on_near_copies(seed):
    """Synthetic near-copy lists: a few bases, each copied with a few
    postings added and dropped, plus empty and singleton lists."""
    rng = np.random.default_rng(seed)
    lists = []
    for _ in range(4):
        base = np.unique(rng.integers(0, 3000, 300))
        for _ in range(6):
            keep = base[rng.random(len(base)) > 0.05]
            lists.append(np.unique(np.concatenate([keep, rng.integers(0, 3000, 8)])))
    lists += [np.zeros(0, np.int64), np.asarray([7], np.int64),
              np.arange(100, 400, dtype=np.int64)]
    order = rng.permutation(len(lists))
    lists = [np.asarray(lists[i], dtype=np.int64) for i in order]
    got, want = RLZStore.build(lists, device="cpu"), RefRLZStore.build(lists)
    _same_rlz(got, want, lists)
    assert got.n_heads < len(lists)
    for ids in ([0, 1], [2, 5, 7], [len(lists) - 1, 0]):
        assert np.array_equal(got.intersect_multi(ids), want.intersect_multi(ids))


def test_rlz_session_equals_reference(rlz, collection):
    """A mixed AND / ``top<k>:`` / ``docs:`` batch over an ``rlz`` index: the
    port's device session (the dense layout: ``rlz`` is not device-resident),
    the reference's and the host-only session answer alike."""
    idx, ref_idx = rlz
    docs = collection.docs
    rng = np.random.default_rng(13)
    words = sorted(idx.vocab.token_to_id)
    batch = []
    for mix in ("word", "and", "topk", "docs"):
        for n_terms in (2, 3):
            batch += sample_traffic(mix, 4, docs, words, rng, n_terms=n_terms, k=3)
    toks = [t for t in docs[2].split() if idx.lookup(t) is not None]
    batch += [" ".join(toks[:2]), f"top10: {toks[1]} {toks[3]}", f"docs: {toks[0]} {toks[2]}"]
    port = Session.build(idx, device="cpu")
    ref = RefSession.build(ref_idx)
    host = Session(idx)
    assert port.server.layout == ref.server.layout == "dense"
    assert port.server.device_bytes() == ref.server.device_bytes()
    got, want, seq = port.execute(batch), ref.execute(batch), host.execute(batch)
    for q, g, w, h in zip(batch, got, want, seq):
        assert np.array_equal(g, w) and np.array_equal(g, h), q
    assert port.device_batches > 0
    assert sum(len(g) > 0 for g in got) > len(batch) // 3
    assert port.explain(batch[-1]) == ref.explain(batch[-1])


def test_similar_queries_equal_reference(mined):
    idx, ref_idx = mined
    n = idx.n_docs
    qs = [f"similar:{d}" for d in range(0, n, 3)] + [f"versions-of:{d}" for d in range(1, n, 4)]
    ref = RefSession(ref_idx)
    for sess in (Session(idx), Session.build(idx, device="cpu")):
        got, want = sess.execute(qs), ref.execute(qs)
        for q, g, w in zip(qs, got, want):
            assert np.array_equal(g, w), q
        assert any(len(g) > 1 for g in got)
        for q in ("similar:0", f"versions-of:{n - 1}"):
            assert sess.explain(q) == ref.explain(q)
    for q in (f"similar:{n}", f"versions-of:{n + 7}"):
        with pytest.raises(ValueError, match="out of range") as got_e:
            Session(idx).execute(q)
        with pytest.raises(ValueError) as want_e:
            ref.execute(q)
        assert str(got_e.value) == str(want_e.value)
        assert "similar:<doc_id>" in str(got_e.value)  # names the grammar
    unmined = Session(NonPositionalIndex.build(["a b", "b c"], store="vbyte"))
    ref_unmined = RefSession(RefNonPositional.build(["a b", "b c"], store="vbyte"))
    with pytest.raises(ValueError, match="mine_similarity=True") as got_e:
        unmined.execute("similar:0")
    with pytest.raises(ValueError) as want_e:
        ref_unmined.execute("similar:0")
    assert str(got_e.value) == str(want_e.value)


def test_default_device_without_a_gpu_raises_and_mines_nothing(collection, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device mines there")
    calls = []
    monkeypatch.setattr(ops, "minhash_rows_torch", lambda *a: calls.append(a))
    docs = collection.docs[:6]
    terms = [np.arange(5, dtype=np.int64), np.arange(3, 9, dtype=np.int64)]
    builds = [lambda: NonPositionalIndex.build(docs, mine_similarity=True),
              lambda: NonPositionalIndex.build(docs, store="rlz"),
              lambda: SimilarityIndex.mine(terms),
              lambda: RLZStore.build(terms),
              lambda: minhash.signature_matrix([np.arange(3, dtype=np.uint32)],
                                               MinHashConfig())]
    for build in builds:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            build()
    assert calls == []
    # no kernel, no device: the plain builds need no GPU and no argument
    assert NonPositionalIndex.build(docs).similarity is None
