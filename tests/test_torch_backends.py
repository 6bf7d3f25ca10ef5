"""All 24 backends, built twice — by the JAX package and by the port — on the
same seeded inputs: the registry's metadata, every codec's encoded bytes,
every store's exported arrays, size and lists, restores of the reference's
exported state, the LZ parses, suffix arrays and self-indexes, and one mixed
query batch per backend through ``Session``.  Integers and bytes: tolerance
0.  (``vbyte_lzma`` holds ``lzma`` output, which depends on the system's
liblzma; both packages run here in one process, on one liblzma.)"""

import dataclasses

import numpy as np
import pytest

from repro.core import registry as ref_registry
from repro.core.codecs import CODEC_REGISTRY as REF_CODECS
from repro.core.index import NonPositionalIndex as RefNonPositional
from repro.core.index import PositionalIndex as RefPositional
from repro.core.lz import lz77_parse as ref_lz77_parse
from repro.core.lz import lzend_parse as ref_lzend_parse
from repro.core.selfindex import LZ77Index as RefLZ77Index
from repro.core.selfindex import LZEndIndex as RefLZEndIndex
from repro.core.selfindex import RLCSA as RefRLCSA
from repro.core.selfindex import SLPIndex as RefSLPIndex
from repro.core.selfindex import WCSA as RefWCSA
from repro.core.selfindex import WSLPIndex as RefWSLPIndex
from repro.core.suffix import bwt_from_sa as ref_bwt_from_sa
from repro.core.suffix import suffix_array as ref_suffix_array
from repro.data import generate_collection
from repro.serving.session import Session as RefSession
from repro_torch.core import registry
from repro_torch.core.codecs import CODEC_REGISTRY
from repro_torch.core.dgaps import from_dgaps
from repro_torch.core.index import NonPositionalIndex, PositionalIndex
from repro_torch.core.lz import lz77_parse, lzend_parse
from repro_torch.core.selfindex import RLCSA, WCSA, LZ77Index, LZEndIndex, SLPIndex, WSLPIndex
from repro_torch.core.suffix import bwt_from_sa, suffix_array
from repro_torch.data.queries import sample_traffic
from repro_torch.serving.session import Session

REF_NAMES = ref_registry.backend_names()
SELFINDEX = ref_registry.backend_names(family=ref_registry.FAMILY_SELFINDEX)


def _store_kw(name: str) -> dict:
    """``rlz`` signs its lists on a device that its caller names."""
    return {"device": "cpu"} if name == "rlz" else {}


def _same_arrays(a: dict, b: dict, what):
    assert list(a) == list(b), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), (what, k)


def _same_value(a, b) -> bool:
    """Deep equality over dataclasses (an ``EncodedList`` and the parts it
    nests), dicts, sequences, arrays, bytes and scalars; array dtypes and
    shapes must agree too."""
    if dataclasses.is_dataclass(a):
        return (type(a).__name__ == type(b).__name__
                and _same_value(dataclasses.asdict(a), dataclasses.asdict(b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same_value(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_value(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------
def test_backend_names_equal_reference():
    assert registry.backend_names() == REF_NAMES
    assert len(REF_NAMES) == 24
    for family in (ref_registry.FAMILY_INVERTED, ref_registry.FAMILY_SELFINDEX):
        assert registry.backend_names(family=family) == ref_registry.backend_names(family=family)
    for group in ("traditional", "ours", "selfindex"):
        assert registry.backend_names(group=group) == ref_registry.backend_names(group=group)


@pytest.mark.parametrize("name", REF_NAMES)
def test_backend_spec_equals_reference(name):
    got, want = registry.get_backend_spec(name), ref_registry.get_backend_spec(name)
    for field in ("family", "group", "paper", "doc", "capabilities", "defaults"):
        assert getattr(got, field) == getattr(want, field), (name, field)
    assert (got.restore is None) == (want.restore is None), name
    # the one difference: rlz's build takes the device its mining runs on
    extra = ("device",) if name == "rlz" else ()
    assert got.build_kwargs == want.build_kwargs + extra, name


# ----------------------------------------------------------------------
# codecs: the cases of tests/test_codecs.py, seeded
# ----------------------------------------------------------------------
ADVERSARIAL_GAPS = {
    "single_min": [1],
    "single_max32": [2**32 - 1],
    "two_extremes": [1, 2**32 - 1],
    "all_equal_small": [7] * 50,
    "all_equal_ones": [1] * 65,
    "all_equal_max32": [2**32 - 1] * 33,
    "max32_mixed": [1, 2**32 - 1, 1, 2**31, 2**31 - 1, 2**32 - 1],
    "powers_of_two": [2**k for k in range(32)],
    "ramp_then_run": list(range(1, 40)) + [1] * 40,
    "empty": [],
}


def _random_gaps(seed: int) -> list[int]:
    """The mixture of tests/test_codecs.py's strategy: runs of 1, small,
    medium and huge gaps."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 301))
    kinds = rng.integers(0, 4, n)
    vals = np.select([kinds == 0, kinds == 1, kinds == 2],
                     [1, rng.integers(1, 11, n), rng.integers(1, 2**20 + 1, n)],
                     rng.integers(2**20, 2**30 + 1, n))
    return vals.tolist()


CODEC_CASES = {**ADVERSARIAL_GAPS, **{f"random{s}": _random_gaps(s) for s in range(3)}}


def test_codec_registry_equals_reference():
    assert sorted(CODEC_REGISTRY) == sorted(REF_CODECS)


@pytest.mark.parametrize("codec", sorted(REF_CODECS))
@pytest.mark.parametrize("pattern", sorted(CODEC_CASES))
def test_codec_same_bytes_and_roundtrip(codec, pattern):
    g = np.asarray(CODEC_CASES[pattern], dtype=np.int64)
    port, ref = CODEC_REGISTRY[codec](), REF_CODECS[codec]()
    got, want = port.encode(g), ref.encode(g)
    assert _same_value(got, want), (codec, pattern)
    dec = port.decode(got)
    assert dec.dtype == g.dtype and np.array_equal(dec, g), (codec, pattern)
    assert np.array_equal(port.decode(want), g)  # the reference's encoding decodes too
    if len(g):
        assert np.array_equal(port.decode_absolute(got), from_dgaps(g))


# ----------------------------------------------------------------------
# every backend: stores built from one collection
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def collection():
    return generate_collection(n_articles=3, versions_per_article=6, words_per_doc=60,
                               edit_rate=0.1, seed=7)


@pytest.fixture(scope="module")
def built(collection):
    """``built(name)``: (port non-positional, port positional, reference
    non-positional, reference positional) indexes over ``collection`` with
    backend ``name``, each built once per module."""
    cache = {}

    def get(name: str):
        if name not in cache:
            docs, kw = collection.docs, _store_kw(name)
            cache[name] = (NonPositionalIndex.build(docs, store=name, **kw),
                           PositionalIndex.build(docs, store=name, **kw),
                           RefNonPositional.build(docs, store=name),
                           RefPositional.build(docs, store=name))
        return cache[name]

    return get


@pytest.mark.parametrize("which", ["nonpositional", "positional"])
@pytest.mark.parametrize("name", REF_NAMES)
def test_store_equals_reference(built, name, which):
    idx, pidx, ref_idx, ref_pidx = built(name)
    got, want = (idx, ref_idx) if which == "nonpositional" else (pidx, ref_pidx)
    assert got.vocab.id_to_token == want.vocab.id_to_token
    assert type(got.store).__name__ == type(want.store).__name__
    assert got.store.size_in_bits == want.store.size_in_bits
    assert got.size_in_bits == want.size_in_bits
    _same_arrays(got.store.to_arrays(), want.store.to_arrays(), (name, which))
    assert got.store.n_lists == want.store.n_lists > 0
    for i in range(got.store.n_lists):
        assert np.array_equal(got.store.get_list(i), want.store.get_list(i)), (name, which, i)
    assert got.store_kw == want.store_kw


@pytest.mark.parametrize("name", REF_NAMES)
def test_restore_from_reference_state(built, name):
    """State exported by the JAX package restores in the port and answers as
    the reference store does."""
    _, _, _, ref_pidx = built(name)
    want = ref_pidx.store
    got = registry.restore_backend(name, want.to_arrays(), **_store_kw(name))
    assert got.size_in_bits == want.size_in_bits
    _same_arrays(got.to_arrays(), want.to_arrays(), name)
    for i in range(want.n_lists):
        assert np.array_equal(got.get_list(i), want.get_list(i)), (name, i)


# ----------------------------------------------------------------------
# LZ parses, suffix arrays, self-indexes: the inputs of tests/test_lz.py and
# tests/test_selfindex.py
# ----------------------------------------------------------------------
def reptext(seed, nb=100, nc=6, sigma=6, noise=0.04):
    rng = np.random.default_rng(seed)
    base = rng.integers(1, sigma, nb)
    parts = [base]
    for _ in range(nc):
        c = base.copy()
        m = rng.random(nb) < noise
        c[m] = rng.integers(1, sigma, m.sum())
        parts.append(c)
    return np.concatenate(parts)


def _lz_texts() -> dict:
    rng = np.random.default_rng(0)
    base4, base8 = rng.integers(0, 4, 100), rng.integers(0, 8, 300)
    texts = {f"random{n}": rng.integers(0, 8, n) for n in (1, 2, 37, 400)}
    texts["lzend_sources"] = np.concatenate([base4] * 5 + [rng.integers(0, 4, 50)])
    texts["repeated"] = np.concatenate([base8] * 8)
    texts["reptext"] = reptext(11)
    return {k: v.astype(np.int64) for k, v in texts.items()}


LZ_TEXTS = _lz_texts()


@pytest.mark.parametrize("text", sorted(LZ_TEXTS))
def test_lz_parses_and_suffix_array_equal_reference(text):
    t = LZ_TEXTS[text]
    for port, ref in ((lz77_parse, ref_lz77_parse), (lzend_parse, ref_lzend_parse)):
        got, want = port(t), ref(t)
        for f in dataclasses.fields(want):
            assert np.array_equal(getattr(got, f.name), getattr(want, f.name)), (text, f.name)
        assert got.size_in_bits() == want.size_in_bits()
        assert np.array_equal(got.decode(), t)
        if len(t) > 1:
            assert np.array_equal(got.extract(1, len(t) - 1), want.extract(1, len(t) - 1))
    sa = suffix_array(t)
    assert np.array_equal(sa, ref_suffix_array(t))
    assert np.array_equal(bwt_from_sa(t, sa), ref_bwt_from_sa(t, sa))


SELF_INDEXES = {"RLCSA": (RLCSA, RefRLCSA), "WCSA": (WCSA, RefWCSA),
                "LZ77Index": (LZ77Index, RefLZ77Index),
                "LZEndIndex": (LZEndIndex, RefLZEndIndex),
                "SLPIndex": (SLPIndex, RefSLPIndex), "WSLPIndex": (WSLPIndex, RefWSLPIndex)}


@pytest.mark.parametrize("check", ["locate", "extract", "absent"])
@pytest.mark.parametrize("cls", sorted(SELF_INDEXES))
def test_selfindex_equals_reference(cls, check):
    port_cls, ref_cls = SELF_INDEXES[cls]
    seed = {"locate": 11, "extract": 12, "absent": 13}[check]
    t = reptext(seed, sigma=4 if check == "absent" else 6)
    got, want = port_cls(t), ref_cls(t)
    assert got.size_in_bits == want.size_in_bits
    rng = np.random.default_rng(seed)
    if check == "locate":
        pats = [t[0:1], t[5:8], t[60:66], np.asarray([4, 4, 4, 4])]
        for _ in range(4):
            i = int(rng.integers(0, len(t) - 6))
            pats.append(t[i: i + int(rng.integers(2, 6))])
        for p in pats:
            assert np.array_equal(got.locate(p), want.locate(p)), (cls, p.tolist())
            assert got.count(p) == want.count(p)
    elif check == "extract":
        for _ in range(8):
            i = int(rng.integers(0, len(t) - 1))
            j = int(rng.integers(i, min(len(t) - 1, i + 40)))
            assert np.array_equal(got.extract(i, j), want.extract(i, j)), (cls, i, j)
    else:
        p = np.asarray([7, 8, 9])  # symbols the text never uses
        assert got.count(p) == want.count(p) == 0
        assert len(got.locate(p)) == len(want.locate(p)) == 0


# ----------------------------------------------------------------------
# Session: one mixed batch per backend
# ----------------------------------------------------------------------
def mixed_batch(docs, idx, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    words = sorted(idx.vocab.token_to_id)
    qs = []
    for mix in ("word", "and", "phrase", "topk", "docs", "docs-phrase"):
        for n_terms in (2, 3):
            qs += sample_traffic(mix, 2, docs, words, rng, n_terms=n_terms, k=3)
    toks = docs[1].split()
    qs += [" ".join(toks[:2]), " ".join(toks[5:8]), f'"{toks[3]} {toks[4]}"',
           f"top5: {toks[0]} {toks[3]}", f"docs: {toks[2]} {toks[4]}",
           f'docs: "{toks[6]} {toks[7]}"', "zzz-missing " + toks[0]]
    return [qs[i] for i in rng.permutation(len(qs))]


@pytest.mark.parametrize("name", REF_NAMES)
def test_session_equals_reference(collection, built, name):
    """The port's device session (``device="cpu"``) where the backend is
    inverted, its host-only session where it is a self-index, against the
    reference's ``Session`` over the same indexes."""
    idx, pidx, ref_idx, ref_pidx = built(name)
    batch = mixed_batch(collection.docs, idx, seed=17)
    ref = RefSession(ref_idx, positional=ref_pidx)
    host = Session(idx, positional=pidx)
    port = Session.build(idx, positional=pidx, device="cpu")
    served = (port.server is not None, port.positional_server is not None)
    assert served == ((False, False) if name in SELFINDEX else (True, True)), name
    got, want, seq = port.execute(batch), ref.execute(batch), host.execute(batch)
    for q, g, w, h in zip(batch, got, want, seq):
        assert isinstance(g, np.ndarray) and g.dtype == np.asarray(w).dtype, (name, q)
        assert np.array_equal(g, w), (name, q, g.tolist(), np.asarray(w).tolist())
        assert np.array_equal(h, w), (name, q)
    assert sum(len(g) > 0 for g in got) > len(batch) // 3  # not vacuous
    if name not in SELFINDEX:
        assert port.device_batches > 0
