"""Artifacts and writer directories cross between the two packages.

The same documents are saved (a bundle of both indexes) and ingested (a
three-commit ``IndexWriter`` directory) by one package and opened by the
other, in both directions, for ``repair_skip``, ``vbyte`` and ``rlz`` (the
port restores ``rlz`` on ``device="cpu"``).  What each package writes is
byte-identical — manifests, ``writer.json`` and every blob — and an opened
collection answers a mixed batch exactly as the writing package's own
session does (integers: tolerance 0; ``rank<k>:`` answers are doc ids).
"""

import numpy as np
import pytest

from repro.core.artifact import save_index as ref_save
from repro.core.index import NonPositionalIndex as RefNonPositional
from repro.core.index import PositionalIndex as RefPositional
from repro.core.writer import IndexWriter as RefWriter
from repro.data import generate_collection
from repro.serving.session import Session as RefSession
from repro_torch.core.artifact import save_index
from repro_torch.core.index import NonPositionalIndex, PositionalIndex
from repro_torch.core.writer import IndexWriter
from repro_torch.data.queries import sample_traffic
from repro_torch.serving.session import Session

STORES = ("repair_skip", "vbyte", "rlz")
COMMITS = 3


@pytest.fixture(scope="module")
def docs():
    return generate_collection(n_articles=3, versions_per_article=6,
                               words_per_doc=50, edit_rate=0.1, seed=11).docs


def mixed_batch(docs, seed: int = 4) -> list[str]:
    rng = np.random.default_rng(seed)
    idx = NonPositionalIndex.build(docs, store="vbyte")
    words = sorted(idx.vocab.token_to_id)
    qs = []
    for mix in ("word", "and", "phrase", "topk", "docs", "docs-phrase", "docs-topk", "rank"):
        for n_terms in (2, 3):
            qs += sample_traffic(mix, 2, docs, words, rng, n_terms=n_terms, k=3)
    toks = docs[4].split()
    qs += [" ".join(toks[:2]), f"top4: {toks[1]} {toks[2]}", f"docs: {toks[3]} {toks[5]}",
           f'"{toks[6]} {toks[7]}"', "similar:5", "versions-of:13"]
    return qs


def _mine(store: str) -> bool:
    return store == "repair_skip"  # rlz mines inside its store


def _port_indexes(docs, store):
    return (NonPositionalIndex.build(docs, store=store, mine_similarity=_mine(store),
                                     device="cpu"),
            PositionalIndex.build(docs, store=store, device="cpu"))


def _ref_indexes(docs, store):
    return (RefNonPositional.build(docs, store=store, mine_similarity=_mine(store)),
            RefPositional.build(docs, store=store))


def _batch_for(docs, store):
    qs = mixed_batch(docs)
    return qs if _mine(store) else [q for q in qs if not q.startswith(("similar", "versions"))]


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _write_writer(cls, path, docs, store, **kw):
    w = cls(path, store=store, positional=True, mine_similarity=_mine(store), **kw)
    step = len(docs) // COMMITS
    for lo in range(0, len(docs), step):
        w.add_documents(docs[lo:lo + step])
        w.commit()
    return w


def _assert_same(got, want, batch):
    for q, g, w in zip(batch, got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.int64, q
        assert np.array_equal(g, np.asarray(w)), (q, g.tolist(), np.asarray(w).tolist())
    assert sum(len(g) > 0 for g in got) > len(batch) // 3  # not vacuous


@pytest.mark.parametrize("store", STORES)
def test_both_packages_write_identical_bytes(tmp_path, docs, store):
    """A bundle and a three-commit writer directory, each written by both
    packages from the same documents: the same files, byte for byte."""
    for sub, (np_idx, pos_idx) in (("port", _port_indexes(docs, store)),
                                   ("ref", _ref_indexes(docs, store))):
        saver = save_index if sub == "port" else ref_save
        saver(np_idx, tmp_path / sub / "bundle" / "nonpositional")
        saver(pos_idx, tmp_path / sub / "bundle" / "positional")
    _write_writer(IndexWriter, tmp_path / "port" / "writer", docs, store, device="cpu")
    _write_writer(RefWriter, tmp_path / "ref" / "writer", docs, store)
    for part in ("bundle", "writer"):
        port, ref = _files(tmp_path / "port" / part), _files(tmp_path / "ref" / part)
        assert port.keys() == ref.keys(), part
        differ = [str(k) for k in port if port[k] != ref[k]]
        assert not differ, (part, differ)
    assert len(_files(tmp_path / "port" / "writer" / "segments")) > 2 * COMMITS


@pytest.mark.parametrize("store", STORES)
def test_reference_bundle_opens_under_the_port(tmp_path, docs, store):
    np_idx, pos_idx = _ref_indexes(docs, store)
    ref_save(np_idx, tmp_path / "b" / "nonpositional")
    ref_save(pos_idx, tmp_path / "b" / "positional")
    batch = _batch_for(docs, store)
    want = RefSession(np_idx, positional=pos_idx).execute(batch)
    for mmap in (False, True):
        sess = Session.open(tmp_path / "b", device="cpu", mmap=mmap)
        assert sess.server is not None and "rank" in sess.server.kinds
        _assert_same(sess.execute(batch), want, batch)
        built = Session.build(*_port_indexes(docs, store), device="cpu")
        assert sess.server.device_bytes() == built.server.device_bytes()
        assert sess.positional_server.device_bytes() == built.positional_server.device_bytes()


@pytest.mark.parametrize("store", STORES)
def test_port_bundle_opens_under_the_reference(tmp_path, docs, store):
    np_idx, pos_idx = _port_indexes(docs, store)
    save_index(np_idx, tmp_path / "b" / "nonpositional")
    save_index(pos_idx, tmp_path / "b" / "positional")
    batch = _batch_for(docs, store)
    want = Session.build(np_idx, positional=pos_idx, device="cpu").execute(batch)
    for mmap in (False, True):
        got = RefSession.open(tmp_path / "b", device=False, mmap=mmap).execute(batch)
        _assert_same([np.asarray(g) for g in got], want, batch)


def _term_queries(batch):
    """The queries whose answers do not depend on where segment boundaries
    fell: ``similar:`` signatures hash segment-local term ids, so a
    compacted collection's clusters need not equal a one-shot mining's."""
    return [q for q in batch if not q.startswith(("similar", "versions"))]


@pytest.mark.parametrize("store", STORES)
def test_reference_writer_opens_under_the_port(tmp_path, docs, store):
    """Segmented answers equal the reference's segmented ones; after the
    port compacts the reference's writer, they equal the reference's own
    compaction of the same commits, and a one-shot build's."""
    w = _write_writer(RefWriter, tmp_path / "w", docs, store)
    twin = _write_writer(RefWriter, tmp_path / "twin", docs, store)
    batch = _batch_for(docs, store)
    sess = Session.open(w.path, device="cpu")
    _assert_same(sess.execute(batch), RefSession.open(w.path, device=False).execute(batch),
                 batch)
    assert sess.metrics()["segments"] == COMMITS
    IndexWriter.open(w.path, device="cpu").compact()
    twin.compact()
    assert _files(w.path) == _files(twin.path)
    assert sess.refresh() == 1
    _assert_same(sess.execute(batch), RefSession.open(twin.path, device=False).execute(batch),
                 batch)
    terms = _term_queries(batch)
    _assert_same(sess.execute(terms), RefSession(*_ref_indexes(docs, store)).execute(terms),
                 terms)


@pytest.mark.parametrize("store", STORES)
def test_port_writer_opens_under_the_reference(tmp_path, docs, store):
    w = _write_writer(IndexWriter, tmp_path / "w", docs, store, device="cpu")
    twin = _write_writer(IndexWriter, tmp_path / "twin", docs, store, device="cpu")
    batch = _batch_for(docs, store)
    ref = RefSession.open(w.path, device=False)
    _assert_same([np.asarray(g) for g in ref.execute(batch)],
                 Session.open(w.path, device="cpu").execute(batch), batch)
    RefWriter.open(w.path).compact()
    twin.compact()
    assert _files(w.path) == _files(twin.path)
    assert ref.refresh() == 1
    _assert_same([np.asarray(g) for g in ref.execute(batch)],
                 Session.open(twin.path, device="cpu").execute(batch), batch)
    terms = _term_queries(batch)
    _assert_same([np.asarray(g) for g in ref.execute(terms)],
                 Session(*_port_indexes(docs, store)).execute(terms), terms)
