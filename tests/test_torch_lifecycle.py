"""The index lifecycle on the port: artifact format, storage layer, writer,
streamed collections and the segmented ``Session``.

The scenarios of the reference's ``test_artifact.py``, ``test_storage.py``
and ``test_synthetic.py``, run on ``repro_torch`` with ``device="cpu"``;
where a scenario produces answers they are also held against the reference
package on the same documents (integers: tolerance 0).  Plus what the port
adds: the device never enters a manifest, and a memory-mapped artifact is
never written through.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.index import NonPositionalIndex as RefNonPositional
from repro.core.index import PositionalIndex as RefPositional
from repro.data.synthetic import stream_collection as ref_stream
from repro.serving.session import Session as RefSession
from repro_torch.core.artifact import (
    ArtifactError,
    open_index,
    read_manifest,
    save_index,
)
from repro_torch.core.index import NonPositionalIndex, PositionalIndex
from repro_torch.core.storage import BlobStore, CompactionHandle, MappedListStore
from repro_torch.core.storage.compaction import CompactionError
from repro_torch.core.writer import IndexWriter, is_writer_dir
from repro_torch.data.synthetic import SyntheticSpec, ingest_stream, stream_collection
from repro_torch.serving.session import Session

BASE_SEED = int(os.environ.get("REPRO_DIFF_SEED", "20260727"))

DOCS = ["alpha beta gamma delta", "beta gamma epsilon", "alpha beta beta zeta",
        "gamma delta epsilon zeta", "alpha zeta", "beta delta gamma"]
DOCS_V1 = [
    "alpha beta gamma alpha beta",
    "alpha gamma delta epsilon gamma",
    "zebra quartz zebra nickel quartz",
    "beta delta nickel epsilon beta",
]
DOCS_V2 = [
    "alpha beta alpha gamma beta",
    "delta alpha epsilon beta gamma",
]
QUERIES = ["alpha", "alpha beta", "docs: gamma", "top3: alpha beta",
           "docs-top3: beta", "rank3: alpha delta", "docs: zebra",
           '"alpha beta"', 'docs: "gamma delta"']
SPEC = SyntheticSpec(n_articles=4, versions_per_article=6, words_per_doc=40,
                     vocab_size=200, chunk_docs=5, seed=BASE_SEED % 9973)


def make_writer(tmp_path, store="vbyte", positional=True, both=True, **kw):
    w = IndexWriter(tmp_path / "col", store=store, positional=positional,
                    device="cpu", **kw)
    w.add_documents(DOCS_V1)
    w.commit()
    if both:
        w.add_documents(DOCS_V2)
        w.commit()
    return w


def corrupt_component(artifact_dir, name):
    manifest = json.loads((artifact_dir / "manifest.json").read_text())
    blob = artifact_dir / manifest["components"][name]["file"]
    data = bytearray(blob.read_bytes())
    data[-1] ^= 0xFF
    blob.write_bytes(bytes(data))


def one_shot(docs, store="vbyte"):
    """The reference's host-only session over a one-shot build."""
    return RefSession(RefNonPositional.build(docs, store=store),
                      positional=RefPositional.build(docs, store=store))


def assert_answers(sess, want_sess, queries=QUERIES):
    for q, g, w in zip(queries, sess.execute(queries), want_sess.execute(queries)):
        assert np.array_equal(g, np.asarray(w)), (q, g.tolist(), np.asarray(w).tolist())


@pytest.fixture()
def artifact(tmp_path):
    idx = NonPositionalIndex.build(DOCS, store="vbyte")
    return save_index(idx, tmp_path / "np"), idx


# ----------------------------------------------------------------------
# artifact format + corruption gating
# ----------------------------------------------------------------------
def test_manifest_records_components_and_checksums(artifact):
    root, _ = artifact
    m = read_manifest(root)
    assert m["kind"] == "nonpositional" and m["store"] == "vbyte"
    assert "vocab" in m["components"]
    for name, entry in m["components"].items():
        assert (root / entry["file"]).is_file(), name
        assert len(entry["sha256"]) == 64


def test_corrupted_blob_names_the_component(artifact):
    root, _ = artifact
    m = read_manifest(root)
    name = next(n for n in m["components"] if n.startswith("store."))
    corrupt_component(root, name)
    with pytest.raises(ArtifactError, match=f"checksum mismatch in component '{name}'"):
        open_index(root)


def test_missing_component_blob_is_named(artifact):
    root, _ = artifact
    m = read_manifest(root)
    (root / m["components"]["vocab"]["file"]).unlink()
    with pytest.raises(ArtifactError, match="missing component 'vocab'"):
        open_index(root)


def test_unknown_format_version_rejected(artifact):
    root, _ = artifact
    m = json.loads((root / "manifest.json").read_text())
    m["format_version"] = 99
    (root / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ArtifactError, match="format_version 99"):
        open_index(root)


def test_open_nonexistent_path_is_artifact_error(tmp_path):
    with pytest.raises(ArtifactError, match="manifest.json not found"):
        open_index(tmp_path / "nope")
    with pytest.raises(ArtifactError, match="nothing to open"):
        Session.open(tmp_path, device="cpu")


def test_open_writer_without_commits_is_artifact_error(tmp_path):
    IndexWriter(tmp_path / "ix", store="vbyte", device="cpu")
    with pytest.raises(ArtifactError, match="no committed segments"):
        Session.open(tmp_path / "ix", device="cpu")


def test_positional_roundtrip_keeps_stream_and_stats(tmp_path):
    pidx = PositionalIndex.build(DOCS, store="rice_runs", keep_text=True)
    got = open_index(save_index(pidx, tmp_path / "pos"))
    assert np.array_equal(got.token_stream, pidx.token_stream)
    assert np.array_equal(got.doc_starts, pidx.doc_starts)
    assert got.stats() == pidx.stats()
    assert got.size_in_bits == pidx.size_in_bits


def test_analyzer_mismatch_is_refused(artifact):
    root, idx = artifact
    assert open_index(root, analyzer=idx.analyzer).analyzer.config() == idx.analyzer.config()
    with pytest.raises(ArtifactError, match="analyzer mismatch"):
        open_index(root, analyzer="stemmed")


# ----------------------------------------------------------------------
# writer: resume, config pinning, commit/compact bookkeeping
# ----------------------------------------------------------------------
def test_writer_commit_requires_documents(tmp_path):
    w = IndexWriter(tmp_path / "ix", store="vbyte", device="cpu")
    with pytest.raises(ValueError, match="nothing to commit"):
        w.commit()
    with pytest.raises(ValueError, match="nothing to compact"):
        w.compact()
    with pytest.raises(TypeError, match="document strings"):
        w.add_documents([1, 2])


def test_writer_resume_pins_configuration(tmp_path):
    w = IndexWriter(tmp_path / "ix", store="vbyte_cm", device="cpu", k=8)
    w.add_documents(DOCS[:3])
    w.commit()
    assert is_writer_dir(tmp_path / "ix")
    with pytest.raises(ValueError, match="share one configuration"):
        IndexWriter(tmp_path / "ix", store="rice")
    with pytest.raises(ValueError, match="share one configuration"):
        IndexWriter(tmp_path / "ix", store="vbyte_cm", k=16)
    with pytest.raises(ValueError, match="share one configuration"):
        IndexWriter(tmp_path / "ix", store="vbyte_cm", positional=False, k=8)
    resumed = IndexWriter.open(tmp_path / "ix", device="cpu")
    assert resumed.store == "vbyte_cm" and resumed.store_kw == {"k": 8}
    resumed.add_documents(DOCS[3:])
    seg = resumed.commit()
    assert seg.doc_base == 3 and resumed.n_docs == len(DOCS)


def test_writer_segment_bases_accumulate(tmp_path):
    w = IndexWriter(tmp_path / "ix", store="vbyte", device="cpu")
    for lo in range(0, len(DOCS), 2):
        w.add_documents(DOCS[lo:lo + 2])
        w.commit()
    assert [s.doc_base for s in w.segments] == [0, 2, 4]
    token_bases = [s.token_base for s in w.segments]
    assert token_bases == sorted(token_bases) and token_bases[0] == 0
    merged = w.compact()
    assert [s.name for s in w.segments] == [merged.name]
    assert merged.n_docs == len(DOCS) and merged.doc_base == 0
    left = sorted(p.name for p in (tmp_path / "ix" / "segments").iterdir())
    assert left == [merged.name]
    assert_answers(Session.open(tmp_path / "ix", device="cpu"), one_shot(DOCS))


@pytest.mark.parametrize("store", ["vbyte", "rlz"])
def test_writer_manifest_carries_no_device(tmp_path, store):
    """The device is the writer's, not the collection's: neither
    ``writer.json`` nor a segment manifest records it, and a directory
    written with ``device="cpu"`` resumes under another device argument."""
    w = make_writer(tmp_path, store=store, mine_similarity=True)
    text = (w.path / "writer.json").read_text()
    assert "device" not in json.loads(text) and "cpu" not in text
    for seg in w.segments:
        for sub in ("nonpositional", "positional"):
            m = read_manifest(w.segment_dir(seg) / sub)
            assert m["store_kw"] == {} and "cpu" not in json.dumps(m), (seg.name, sub)
    assert IndexWriter.open(w.path, device="cuda").store == store
    assert IndexWriter(w.path, store=store, positional=True, mine_similarity=True,
                       device="meta").n_docs == len(DOCS_V1 + DOCS_V2)


def test_writer_compaction_equals_one_shot_build(tmp_path):
    """Compaction remaps vocab ids in first-occurrence order: the merged
    stores and scoring runs equal a one-shot build."""
    w = make_writer(tmp_path, store="repair_skip", mine_similarity=True)
    w.compact()
    np_idx, pos_idx = w.open_segment(w.segments[0])
    docs = DOCS_V1 + DOCS_V2
    one = NonPositionalIndex.build(docs, store="repair_skip")
    pone = PositionalIndex.build(docs, store="repair_skip")
    assert np_idx.vocab.id_to_token == one.vocab.id_to_token
    for a, b in ((np_idx, one), (pos_idx, pone)):
        assert all(np.array_equal(a.store.get_list(i), b.store.get_list(i))
                   for i in range(a.store.n_lists))
    for k in ("doc_lengths", "run_docs", "run_tfs", "run_offsets", "max_tf"):
        assert np.array_equal(getattr(np_idx.scoring, k), getattr(one.scoring, k)), k
    assert np_idx.similarity.n_docs == len(docs)


# ----------------------------------------------------------------------
# Session.open surface
# ----------------------------------------------------------------------
def test_session_open_single_artifact_and_refresh_guard(tmp_path):
    idx = NonPositionalIndex.build(DOCS, store="vbyte")
    save_index(idx, tmp_path / "np")
    sess = Session.open(tmp_path / "np", device="cpu")
    assert np.array_equal(sess.execute("beta"), idx.query_word("beta"))
    with pytest.raises(ValueError, match="writer directory"):
        sess.refresh()


def test_session_open_segmented_metrics_report_segments(tmp_path):
    w = IndexWriter(tmp_path / "ix", store="vbyte", device="cpu")
    w.add_documents(DOCS[:3])
    w.commit()
    w.add_documents(DOCS[3:])
    w.commit()
    sess = Session.open(tmp_path / "ix", device="cpu")
    out = sess.execute(["beta", "docs: beta gamma"])
    m = sess.metrics()
    assert m["segments"] == 2 and m["queries_executed"] == 2
    for got, want in zip(out, one_shot(DOCS).execute(["beta", "docs: beta gamma"])):
        assert np.array_equal(got, np.asarray(want))
    assert "segments: 2" in sess.explain("beta gamma")
    assert sess.explain("beta gamma", fmt="json")["segments"] == 2
    assert sess.segment_shape == (2,) and sess.primary_index is sess._segments[0].session.index
    assert sess.result_key("beta")[-1] == (2,)


@pytest.mark.parametrize("attach", [True, False])
def test_session_open_arguments_reach_every_segment(tmp_path, attach):
    """``Session.open`` takes ``build``'s arguments, and every refresh
    hands them to the new segments' child sessions."""
    w = make_writer(tmp_path, store="repair_skip", both=False)
    sess = Session.open(w.path, device="cpu", attach=attach, layout="dense",
                        expand_len=16)
    w.add_documents(DOCS_V2)
    w.commit()
    assert sess.refresh() == 1
    for seg in sess._segments:
        srv = seg.session.server
        if attach:
            assert srv.layout == "dense" and srv.device.type == "cpu"
            assert srv.probe == "torch" and seg.session.positional_server is not None
        else:
            assert srv is None and seg.session.positional_server is None
    assert_answers(sess, one_shot(DOCS_V1 + DOCS_V2, "repair_skip"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            Session.open(w.path)  # device defaults to "cuda"


def test_segmented_similar_and_extract(tmp_path):
    w = make_writer(tmp_path, mine_similarity=True, keep_text=True)
    sess = Session.open(w.path, device="cpu")
    ref = RefSession.open(w.path, device=False)
    qs = [f"similar:{d}" for d in range(6)] + [f"versions-of:{d}" for d in (0, 4, 5)]
    assert_answers(sess, ref, qs)
    for q in ('"alpha beta"', "gamma"):
        got, want = sess.extract(q, context=1), ref.extract(q, context=1)
        assert len(got) == len(want) > 0
        assert all(np.array_equal(g, np.asarray(x)) for g, x in zip(got, want))
    with pytest.raises(ValueError, match="out of range") as got:
        sess.execute("similar:99")
    with pytest.raises(ValueError) as want:
        ref.execute("similar:99")
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------------
# mmap open: identity, residency, store selection, read-only maps
# ----------------------------------------------------------------------
def test_mmap_open_serves_mapped_store_byte_identical(tmp_path):
    idx = NonPositionalIndex.build(DOCS_V1 + DOCS_V2, store="vbyte")
    root = save_index(idx, tmp_path / "art")
    eager = open_index(root)
    mapped = open_index(root, mmap=True)
    assert isinstance(mapped.store, MappedListStore)
    assert not isinstance(eager.store, MappedListStore)
    for tid in range(len(idx.vocab)):
        assert np.array_equal(eager.store.get_list(tid), mapped.store.get_list(tid))
        assert eager.store.list_length(tid) == mapped.store.list_length(tid)
    assert mapped.store.n_lists == eager.store.n_lists


@pytest.mark.parametrize("store", ["vbyte", "repair_skip"])
def test_mmap_session_answers_equal_eager(tmp_path, store):
    w = make_writer(tmp_path, store=store)
    eager = Session.open(w.path, device="cpu")
    mapped = Session.open(w.path, device="cpu", mmap=True)
    if store == "repair_skip":  # a restore hook adopts the packed arrays
        assert not isinstance(mapped._segments[0].session.index.store, MappedListStore)
    assert_answers(mapped, eager)
    assert_answers(mapped, one_shot(DOCS_V1 + DOCS_V2, store))


def test_mmap_open_materializes_small_fraction(tmp_path):
    w = make_writer(tmp_path, positional=False)
    sess = Session.open(w.path, device="cpu", mmap=True, attach=False)
    stores = [seg.session.index.blobstore for seg in sess._segments]
    assert stores and all(b.mmap for b in stores)
    frac = sum(b.loaded_nbytes for b in stores) / sum(b.total_nbytes for b in stores)
    assert frac < 0.5, frac
    loaded_before = sum(b.loaded_nbytes for b in stores)
    sess.execute("alpha beta")
    assert sum(b.loaded_nbytes for b in stores) == loaded_before


@pytest.mark.parametrize("store", ["vbyte", "repair_skip"])
def test_mmap_arrays_are_read_only_and_never_written_through(tmp_path, store):
    """Maps open read-only; a server copies what it needs onto its device,
    so writing into every server tensor leaves the files as they were."""
    idx = NonPositionalIndex.build(DOCS_V1 + DOCS_V2, store=store)
    pidx = PositionalIndex.build(DOCS_V1 + DOCS_V2, store=store)
    save_index(idx, tmp_path / "b" / "nonpositional")
    save_index(pidx, tmp_path / "b" / "positional")
    files = {p: p.read_bytes() for p in (tmp_path / "b").rglob("*") if p.is_file()}
    sess = Session.open(tmp_path / "b", device="cpu", mmap=True)
    for ix in (sess.index, sess.positional):
        maps = [v for v in ix.blobstore._cache.values() if isinstance(v, np.ndarray)]
        assert maps and all(not m.flags.writeable for m in maps)
        for m in maps:
            with pytest.raises(ValueError):
                m.flat[0] = m.flat[0]
    want = sess.execute(QUERIES)
    for srv in (sess.server, sess.positional_server):
        for t in srv.arrays.values():
            t.fill_(True if t.dtype == torch.bool else 7)
    assert all(p.read_bytes() == b for p, b in files.items())
    again = Session.open(tmp_path / "b", device="cpu", mmap=True)
    for q, g, w in zip(QUERIES, again.execute(QUERIES), want):
        assert np.array_equal(g, w), q


# ----------------------------------------------------------------------
# verify policies
# ----------------------------------------------------------------------
def test_verify_eager_fails_at_open(tmp_path):
    root = save_index(NonPositionalIndex.build(DOCS_V1, store="vbyte"), tmp_path / "art")
    corrupt_component(root, "store.postings")
    with pytest.raises(ArtifactError, match="checksum mismatch.*store.postings"):
        open_index(root)
    with pytest.raises(ArtifactError, match="checksum mismatch.*store.postings"):
        Session.open(root, device="cpu")


def test_verify_lazy_fails_before_first_answer(tmp_path):
    root = save_index(NonPositionalIndex.build(DOCS_V1, store="vbyte"), tmp_path / "art")
    corrupt_component(root, "store.postings")
    mapped = open_index(root, mmap=True)
    assert "store.postings" in mapped.blobstore.pending_verification
    with pytest.raises(ArtifactError, match="checksum mismatch.*store.postings"):
        mapped.store.get_list(0)


def test_verify_lazy_settles_on_first_touch(tmp_path):
    root = save_index(NonPositionalIndex.build(DOCS_V1, store="vbyte"), tmp_path / "art")
    mapped = open_index(root, mmap=True, verify="lazy")
    assert mapped.blobstore.pending_verification
    mapped.store.get_list(0)
    assert not mapped.blobstore.pending_verification
    mapped.store.get_list(1)


def test_verify_off_never_checks(tmp_path):
    root = save_index(NonPositionalIndex.build(DOCS_V1, store="vbyte"), tmp_path / "art")
    corrupt_component(root, "scoring.doc_lengths")
    open_index(root, verify="off").store.get_list(0)


def test_verify_mode_validated(tmp_path):
    root = save_index(NonPositionalIndex.build(DOCS_V1, store="vbyte"), tmp_path / "art")
    with pytest.raises(ValueError, match="unknown verify mode"):
        open_index(root, verify="sometimes")


def test_blobstore_accounting(tmp_path):
    root = save_index(NonPositionalIndex.build(DOCS_V1, store="vbyte"), tmp_path / "art")
    manifest = json.loads((root / "manifest.json").read_text())
    blobs = BlobStore(root, manifest["components"], mmap=False)
    assert blobs.loaded_nbytes == 0 and blobs.loaded_fraction == 0.0
    blobs.get_all()
    assert blobs.loaded_nbytes > 0
    assert blobs.total_nbytes == sum(int(e["nbytes"]) for e in manifest["components"].values())


# ----------------------------------------------------------------------
# background compaction
# ----------------------------------------------------------------------
def test_compact_async_equals_sync_compact(tmp_path):
    wa = make_writer(tmp_path / "a")
    wb = make_writer(tmp_path / "b")
    wa.compact()
    meta = wb.compact_async().wait(60)
    assert meta.n_docs == wa.segments[0].n_docs == len(DOCS_V1 + DOCS_V2)
    assert_answers(Session.open(wa.path, device="cpu"), RefSession.open(wb.path, device=False))


def test_serving_continues_during_compaction(tmp_path):
    """Answers during the merge equal the quiesced ones, before and after
    the swap; the swap's hook refreshes the session exactly once."""
    w = make_writer(tmp_path)
    sess = Session.open(w.path, device="cpu", mmap=True)
    fired = []
    sess.add_refresh_hook(lambda old, new, added: fired.append((old, new, added)))
    expected = sess.execute(QUERIES)
    handle = w.compact_async(on_swap=sess.refresh)
    while not handle.done:
        for q, g, e in zip(QUERIES, sess.execute(QUERIES), expected):
            assert np.array_equal(g, e), q
    handle.wait(60)
    assert len(sess._segments) == 1 and sess.data_version == 2
    assert fired == [((2,), (1,), None)]
    for q, g, e in zip(QUERIES, sess.execute(QUERIES), expected):
        assert np.array_equal(g, e), q
    assert sess.refresh() == 0 and len(fired) == 1


def test_on_swap_fires_exactly_once(tmp_path):
    w = make_writer(tmp_path)
    fired = []
    w.compact_async(on_swap=lambda: fired.append(1)).wait(60)
    assert fired == [1]


def test_refresh_hook_sees_appended_sessions(tmp_path):
    w = make_writer(tmp_path, both=False)
    sess = Session.open(w.path, device="cpu")
    fired = []
    sess.add_refresh_hook(lambda old, new, added: fired.append((old, new, added)))
    w.add_documents(DOCS_V2)
    w.commit()
    assert sess.refresh() == 1
    (old, new, added), = fired
    assert (old, new) == ((1,), (2,)) and added == [sess._segments[1].session]


def test_writer_mutation_during_compaction_is_typed_error(tmp_path):
    w = make_writer(tmp_path)
    gate = threading.Event()
    orig = w._merged_indexes

    def slow_merge(segments):
        gate.wait(10)
        return orig(segments)

    w._merged_indexes = slow_merge
    handle = w.compact_async()
    w.add_documents(["held back"])
    try:
        assert w.compacting
        for call in (w.commit, w.compact, w.compact_async):
            with pytest.raises(RuntimeError, match="background compaction"):
                call()
    finally:
        gate.set()
    handle.wait(60)
    assert not w.compacting
    w.commit()
    assert w.n_docs == len(DOCS_V1 + DOCS_V2) + 1


def test_failed_compaction_leaves_segments_intact(tmp_path):
    w = make_writer(tmp_path)
    before = [s.name for s in w.segments]

    def exploding(segments):
        raise RuntimeError("merge wedged")

    w._merged_indexes = exploding
    handle = w.compact_async()
    with pytest.raises(CompactionError, match="merge wedged"):
        handle.wait(60)
    assert handle.failed and handle.result is None
    assert [s.name for s in w.segments] == before
    assert sorted(p.name for p in (w.path / "segments").iterdir()) == before
    assert_answers(Session.open(w.path, device="cpu"), one_shot(DOCS_V1 + DOCS_V2))


def test_compaction_handle_timeout_is_typed():
    gate = threading.Event()
    handle = CompactionHandle(lambda: gate.wait(10)).start()
    with pytest.raises(TimeoutError, match="still running"):
        handle.wait(0.05)
    gate.set()
    handle.wait(10)


# ----------------------------------------------------------------------
# crash consistency
# ----------------------------------------------------------------------
def test_interrupted_commit_leaves_no_half_segment(tmp_path, monkeypatch):
    import repro_torch.core.writer as writer_mod

    w = make_writer(tmp_path, both=False)
    calls = {"n": 0}
    orig = writer_mod.save_index

    def failing_save(idx, path):
        calls["n"] += 1
        if calls["n"] > 1:  # let nonpositional through, kill positional
            raise OSError("injected mid-commit failure")
        return orig(idx, path)

    monkeypatch.setattr(writer_mod, "save_index", failing_save)
    w.add_documents(DOCS_V2)
    with pytest.raises(OSError, match="injected"):
        w.commit()
    monkeypatch.setattr(writer_mod, "save_index", orig)
    assert [s.name for s in w.segments] == ["seg-000000"]
    assert sorted(p.name for p in (w.path / "segments").iterdir()) == ["seg-000000"]
    assert IndexWriter.open(w.path, device="cpu").n_docs == len(DOCS_V1)
    Session.open(w.path, device="cpu").execute("alpha")


def test_resume_discards_orphaned_build_dirs(tmp_path):
    w = make_writer(tmp_path, both=False)
    seg_root = w.path / "segments"
    (seg_root / ".tmp-seg-000001").mkdir()
    (seg_root / ".tmp-seg-000001" / "junk.bin").write_bytes(b"xx")
    (seg_root / ".compact-seg-000001").mkdir()
    (seg_root / "seg-000099").mkdir()
    resumed = IndexWriter.open(w.path, device="cpu")
    assert sorted(p.name for p in seg_root.iterdir()) == ["seg-000000"]
    assert [s.name for s in resumed.segments] == ["seg-000000"]
    resumed.add_documents(DOCS_V2)
    resumed.commit()
    assert resumed.n_docs == len(DOCS_V1 + DOCS_V2)


def test_refresh_racing_execute_yields_consistent_snapshots(tmp_path):
    """One thread refreshes through a commit and a compaction while another
    executes: every answer equals one committed snapshot's, never a mix."""
    w = make_writer(tmp_path, both=False)
    sess = Session.open(w.path, device="cpu", mmap=True)
    q = "docs: alpha"
    legal = [Session.open(w.path, device="cpu").execute(q)]
    w_after = IndexWriter.open(w.path, device="cpu")
    w_after.add_documents(DOCS_V2)
    errors: list[BaseException] = []
    answers: list[np.ndarray] = []
    stop = threading.Event()

    def executor():
        try:
            while not stop.is_set():
                answers.append(sess.execute(q))
        except BaseException as e:  # pragma: no cover - failure surface
            errors.append(e)

    t = threading.Thread(target=executor)
    t.start()
    try:
        w_after.commit()
        sess.refresh()
        legal.append(Session.open(w.path, device="cpu").execute(q))
        time.sleep(0.05)
        w_after.compact_async(on_swap=sess.refresh).wait(60)
        legal.append(Session.open(w.path, device="cpu").execute(q))
        time.sleep(0.05)
    finally:
        stop.set()
        t.join(30)
    assert not errors, errors
    assert answers and all(any(np.array_equal(a, s) for s in legal) for a in answers)
    assert any(np.array_equal(answers[-1], s) for s in legal[1:])


# ----------------------------------------------------------------------
# streamed synthetic collections
# ----------------------------------------------------------------------
def all_docs(spec):
    return [d for chunk in stream_collection(spec) for d in chunk]


@pytest.mark.parametrize("branching", [1, 3])
def test_stream_equals_reference_and_is_deterministic(branching):
    from repro.data.synthetic import SyntheticSpec as RefSpec

    spec = SyntheticSpec(**{**SPEC.config(), "branching": branching})
    got = list(stream_collection(spec))
    assert got == list(stream_collection(spec))
    assert got == list(ref_stream(RefSpec(**spec.config())))
    assert sum(map(len, got)) == spec.n_docs == 24
    assert all(len(c) <= spec.chunk_docs for c in got)


def test_seed_and_edit_rate_change_the_collection():
    base = all_docs(SPEC)
    assert all_docs(SyntheticSpec(**{**SPEC.config(), "seed": SPEC.seed + 1})) != base
    assert all_docs(SyntheticSpec(**{**SPEC.config(), "edit_rate": 0.3})) != base


def test_invalid_spec_is_typed_error():
    with pytest.raises(ValueError, match="branching"):
        next(stream_collection(SyntheticSpec(branching=0)))
    with pytest.raises(ValueError, match="chunk_docs"):
        next(stream_collection(SyntheticSpec(chunk_docs=0)))


def test_ingest_stream_builds_servable_segments(tmp_path):
    w = IndexWriter(tmp_path / "col", store="vbyte", positional=False, device="cpu")
    assert ingest_stream(w, SPEC, commit_every=2) == SPEC.n_docs
    assert w.n_docs == SPEC.n_docs and len(w.segments) == 3
    sess = Session.open(w.path, device="cpu", mmap=True)
    docs = all_docs(SPEC)
    word = docs[0].split()[0]
    expected = np.asarray(sorted(i for i, d in enumerate(docs) if word in d.split()),
                          dtype=np.int64)
    assert np.array_equal(sess.execute(f"docs: {word}"), expected)


def test_ingest_stream_max_docs_truncates(tmp_path):
    w = IndexWriter(tmp_path / "col", store="vbyte", positional=False, device="cpu")
    assert ingest_stream(w, SPEC, max_docs=7) == 7 and w.n_docs == 7
    docs = all_docs(SPEC)[:7]
    word = docs[0].split()[0]
    expected = np.asarray(sorted(i for i, d in enumerate(docs) if word in d.split()),
                          dtype=np.int64)
    assert np.array_equal(Session.open(w.path, device="cpu").execute(f"docs: {word}"),
                          expected)


def test_approx_bytes_in_right_ballpark():
    actual = sum(len(d) for d in all_docs(SPEC))
    assert 0.3 * actual < SPEC.approx_bytes() < 3 * actual
