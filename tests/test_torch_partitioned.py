"""The document-partitioned server on the port, held against the reference.

``repro_torch.serving.partitioned`` runs every shard of a window as one
batched step on one device; the reference loops its shards through one
jitted shard-local step (``mesh=None``).  The same seeded posting lists and
collections go through both, with ``device="cpu"``: the stacked arrays must
be equal byte for byte, and every answer equal to the reference's and to
the host-only session's (integers: tolerance 0).
"""

import os
import threading

import numpy as np
import pytest
import torch

from repro.core.artifact import save_index as ref_save_index
from repro.core.index import NonPositionalIndex as RefNonPositional
from repro.core.index import PositionalIndex as RefPositional
from repro.data import generate_collection
from repro.serving import partitioned as ref_part
from repro.serving.session import Session as RefSession
from repro_torch.core.index import NonPositionalIndex, PositionalIndex
from repro_torch.data.queries import sample_traffic
from repro_torch.serving import partitioned as part
from repro_torch.serving.engine import make_serve_step
from repro_torch.serving.plan import MAX_CAND_ROWS
from repro_torch.serving.session import Session

BASE_SEED = int(os.environ.get("REPRO_DIFF_SEED", "20260727"))
N_DOCS = 1600
ARRAY_KEYS = ("anchors", "c_offsets", "expand", "expand_valid", "lengths", "doc_base")


def random_lists(seed: int) -> list[np.ndarray]:
    """Sorted distinct posting lists over [0, N_DOCS): long ones (several
    candidate windows a shard), short ones, lists confined to the first
    quarter (empty in the other shards), one empty list, and nothing at all
    in the last eighth of the id space (a shard of 8 equal cuts — or the
    last of the aligned cuts — may hold no C entry at all)."""
    rng = np.random.default_rng(seed)
    top = N_DOCS - N_DOCS // 8
    lists = []
    for i in range(14):
        hi = N_DOCS // 4 if i % 5 == 3 else top
        n = int(rng.integers(400, 700)) if i < 4 else int(rng.integers(3, 120))
        lists.append(np.unique(rng.integers(0, hi, size=n)).astype(np.int64))
    lists.append(np.asarray([], dtype=np.int64))
    return lists


@pytest.fixture(scope="module")
def lists():
    return random_lists(BASE_SEED)


def bounds_for(kind: str, n_shards: int):
    if kind == "equal":
        return None
    # document-aligned cuts of uneven widths, the last range past every posting
    inner = np.sort(np.random.default_rng(n_shards).choice(
        np.arange(50, N_DOCS - N_DOCS // 8), size=n_shards - 1, replace=False))
    return np.concatenate([[0], inner, [N_DOCS]])


def assert_arrays_equal(port: "part.PartitionedAnchoredIndex", ref) -> None:
    assert port.n_shards == ref.n_shards and port.expand_len == ref.expand_len
    assert np.array_equal(port.doc_bounds, ref.doc_bounds)
    assert port.doc_bounds.dtype == ref.doc_bounds.dtype
    assert set(port.arrays) == set(ARRAY_KEYS) == set(ref.arrays)
    for k in ARRAY_KEYS:
        got, want = port.arrays[k].numpy(), np.asarray(ref.arrays[k])
        assert got.dtype == want.dtype and got.shape == want.shape, (k, got.dtype, want.dtype,
                                                                     got.shape, want.shape)
        assert got.tobytes() == want.tobytes(), k


@pytest.fixture(scope="module")
def built_lists(lists):
    """(port, reference) partitioned indexes per (n_shards, bounds kind)."""
    out = {}
    for s in (1, 2, 3, 4):
        for kind in ("equal", "aligned"):
            b = bounds_for(kind, s) if s > 1 else None
            out[s, kind] = (
                part.PartitionedAnchoredIndex.build(lists, N_DOCS, s, bounds=b, device="cpu"),
                ref_part.PartitionedAnchoredIndex.build(lists, N_DOCS, s, bounds=b))
    return out


@pytest.mark.parametrize("kind", ["equal", "aligned"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_build_arrays_equal_reference(built_lists, n_shards, kind):
    port, ref = built_lists[n_shards, kind]
    assert_arrays_equal(port, ref)
    c = port.arrays["c_offsets"].numpy()
    # lists empty in some shards: an empty slice there, as in the reference
    assert ((c[:, 1:] - c[:, :-1]) == 0).any()
    assert port.arrays["anchors"].device.type == "cpu"


def test_a_shard_with_no_c_entry(lists):
    """Eight equal cuts: the last shard's range holds no posting at all, so
    every one of its lists is empty and its arrays are all padding.  The
    reference cannot stack such a shard (its empty expand table is 1-D, so
    ``pad2`` raises ``IndexError``: logged in Queue C of ``ROADMAP.md``);
    the port pads it like any other shard and answers as the posting lists
    say — the same answers as the seven-shard cut of the other shards."""
    with pytest.raises(IndexError):
        ref_part.PartitionedAnchoredIndex.build(lists, N_DOCS, 8)
    port = part.PartitionedAnchoredIndex.build(lists, N_DOCS, 8, device="cpu")
    assert int(port.arrays["c_offsets"][-1].max()) == 0
    assert bool((port.arrays["anchors"][-1] == 2**31 - 1).all())
    assert not bool(port.arrays["expand_valid"][-1].any())
    assert port.arrays["expand"].dtype == torch.int32
    assert port.arrays["expand_valid"].dtype == torch.bool
    srv = part.PartitionedServer(port, FakeHost(len(lists)), probe="torch")
    qs = [["t0", "t1"], ["t2", "t6"], ["t14", "t0"], ["t3"], ["t1", "t2", "t3"]]
    for method, oracle in (("conjunctive", oracle_and), ("phrase", oracle_phrase)):
        for got, q in zip(getattr(srv, method)(qs), qs):
            assert np.array_equal(got, oracle(lists, q)), (method, q)


class FakeHost:
    """A host index of the random lists: term ``t{i}`` is list ``i``."""

    def __init__(self, n: int):
        self.n = n

    def lookup(self, term: str):
        if term.startswith("t") and term[1:].isdigit() and int(term[1:]) < self.n:
            return int(term[1:])
        return None


def oracle_and(lists, q) -> np.ndarray:
    ids = [int(t[1:]) for t in q]
    out = lists[ids[0]]
    for i in ids[1:]:
        out = np.intersect1d(out, lists[i])
    return out.astype(np.int64)


def oracle_phrase(lists, q) -> np.ndarray:
    ids = [int(t[1:]) for t in q]
    out = lists[ids[0]]
    for k, i in enumerate(ids[1:], start=1):
        out = out[np.isin(out + k, lists[i])]
    return out.astype(np.int64)


def random_queries(rng, n_lists: int, n: int) -> list[list[str]]:
    qs = []
    for _ in range(n):
        w = int(rng.integers(1, 5))
        qs.append([f"t{int(rng.integers(0, n_lists))}" for _ in range(w)])
    # long lists drive (several windows), unknown terms, a repeated term
    qs += [["t0", "t1"], ["t1", "t2", "t3"], ["t0", "nope"], ["t2", "t2"], ["t3"]]
    return qs


@pytest.mark.parametrize("n_shards,kind", [(2, "equal"), (3, "aligned"), (4, "equal")])
def test_server_equals_reference_over_several_windows(built_lists, lists, n_shards, kind):
    port, ref = built_lists[n_shards, kind]
    srv = part.PartitionedServer(port, FakeHost(len(lists)), probe="torch")
    refsrv = ref_part.PartitionedServer(ref, FakeHost(len(lists)))
    assert srv.c_entries(0) > MAX_CAND_ROWS  # the long lists sweep several windows
    assert srv.c_entries(0) == refsrv.c_entries(0)
    rng = np.random.default_rng(BASE_SEED + n_shards)
    qs = random_queries(rng, len(lists), 24)
    for method, oracle in (("conjunctive", oracle_and), ("phrase", oracle_phrase)):
        got = getattr(srv, method)(qs)
        want = getattr(refsrv, method)(qs)
        for q, g, w in zip(qs, got, want):
            assert g.dtype == np.int64 and np.array_equal(g, w), (method, q)
            if all(FakeHost(len(lists)).lookup(t) is not None for t in q):
                assert np.array_equal(g, oracle(lists, q)), (method, q)
    assert srv.windows_swept > 2


def test_all_invalid_batch(built_lists, lists):
    port, ref = built_lists[2, "equal"]
    srv = part.PartitionedServer(port, FakeHost(len(lists)), probe="torch")
    refsrv = ref_part.PartitionedServer(ref, FakeHost(len(lists)))
    qs = [["nope", "t1"], ["t0", "gone"]]
    got, want = srv.conjunctive(qs), refsrv.conjunctive(qs)
    assert all(len(g) == 0 and g.dtype == np.int64 for g in got)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    # as in the reference, the padded row (term id 0) drives the sweep
    assert srv.windows_swept == max(1, -(-srv.c_entries(0) // MAX_CAND_ROWS))


def test_batched_step_equals_per_shard_loop(built_lists, lists):
    """One batched step over all shards == the engine's dense step run on
    each shard's own arrays, re-based by ``doc_base`` (the reference's host
    loop over shards), on every window; also == the reference's
    shard-local step."""
    port, ref = built_lists[3, "aligned"]
    rng = np.random.default_rng(BASE_SEED + 3)
    qs = random_queries(rng, len(lists), 12)
    srv = part.PartitionedServer(port, FakeHost(len(lists)), probe="torch")
    qt, ql, _ = srv.encode(qs, sort_by_length=True)
    width = qt.shape[1]
    for mode in ("and", "phrase"):
        step = part.make_partitioned_serve_step(width, mode=mode)
        per_shard = make_serve_step(max_terms=width, mode=mode)
        ref_step = ref_part.PartitionedServer(ref, FakeHost(len(lists)))._step(mode, width)
        for w in range(srv.c_entries(0) // MAX_CAND_ROWS + 1):
            vals, mask = step(port.step_arrays(), torch.from_numpy(qt),
                              torch.from_numpy(ql), w * MAX_CAND_ROWS)
            assert vals.dtype == torch.int32 and vals.shape[:2] == (3, len(qs))
            rv, rm = ref_step(ref.arrays, qt, ql, w * MAX_CAND_ROWS)
            rv, rm = np.asarray(rv), np.asarray(rm)
            assert np.array_equal(mask.numpy(), rm), (mode, w)
            assert np.array_equal(vals.numpy()[rm], rv[rm]), (mode, w)
            for s in range(3):
                local = {k: port.arrays[k][s] for k in ARRAY_KEYS if k != "doc_base"}
                lv, lm = per_shard(local, torch.from_numpy(qt), torch.from_numpy(ql),
                                   w * MAX_CAND_ROWS)
                lv = lv + port.arrays["doc_base"][s]
                assert torch.equal(mask[s], lm), (mode, w, s)
                assert torch.equal(vals[s][lm], lv[lm]), (mode, w, s)


def test_kernel_step_probes_once_per_term_per_window(built_lists, lists, monkeypatch):
    """``probe="kernel"`` routes every probe through ``dense_probe_window``:
    one call a window for every probed term of all shards together (the
    wrapper takes its plain version on these CPU tensors), and no
    ``anchor_probe_sliced`` call."""
    from repro_torch.kernels.anchor_intersect import ops

    calls, sliced = [], []
    real = ops.dense_probe_window
    real_sliced = ops.anchor_probe_sliced

    def recorded(cand_vals, *rest):
        calls.append(cand_vals.shape)
        return real(cand_vals, *rest)

    def recorded_sliced(*args):
        sliced.append(args[0].shape[0])
        return real_sliced(*args)

    monkeypatch.setattr(ops, "dense_probe_window", recorded)
    monkeypatch.setattr(ops, "anchor_probe_sliced", recorded_sliced)
    port, _ = built_lists[4, "equal"]
    srv = part.PartitionedServer(port, FakeHost(len(lists)), probe="torch")
    qs = [["t0", "t1", "t2"], ["t1", "t3", "t5"], ["t0", "t4"]]
    want = srv.conjunctive(qs, width=4)
    assert not calls
    step = part.make_partitioned_serve_step(4, mode="and", probe="kernel")
    qt, ql, _ = srv.encode(qs, sort_by_length=True, width=4)
    n_windows = -(-max(srv.c_entries(int(t)) for t in qt[:, 0]) // MAX_CAND_ROWS)
    hits = [[] for _ in qs]
    for w in range(n_windows):
        vals, mask = step(port.step_arrays(), torch.from_numpy(qt), torch.from_numpy(ql),
                          w * MAX_CAND_ROWS)
        for qi in range(len(qs)):
            hits[qi].append(vals[:, qi][mask[:, qi]].numpy())
    assert len(calls) == n_windows and not sliced
    assert set(calls) == {(4 * len(qs), MAX_CAND_ROWS * port.expand_len)}
    for h, g in zip(hits, want):
        assert np.array_equal(np.unique(np.concatenate(h)), g)


def test_merge_and_windowed_equal_reference(built_lists, lists):
    port, ref = built_lists[4, "aligned"]
    qs = [["t0", "t2"], ["t1", "t3"], ["t4", "t9"]]
    srv = part.PartitionedServer(port, FakeHost(len(lists)), probe="torch")
    qt, ql, _ = srv.encode(qs, sort_by_length=True)
    got = part.serve_partitioned_windowed(port, part.make_partitioned_serve_step(2), qt, ql)
    want = ref_part.serve_partitioned_windowed(
        ref, ref_part.PartitionedServer(ref, FakeHost(len(lists)))._step("and", 2), qt, ql)
    for g, w, q in zip(got, want, qs):
        assert np.array_equal(g, np.asarray(w)), q
        assert np.array_equal(g, oracle_and(lists, q)), q
    vals, mask = part.make_partitioned_serve_step(2)(port.step_arrays(), torch.from_numpy(qt),
                                                     torch.from_numpy(ql))
    got = part.merge_results(vals.numpy(), mask.numpy())
    want = ref_part.merge_results(vals.numpy(), mask.numpy())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_encode_keeps_the_reference_order_on_equal_lengths(built_lists, lists):
    """Rarest first by the shard-summed lengths, stable on ties: two terms
    of equal global length keep the query's order, as in the reference."""
    port, ref = built_lists[3, "equal"]
    srv = part.PartitionedServer(port, FakeHost(len(lists)), probe="torch")
    refsrv = ref_part.PartitionedServer(ref, FakeHost(len(lists)))
    lengths = srv._lengths_np
    assert np.array_equal(lengths, np.asarray(refsrv._lengths_np))
    ties = [(a, b) for a in range(len(lists)) for b in range(len(lists))
            if a != b and lengths[a] == lengths[b]]
    qs = [[f"t{a}", f"t{b}", "t0"] for a, b in ties[:6]] + [["t5", "t1", "t14"], ["x", "t1"]]
    assert ties, "the seeded lists give no two terms of equal length"
    for width in (None, 4):
        for sort in (True, False):
            got = srv.encode(qs, sort_by_length=sort, width=width)
            want = refsrv.encode(qs, sort_by_length=sort, width=width)
            for g, w in zip(got, want):
                assert g.dtype == np.asarray(w).dtype and np.array_equal(g, w)
    for t in range(len(lists)):
        assert srv.c_entries(t) == refsrv.c_entries(t)


# ----------------------------------------------------------------------
# over real indexes, under a Session
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def collection():
    return generate_collection(n_articles=2, versions_per_article=5, words_per_doc=60,
                               seed=BASE_SEED % 10_000)


@pytest.fixture(scope="module")
def indexes(collection):
    docs = collection.docs
    return (NonPositionalIndex.build(docs, store="repair_skip"),
            PositionalIndex.build(docs, store="repair_skip"),
            RefNonPositional.build(docs, store="repair_skip"),
            RefPositional.build(docs, store="repair_skip"))


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_from_index_equals_reference(indexes, n_shards):
    idx, pidx, ref_idx, ref_pidx = indexes
    for ix, rix in ((idx, ref_idx), (pidx, ref_pidx)):
        assert_arrays_equal(part.PartitionedAnchoredIndex.from_index(ix, n_shards, device="cpu"),
                            ref_part.PartitionedAnchoredIndex.from_index(rix, n_shards))
    # positional cuts fall on document starts
    p = part.PartitionedAnchoredIndex.from_index(pidx, n_shards, device="cpu")
    assert all(int(b) in set(pidx.doc_starts.tolist()) for b in p.doc_bounds[:-1])
    assert int(p.doc_bounds[-1]) == pidx.n_tokens


def session_queries(collection, idx, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    words = idx.vocab.id_to_token[:60]
    qs = sample_traffic("mixed", 30, collection.docs, words, rng)
    qs += sample_traffic("and", 12, collection.docs, words, rng, n_terms=3)
    qs += sample_traffic("phrase", 12, collection.docs, words, rng, n_terms=3)
    qs += [f"{words[1]} qqqzz", '"qqqzz unknownzz"', f'"{words[2]}"', words[3],
           f"{words[4]} {words[4]}"]
    return qs


@pytest.mark.parametrize("n_shards", [2, 3])
def test_session_answers_equal_reference_and_host(collection, indexes, n_shards):
    idx, pidx, ref_idx, ref_pidx = indexes
    sess = Session(idx, positional=pidx,
                   server=part.PartitionedServer.from_index(idx, n_shards, device="cpu"),
                   positional_server=part.PartitionedServer.from_index(pidx, n_shards,
                                                                       device="cpu"))
    ref = RefSession(ref_idx, positional=ref_pidx,
                     server=ref_part.PartitionedServer.from_index(ref_idx, n_shards),
                     positional_server=ref_part.PartitionedServer.from_index(ref_pidx, n_shards))
    host = Session(idx, positional=pidx)
    qs = session_queries(collection, idx, BASE_SEED + n_shards)
    routes = [sess.plan(q).route for q in qs]
    assert routes == [ref.plan(q).route for q in qs]
    assert routes.count("device") >= 20
    got, want, base = sess.execute(qs), ref.execute(qs), host.execute(qs)
    for q, g, w, h in zip(qs, got, want, base):
        assert np.array_equal(g, np.asarray(w)), q
        assert np.array_equal(g, np.asarray(h)), q
    steps = sess.jit_traces
    assert steps > 0
    sess.execute(qs)
    assert sess.jit_traces == steps  # shard steps cached


def test_open_reference_artifact(collection, indexes, tmp_path):
    idx, pidx, ref_idx, ref_pidx = indexes
    ref_save_index(ref_idx, tmp_path / "np")
    ref_save_index(ref_pidx, tmp_path / "pos")
    for name, host_ix in (("np", idx), ("pos", pidx)):
        srv = part.PartitionedServer.open(tmp_path / name, 2, device="cpu")
        refsrv = ref_part.PartitionedServer.open(tmp_path / name, 2)
        assert_arrays_equal(srv.pidx, refsrv.pidx)
        words = host_ix.vocab.id_to_token[1:9]
        qs = [[words[i], words[i + 1]] for i in range(0, 6, 2)]
        method = "conjunctive" if name == "np" else "phrase"
        for g, w in zip(getattr(srv, method)(qs), getattr(refsrv, method)(qs)):
            assert np.array_equal(g, np.asarray(w))


def test_mesh_and_kernel_probe_refused_on_cpu(indexes, lists):
    """A mesh that is not a ``DeviceMesh`` is refused by name (the mesh path
    itself runs in tests/test_torch_distributed.py)."""
    idx = indexes[0]
    with pytest.raises(TypeError, match="DeviceMesh"):
        part.PartitionedServer.from_index(idx, 2, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        part.make_partitioned_serve_step(2, mesh=object())
    pidx = part.PartitionedAnchoredIndex.build(lists, N_DOCS, 2, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        part.PartitionedServer(pidx, FakeHost(len(lists)), mesh=object())
    with pytest.raises(ValueError, match="probe='kernel'"):
        part.PartitionedServer.from_index(idx, 2, device="cpu", probe="kernel")
    with pytest.raises(ValueError, match="probe='kernel'"):
        part.PartitionedServer(pidx, FakeHost(len(lists)), probe="kernel")
    assert part.PartitionedServer(pidx, FakeHost(len(lists))).probe == "torch"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            part.PartitionedServer.from_index(idx, 2)  # device defaults to "cuda"


def test_flat_offsets_stay_int32_and_refuse_past_it():
    c = np.asarray([[0, 3, 3, 7], [0, 0, 2, 5]], dtype=np.int32)
    flat = part.shard_offsets(c, 7)
    assert flat.dtype == np.int32
    assert flat.tolist() == [0, 3, 3, 7, 7, 7, 9, 12]
    assert part.shard_offsets(c, (2**31 - 1) // 2).dtype == np.int32
    with pytest.raises(ValueError, match="int32"):
        part.shard_offsets(c, 2**30)


def test_served_from_another_thread_with_grad_on(built_lists, lists):
    """The frontend runs ``Session.execute`` on its executor thread, whose
    grad mode is its own: the server enters ``no_grad`` itself and names its
    device on every tensor it makes."""
    port, _ = built_lists[2, "aligned"]
    srv = part.PartitionedServer(port, FakeHost(len(lists)), probe="torch")
    qs = [["t0", "t1"], ["t2", "t3", "t4"]]
    want = srv.conjunctive(qs)
    seen = {}
    real = srv._step

    def step(mode, width):
        inner = real(mode, width)

        def run(*a, **kw):
            seen["grad"] = torch.is_grad_enabled()
            out = inner(*a, **kw)
            seen["requires_grad"] = any(o.requires_grad for o in out)
            return out
        return run

    srv._step = step
    got = {}

    def worker():
        torch.set_grad_enabled(True)
        got["res"] = srv.conjunctive(qs)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert seen == {"grad": False, "requires_grad": False}
    assert all(np.array_equal(g, w) for g, w in zip(got["res"], want))


def test_bounds_must_match_the_shard_count(lists):
    with pytest.raises(ValueError, match="bounds"):
        part.PartitionedAnchoredIndex.build(lists, N_DOCS, 3, bounds=[0, 800, N_DOCS],
                                            device="cpu")
