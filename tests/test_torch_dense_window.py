"""The dense serving step's window op (``anchor_intersect.dense_probe_window``)
against the reference's probe loop, on device state carried across with
``BatchedServer.from_arrays`` from ``repro.core.anchors.build_anchored``.

The reference runs ``_probe_terms`` with its plain member and with its
Pallas member in interpret mode (``_kernel_member(interpret=True)``); the
port's plain version, its CPU wrapper (which takes the plain version for CPU
tensors), the NumPy oracle and the dense ``make_serve_step(probe="kernel")``
must equal both, with tolerance 0.  The partitioned step with
``probe="kernel"`` is held against the reference's partitioned step at 2 and
4 shards.  The kernel's row bisection needs every dense row's valid lanes to
be a strictly increasing prefix: that precondition is pinned here on every
dense table the port builds.  The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.anchors import build_anchored as ref_build_anchored
from repro.serving import engine as ref_engine
from repro.serving import partitioned as ref_part
from repro_torch.core import anchors as port_anchors
from repro_torch.kernels.anchor_intersect import ops as ai
from repro_torch.kernels.anchor_intersect.ref import dense_probe_window_ref
from repro_torch.serving import engine
from repro_torch.serving import partitioned as part
from repro_torch.serving.plan import AND, MAX_CAND_ROWS, PHRASE
from repro_torch.serving.session import Session

TOP = 2**31 - 3  # the largest posting whose cumulative value stays below 2^31 - 1
TABLE = ("c_offsets", "anchors", "expand", "expand_valid")
DENSE = TABLE + ("lengths",)
N_LISTS = 16


def _lists(seed: int) -> list[np.ndarray]:
    """Lists 0-5 shift one base set by 0..5 (phrase hits), 7-10 keep it in
    place (AND hits), 11 is long and unrelated (several windows), 6 and 12
    are empty, 13-14 sit at the top of the int32 universe, and 15, the last
    list, is empty (its slice starts and ends at the table's end)."""
    rng = np.random.default_rng(seed)
    base = np.sort(rng.choice(4000, size=300, replace=False))
    keep = lambda: rng.random(len(base)) >= 0.05  # noqa: E731
    lists = [base[keep()] + i for i in range(6)] + [np.zeros(0, np.int64)]
    lists += [base[keep()] for _ in range(4)]
    lists += [np.sort(rng.choice(20000, size=900, replace=False)), np.zeros(0, np.int64)]
    lists += [np.asarray([10, TOP - 3, TOP]), np.asarray([11, TOP - 2, TOP - 1])]
    lists += [np.zeros(0, np.int64)]
    assert len(lists) == N_LISTS
    return lists


def _build(expand_len: int):
    """(reference index, the port's dense server over its arrays, numpy arrays)."""
    ref = ref_build_anchored(_lists(20261018), expand_len=expand_len)
    arrays = {k: np.asarray(getattr(ref, k)) for k in DENSE}
    port = engine.BatchedServer.from_arrays(None, arrays, layout="dense", n_docs=1.0,
                                            device="cpu")
    return ref, port, arrays


@pytest.fixture(scope="module")
def index():
    return _build(32)


@pytest.fixture(scope="module")
def wide_index():
    return _build(2048)


def _queries(width: int, mode: str, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """A full-width query, a shorter one with garbage in its inactive
    columns, the padded row of a query with an unknown term (ids 0, length
    1), a query driven by the long list, queries with an empty list as a
    probed term and as the driving term (the last list), and the two lists
    at the int32 top."""
    rng = np.random.default_rng(seed)
    first = (lambda: list(range(6))) if mode == PHRASE else (lambda: [7, 8, 9, 10, 7, 8])
    rows = [(first() * 2)[:width], (first()[1:] * 2)[:width],
            [0] * width, [11] + (first() * 2)[:width - 1],
            ([0, 15] + first() * 2)[:width], [15] + (first() * 2)[:width - 1],
            ([13, 14] * width)[:width]]
    lens = [width, max(1, width - 1), 1, width, width, width, min(2, width)]
    qt = np.asarray(rows, np.int32)
    qt[1, lens[1]:] = rng.integers(0, N_LISTS, width - lens[1])
    return qt, np.asarray(lens, np.int32)


def _table(port) -> list[torch.Tensor]:
    return [port.arrays[k] for k in TABLE]


def _reference_runs(ref, qt, ql, vals, valid, width, phrase):
    """The reference's probe loop on the same candidates, with its plain
    member and with its Pallas member in interpret mode."""
    out = []
    for member in (None, ref_engine._kernel_member(interpret=True)):
        out.append(np.asarray(ref_engine._probe_terms(
            ref, jnp.asarray(qt), jnp.asarray(ql), jnp.asarray(vals), jnp.asarray(valid),
            width, phrase, member=member)))
    return out


def _check_all(ref, port, arrays, qt, ql, vals, valid, phrase) -> torch.Tensor:
    """Plain version == reference (both members) == oracle == CPU wrapper."""
    width = qt.shape[1]
    table = _table(port)
    args = (vals, valid, torch.from_numpy(qt), torch.from_numpy(ql), *table, phrase)
    match = ai.dense_probe_window_torch(*args)
    for want in _reference_runs(ref, qt, ql, vals.numpy(), valid.numpy(), width, phrase):
        assert np.array_equal(match.numpy(), want)
    oracle = dense_probe_window_ref(vals.numpy(), valid.numpy(), qt, ql,
                                    *(arrays[k] for k in TABLE), phrase)
    assert np.array_equal(match.numpy(), oracle)
    assert torch.equal(ai.dense_probe_window(*args), match)
    return match


@pytest.mark.parametrize("width", list(range(1, 10)))
@pytest.mark.parametrize("mode", [AND, PHRASE])
def test_dense_window_equals_reference(index, mode, width):
    """The first window's candidates of every query kind, W from 1 to 9."""
    ref, port, arrays = index
    qt, ql = _queries(width, mode, seed=width)
    ids = jnp.asarray(qt[:, 0])
    vals, valid = engine.candidates_for(engine._as_anchored(port.arrays),
                                        torch.from_numpy(qt)[:, 0], 0)
    rv, rvalid = ref_engine.candidates_for(ref, ids, 0)
    assert np.array_equal(vals.numpy(), np.asarray(rv))
    assert np.array_equal(valid.numpy(), np.asarray(rvalid))
    match = _check_all(ref, port, arrays, qt, ql, vals, valid, mode == PHRASE)
    if width > 1:  # the cases must reach hits, misses and dead lanes
        assert 0 < int(match.sum()) < int(valid.sum()) < valid.numel()


@pytest.mark.parametrize("window", ["last", "past_end"])
@pytest.mark.parametrize("mode", [AND, PHRASE])
def test_dense_window_later_windows(index, mode, window):
    ref, port, arrays = index
    qt, ql = _queries(4, mode, seed=11)
    n_rows = int(np.diff(arrays["c_offsets"])[qt[:, 0]].max())
    n_win = -(-n_rows // MAX_CAND_ROWS)
    row_start = (n_win - 1 if window == "last" else n_win + 1) * MAX_CAND_ROWS
    vals, valid = engine.candidates_for(engine._as_anchored(port.arrays),
                                        torch.from_numpy(qt)[:, 0], row_start)
    _check_all(ref, port, arrays, qt, ql, vals, valid, mode == PHRASE)


@pytest.mark.parametrize("mode", [AND, PHRASE])
def test_dense_window_on_rows_of_2048_lanes(wide_index, mode):
    """``expand_len`` 2,048 (the serving path's width): candidates drawn from
    the lists' postings (in cumulative-gap space), their neighbours, values
    at the int32 top and invalid lanes, on every query kind."""
    ref, port, arrays = wide_index
    assert arrays["expand"].shape[1] == 2048
    rng = np.random.default_rng(7)
    qt, ql = _queries(5, mode, seed=5)
    posts = arrays["expand"][arrays["expand_valid"]]
    cand = rng.choice(posts, (qt.shape[0], 300)) + rng.integers(-1, 2, (qt.shape[0], 300))
    cand[:, ::29] = 2**31 - 1 - rng.integers(0, 4, cand[:, ::29].shape)
    vals = torch.from_numpy(cand.astype(np.int32))
    valid = torch.from_numpy(rng.random(cand.shape) < 0.9)
    match = _check_all(ref, port, arrays, qt, ql, vals, valid, mode == PHRASE)
    assert 0 < int(match.sum()) < int(valid.sum())


@pytest.mark.parametrize("mode", [AND, PHRASE])
def test_dense_window_at_the_int32_top(index, mode):
    """Driving postings near 2^31 - 1: a phrase target past 2^31 - 2 misses
    instead of wrapping; the real pairs below it still hit."""
    ref, port, arrays = index
    qt = np.asarray([[13, 14], [14, 13]], np.int32)
    ql = np.asarray([2, 2], np.int32)
    vals, valid = engine.candidates_for(engine._as_anchored(port.arrays),
                                        torch.from_numpy(qt)[:, 0], 0)
    match = _check_all(ref, port, arrays, qt, ql, vals, valid, mode == PHRASE)
    got = np.unique(vals.numpy()[0][match.numpy()[0]]) - 1
    assert np.array_equal(got, [10, TOP - 3] if mode == PHRASE else [])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_window_plain_version_equals_the_oracle(seed):
    """Random tables (lists of 0..200 postings, the last one empty), random
    terms and ids over the whole table and one past it, lengths 0..W+1,
    random candidates with invalid lanes and values near the top."""
    rng = np.random.default_rng(seed)
    lists = [np.sort(rng.choice(3000, size=int(n), replace=False))
             for n in rng.integers(0, 200, 9)] + [np.zeros(0, np.int64)]
    idx = port_anchors.build_anchored(lists, device="cpu")
    a = {k: getattr(idx, k).numpy() for k in TABLE}
    b, w = 6, int(rng.integers(2, 7))
    qt = rng.integers(0, len(lists) + 1, (b, w)).astype(np.int32)
    ql = rng.integers(0, w + 2, b).astype(np.int32)
    posts = a["expand"][a["expand_valid"]]
    cand = rng.choice(posts, (b, 200)) + rng.integers(-2, 3, (b, 200))
    cand[:, ::17] = 2**31 - 1 - rng.integers(0, 4, cand[:, ::17].shape)
    vals = torch.from_numpy(cand.astype(np.int32))
    valid = torch.from_numpy(rng.random(cand.shape) < 0.9)
    for phrase in (False, True):
        got = ai.dense_probe_window_torch(vals, valid, torch.from_numpy(qt), torch.from_numpy(ql),
                                          *(getattr(idx, k) for k in TABLE), phrase)
        want = dense_probe_window_ref(vals.numpy(), valid.numpy(), qt, ql,
                                      *(a[k] for k in TABLE), phrase)
        assert np.array_equal(got.numpy(), want)


def test_dense_window_without_entries():
    """An empty entry table: a probe misses on every active term (a query
    of one term keeps its valid candidates)."""
    t = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    c_offsets, empty = t([0, 0, 0]), t([])
    expand = torch.zeros((0, 32), dtype=torch.int32)
    cand = t([[5, 6], [7, 8]])
    live = torch.tensor([[True, False], [True, True]])
    for phrase in (False, True):
        match = ai.dense_probe_window(cand, live, t([[0, 1], [1, 0]]), t([2, 1]), c_offsets,
                                      empty, expand, expand.bool(), phrase)
        assert match.tolist() == [[False, False], [True, True]]


MODES = [(AND, 0, False), (AND, 3, False), (AND, 0, True), (PHRASE, 0, False),
         (PHRASE, 0, True)]


@pytest.mark.parametrize("mode,topk,doclist", MODES)
def test_dense_kernel_step_equals_the_plain_step(index, mode, topk, doclist):
    """``make_serve_step(probe="kernel", layout="dense")`` (its wrapper
    takes the plain version for CPU tensors) returns what the plain step
    does, on every window, counting no launch."""
    _, port, arrays = index
    qt, ql = _queries(4, mode, seed=3)
    kw = dict(max_terms=4, mode=mode, topk=topk, n_docs=1.0, doclist=doclist, layout="dense")
    before = (ai.dense_probe_window.launches, ai.anchor_probe_sliced.launches)
    plain = engine.make_serve_step(probe="torch", **kw)
    kernel = engine.make_serve_step(probe="kernel", **kw)
    n_rows = int(np.diff(arrays["c_offsets"])[qt[:, 0]].max())
    for w in range(-(-n_rows // MAX_CAND_ROWS) + 1):
        want = plain(port.arrays, torch.from_numpy(qt), torch.from_numpy(ql), w * MAX_CAND_ROWS)
        got = kernel(port.arrays, torch.from_numpy(qt), torch.from_numpy(ql), w * MAX_CAND_ROWS)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert (ai.dense_probe_window.launches, ai.anchor_probe_sliced.launches) == before


def test_dense_kernel_step_calls_the_window_op_once_a_window(index, monkeypatch):
    """One ``dense_probe_window`` call a window whatever the width, and no
    ``anchor_probe_sliced`` call."""
    _, port, _ = index
    calls = {"dense_probe_window": 0, "anchor_probe_sliced": 0}
    for name in calls:
        real = getattr(ai, name)

        def rec(*a, _name=name, _real=real):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(ai, name, rec)
    for width in (2, 5, 9):
        qt, ql = _queries(width, AND, seed=width)
        step = engine.make_serve_step(max_terms=width, probe="kernel", layout="dense")
        for w in range(3):
            step(port.arrays, torch.from_numpy(qt), torch.from_numpy(ql), w * MAX_CAND_ROWS)
    assert calls == {"dense_probe_window": 9, "anchor_probe_sliced": 0}


def test_dense_kernel_probe_is_refused_on_the_cpu(index):
    """``probe="kernel"`` needs a CUDA device: a dense server or session on
    the CPU refuses it (``resolve_probe``)."""
    from repro_torch.core.index import NonPositionalIndex

    _, _, arrays = index
    with pytest.raises(ValueError, match="probe='kernel'"):
        engine.BatchedServer.from_arrays(None, arrays, layout="dense", n_docs=1.0,
                                         device="cpu", probe="kernel")
    idx = NonPositionalIndex.build(["a b c", "a b d", "b c d"], store="repair_skip")
    with pytest.raises(ValueError, match="probe='kernel'"):
        Session.build(idx, device="cpu", probe="kernel", layout="dense")


def test_dense_window_counts_no_launch_on_cpu(index):
    _, port, _ = index
    before = ai.dense_probe_window.launches
    qt = torch.tensor([[7, 8]], dtype=torch.int32)
    vals, valid = engine.candidates_for(engine._as_anchored(port.arrays), qt[:, 0], 0)
    ai.dense_probe_window(vals, valid, qt, torch.tensor([2], dtype=torch.int32),
                          *_table(port), True)
    assert ai.dense_probe_window.launches == before


@pytest.mark.parametrize("case", ["device", "dtype", "stride", "rows", "valid", "width"])
def test_dense_window_refuses_what_the_kernel_does_not_take(index, case):
    """A tensor on another device than the CPU or CUDA, a wrong dtype, a
    strided column where a contiguous one is needed, an expand table whose
    rows differ from the anchors', a wrong flag table and too wide a query
    are refused before any launch."""
    _, port, _ = index
    c_offsets, anchors, expand, expand_valid = [x.to("meta") for x in _table(port)]
    m = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device="meta")  # noqa: E731
    cand, live = m(2, 8), m(2, 8, dt=torch.bool)
    calls = {
        "device": (ValueError, "lies on", lambda: ai.dense_probe_window(
            cand, live, m(2, 2), m(2), c_offsets, anchors, expand, expand_valid, False)),
        "dtype": (TypeError, "int32", lambda: ai.dense_probe_window(
            m(2, 8, dt=torch.int64), live, m(2, 2), m(2), c_offsets, anchors, expand,
            expand_valid, False)),
        "stride": (ValueError, "contiguous", lambda: ai.dense_probe_window(
            cand, live, m(2, 4)[:, ::2], m(2), c_offsets, anchors, expand, expand_valid, False)),
        "rows": (ValueError, "rows", lambda: ai.dense_probe_window(
            cand, live, m(2, 2), m(2), c_offsets, anchors, expand[:-1], expand_valid[:-1],
            False)),
        "valid": (ValueError, "expand_valid", lambda: ai.dense_probe_window(
            cand, live, m(2, 2), m(2), c_offsets, anchors, expand, expand_valid[:, :-1], False)),
        "width": (ValueError, "at most", lambda: ai.dense_probe_window(
            cand, live, m(2, ai.MAX_WINDOW_TERMS + 1), m(2), c_offsets, anchors, expand,
            expand_valid, False)),
    }
    exc, text, call = calls[case]
    before = ai.dense_probe_window.launches
    if case == "device":  # a meta tensor is neither a CPU nor a CUDA tensor
        with pytest.raises(exc, match=text):
            call()
    else:
        # the checks past the device one need CUDA tensors; on the CPU they
        # are reached through meta tensors with the device check passed
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ai.cuda_build, "require_cuda", lambda name, t: None)
            with pytest.raises(exc, match=text):
                call()
    assert ai.dense_probe_window.launches == before


# ----------------------------------------------------------------------
# the partitioned step: one dense_probe_window a window over all shards
# ----------------------------------------------------------------------
N_DOCS = 6000


class FakeHost:
    """A host index of the random lists: term ``t{i}`` is list ``i``."""

    def __init__(self, n: int):
        self.n = n

    def lookup(self, term: str):
        if term.startswith("t") and term[1:].isdigit() and int(term[1:]) < self.n:
            return int(term[1:])
        return None


def _shard_lists(seed: int) -> list[np.ndarray]:
    """Long lists (several windows a shard), short ones, lists confined to
    the first quarter (empty in the other shards), and an empty last list."""
    rng = np.random.default_rng(seed)
    lists = []
    for i in range(10):
        hi = N_DOCS // 4 if i % 4 == 3 else N_DOCS
        n = int(rng.integers(1200, 1800)) if i < 3 else int(rng.integers(3, 200))
        lists.append(np.unique(rng.integers(0, hi, size=n)).astype(np.int64))
    return lists + [np.asarray([], dtype=np.int64)]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_partitioned_kernel_step_equals_reference(n_shards):
    """``make_partitioned_serve_step(probe="kernel")`` on CPU tensors equals
    the reference's partitioned step on every window of AND and phrase
    batches, and calls ``dense_probe_window`` once a window."""
    lists = _shard_lists(20261018 + n_shards)
    port = part.PartitionedAnchoredIndex.build(lists, N_DOCS, n_shards, device="cpu")
    ref = ref_part.PartitionedAnchoredIndex.build(lists, N_DOCS, n_shards)
    host = FakeHost(len(lists))
    rng = np.random.default_rng(n_shards)
    qs = [[f"t{int(rng.integers(0, len(lists)))}" for _ in range(int(rng.integers(1, 5)))]
          for _ in range(10)]
    qs += [["t0", "t1"], ["t1", "t2", "t3"], ["t0", "nope"], ["t2", "t10"], ["t10", "t0"]]
    srv = part.PartitionedServer(port, host, probe="torch")
    qt, ql, _ = srv.encode(qs, sort_by_length=True, width=4)
    n_windows = -(-max(srv.c_entries(int(t)) for t in qt[:, 0]) // MAX_CAND_ROWS)
    assert n_windows > 1
    real, calls = ai.dense_probe_window, []

    def rec(*a):
        calls.append(a[0].shape)
        return real(*a)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ai, "dense_probe_window", rec)
        for mode in (AND, PHRASE):
            step = part.make_partitioned_serve_step(4, mode=mode, probe="kernel")
            ref_step = ref_part.PartitionedServer(ref, host)._step(mode, 4)
            for w in range(n_windows + 1):
                vals, mask = step(port.step_arrays(), torch.from_numpy(qt),
                                  torch.from_numpy(ql), w * MAX_CAND_ROWS)
                rv, rm = ref_step(ref.arrays, qt, ql, w * MAX_CAND_ROWS)
                rv, rm = np.asarray(rv), np.asarray(rm)
                assert np.array_equal(mask.numpy(), rm), (mode, w)
                assert np.array_equal(vals.numpy()[rm], rv[rm]), (mode, w)
    assert len(calls) == 2 * (n_windows + 1)
    assert set(calls) == {(n_shards * len(qs), MAX_CAND_ROWS * port.expand_len)}


# ----------------------------------------------------------------------
# the precondition of the kernel's row bisection, on every dense table
# ----------------------------------------------------------------------
def _assert_sorted_prefixes(expand, expand_valid, what: str) -> None:
    assert port_anchors.rows_are_sorted_prefixes(expand, expand_valid), what
    assert bool(expand_valid.any()), what  # not vacuous


def test_the_precondition_catches_a_broken_row():
    """The check itself: a gap in the valid lanes, or valid lanes that do
    not rise, fail it."""
    e = torch.tensor([[1, 2, 3, 0], [4, 6, 5, 0]], dtype=torch.int32)
    flags = lambda rows: torch.tensor(rows, dtype=torch.bool)  # noqa: E731
    assert port_anchors.rows_are_sorted_prefixes(e, flags([[1, 1, 1, 0], [1, 1, 0, 0]]))
    assert not port_anchors.rows_are_sorted_prefixes(e, flags([[1, 0, 1, 0], [1, 1, 0, 0]]))
    assert not port_anchors.rows_are_sorted_prefixes(e, flags([[1, 1, 1, 0], [1, 1, 1, 0]]))


@pytest.mark.parametrize("expand_len", [32, 2048])
def test_precondition_from_store_and_reference_arrays(expand_len):
    """``AnchoredIndex.from_store`` (through ``build_anchored``) and
    ``from_numpy`` of the reference's arrays for the same lists."""
    lists = _lists(3)
    idx = port_anchors.build_anchored(lists, expand_len=expand_len, device="cpu")
    _assert_sorted_prefixes(idx.expand, idx.expand_valid, "from_store")
    ref = ref_build_anchored(lists, expand_len=expand_len)
    carried = port_anchors.AnchoredIndex.from_numpy(
        {k: np.asarray(getattr(ref, k)) for k in DENSE}, device="cpu")
    _assert_sorted_prefixes(carried.expand, carried.expand_valid, "from_numpy")
    assert torch.equal(carried.expand, idx.expand)


@pytest.mark.parametrize("store", ["repair_skip", "vbyte", "elias_fano", "rlz"])
def test_precondition_of_the_dense_servers(store):
    """Dense servers over a Re-Pair store (anchored directly) and over
    re-anchored backends, ``rlz`` among them (signed on the CPU), for a
    positional and a non-positional index; and a reference artifact opened
    by the port as a dense session."""
    from repro.data import generate_collection
    from repro_torch.core.index import NonPositionalIndex, PositionalIndex

    docs = generate_collection(n_articles=3, versions_per_article=4, words_per_doc=60,
                               seed=1).docs
    for cls in (NonPositionalIndex, PositionalIndex):
        idx = cls.build(docs, store=store, device="cpu")
        srv = engine.BatchedServer.from_index(idx, layout="dense", device="cpu")
        _assert_sorted_prefixes(srv.arrays["expand"], srv.arrays["expand_valid"],
                                f"{store} {cls.__name__}")


def test_precondition_of_an_opened_reference_artifact(tmp_path):
    from repro.core.artifact import save_index as ref_save_index
    from repro.core.index import PositionalIndex as RefPositional
    from repro.data import generate_collection

    docs = generate_collection(n_articles=3, versions_per_article=4, words_per_doc=60,
                               seed=2).docs
    ref_save_index(RefPositional.build(docs), tmp_path / "pos")
    sess = Session.open(tmp_path / "pos", device="cpu", layout="dense")
    srv = sess.positional_server
    _assert_sorted_prefixes(srv.arrays["expand"], srv.arrays["expand_valid"], "opened")


@pytest.mark.parametrize("n_shards", [2, 4])
def test_precondition_of_the_partitioned_stacks(n_shards):
    """The padded stacks of every shard, read as the step reads them."""
    port = part.PartitionedAnchoredIndex.build(_shard_lists(n_shards), N_DOCS, n_shards,
                                               device="cpu")
    flat = part._flat_index(port.step_arrays())
    _assert_sorted_prefixes(flat.expand, flat.expand_valid, "partitioned")
