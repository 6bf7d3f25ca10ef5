"""The fused serving step's whole-window ops (``fused_decode.decode_window`` /
``probe_window``) against the reference's candidate generator and probe
loop, on device state carried across with ``BatchedServer.from_arrays``
from ``repro.core.anchors.build_compressed_anchored``.

The reference runs both with its plain member and with its Pallas kernels
in interpret mode (``_kernel_member_fused(interpret=True)`` and the
interpret-mode ``decode_rows``); the port's plain versions and its CPU
wrappers (which take the plain versions for CPU tensors) must equal both,
and the NumPy oracles, with tolerance 0.  The CUDA kernels themselves are
held against these plain versions on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.anchors import build_compressed_anchored as ref_build_compressed
from repro.kernels.fused_decode import ops as ref_fd_ops
from repro.serving import engine as ref_engine
from repro_torch.kernels.fused_decode import ops as fd
from repro_torch.kernels.fused_decode.ref import decode_window_ref, probe_window_ref
from repro_torch.serving import engine
from repro_torch.serving.plan import AND, MAX_CAND_ROWS, PHRASE
from repro_torch.serving.session import Session

TOP = 2**31 - 3  # the largest posting whose cumulative value stays below 2^31 - 1
TABLE = ("c_offsets", "anchors", "c_ptr", "c_len", "pool")


def _lists(seed: int) -> list[np.ndarray]:
    """Lists 0-5 shift one base set by 0..5 (phrase hits), 7-10 keep it in
    place (AND hits), 11 is long and unrelated (several windows), 6 and 12
    are empty (12 is the last list: its slice starts at the table's end),
    13-14 sit at the top of the int32 universe."""
    rng = np.random.default_rng(seed)
    base = np.sort(rng.choice(4000, size=300, replace=False))
    keep = lambda: rng.random(len(base)) >= 0.05  # noqa: E731
    lists = [base[keep()] + i for i in range(6)] + [np.zeros(0, np.int64)]
    lists += [base[keep()] for _ in range(4)]
    lists += [np.sort(rng.choice(20000, size=900, replace=False)), np.zeros(0, np.int64)]
    lists += [np.asarray([10, TOP - 3, TOP]), np.asarray([11, TOP - 2, TOP - 1])]
    return lists


@pytest.fixture(scope="module")
def index():
    """(reference index, the port's server over its arrays, numpy arrays)."""
    ref = ref_build_compressed(_lists(20261017))
    arrays = {k: np.asarray(getattr(ref, k)) for k in TABLE + ("lengths",)}
    port = engine.BatchedServer.from_arrays(None, arrays, layout="fused",
                                            max_phrase=ref.max_phrase, n_docs=1.0,
                                            device="cpu")
    return ref, port, arrays


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
            ([0, 6] + first() * 2)[:width], [12] + (first() * 2)[:width - 1],
            ([13, 14] * width)[:width]]
    lens = [width, max(1, width - 1), 1, width, width, width, 2]
    qt = np.asarray(rows, np.int32)
    qt[1, lens[1]:] = rng.integers(0, 15, width - lens[1])
    return qt, np.asarray(lens, np.int32)


def _windows(arrays: dict, qt: np.ndarray) -> dict:
    n_rows = int(np.diff(arrays["c_offsets"])[qt[:, 0]].max())
    n_win = -(-n_rows // MAX_CAND_ROWS)
    return {"first": 0, "last": (n_win - 1) * MAX_CAND_ROWS,
            "past_end": (n_win + 1) * MAX_CAND_ROWS}


def _port_table(port) -> list[torch.Tensor]:
    return [port.arrays[k] for k in TABLE]


def _interpret_decode(g, b, n):
    return ref_fd_ops.decode_rows(g, b, n, interpret=True)


@pytest.mark.parametrize("window", ["first", "last", "past_end"])
@pytest.mark.parametrize("width", [2, 3, 5, 8])
@pytest.mark.parametrize("mode", [AND, PHRASE])
def test_window_ops_equal_reference(index, mode, width, window):
    ref, port, arrays = index
    qt, ql = _queries(width, mode, seed=width)
    row_start = _windows(arrays, qt)[window]
    phrase = mode == PHRASE
    L = max(int(ref.max_phrase), 1)
    c_offsets, anchors, c_ptr, c_len, pool = _port_table(port)
    ids = torch.from_numpy(qt)[:, 0]

    vals, valid = fd.decode_window_torch(pool, c_offsets, anchors, c_ptr, c_len, ids,
                                         row_start, MAX_CAND_ROWS, L)
    for decode in (None, _interpret_decode):
        rv, rvalid = ref_engine.fused_candidates_for(ref, jnp.asarray(qt[:, 0]), row_start,
                                                     decode=decode)
        assert np.array_equal(vals.numpy(), np.asarray(rv))
        assert np.array_equal(valid.numpy(), np.asarray(rvalid))
    wv, wvalid = decode_window_ref(*(arrays[k] for k in ("pool",) + TABLE[:4]), qt[:, 0],
                                   row_start, MAX_CAND_ROWS, L)
    assert np.array_equal(vals.numpy(), wv) and np.array_equal(valid.numpy(), wvalid)
    got = fd.decode_window(pool, c_offsets, anchors, c_ptr, c_len, ids, row_start,
                           MAX_CAND_ROWS, L)
    assert torch.equal(got[0], vals) and torch.equal(got[1], valid)

    match = fd.probe_window_torch(vals, valid, torch.from_numpy(qt), torch.from_numpy(ql),
                                  c_offsets, anchors, c_ptr, c_len, pool, phrase)
    for member in (None, ref_engine._kernel_member_fused(interpret=True)):
        want = ref_engine._probe_terms(ref, jnp.asarray(qt), jnp.asarray(ql), jnp.asarray(
            vals.numpy()), jnp.asarray(valid.numpy()), width, phrase, member=member)
        assert np.array_equal(match.numpy(), np.asarray(want))
    oracle = probe_window_ref(vals.numpy(), valid.numpy(), qt, ql,
                              *(arrays[k] for k in TABLE), phrase)
    assert np.array_equal(match.numpy(), oracle)
    assert torch.equal(match, fd.probe_window(vals, valid, torch.from_numpy(qt),
                                              torch.from_numpy(ql), c_offsets, anchors,
                                              c_ptr, c_len, pool, phrase))
    if window == "first":  # the cases must reach hits, misses and dead lanes
        assert 0 < int(match.sum()) < int(valid.sum()) < valid.numel()


@pytest.mark.parametrize("mode", [AND, PHRASE])
def test_window_ops_at_the_int32_top(index, mode):
    """Driving postings near 2^31 - 1: a phrase target past 2^31 - 2 misses
    instead of wrapping; the real pairs below it still hit."""
    ref, port, arrays = index
    qt = np.asarray([[13, 14], [14, 13]], np.int32)
    ql = np.asarray([2, 2], np.int32)
    c_offsets, anchors, c_ptr, c_len, pool = _port_table(port)
    L = max(int(ref.max_phrase), 1)
    vals, valid = fd.decode_window_torch(pool, c_offsets, anchors, c_ptr, c_len,
                                         torch.from_numpy(qt)[:, 0], 0, MAX_CAND_ROWS, L)
    match = fd.probe_window_torch(vals, valid, torch.from_numpy(qt), torch.from_numpy(ql),
                                  c_offsets, anchors, c_ptr, c_len, pool, mode == PHRASE)
    got = np.unique(vals.numpy()[0][match.numpy()[0]]) - 1
    assert np.array_equal(got, [10, TOP - 3] if mode == PHRASE else [])
    for member in (None, ref_engine._kernel_member_fused(interpret=True)):
        want = ref_engine._probe_terms(ref, jnp.asarray(qt), jnp.asarray(ql),
                                       jnp.asarray(vals.numpy()), jnp.asarray(valid.numpy()),
                                       2, mode == PHRASE, member=member)
        assert np.array_equal(match.numpy(), np.asarray(want))


@pytest.mark.parametrize("extra", [1, 7])
def test_decode_window_reads_clamp_at_the_pool_tail(index, extra):
    """Lanes past the pool's tail padding (L above max_phrase, a pool cut
    to its rows) read the pool's last word, as the oracle and the kernel
    do; valid lanes are unchanged."""
    ref, port, arrays = index
    L = int(ref.max_phrase) + extra
    cut = arrays["pool"][:len(arrays["pool"]) - int(ref.max_phrase)]
    c_offsets, anchors, c_ptr, c_len, _ = _port_table(port)
    ids = torch.tensor([11, 10, 12, 0], dtype=torch.int32)
    for row_start in (0, 640):
        got = fd.decode_window_torch(torch.from_numpy(cut.astype(np.int32)), c_offsets,
                                     anchors, c_ptr, c_len, ids, row_start, MAX_CAND_ROWS, L)
        want = decode_window_ref(cut, *(arrays[k] for k in TABLE[:4]), ids.numpy(),
                                 row_start, MAX_CAND_ROWS, L)
        assert np.array_equal(got[0].numpy(), want[0])
        assert np.array_equal(got[1].numpy(), want[1])


def test_window_ops_without_entries():
    """An empty entry table: decode gives zeros and no live lane; a probe
    misses on every active term (a query of one term keeps its valid
    candidates)."""
    t = lambda a: torch.tensor(a, dtype=torch.int32)  # noqa: E731
    pool, c_offsets, empty = t([0, 0]), t([0, 0, 0]), t([])
    vals, valid = fd.decode_window(pool, c_offsets, empty, empty, empty, t([0, 1]), 0,
                                   MAX_CAND_ROWS, 2)
    assert vals.shape == (2, 2 * MAX_CAND_ROWS) and not vals.any() and not valid.any()
    cand = t([[5, 6], [7, 8]])
    live = torch.tensor([[True, False], [True, True]])
    for phrase in (False, True):
        match = fd.probe_window(cand, live, t([[0, 1], [1, 0]]), t([2, 1]), c_offsets, empty,
                                empty, empty, pool, phrase)
        assert match.tolist() == [[False, False], [True, True]]


def test_window_ids_outside_the_table_read_in_range(index):
    """A list id past the offsets table reads its last entry (an empty
    slice), in the plain versions as in the kernels: no read out of range."""
    _, port, arrays = index
    c_offsets, anchors, c_ptr, c_len, pool = _port_table(port)
    n_lists = len(arrays["c_offsets"]) - 1
    ids = torch.tensor([n_lists, n_lists + 5], dtype=torch.int32)
    vals, valid = fd.decode_window(pool, c_offsets, anchors, c_ptr, c_len, ids, 0,
                                   MAX_CAND_ROWS, 4)
    assert not valid.any()
    qt = torch.tensor([[0, n_lists + 3]], dtype=torch.int32)
    cv, cval = fd.decode_window(pool, c_offsets, anchors, c_ptr, c_len, qt[:, 0], 0,
                                MAX_CAND_ROWS, 4)
    match = fd.probe_window(cv, cval, qt, torch.tensor([2], dtype=torch.int32), c_offsets,
                            anchors, c_ptr, c_len, pool, False)
    assert cval.any() and not match.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_plain_versions_equal_the_oracles(seed):
    """Random windows of 64, 5 and 1 rows over random pools and tables (ids
    and terms drawn over the whole table, lengths 0..W+1, invalid candidates
    and values near the top among the candidates) against the NumPy
    oracles."""
    rng = np.random.default_rng(seed)
    lists = [np.sort(rng.choice(3000, size=int(n), replace=False))
             for n in rng.integers(0, 200, 9)]
    ref = ref_build_compressed(lists)
    a = {k: np.asarray(getattr(ref, k)) for k in TABLE}
    tt = {k: torch.from_numpy(v.astype(np.int32)) for k, v in a.items()}
    b, w, L = 5, int(rng.integers(2, 7)), max(int(ref.max_phrase), 1)
    qt = rng.integers(0, len(lists), (b, w)).astype(np.int32)
    ql = rng.integers(0, w + 2, b).astype(np.int32)
    for row_start, window_rows in ((0, MAX_CAND_ROWS), (64, MAX_CAND_ROWS), (3, 5), (7, 1)):
        vals, valid = fd.decode_window_torch(tt["pool"], tt["c_offsets"], tt["anchors"],
                                             tt["c_ptr"], tt["c_len"], torch.from_numpy(qt[:, 0]),
                                             row_start, window_rows, L)
        want = decode_window_ref(a["pool"], a["c_offsets"], a["anchors"], a["c_ptr"],
                                 a["c_len"], qt[:, 0], row_start, window_rows, L)
        assert np.array_equal(vals.numpy(), want[0]) and np.array_equal(valid.numpy(), want[1])
        cand = vals.clone()
        cand[:, ::17] = torch.from_numpy(
            (2**31 - 1 - rng.integers(0, 4, cand[:, ::17].shape)).astype(np.int32))
        live = valid | (torch.from_numpy(rng.random(valid.shape) < 0.1))
        for phrase in (False, True):
            got = fd.probe_window_torch(cand, live, torch.from_numpy(qt), torch.from_numpy(ql),
                                        tt["c_offsets"], tt["anchors"], tt["c_ptr"], tt["c_len"],
                                        tt["pool"], phrase)
            oracle = probe_window_ref(cand.numpy(), live.numpy(), qt, ql, a["c_offsets"],
                                      a["anchors"], a["c_ptr"], a["c_len"], a["pool"], phrase)
            assert np.array_equal(got.numpy(), oracle)


MODES = [(AND, 0, False), (AND, 3, False), (AND, 0, True), (PHRASE, 0, False),
         (PHRASE, 0, True)]


@pytest.mark.parametrize("mode,topk,doclist", MODES)
def test_fused_kernel_step_equals_the_plain_step(index, mode, topk, doclist):
    """``make_serve_step(probe="kernel", layout="fused")`` (its wrappers take
    their plain versions for CPU tensors) returns what the plain step does,
    on every window, counting no launch."""
    ref, port, arrays = index
    qt, ql = _queries(4, mode, seed=3)
    kw = dict(max_terms=4, mode=mode, topk=topk, n_docs=1.0, doclist=doclist,
              layout="fused", max_phrase=ref.max_phrase)
    before = (fd.decode_window.launches, fd.probe_window.launches)
    plain = engine.make_serve_step(probe="torch", **kw)
    kernel = engine.make_serve_step(probe="kernel", **kw)
    for row_start in _windows(arrays, qt).values():
        want = plain(port.arrays, torch.from_numpy(qt), torch.from_numpy(ql), row_start)
        got = kernel(port.arrays, torch.from_numpy(qt), torch.from_numpy(ql), row_start)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (fd.decode_window.launches, fd.probe_window.launches) == before


def test_window_wrappers_count_no_launch_on_cpu(index):
    _, port, _ = index
    c_offsets, anchors, c_ptr, c_len, pool = _port_table(port)
    counts = lambda: (fd.decode_window.launches, fd.probe_window.launches,  # noqa: E731
                      fd.decode_rows.launches, fd.probe_rows.launches)
    before = counts()
    qt = torch.tensor([[0, 1]], dtype=torch.int32)
    vals, valid = fd.decode_window(pool, c_offsets, anchors, c_ptr, c_len, qt[:, 0], 0,
                                   MAX_CAND_ROWS, 3)
    fd.probe_window(vals, valid, qt, torch.tensor([2], dtype=torch.int32), c_offsets, anchors,
                    c_ptr, c_len, pool, True)
    assert counts() == before


def test_fused_kernel_probe_is_refused_on_the_cpu(index):
    """``probe="kernel"`` needs a CUDA device: a fused server or session on
    the CPU refuses it (``resolve_probe``)."""
    from repro_torch.core.index import NonPositionalIndex

    _, _, arrays = index
    with pytest.raises(ValueError, match="probe='kernel'"):
        engine.BatchedServer.from_arrays(None, arrays, layout="fused", max_phrase=4,
                                         n_docs=1.0, device="cpu", probe="kernel")
    idx = NonPositionalIndex.build(["a b c", "a b d", "b c d"], store="repair_skip")
    with pytest.raises(ValueError, match="probe='kernel'"):
        Session.build(idx, device="cpu", probe="kernel", layout="fused")


@pytest.mark.parametrize("case", ["device", "dtype", "stride", "shape", "width"])
def test_window_wrappers_refuse_what_the_kernels_do_not_take(index, case):
    """A tensor on another device than the CPU or CUDA, a wrong dtype, a
    strided column where a contiguous one is needed, mismatched shapes and
    too wide a query are refused before any launch."""
    _, port, _ = index
    table = [x.to("meta") for x in _port_table(port)]
    c_offsets, anchors, c_ptr, c_len, pool = table
    m = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device="meta")  # noqa: E731
    calls = {
        "device": (ValueError, "lies on", lambda: fd.decode_window(
            pool, c_offsets, anchors, c_ptr, c_len, m(2), 0, MAX_CAND_ROWS, 4)),
        "dtype": (TypeError, "int32", lambda: fd.probe_window(
            m(2, 8, dt=torch.int64), m(2, 8, dt=torch.bool), m(2, 2), m(2), c_offsets, anchors,
            c_ptr, c_len, pool, False)),
        "stride": (ValueError, "contiguous", lambda: fd.probe_window(
            m(2, 8), m(2, 8, dt=torch.bool), m(2, 4)[:, ::2], m(2), c_offsets, anchors, c_ptr,
            c_len, pool, False)),
        "shape": (ValueError, "rows", lambda: fd.decode_window(
            pool, c_offsets, anchors, c_ptr[:-1], c_len, m(2), 0, MAX_CAND_ROWS, 4)),
        "width": (ValueError, "at most", lambda: fd.probe_window(
            m(1, 8), m(1, 8, dt=torch.bool), m(1, fd.MAX_WINDOW_TERMS + 1), m(1), c_offsets,
            anchors, c_ptr, c_len, pool, False)),
    }
    exc, text, call = calls[case]
    if case == "device":  # a meta tensor is neither a CPU nor a CUDA tensor
        with pytest.raises(exc, match=text):
            call()
        return
    # the checks past the device one need CUDA tensors; on the CPU they are
    # reached through meta tensors with the device check passed
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fd.cuda_build, "require_cuda", lambda name, t: None)
        with pytest.raises(exc, match=text):
            call()


@pytest.mark.parametrize("row_stride", [False, True])
def test_require_int32_row_stride(row_stride):
    """``require_int32(..., row_stride=True)`` takes a column view (1-D, any
    stride) and rows read by a stride (2-D, contiguous last dimension),
    which the default refuses; a strided last dimension is refused by both."""
    from repro_torch.kernels import cuda_build

    wide = torch.zeros((4, 6), dtype=torch.int32)
    for t, ndim in ((wide[:, 0], 1), (wide[:, :3], 2)):
        if row_stride:
            cuda_build.require_int32("t", t, ndim, row_stride=True)
        else:
            with pytest.raises(ValueError, match="contiguous"):
                cuda_build.require_int32("t", t, ndim)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_build.require_int32("t", wide[:, ::2], 2, row_stride=row_stride)
