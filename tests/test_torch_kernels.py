"""The port's kernel ops on the CPU: each op's plain PyTorch version against
the JAX op (Pallas, interpret mode) and against the NumPy oracles, over the
shape sweeps of ``tests/test_kernels.py`` with the tile-boundary ±1 cases.
Integers and bools: tolerance 0.  The CUDA kernels themselves cannot run
here; ``chip_smoke.py`` holds them against these plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import anchors as ref_anchors
from repro.core.repair import RePairStore as RefRePairStore
from repro.kernels.anchor_intersect import ops as ref_ai_ops
from repro.kernels.anchor_intersect.ref import anchor_probe_ref as ref_probe_oracle
from repro.kernels.anchor_intersect.ref import anchor_probe_sliced_ref as ref_sliced_ref
from repro.kernels.dgap_decode import ops as ref_dg_ops
from repro.kernels.fused_decode import ops as ref_fd_ops
from repro.kernels.fused_decode.ref import decode_rows_ref as ref_decode_ref
from repro.kernels.fused_decode.ref import probe_rows_ref as ref_probe_ref
from repro_torch.core import anchors as port_anchors
from repro_torch.kernels.anchor_intersect import ops as ai_ops
from repro_torch.kernels.anchor_intersect.ref import anchor_probe_ref, anchor_probe_sliced_ref
from repro_torch.kernels.dgap_decode import ops as dg_ops
from repro_torch.kernels.dgap_decode.ref import dgap_decode_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fdec_ops
from repro_torch.kernels.fused_decode import ops as fd_ops
from repro_torch.kernels.fused_decode.ref import decode_rows_ref, probe_rows_ref
from repro_torch.kernels.cin_interaction import ops as cin_ops
from repro_torch.kernels.cin_interaction.ref import cin_layer_ref
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.moe_gemm import ops as mg_ops
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _rows_as_pool(gaps: np.ndarray):
    """Lay rectangular (R, L) rows out as a pool: row r at ptr[r] = r * L,
    plus L zeros of tail padding (the layout the port's ops read)."""
    r, l = gaps.shape
    pool = np.concatenate([gaps.reshape(-1), np.zeros(max(l, 1), gaps.dtype)])
    return pool.astype(np.int32), (np.arange(r) * l).astype(np.int32)


@pytest.mark.parametrize("r,l", [(0, 8), (1, 1), (3, 41), (255, 127), (256, 128), (257, 129)])
def test_decode_rows_vs_jax_and_oracles(r, l):
    rng = np.random.default_rng(1000 + 7 * r + l)
    gaps = rng.integers(1, 50, size=(r, l)).astype(np.int32)
    lens = rng.integers(0, l + 1, size=r).astype(np.int32)
    base = rng.integers(0, 10**6, size=r).astype(np.int32)
    pool, ptr = _rows_as_pool(gaps)
    vals, valid = fd_ops.decode_rows(t32(pool), t32(ptr), t32(base), t32(lens), l)
    assert vals.dtype == torch.int32 and valid.dtype == torch.bool
    assert tuple(vals.shape) == (r, l) and tuple(valid.shape) == (r, l)
    jv, jvalid = ref_fd_ops.decode_rows(jnp.asarray(gaps), jnp.asarray(base),
                                        jnp.asarray(lens), interpret=True)
    # every lane, not only the live ones: dead lanes hold base + row value too
    assert np.array_equal(vals.numpy(), np.asarray(jv))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    rv, rvalid = ref_decode_ref(gaps, base, lens)
    assert np.array_equal(vals.numpy(), rv) and np.array_equal(valid.numpy(), rvalid)
    pv, pvalid = decode_rows_ref(pool, ptr, base, lens, l)
    assert np.array_equal(vals.numpy(), pv) and np.array_equal(valid.numpy(), pvalid)


@pytest.mark.parametrize("r,l", [(0, 8), (1, 1), (3, 41), (255, 127), (256, 128), (257, 129)])
def test_probe_rows_vs_jax_and_oracles(r, l):
    rng = np.random.default_rng(2000 + 7 * r + l)
    gaps = np.cumsum(rng.integers(1, 50, size=(r, l)), axis=1).astype(np.int32)
    lens = rng.integers(0, l + 1, size=r).astype(np.int32)
    base = rng.integers(0, 10**6, size=r).astype(np.int32)
    rvals, _ = ref_decode_ref(gaps, base, lens)
    hit_lane = rng.integers(0, np.maximum(lens, 1))
    targets = np.where(np.arange(r) % 2 == 0,
                       rvals[np.arange(r), hit_lane] if r else 0, -5).astype(np.int32)
    pool, ptr = _rows_as_pool(gaps)
    got = fd_ops.probe_rows(t32(pool), t32(ptr), t32(base), t32(lens), t32(targets))
    assert got.dtype == torch.bool and tuple(got.shape) == (r,)
    jhit = ref_fd_ops.probe_rows(jnp.asarray(gaps), jnp.asarray(base), jnp.asarray(lens),
                                 jnp.asarray(targets), interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(jhit))
    assert np.array_equal(got.numpy(), ref_probe_ref(gaps, base, lens, targets))
    assert np.array_equal(got.numpy(), probe_rows_ref(pool, ptr, base, lens, targets))
    if r:
        assert got.numpy()[(np.arange(r) % 2 == 0) & (lens > 0)].all()
        assert not got.numpy()[lens == 0].any()


def test_probe_rows_plain_version_chunks(monkeypatch):
    """The plain probe stages its (rows, L) gather in chunks; a tiny chunk
    size must not change the answer."""
    rng = np.random.default_rng(5)
    gaps = np.cumsum(rng.integers(1, 9, size=(300, 17)), axis=1).astype(np.int32)
    lens = rng.integers(0, 18, size=300).astype(np.int32)
    base = rng.integers(0, 1000, size=300).astype(np.int32)
    targets = (base + gaps[np.arange(300), rng.integers(0, 17, 300)]).astype(np.int32)
    pool, ptr = _rows_as_pool(gaps)
    args = (t32(pool), t32(ptr), t32(base), t32(lens), t32(targets))
    whole = fd_ops.probe_rows_torch(*args)
    monkeypatch.setattr(fd_ops, "PROBE_CHUNK_ELEMS", 64)
    assert torch.equal(fd_ops.probe_rows_torch(*args), whole)


def test_decode_rows_reads_clamp_to_the_pool():
    """A row that points near the pool's end reads the last element instead
    of running off the allocation (same rule in op, oracle and kernel)."""
    pool = np.asarray([3, 5, 9, 0], np.int32)
    ptr, base, lens = np.asarray([2], np.int32), np.asarray([10], np.int32), np.asarray([1], np.int32)
    vals, valid = fd_ops.decode_rows(t32(pool), t32(ptr), t32(base), t32(lens), 4)
    assert vals.tolist() == [[19, 10, 10, 10]] and valid.tolist() == [[True, False, False, False]]
    pv, _ = decode_rows_ref(pool, ptr, base, lens, 4)
    assert np.array_equal(vals.numpy(), pv)


def _sliced_case(rng, nq, na, nl):
    bounds = np.sort(np.concatenate([[0, na], rng.integers(0, na, nl - 1)]))
    # strictly increasing inside each slice (as prefix sums of phrase sums are)
    anchors = np.concatenate(
        [np.sort(rng.choice(10**6, size=hi - lo, replace=False))
         for lo, hi in zip(bounds[:-1], bounds[1:])] + [np.zeros(0, np.int64)])
    lists = rng.integers(0, nl, nq)
    lo = bounds[lists].astype(np.int32)
    hi = bounds[lists + 1].astype(np.int32)
    queries = rng.integers(0, 10**6, nq).astype(np.int32)
    if nq > 4:
        queries[0] = 2**31 - 2  # above every anchor -> hi
        queries[1] = -7  # below every anchor -> lo
        queries[2] = anchors[lo[2]] if hi[2] > lo[2] else 0  # exact hit on the first
    return queries, lo, hi, anchors.astype(np.int32)


@pytest.mark.parametrize("nq,na,nl", [(1, 1, 1), (7, 100, 3), (255, 2047, 9), (256, 2048, 9),
                                      (257, 2049, 9), (300, 5000, 12), (1024, 2048, 40)])
def test_anchor_probe_sliced_vs_jax_and_oracles(nq, na, nl):
    rng = np.random.default_rng(3000 + nq + na)
    queries, lo, hi, anchors = _sliced_case(rng, nq, na, nl)
    got = ai_ops.anchor_probe_sliced(t32(queries), t32(lo), t32(hi), t32(anchors))
    assert got.dtype == torch.int32 and tuple(got.shape) == (nq,)
    jgot = ref_ai_ops.anchor_probe_sliced(jnp.asarray(queries), jnp.asarray(lo),
                                          jnp.asarray(hi), jnp.asarray(anchors),
                                          interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(jgot))
    assert np.array_equal(got.numpy(), ref_sliced_ref(queries, lo, hi, anchors))
    assert np.array_equal(got.numpy(), anchor_probe_sliced_ref(queries, lo, hi, anchors))


def test_anchor_probe_sliced_empty_inputs():
    e = t32(np.zeros(0))
    out = ai_ops.anchor_probe_sliced(e, e, e, t32([1, 2, 3]))
    assert out.dtype == torch.int32 and out.numel() == 0
    # an empty slice returns lo, whatever the query
    out = ai_ops.anchor_probe_sliced(t32([5, -1]), t32([2, 0]), t32([2, 0]), t32([1, 2, 3]))
    assert out.tolist() == [2, 0]


def _member_lists(rng):
    lists = []
    for i in range(12):
        if i == 5:
            lists.append(np.asarray([], dtype=np.int64))  # empty list
        else:
            lists.append(np.flatnonzero(
                np.repeat(rng.random(40) < 0.4, 10)).astype(np.int64))
    return lists


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_member_batch_vs_reference(seed):
    """member_batch / member_batch_compressed / the kernel-split membership
    against the reference on random (list, value) pairs, empty lists and
    out-of-range values included."""
    rng = np.random.default_rng(seed)
    lists = _member_lists(rng)
    store = RefRePairStore.build(lists, variant="skip")
    ref_dense = ref_anchors.AnchoredIndex.from_store(store)
    ref_comp = ref_anchors.CompressedAnchoredIndex.from_store(store)
    dense = port_anchors.AnchoredIndex.from_numpy(
        {k: np.asarray(getattr(ref_dense, k)) for k in
         ("anchors", "c_offsets", "expand", "expand_valid", "lengths")}, device="cpu")
    comp = port_anchors.CompressedAnchoredIndex.from_numpy(
        {**{k: np.asarray(getattr(ref_comp, k)) for k in
            ("anchors", "c_offsets", "c_ptr", "c_len", "pool", "lengths")},
         "max_phrase": ref_comp.max_phrase}, device="cpu")
    ids = rng.integers(0, len(lists), 400).astype(np.int32)
    vals = rng.integers(-1, 500, 400).astype(np.int32)
    want = np.asarray(ref_anchors.member_batch(ref_dense, jnp.asarray(ids), jnp.asarray(vals)))
    want_c = np.asarray(ref_anchors.member_batch_compressed(
        ref_comp, jnp.asarray(ids), jnp.asarray(vals)))
    truth = np.asarray([v in set(lists[i].tolist()) for i, v in zip(ids, vals)])
    assert np.array_equal(want, truth) and np.array_equal(want_c, truth)
    got = port_anchors.member_batch(dense, t32(ids), t32(vals)).numpy()
    got_c = port_anchors.member_batch_compressed(comp, t32(ids), t32(vals)).numpy()
    got_k = ai_ops.member_batch_kernel(dense.anchors, dense.c_offsets, dense.expand,
                                       dense.expand_valid, t32(ids), t32(vals)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got_c, want_c)
    assert np.array_equal(got_k, want)
    assert not got[ids == 5].any() and not got_c[ids == 5].any()


def test_member_batch_compressed_without_entries():
    """anchors.shape[0] == 0 (every list empty): nothing matches, nothing is
    gathered."""
    comp = port_anchors.build_compressed_anchored(
        [np.zeros(0, np.int64), np.zeros(0, np.int64)], device="cpu")
    assert comp.anchors.shape[0] == 0
    got = port_anchors.member_batch_compressed(comp, t32([0, 1, 0]), t32([0, 5, 9]))
    assert got.tolist() == [False, False, False]
    ref = ref_anchors.build_compressed_anchored(
        [np.zeros(0, np.int64), np.zeros(0, np.int64)])
    want = ref_anchors.member_batch_compressed(ref, jnp.asarray([0, 1, 0]),
                                               jnp.asarray([0, 5, 9]))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_row_compare_chunks(monkeypatch):
    """The dense row compare stages its gather in chunks; a tiny chunk size
    must not change the answer."""
    rng = np.random.default_rng(3)
    idx = port_anchors.build_anchored(_member_lists(rng), device="cpu")
    ids = t32(rng.integers(0, 12, 500))
    vals = t32(rng.integers(0, 450, 500))
    whole = port_anchors.member_batch(idx, ids, vals)
    monkeypatch.setattr(port_anchors, "ROW_CHUNK_ELEMS", 100)
    assert torch.equal(port_anchors.member_batch(idx, ids, vals), whole)


def test_launch_counts_stay_zero_on_cpu():
    """A CPU tensor takes the plain version and never counts as a launch."""
    from repro_torch.kernels.minhash_sig import ops as mh_ops

    counts = lambda: (ai_ops.anchor_probe_sliced.launches,  # noqa: E731
                      fd_ops.decode_rows.launches, fd_ops.probe_rows.launches,
                      mh_ops.minhash_rows.launches, ai_ops.anchor_probe.launches,
                      dg_ops.dgap_decode.launches)
    before = counts()
    ai_ops.anchor_probe_sliced(t32([1]), t32([0]), t32([1]), t32([1]))
    ai_ops.anchor_probe(t32([1, 5]), t32([1, 2, 3]))
    dg_ops.dgap_decode(t32([1, 2, 3]))
    fd_ops.decode_rows(t32([1, 0]), t32([0]), t32([0]), t32([1]), 1)
    fd_ops.probe_rows(t32([1, 0]), t32([0]), t32([0]), t32([1]), t32([1]))
    mh_ops.minhash_rows(t32([[5, 6]]), t32([2]), t32([3]), t32([1]))
    assert before == counts()


def test_kernel_probe_needs_a_cuda_device():
    """probe="kernel" on a CPU server raises; so does the default device
    when there is no GPU."""
    from repro_torch.core.index import NonPositionalIndex
    from repro_torch.serving.engine import BatchedServer, make_serve_step

    idx = NonPositionalIndex.build(["a b c", "a b d", "b c d"], store="repair_skip")
    with pytest.raises(ValueError, match="probe='kernel'"):
        BatchedServer.from_index(idx, device="cpu", probe="kernel")
    with pytest.raises(ValueError, match="unknown probe"):
        BatchedServer.from_index(idx, device="cpu", probe="vmap")
    with pytest.raises(ValueError, match="unknown probe"):
        make_serve_step(probe="pallas")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            BatchedServer.from_index(idx)  # device defaults to "cuda"
    assert BatchedServer.from_index(idx, device="cpu").probe == "torch"


def test_wrapper_refuses_wrong_dtype_on_check():
    """The argument checks of the CUDA path (exercised directly: no GPU is
    needed to refuse a tensor)."""
    from repro_torch.kernels import cuda_build

    with pytest.raises(TypeError, match="int32"):
        cuda_build.require_int32("x", torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="dimension"):
        cuda_build.require_int32("x", torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_build.require_int32("x", torch.zeros(6, dtype=torch.int32)[::2])
    with pytest.raises(TypeError, match="Tensor"):
        cuda_build.require_int32("x", np.zeros(3, np.int32))


def test_kernel_sources_are_in_the_package():
    from repro_torch.kernels import cuda_build

    names = {p.name for p in cuda_build.CSRC_DIR.glob("*.cu")}
    assert {"anchor_intersect.cu", "fused_decode.cu", "minhash_sig.cu", "dgap_decode.cu",
            "flash_attention.cu", "flash_decode.cu", "common.cu"} <= names
    text = "".join(p.read_text() for p in cuda_build.CSRC_DIR.glob("*.cu"))
    for entry in cuda_build.SIGNATURES:
        assert f" {entry}(" in text, entry  # every bound entry point exists


@pytest.mark.parametrize("n", [0, 1, 2, 255, 4095, 4096, 4097, 8191, 8192, 8193, 65535,
                               65536, 65537, 131072 + 13])
def test_dgap_decode_vs_jax_and_oracle(n):
    """n over one and two of the port's 4096-value tiles and the reference's
    65,536-value tile, ± 1, plus the n <= 1 shortcuts."""
    rng = np.random.default_rng(4000 + n)
    g = rng.integers(1, 2**20, n).astype(np.int32)
    got = dg_ops.dgap_decode(t32(g))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n,)
    want = np.asarray(ref_dg_ops.dgap_decode(jnp.asarray(g), interpret=True))
    assert want.dtype == np.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), dgap_decode_ref(g) - 1)


@pytest.mark.parametrize("case", ["wraps", "negative", "int64_input"])
def test_dgap_decode_wraps_like_the_reference(case):
    """70,000 gaps of 40,000 sum past 2^31: both sides wrap in int32; so do
    negative gaps below -2^31.  An int64 input is cast to int32 first, as
    the reference op casts."""
    rng = np.random.default_rng(7)
    if case == "wraps":
        g = np.full(70_000, 40_000, np.int32)
    elif case == "negative":
        g = rng.integers(-2**31, 2**31, 70_001).astype(np.int32)
    else:
        g = rng.integers(-2**31, 2**31, 5000).astype(np.int64)
    got = dg_ops.dgap_decode(torch.from_numpy(g))
    want = np.asarray(ref_dg_ops.dgap_decode(jnp.asarray(g.astype(np.int32)),
                                             interpret=True))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    if case == "wraps":
        assert int(got[-1]) == (70_000 * 40_000 - 1) - 2**32
    assert np.array_equal(got.numpy(), dgap_decode_ref(g.astype(np.int32)) - 1)


def _probe_case(rng, nq, na, dups=False):
    anchors = np.sort(rng.integers(0, 10**6, na)) if dups else \
        np.unique(rng.integers(0, 10**6, na))
    if dups and na > 4:
        anchors[na // 2: na // 2 + 4] = anchors[na // 2]  # a run of equal anchors
    half = rng.choice(anchors, nq // 2 + 1) if na else rng.integers(0, 10**6, nq // 2 + 1)
    queries = np.concatenate([rng.integers(-5, 10**6 + 5, nq // 2), half])[:nq]
    if nq > 3:
        queries[:3] = [-2**31, 2**31 - 2, anchors[na // 2] if na else 0]
    return queries.astype(np.int32), anchors.astype(np.int32)


@pytest.mark.parametrize("nq,na,dups", [(1, 1, False), (7, 100, False), (300, 5000, False),
                                        (1024, 2048, False), (257, 2049, True),
                                        (300, 17, True)])
def test_anchor_probe_vs_jax_and_oracles(nq, na, dups):
    rng = np.random.default_rng(5000 + nq + na)
    queries, anchors = _probe_case(rng, nq, na, dups)
    idx, found = ai_ops.anchor_probe(t32(queries), t32(anchors))
    assert idx.dtype == found.dtype == torch.int32
    assert tuple(idx.shape) == tuple(found.shape) == (nq,)
    jidx, jfound = ref_ai_ops.anchor_probe(jnp.asarray(queries), jnp.asarray(anchors),
                                           interpret=True)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(found.numpy(), np.asarray(jfound))
    ridx, rfound = ref_probe_oracle(jnp.asarray(queries), jnp.asarray(anchors))
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert np.array_equal(found.numpy(), np.asarray(rfound))
    pidx, pfound = anchor_probe_ref(queries, anchors)
    assert np.array_equal(idx.numpy(), pidx) and np.array_equal(found.numpy(), pfound)
    assert np.array_equal(idx.numpy(), np.searchsorted(anchors, queries, side="right"))
    assert np.array_equal(found.numpy().astype(bool), np.isin(queries, anchors))


def test_anchor_probe_empty_inputs():
    e = t32(np.zeros(0))
    idx, found = ai_ops.anchor_probe(t32([3, -1, 7]), e)  # NA == 0
    assert idx.tolist() == found.tolist() == [0, 0, 0]
    assert idx.dtype == found.dtype == torch.int32
    pidx, pfound = anchor_probe_ref([3, -1, 7], [])
    assert pidx.tolist() == pfound.tolist() == [0, 0, 0]
    idx, found = ai_ops.anchor_probe(e, t32([1, 2]))  # NQ == 0
    assert idx.numel() == found.numel() == 0 and idx.dtype == torch.int32


def test_new_wrappers_refuse_other_devices():
    """A CPU tensor takes the plain version, a CUDA tensor the kernel; a
    tensor on any other device is refused, and counts no launch."""
    before = (ai_ops.anchor_probe.launches, dg_ops.dgap_decode.launches)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="lies on meta"):
        dg_ops.dgap_decode(meta)
    with pytest.raises(ValueError, match="lies on meta"):
        ai_ops.anchor_probe(meta, meta)
    assert before == (ai_ops.anchor_probe.launches, dg_ops.dgap_decode.launches)


def test_package_exports_the_index_side_ops():
    """``repro_torch.kernels`` exports every public op of the reference —
    the index-side ones and, since the model-side slice, ``cin_layer``,
    ``embedding_bag`` and ``moe_gemm`` — and importing it builds and loads
    nothing."""
    import subprocess
    import sys
    from pathlib import Path

    import repro.kernels as ref_kernels
    import repro_torch.kernels as kernels

    assert sorted(kernels.__all__) == sorted(ref_kernels.__all__)
    assert len(kernels.__all__) == 11
    for name in kernels.__all__:
        assert callable(getattr(kernels, name)), name
    assert kernels.anchor_probe is ai_ops.anchor_probe
    assert kernels.dgap_decode is dg_ops.dgap_decode
    assert kernels.flash_attention_tpu is fa_ops.flash_attention_tpu
    assert kernels.flash_decode is fdec_ops.flash_decode
    assert kernels.embedding_bag is eb_ops.embedding_bag
    assert kernels.cin_layer is cin_ops.cin_layer
    assert kernels.moe_gemm is mg_ops.moe_gemm
    src = Path(__file__).resolve().parent.parent / "src"
    code = ("import sys, repro_torch.kernels as k\n"
            "from repro_torch.kernels import cuda_build\n"
            "assert cuda_build._lib is None and not cuda_build.build_info\n"
            "assert 'jax' not in sys.modules\n"
            "print(len(k.__all__))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(src), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "11"


# ----------------------------------------------------------------------
# the attention kernels' plain versions against the Pallas ops
# ----------------------------------------------------------------------
def _jax_and_torch(arrs, dtype):
    as_jax = [jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
              for a in arrs]
    # the port gets the same values, rounded to bf16 by JAX when bf16
    as_torch = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype) for a in as_jax]
    return as_jax, as_torch


def _attn_inputs(seed: int, shapes, dtype):
    rng = np.random.default_rng(seed)
    return _jax_and_torch([rng.normal(size=s).astype(np.float32) for s in shapes], dtype)


def _to_kernel_layout(q, k, v):
    """Model layout -> the TPU kernel's (B*K, G, T, hd) / (B*K, S, hd), as NumPy."""
    q, k, v = (np.asarray(x, dtype=np.float32) for x in (q, k, v))
    b, t, h, hd = q.shape
    kh = k.shape[2]
    qk = np.moveaxis(q.reshape(b, t, kh, h // kh, hd), 1, 3).reshape(b * kh, h // kh, t, hd)
    kk = np.moveaxis(k, 1, 2).reshape(b * kh, -1, hd)
    vk = np.moveaxis(v, 1, 2).reshape(b * kh, -1, hd)
    return qk, kk, vk


#: the reference's own tolerances (tests/test_kernels.py:160, 214): float32
#: sums in another order; bf16 outputs one rounding of a value near 1 apart
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
DECODE_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("b,t,h,kh,hd", [(1, 256, 4, 2, 64), (2, 300, 8, 4, 128),
                                         (1, 513, 2, 1, 32), (1, 512, 3, 1, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_vs_pallas(b, t, h, kh, hd, dtype, causal):
    """flash_attention_torch against the Pallas op in interpret mode and the
    float64 NumPy oracle.  Non-causal, the Pallas op's zero-padded keys
    (S padded to a multiple of 512) take part in its softmax, so it is held
    only where S needs no padding; the oracle holds every shape."""
    from repro.kernels.flash_attention.ops import flash_attention_tpu as ref_flash
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref

    (jq, jk, jv), (q, k, v) = _attn_inputs(7 * t + hd, [(b, t, h, hd), (b, t, kh, hd),
                                                        (b, t, kh, hd)], dtype)
    got = fa_ops.flash_attention_tpu(q, k, v, causal)
    assert got.dtype == dtype and tuple(got.shape) == (b, t, h, hd)
    assert torch.equal(got, fa_ops.flash_attention_torch(q, k, v, causal))
    tol = FLASH_TOL[dtype]
    if causal or t % 512 == 0:
        want = np.asarray(ref_flash(jq, jk, jv, causal=causal, interpret=True)
                          .astype(jnp.float32))
        assert float(np.abs(got.float().numpy() - want).max()) < tol
    oracle = flash_fwd_ref(*_to_kernel_layout(q.float(), k.float(), v.float()), causal=causal)
    oracle = np.moveaxis(oracle.reshape(b, kh, h // kh, t, hd), 3, 1).reshape(b, t, h, hd)
    assert float(np.abs(got.float().numpy() - oracle).max()) < tol


def test_flash_attention_pallas_counts_padded_keys_without_causal():
    """The reference's Pallas op, non-causal at S = 256 (padded to 512),
    lets the 256 zero keys into its softmax; the port attends to the S real
    keys, as the oracle does."""
    from repro.kernels.flash_attention.ops import flash_attention_tpu as ref_flash
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref

    (jq, jk, jv), (q, k, v) = _attn_inputs(3, [(1, 256, 2, 32), (1, 256, 1, 32),
                                               (1, 256, 1, 32)], torch.float32)
    got = fa_ops.flash_attention_tpu(q, k, v, causal=False).numpy()
    oracle = flash_fwd_ref(*_to_kernel_layout(q, k, v), causal=False)
    oracle = np.moveaxis(oracle.reshape(1, 1, 2, 256, 32), 3, 1).reshape(1, 256, 2, 32)
    assert np.abs(got - oracle).max() < 1e-5
    pallas = np.asarray(ref_flash(jq, jk, jv, causal=False, interpret=True))
    assert np.abs(pallas - oracle).max() > 0.05


@pytest.mark.parametrize("b,s,h,kh,hd", [(2, 512, 4, 2, 64), (1, 1024, 8, 8, 128),
                                         (3, 700, 4, 1, 32), (2, 33, 6, 2, 16)])
@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16)])
def test_flash_decode_plain_vs_pallas(b, s, h, kh, hd, q_dtype, kv_dtype):
    """flash_decode_torch against the Pallas op in interpret mode, the
    reference's decode_attention and the NumPy oracle; positions include 0
    and S - 1, and an f32 q meets a bf16 cache (each cast to f32 on its
    own, as the Pallas kernel does)."""
    from repro.kernels.flash_decode.ops import flash_decode as ref_decode
    from repro.models.layers import decode_attention as ref_decode_attention
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    rng = np.random.default_rng(11 * s + hd)
    (jq,), (q,) = _attn_inputs(s, [(b, 1, h, hd)], q_dtype)
    (jk, jv), (k, v) = _attn_inputs(s + 1, [(b, s, kh, hd), (b, s, kh, hd)], kv_dtype)
    pos = rng.integers(0, s, b).astype(np.int32)
    pos[0] = 0
    pos[-1] = s - 1
    got = fdec_ops.flash_decode(q, k, v, torch.from_numpy(pos))
    assert got.dtype == q_dtype and tuple(got.shape) == (b, 1, h, hd)
    tol = DECODE_TOL[q_dtype]
    jpos = jnp.asarray(pos)
    for want in (ref_decode(jq, jk, jv, jpos, interpret=True),
                 ref_decode_attention(jq, jk, jv, jpos)):
        want = np.asarray(want.astype(jnp.float32))
        assert float(np.abs(got.float().numpy() - want).max()) < tol
    g = h // kh
    oracle = flash_decode_ref(np.repeat(pos + 1, kh),
                              q.float().numpy()[:, 0].reshape(b * kh, g, hd),
                              *(np.moveaxis(x.float().numpy(), 1, 2).reshape(b * kh, s, hd)
                                for x in (k, v)))
    assert float(np.abs(got.float().numpy() - oracle.reshape(b, 1, h, hd)).max()) < tol


def test_flash_decode_position_zero_sees_one_row():
    """Position 0 attends to the first cache row alone: the output is v[0]."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 40, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 40, 2, 32)).astype(np.float32))
    got = fdec_ops.flash_decode(q, k, v, torch.zeros(2, dtype=torch.int32))
    want = v[:, 0].repeat_interleave(2, dim=1)[:, None]
    assert torch.allclose(got, want, atol=1e-6, rtol=0)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "head_dim", "shape", "grouping",
                                  "stride", "device"])
def test_flash_attention_refuses_what_the_kernel_does_not_take(case):
    """Every argument check of the CUDA path, on meta tensors (no GPU needed
    to refuse); a refusal counts no launch."""
    q, k = _meta(1, 8, 4, 32), _meta(1, 8, 2, 32)
    args = {"dtype": (_meta(1, 8, 4, 32, dtype=torch.float64), k, k),
            "mixed_dtype": (q, _meta(1, 8, 2, 32, dtype=torch.bfloat16), k),
            "head_dim": (_meta(1, 8, 4, 48), _meta(1, 8, 2, 48), _meta(1, 8, 2, 48)),
            "shape": (q, k, _meta(1, 9, 2, 32)),
            "grouping": (_meta(1, 8, 3, 32), k, k),
            "stride": (_meta(1, 8, 4, 64)[..., ::2], k, k),
            "device": (q, k, k)}[case]
    text = {"dtype": "float32 or bfloat16", "mixed_dtype": "one dtype",
            "head_dim": "head_dim 48", "shape": "do not fit", "grouping": "multiple",
            "stride": "contiguous", "device": "lies on meta"}[case]
    before = fa_ops.flash_attention_tpu.launches
    with pytest.raises((TypeError, ValueError), match=text):
        fa_ops.flash_attention_tpu(*args)
    assert fa_ops.flash_attention_tpu.launches == before


@pytest.mark.parametrize("case", ["dtype", "cache_dtypes", "head_dim", "group", "positions",
                                  "positions_dtype", "device"])
def test_flash_decode_refuses_what_the_kernel_does_not_take(case):
    q, c = _meta(2, 1, 4, 32), _meta(2, 16, 2, 32)
    pos = _meta(2, dtype=torch.int32)
    args = {"dtype": (_meta(2, 1, 4, 32, dtype=torch.float16), c, c, pos),
            "cache_dtypes": (q, c, _meta(2, 16, 2, 32, dtype=torch.bfloat16), pos),
            "head_dim": (_meta(2, 1, 4, 8), _meta(2, 16, 2, 8), _meta(2, 16, 2, 8), pos),
            "group": (_meta(2, 1, 34, 32), c, c, pos),
            "positions": (q, c, c, _meta(3, dtype=torch.int32)),
            "positions_dtype": (q, c, c, _meta(2, dtype=torch.int64)),
            "device": (q, c, c, pos)}[case]
    text = {"dtype": "float32 or bfloat16", "cache_dtypes": "one cache dtype",
            "head_dim": "head_dim 8", "group": "at most 16", "positions": "positions has",
            "positions_dtype": "int32", "device": "lies on meta"}[case]
    before = fdec_ops.flash_decode.launches
    with pytest.raises((TypeError, ValueError), match=text):
        fdec_ops.flash_decode(*args)
    assert fdec_ops.flash_decode.launches == before


def test_attention_wrappers_count_no_launch_on_cpu():
    before = (fa_ops.flash_attention_tpu.launches, fdec_ops.flash_decode.launches)
    x = torch.zeros(1, 4, 2, 16)
    fa_ops.flash_attention_tpu(x, x[:, :, :1], x[:, :, :1])
    fdec_ops.flash_decode(x[:, :1], x, x, torch.zeros(1, dtype=torch.int32))
    assert before == (fa_ops.flash_attention_tpu.launches, fdec_ops.flash_decode.launches)


# ----------------------------------------------------------------------
# the model-side kernels' plain versions against the Pallas ops
# ----------------------------------------------------------------------
def _gamma(n: int) -> float:
    """n u / (1 - n u), u = 2^-24: the relative bound on a float32 sum of n
    terms in any order, over the sum of the terms' magnitudes."""
    return n * 2.0 ** -24 / (1 - n * 2.0 ** -24)


def _jax_pair(rng, shape, dtype):
    a = rng.normal(size=shape).astype(np.float32)
    j = jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(dtype)


@pytest.mark.parametrize("nb,bs,v,d", [(2, 2, 10, 8), (16, 39, 1000, 10), (8, 5, 128, 130),
                                       (3, 1, 7, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_plain_vs_pallas(nb, bs, v, d, dtype):
    """Both sum each bag from 0 in index order in float32: equal bit for bit
    (the reference's op pads D to 128 and slices it back)."""
    from repro.kernels.embedding_bag.ops import embedding_bag as ref_embedding_bag
    from repro.kernels.embedding_bag.ref import embedding_bag_ref as ref_oracle

    rng = np.random.default_rng(nb * 100 + bs)
    idx = rng.integers(0, v, (nb, bs)).astype(np.int32)
    jt, tt = _jax_pair(rng, (v, d), dtype)
    got = eb_ops.embedding_bag(torch.from_numpy(idx), tt, bs)
    assert got.dtype == torch.float32 and tuple(got.shape) == (nb, d)
    want = ref_embedding_bag(jnp.asarray(idx), jt, bs, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    flat = eb_ops.embedding_bag(torch.from_numpy(idx.reshape(-1)), tt, bs)
    assert torch.equal(flat, got)
    assert np.array_equal(got.numpy(), np.asarray(ref_oracle(jnp.asarray(idx.reshape(-1)), jt, bs)))
    oracle = embedding_bag_ref(idx.reshape(-1), tt.float().numpy(), bs)
    assert np.abs(got.numpy() - oracle).max() <= _gamma(bs) * np.abs(oracle).max() + 1e-30


def _eb_table(jt, dtype, layout: str):
    """The table of the JAX pair as the layout lays it out in torch: in place,
    as ``linear[:, None]`` of a (V,) vector, as the first D columns of a
    table 2 columns wider (a row stride of D + 2), or one element into a
    flat buffer (misaligned for every vector route)."""
    vals = torch.from_numpy(np.array(jt.astype(jnp.float32))).to(dtype)
    v, d = vals.shape
    if layout == "linear[:, None]":
        return vals.reshape(-1).clone()[:, None]
    if layout == "row stride":
        wide = torch.zeros((v, d + 2), dtype=dtype)
        wide[:, :d] = vals
        return wide[:, :d]
    if layout == "one element in":
        flat = torch.zeros(v * d + 1, dtype=dtype)
        flat[1:] = vals.reshape(-1)
        return flat[1:].view(v, d)
    return vals


@pytest.mark.parametrize("d,bs,layout", [(d, bs, "contiguous") for d in (1, 10, 50, 256)
                                         for bs in (1, 39)]
                         + [(1, bs, "linear[:, None]") for bs in (1, 39)]
                         + [(10, bs, "row stride") for bs in (1, 39)]
                         + [(d, bs, "one element in") for d in (10, 50) for bs in (1, 39)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_plain_vs_pallas_at_path_widths(d, bs, layout, dtype):
    """At the recsys paths' widths (1: the linear term, 10: xDeepFM and FM,
    50: SASRec, 256: two-tower) and bag lengths (1: the field lookups, 39:
    the linear term and FM's field sum), on every table layout the kernel's
    routes tell apart: bit for bit the Pallas op in interpret mode."""
    from repro.kernels.embedding_bag.ops import embedding_bag as ref_embedding_bag

    rng = np.random.default_rng(d * 100 + bs)
    v, nb = 300, 4
    idx = rng.integers(0, v, (nb, bs)).astype(np.int32)
    jt, _ = _jax_pair(rng, (v, d), dtype)
    table = _eb_table(jt, dtype, layout)
    got = eb_ops.embedding_bag(torch.from_numpy(idx), table, bs)
    want = ref_embedding_bag(jnp.asarray(idx), jt, bs, interpret=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (nb, d)
    assert np.array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("dtype,d,layout,route", [
    (torch.float32, 4, "contiguous", "vec16"), (torch.float32, 256, "contiguous", "vec16"),
    (torch.float32, 10, "contiguous", "vec8"), (torch.float32, 2, "row stride", "vec8"),
    (torch.float32, 10, "row stride", "vec8"), (torch.float32, 3, "contiguous", "scalar"),
    (torch.float32, 1, "linear[:, None]", "scalar"), (torch.float32, 10, "one element in", "scalar"),
    (torch.bfloat16, 8, "contiguous", "vec16"), (torch.bfloat16, 4, "contiguous", "vec8"),
    (torch.bfloat16, 6, "contiguous", "scalar"), (torch.bfloat16, 50, "contiguous", "scalar"),
    (torch.bfloat16, 8, "one element in", "scalar")])
def test_embedding_bag_route_choice(dtype, d, layout, route):
    """The load route follows D x element size, the row stride and the
    table's address: a table whose rows and start are whole 16- (8-) byte
    words takes vec16 (vec8); an odd float32 D, a bf16 D not a multiple of
    4, a misaligned base or stride, or ``linear[:, None]`` the element
    route."""
    jt, _ = _jax_pair(np.random.default_rng(0), (20, d), dtype)
    table = _eb_table(jt, dtype, layout)
    assert eb_ops.embedding_bag_route(table) == route
    assert set(eb_ops.ROUTE_CODES) == {"scalar", "vec8", "vec16"}


def test_embedding_bag_edges():
    """A bag holding a row outside [0, V) is NaN (never read); int64 indices,
    a table read by row stride (``linear[:, None]``), bags of 0 and no bags."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(20, 3)).astype(np.float32))
    idx = torch.tensor([[0, 5], [19, 20], [-1, 2], [7, 7]], dtype=torch.int32)
    got = eb_ops.embedding_bag(idx, table)
    want = embedding_bag_ref(idx.reshape(-1).numpy(), table.numpy(), 2)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert torch.isnan(got[1]).all() and torch.isnan(got[2]).all()
    assert np.abs(got.numpy()[[0, 3]] - want[[0, 3]]).max() < 1e-6
    assert torch.equal(eb_ops.embedding_bag(idx[[0, 3]].long(), table), got[[0, 3]])
    lin = torch.from_numpy(rng.normal(size=(50,)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 50, 4 * 39).astype(np.int32))
    assert torch.equal(eb_ops.embedding_bag(ids, lin[:, None], 39),
                       eb_ops.embedding_bag(ids, lin[:, None].contiguous(), 39))
    assert torch.equal(eb_ops.embedding_bag(torch.zeros((4, 0), dtype=torch.int32), table),
                       torch.zeros((4, 3)))
    assert tuple(eb_ops.embedding_bag(torch.zeros(0, dtype=torch.int32), table, 3).shape) == (0, 3)
    with pytest.raises(ValueError, match="bags of"):
        eb_ops.embedding_bag(torch.zeros(5, dtype=torch.int32), table, 2)
    with pytest.raises(TypeError, match="integer"):
        eb_ops.embedding_bag(torch.zeros(4), table, 2)


@pytest.mark.parametrize("b,m,hk,h,d", [(4, 6, 8, 5, 10), (3, 4, 4, 7, 130), (9, 39, 20, 16, 10),
                                        (1, 1, 1, 1, 1)])
def test_cin_layer_plain_vs_pallas(b, m, hk, h, d, monkeypatch):
    """Within 2 gamma_(m Hk + 2) of the sum of |terms| of the Pallas op (in
    interpret mode) and of the float64 oracle, elementwise; the batch
    chunks of the plain version change nothing but the sums' order."""
    from repro.kernels.cin_interaction.ops import cin_layer as ref_cin_layer
    from repro.kernels.cin_interaction.ref import cin_layer_ref as ref_oracle

    rng = np.random.default_rng(b * 1000 + m * 10 + h)
    x0, xk, w = (rng.normal(size=s).astype(np.float32) for s in ((b, m, d), (b, hk, d), (m * hk, h)))
    got = cin_ops.cin_layer(*(torch.from_numpy(a) for a in (x0, xk, w)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, d)
    limit = 2 * _gamma(m * hk + 2) * cin_layer_ref(np.abs(x0), np.abs(xk), np.abs(w))
    want = np.asarray(ref_cin_layer(jnp.asarray(x0), jnp.asarray(xk), jnp.asarray(w),
                                    interpret=True))
    assert np.all(np.abs(got.numpy() - want) <= limit)
    assert np.all(np.abs(got.numpy() - cin_layer_ref(x0, xk, w)) <= limit)
    assert np.all(np.abs(got.numpy() - np.asarray(ref_oracle(x0, xk, w))) <= limit)
    monkeypatch.setattr(cin_ops, "PLAIN_CHUNK_BYTES", 4 * m * hk * d)  # one row a chunk
    chunked = cin_ops.cin_layer(*(torch.from_numpy(a) for a in (x0, xk, w)))
    assert np.all(np.abs(chunked.numpy() - got.numpy()) <= limit)


def test_cin_layer_casts_and_checks():
    x0 = torch.randn((2, 3, 4), dtype=torch.float64)
    xk = torch.randn((2, 5, 4)).to(torch.bfloat16)
    w = torch.randn((15, 6))
    got = cin_ops.cin_layer(x0, xk, w)
    assert got.dtype == torch.float32
    assert torch.equal(got, cin_ops.cin_layer(x0.float(), xk.float(), w))
    with pytest.raises(ValueError, match="do not fit"):
        cin_ops.cin_layer(x0, xk, w[:14])
    assert torch.equal(cin_ops.cin_layer(x0[:, :0], xk, w[:0]), torch.zeros((2, 6, 4)))


@pytest.mark.parametrize("e,c,d,f", [(2, 8, 16, 16), (4, 100, 64, 200), (3, 1, 70, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_plain_vs_pallas(e, c, d, f, dtype):
    """Within 2 gamma_(D + 1) of the sum of |terms| of the Pallas op (in
    interpret mode) and of the float64 oracle, elementwise."""
    from repro.kernels.moe_gemm.ops import moe_gemm as ref_moe_gemm
    from repro.kernels.moe_gemm.ref import moe_gemm_ref as ref_oracle

    rng = np.random.default_rng(e * 1000 + c + d)
    (jb, tb), (jw, tw) = _jax_pair(rng, (e, c, d), dtype), _jax_pair(rng, (e, d, f), dtype)
    got = mg_ops.moe_gemm(tb, tw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (e, c, f)
    limit = 2 * _gamma(d + 1) * moe_gemm_ref(tb.float().abs().numpy(), tw.float().abs().numpy())
    want = np.asarray(ref_moe_gemm(jb, jw, interpret=True))
    assert np.all(np.abs(got.numpy() - want) <= limit)
    assert np.all(np.abs(got.numpy() - np.asarray(ref_oracle(jb, jw))) <= limit)
    assert np.all(np.abs(got.numpy() - moe_gemm_ref(tb.float().numpy(), tw.float().numpy()))
                  <= limit)


def test_model_side_wrappers_refuse_other_devices_and_count_no_launch():
    """On the CPU each wrapper runs its plain version and counts nothing; a
    tensor on another device is refused."""
    before = (eb_ops.embedding_bag.launches, cin_ops.cin_layer.launches,
              mg_ops.moe_gemm.launches)
    eb_ops.embedding_bag(torch.zeros(4, dtype=torch.int32), torch.zeros((3, 2)), 2)
    cin_ops.cin_layer(torch.zeros((1, 2, 3)), torch.zeros((1, 2, 3)), torch.zeros((4, 5)))
    mg_ops.moe_gemm(torch.zeros((2, 3, 4)), torch.zeros((2, 4, 5)))
    meta = lambda *s: torch.zeros(s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="lies on meta"):
        eb_ops.embedding_bag(torch.zeros(4, dtype=torch.int32, device="meta"), meta(3, 2), 2)
    with pytest.raises(ValueError, match="lies on meta"):
        cin_ops.cin_layer(meta(1, 2, 3), meta(1, 2, 3), meta(4, 5))
    with pytest.raises(ValueError, match="lies on meta"):
        mg_ops.moe_gemm(meta(2, 3, 4), meta(2, 4, 5))
    with pytest.raises(ValueError, match="do not fit"):
        mg_ops.moe_gemm(torch.zeros((2, 3, 4)), torch.zeros((2, 5, 5)))
    assert before == (eb_ops.embedding_bag.launches, cin_ops.cin_layer.launches,
                      mg_ops.moe_gemm.launches)



# ----------------------------------------------------------------------
# the routes the wrappers pick before a launch, and the arithmetic of the
# tensor-core attention instance (split P), held on the CPU
# ----------------------------------------------------------------------
def _misaligned(*shape, dtype=torch.bfloat16):
    """A contiguous tensor whose data starts one element past a 16-byte
    boundary (a slice of a small buffer)."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


_F32 = torch.float32
MOE_ROUTE_CASES = {
    # name: ((E, C, D), (E, D, F), buf dtype, w dtype, route)
    "moonshot_prefill_w_gate": ((64, 960, 2048), (64, 2048, 1408), None, None, "wgmma"),
    "moonshot_prefill_w_down": ((64, 960, 1408), (64, 1408, 2048), None, None, "wgmma"),
    "moonshot_decode": ((64, 1, 2048), (64, 2048, 1408), None, None, "small_c"),
    "c8": ((64, 8, 2048), (64, 2048, 1408), None, None, "small_c"),
    "c9": ((64, 9, 2048), (64, 2048, 1408), None, None, "wgmma"),
    "float32": ((64, 960, 2048), (64, 2048, 1408), _F32, _F32, "fma"),
    "mixed_bf16_f32": ((64, 960, 2048), (64, 2048, 1408), None, _F32, "fma"),
    "mixed_f32_bf16": ((64, 1, 2048), (64, 2048, 1408), _F32, None, "fma"),
    "d33": ((2, 130, 33), (2, 33, 136), None, None, "fma"),
    "f257": ((2, 130, 64), (2, 64, 257), None, None, "fma"),
    "f257_c1": ((2, 1, 64), (2, 64, 257), None, None, "fma"),
    "d0": ((2, 130, 0), (2, 0, 16), None, None, "fma"),
}


@pytest.mark.parametrize("case", list(MOE_ROUTE_CASES))
def test_moe_gemm_route(case):
    """The route is a function of dtypes, shapes and alignment alone; the
    model's shapes are built on the meta device (nothing allocated)."""
    bshape, wshape, bt, wt, route = MOE_ROUTE_CASES[case]
    buf = _meta(*bshape, dtype=bt or torch.bfloat16)
    w = _meta(*wshape, dtype=wt or torch.bfloat16)
    assert mg_ops.moe_gemm_route(buf, w) == route


@pytest.mark.parametrize("which,c", [("buf", 130), ("w", 130), ("w", 1)])
def test_moe_gemm_route_needs_16_byte_alignment(which, c):
    """An operand one element off a 16-byte boundary takes the fma route
    (the buf of a small_c launch is read element by element: no rule)."""
    buf, w = torch.zeros((2, c, 64), dtype=torch.bfloat16), torch.zeros((2, 64, 136),
                                                                        dtype=torch.bfloat16)
    assert mg_ops.moe_gemm_route(buf, w) == ("small_c" if c == 1 else "wgmma")
    if which == "buf":
        buf = _misaligned(2, c, 64)
    else:
        w = _misaligned(2, 64, 136)
    assert mg_ops.moe_gemm_route(buf, w) == "fma"
    if which == "buf":
        assert mg_ops.moe_gemm_route(buf[:, :1].contiguous(), w) == "small_c"


ATTN_ROUTE_CASES = {
    # name: (q shape, k / v shape, dtype, route)
    "qwen3_8b_prefill": ((4, 2048, 32, 128), (4, 2048, 8, 128), None, "wgmma"),
    "moonshot_prefill": ((4, 2048, 16, 128), (4, 2048, 16, 128), None, "wgmma"),
    "hd64": ((2, 300, 8, 64), (2, 300, 2, 64), None, "wgmma"),
    "float32": ((4, 2048, 32, 128), (4, 2048, 8, 128), _F32, "fma"),
    "hd32": ((2, 300, 8, 32), (2, 300, 2, 32), None, "fma"),
    "hd16": ((2, 300, 8, 16), (2, 300, 2, 16), None, "fma"),
}


@pytest.mark.parametrize("case", list(ATTN_ROUTE_CASES))
def test_flash_attention_route(case):
    qshape, kshape, dt, route = ATTN_ROUTE_CASES[case]
    q, k = _meta(*qshape, dtype=dt or torch.bfloat16), _meta(*kshape, dtype=dt or torch.bfloat16)
    assert fa_ops.flash_attention_route(q, k, k) == route


@pytest.mark.parametrize("case", ["heads_sliced", "misaligned", "stride_not_16_bytes",
                                  "mixed_dtypes"])
def test_flash_attention_route_strides_and_alignment(case):
    """q sliced by heads keeps 16-byte strides and base (TMA reads it in
    place); an offset off a 16-byte boundary, a row stride of 68 bf16 or a
    float32 k take the fma instance."""
    k = torch.zeros((2, 100, 2, 64), dtype=torch.bfloat16)
    if case == "heads_sliced":
        q, route = torch.zeros((2, 100, 12, 64), dtype=torch.bfloat16)[:, :, 2:10], "wgmma"
    elif case == "misaligned":
        q, route = _misaligned(2, 100, 8, 64), "fma"
    elif case == "stride_not_16_bytes":
        q, route = torch.zeros(2 * 100 * 8 * 68, dtype=torch.bfloat16).as_strided(
            (2, 100, 8, 64), (100 * 8 * 68, 8 * 68, 68, 1)), "fma"
    else:
        q, route = torch.zeros((2, 100, 8, 64), dtype=torch.bfloat16), "fma"
        k = k.float()
    assert fa_ops.flash_attention_route(q, k, k) == route


def test_wrappers_count_launches_by_route_and_none_on_cpu():
    """Both wrappers keep a count per route beside their total; the plain
    versions on the CPU count nothing."""
    assert set(mg_ops.moe_gemm.launches_by_route) == {"wgmma", "small_c", "fma"}
    assert set(fa_ops.flash_attention_tpu.launches_by_route) == {"wgmma", "fma"}
    before = (dict(mg_ops.moe_gemm.launches_by_route),
              dict(fa_ops.flash_attention_tpu.launches_by_route))
    x = torch.zeros((1, 130, 2, 64), dtype=torch.bfloat16)
    fa_ops.flash_attention_tpu(x, x[:, :, :1], x[:, :, :1])
    mg_ops.moe_gemm(torch.zeros((2, 130, 64), dtype=torch.bfloat16),
                    torch.zeros((2, 64, 136), dtype=torch.bfloat16))
    assert before == (mg_ops.moe_gemm.launches_by_route,
                      fa_ops.flash_attention_tpu.launches_by_route)


#: the limit chip_smoke.py holds a bf16 attention output to against its plain
#: version, elementwise: |got - want| <= 2^-7 |want| + 1e-5 (one bf16
#: rounding of the value, plus the float32 floor where it is near 0)
ATTENTION_TOL_BF16 = (2.0 ** -7, 1e-5)


def _limit_used(got: torch.Tensor, want: torch.Tensor) -> float:
    rel, floor = ATTENTION_TOL_BF16
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (rel * w.abs() + floor)).max())


def _cancelling(rng, b, t, h, kh, hd):
    """q, k, v (float32) whose keys come in near pairs (the second a 5 %
    perturbation of the first) and whose value rows come in opposite pairs
    of +-5: a pair's weights nearly agree, so each output nearly cancels to
    0 while sum(p |v|) / l is 5."""
    q = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, kh, hd)).astype(np.float32)
    n = t // 2
    k[:, 1:2 * n:2] = k[:, 0:2 * n:2] + 0.05 * rng.normal(size=(b, n, kh, hd))
    sign = rng.choice([-1.0, 1.0], size=(b, n, kh, hd))
    v = rng.normal(size=(b, t, kh, hd)).astype(np.float32)
    v[:, 0:2 * n:2] = 5 * sign
    v[:, 1:2 * n:2] = -5 * sign
    return q, k, v


@pytest.mark.parametrize("b,t,h,kh,hd", [(1, 256, 4, 2, 64), (2, 300, 8, 4, 128),
                                         (1, 513, 2, 1, 32), (1, 512, 3, 1, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("values", ["normal", "cancelling"])
def test_flash_attention_split_arithmetic(b, t, h, kh, hd, causal, values):
    """flash_attention_split_torch (the tensor-core instance's arithmetic:
    scores scaled after the sum, exp2, P in three bf16 terms) against the
    Pallas op in interpret mode and the float64 oracle at the reference's
    bf16 tolerance, against flash_attention_torch at the card's limit
    (ATTENTION_TOL_BF16) on bf16 outputs and on float32 outputs of the same
    bf16 values, and, on those float32 outputs, the split's own error (the
    same arithmetic with P unsplit) within a quarter of that limit, the
    margin two terms miss on cancelling rows."""
    from repro.kernels.flash_attention.ops import flash_attention_tpu as ref_flash
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref

    rng = np.random.default_rng(7 * t + hd + (values == "cancelling"))
    if values == "normal":
        arrs = [rng.normal(size=s).astype(np.float32)
                for s in ((b, t, h, hd), (b, t, kh, hd), (b, t, kh, hd))]
    else:
        arrs = _cancelling(rng, b, t, h, kh, hd)
    (jq, jk, jv), (q, k, v) = _jax_and_torch(arrs, torch.bfloat16)
    got = fa_ops.flash_attention_split_torch(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, t, h, hd)
    tol = FLASH_TOL[torch.bfloat16]
    if causal or t % 512 == 0:
        want = np.asarray(ref_flash(jq, jk, jv, causal=causal, interpret=True)
                          .astype(jnp.float32))
        assert float(np.abs(got.float().numpy() - want).max()) < tol
    oracle = flash_fwd_ref(*_to_kernel_layout(q.float(), k.float(), v.float()), causal=causal)
    oracle = np.moveaxis(oracle.reshape(b, kh, h // kh, t, hd), 3, 1).reshape(b, t, h, hd)
    assert float(np.abs(got.float().numpy() - oracle).max()) < tol
    assert _limit_used(got, fa_ops.flash_attention_torch(q, k, v, causal)) <= 1.0
    wide = [x.float() for x in (q, k, v)]
    split = fa_ops.flash_attention_split_torch(*wide, causal)
    assert _limit_used(split, fa_ops.flash_attention_torch(*wide, causal)) <= 1.0
    assert _limit_used(split, fa_ops.flash_attention_split_torch(*wide, causal, terms=None)) <= 0.25


@pytest.mark.parametrize("terms,least", [(1, 1.0), (2, 0.25)])
def test_flash_attention_fewer_p_terms_break_the_margin(terms, least):
    """On cancelling rows, P rounded once to bf16 leaves the card's limit
    (its error is up to 2^-9 sum(p |v|) / l where the output is near 0), and
    two terms (2^-18) leave less than the 4x margin: why P is split in
    three (2^-27)."""
    rng = np.random.default_rng(2)
    arrs = _cancelling(rng, 2, 300, 8, 4, 128)
    _, (q, k, v) = _jax_and_torch(arrs, torch.bfloat16)
    wide = [x.float() for x in (q, k, v)]
    unsplit = fa_ops.flash_attention_split_torch(*wide, True, terms=None)
    assert _limit_used(fa_ops.flash_attention_split_torch(*wide, True, terms=terms),
                       unsplit) > least
    assert _limit_used(fa_ops.flash_attention_split_torch(*wide, True), unsplit) <= 0.25
    if terms == 1:
        assert _limit_used(fa_ops.flash_attention_split_torch(q, k, v, True, terms=1),
                           fa_ops.flash_attention_torch(q, k, v, True)) > 1.0


# ----------------------------------------------------------------------
# flash_decode's split and combine arithmetic, its split planner and its
# load route, held on the CPU
# ----------------------------------------------------------------------
#: the card's limit for a float32 attention output against its plain version
ATTENTION_TOL_F32 = 1e-5


@pytest.mark.parametrize("g", [1, 4, 16])
@pytest.mark.parametrize("n_splits", [1, 2, 3, "S"])
@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16)])
def test_flash_decode_split_arithmetic(g, n_splits, q_dtype, kv_dtype):
    """flash_decode_split_torch (the kernel's split + combine arithmetic)
    against flash_decode_torch, the Pallas op in interpret mode and the NumPy
    oracle within DECODE_TOL, float32 outputs also within the card's 1e-5.
    Positions 0, S - 1, one past S (S is a multiple of the Pallas block, so
    the Pallas op sees no padding there) and 100, whose row leaves the later
    chunks wholly empty once S is split."""
    from repro.kernels.flash_decode.ops import flash_decode as ref_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    b, s, kh, hd = 4, 512, 2, 32
    splits = s if n_splits == "S" else n_splits
    (jq,), (q,) = _attn_inputs(g, [(b, 1, kh * g, hd)], q_dtype)
    (jk, jv), (k, v) = _attn_inputs(g + 1, [(b, s, kh, hd), (b, s, kh, hd)], kv_dtype)
    pos = np.array([0, s - 1, s + 7, 100], dtype=np.int32)
    got = fdec_ops.flash_decode_split_torch(q, k, v, torch.from_numpy(pos), splits)
    assert got.dtype == q_dtype and tuple(got.shape) == (b, 1, kh * g, hd)
    plain = fdec_ops.flash_decode_torch(q, k, v, torch.from_numpy(pos))
    tol = DECODE_TOL[q_dtype]
    assert float((got.float() - plain.float()).abs().max()) < tol
    if q_dtype == torch.float32:
        assert float((got - plain).abs().max()) <= ATTENTION_TOL_F32
    want = np.asarray(ref_decode(jq, jk, jv, jnp.asarray(pos), interpret=True)
                      .astype(jnp.float32))
    assert float(np.abs(got.float().numpy() - want).max()) < tol
    oracle = flash_decode_ref(np.repeat(np.minimum(pos + 1, s), kh),
                              q.float().numpy()[:, 0].reshape(b * kh, g, hd),
                              *(np.moveaxis(x.float().numpy(), 1, 2).reshape(b * kh, s, hd)
                                for x in (k, v)))
    assert float(np.abs(got.float().numpy() - oracle.reshape(b, 1, kh * g, hd)).max()) < tol


@pytest.mark.parametrize("n_splits", [1, 3, 40])
def test_flash_decode_split_of_an_empty_row_is_zero(n_splits):
    """A row that sees no cache row (position -1) is 0 in the split
    arithmetic, as in the plain version: every chunk's partial is empty."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 40, 2, 16)).astype(np.float32))
            for _ in range(2))
    pos = torch.tensor([-1, 17], dtype=torch.int32)
    got = fdec_ops.flash_decode_split_torch(q, k, v, pos, n_splits)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(fdec_ops.flash_decode_torch(q, k, v, pos)[0], got[0])
    assert float((got[1] - fdec_ops.flash_decode_torch(q, k, v, pos)[1]).abs().max()) < 1e-6


DECODE_PLAN_CASES = {
    # name: ((B, K, S, SMs), the plan where the test pins it)
    "qwen3_8b_decode": ((4, 8, 2080, 132), (256, 9)),
    "moonshot_decode": ((4, 16, 2080, 132), (448, 5)),
    "sparse_capacity": ((3, 2, 32768, 132), None),
    "one_row": ((1, 1, 1, 132), (64, 1)),
    "wide_batch": ((128, 8, 32768, 132), None),
    "long_cache": ((1, 1, 10**7, 132), None),
    "one_sm": ((2, 2, 64, 1), (64, 1)),
}


@pytest.mark.parametrize("case", list(DECODE_PLAN_CASES))
def test_flash_decode_plan(case):
    """At least one split, chunks whole multiples of the granule that cover
    [0, S) with none starting at or past S, no more splits than the combine
    pass takes, and at least half of BLOCKS_PER_SM blocks per SM where S
    allows (the chunk is rounded up to the granule)."""
    (b, kh, s, sms), pinned = DECODE_PLAN_CASES[case]
    chunk, n = fdec_ops.flash_decode_plan(b, kh, s, sms)
    assert n >= 1 and chunk >= 1 and chunk % fdec_ops.SPLIT_GRANULE == 0
    assert chunk * n >= s and chunk * (n - 1) < s
    assert n <= fdec_ops.MAX_SPLITS
    if s >= fdec_ops.SPLIT_GRANULE * fdec_ops.BLOCKS_PER_SM * sms:
        assert 2 * b * kh * n >= fdec_ops.BLOCKS_PER_SM * sms or n == fdec_ops.MAX_SPLITS
    if pinned is not None:
        assert (chunk, n) == pinned


def test_flash_decode_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="no split plan"):
        fdec_ops.flash_decode_plan(0, 8, 2080, 132)


def _decode_route_case(case):
    bf, f32 = torch.bfloat16, torch.float32
    if case == "bf16_contiguous":
        return torch.zeros((2, 64, 2, 32), dtype=bf), "vec16"
    if case == "f32_contiguous":
        return torch.zeros((2, 64, 2, 16), dtype=f32), "vec16"
    if case == "layer_slice_of_stacked_cache":
        return torch.zeros((3, 2, 2, 64, 2, 32), dtype=bf)[1, 0], "vec16"
    if case == "misaligned_slice":
        return torch.zeros(2 * 64 * 2 * 32 + 1, dtype=bf)[1:].view(2, 64, 2, 32), "scalar"
    if case == "odd_row_stride":
        return torch.zeros((2, 64, 2, 33), dtype=bf)[..., :32], "scalar"
    if case == "f32_stride_of_two_units_and_a_half":
        return torch.zeros((2, 64, 2, 18), dtype=f32)[..., :16], "scalar"
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["bf16_contiguous", "f32_contiguous",
                                  "layer_slice_of_stacked_cache", "misaligned_slice",
                                  "odd_row_stride", "f32_stride_of_two_units_and_a_half"])
def test_flash_decode_route(case):
    """16-byte copies (vec16) need a 16-byte aligned base and strides of
    whole 16-byte units; a misaligned slice or an odd stride takes element
    loads (scalar).  Either cache of a pair decides for both."""
    cache, route = _decode_route_case(case)
    assert fdec_ops.flash_decode_route(cache, cache) == route
    aligned = torch.zeros(cache.shape, dtype=cache.dtype)
    assert fdec_ops.flash_decode_route(aligned, aligned) == "vec16"
    assert fdec_ops.flash_decode_route(aligned, cache) == route


def test_flash_decode_counts_launches_by_route_and_none_on_cpu():
    assert set(fdec_ops.flash_decode.launches_by_route) == set(fdec_ops.ROUTE_CODES)
    before = (fdec_ops.flash_decode.launches, dict(fdec_ops.flash_decode.launches_by_route))
    x = torch.zeros(2, 16, 2, 32, dtype=torch.bfloat16)
    out = fdec_ops.flash_decode(torch.zeros(2, 1, 4, 32), x, x, torch.zeros(2, dtype=torch.int32))
    assert out.dtype == torch.float32
    assert before == (fdec_ops.flash_decode.launches, fdec_ops.flash_decode.launches_by_route)
    assert fdec_ops.KERNELS_PER_CALL == 2


@pytest.mark.parametrize("b,m,hk,h,d", [(5, 3, 5, 201, 13), (1, 2, 3, 7, 1), (3, 7, 9, 250, 10),
                                        (4, 5, 20, 203, 10), (2, 1, 1, 3, 33)])
def test_cin_layer_plain_at_tile_edges(b, m, hk, h, d):
    """The plain version at the CUDA kernel's tile edges (ragged 200-row and
    64-column tiles, K below and no multiple of its 16-row step, B D = 1)
    against the float64 oracle within 2 gamma_(m Hk + 2) of the sum of
    |terms|: the shapes chip_smoke.py holds the kernel to on the card."""
    rng = np.random.default_rng(b * 100 + h)
    x0, xk, w = (rng.normal(size=s).astype(np.float32)
                 for s in ((b, m, d), (b, hk, d), (m * hk, h)))
    got = cin_ops.cin_layer(*(torch.from_numpy(a) for a in (x0, xk, w)))
    limit = 2 * _gamma(m * hk + 2) * cin_layer_ref(np.abs(x0), np.abs(xk), np.abs(w))
    assert np.all(np.abs(got.numpy() - cin_layer_ref(x0, xk, w)) <= limit)


def test_ab_timing_refuses_to_run_without_a_card():
    """The A/B timing script measures on a CUDA card only: without one it
    exits non-zero and prints no result."""
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parent.parent / "src/repro_torch/kernels/ab_timing.py"
    res = subprocess.run([sys.executable, str(script), "--reps", "1"], capture_output=True,
                         text=True, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 2 and res.stdout == ""
    assert "no CUDA device" in res.stderr


# ----------------------------------------------------------------------
# anchor_probe_sliced at the slice lengths where its bisection takes one step
# more, and dgap_decode's single-pass scan: the kernel's tile protocol in
# tensor code and its load route, held on the CPU
# ----------------------------------------------------------------------
def _edge_slices(rng, lens):
    """Slices of ``lens`` strictly increasing anchors, one after another, and
    queries below, on, between and above every anchor, plus 2^31 - 2."""
    anchors, lo, hi, queries = [], [], [], []
    start = 0
    for n in lens:
        vals = 2 * np.cumsum(rng.integers(1, 6, n)) + 3 * start
        anchors.append(vals)
        q = np.concatenate([[-2**31, -1, 2**31 - 2], vals, vals - 1, vals + 1,
                            [vals[-1] + 5 if n else 7]])
        if len(q) > 600:  # keep the interpret-mode reference quick
            q = np.concatenate([q[:3], rng.choice(q[3:], 600, replace=False)])
        queries.append(q)
        lo.append(np.full(len(q), start))
        hi.append(np.full(len(q), start + n))
        start += n
    cat = lambda xs: np.concatenate(xs).astype(np.int32)  # noqa: E731
    return cat(queries), cat(lo), cat(hi), cat(anchors)


@pytest.mark.parametrize("k", list(range(1, 13)))
def test_anchor_probe_sliced_at_bisection_steps(k):
    """Slices of 0, 1, 2^k - 1, 2^k and 2^k + 1 anchors (where the bisection
    takes one step more) against the Pallas op in interpret mode and both
    oracles."""
    rng = np.random.default_rng(6000 + k)
    queries, lo, hi, anchors = _edge_slices(rng, [0, 1, 2**k - 1, 2**k, 2**k + 1])
    got = ai_ops.anchor_probe_sliced(*(t32(a) for a in (queries, lo, hi, anchors)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(queries),)
    jgot = ref_ai_ops.anchor_probe_sliced(*(jnp.asarray(a) for a in (queries, lo, hi, anchors)),
                                          interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(jgot))
    assert np.array_equal(got.numpy(), ref_sliced_ref(queries, lo, hi, anchors))
    assert np.array_equal(got.numpy(), anchor_probe_sliced_ref(queries, lo, hi, anchors))


def test_anchor_probe_sliced_counts_no_launch_on_cpu():
    """A CPU call takes the plain version and counts no launch."""
    before = ai_ops.anchor_probe_sliced.launches
    got = ai_ops.anchor_probe_sliced(t32([0, 5, 9]), t32([0, 0, 2]), t32([3, 3, 2]),
                                     t32([1, 4, 8]))
    assert got.tolist() == [0, 2, 2]
    assert ai_ops.anchor_probe_sliced.launches == before


def _tile_orders(rng, n_tiles: int):
    return {"ascending": None, "descending": list(range(n_tiles))[::-1],
            "random": rng.permutation(n_tiles), "random2": rng.permutation(n_tiles)}


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 8191, 8192, 8193, 3 * 4096 + 5])
@pytest.mark.parametrize("tile", [4096, 8192, 256])
def test_dgap_decode_lookback_arithmetic(n, tile):
    """dgap_decode_lookback_torch (the kernel's tiles, aggregates, inclusive
    prefixes and look-back) in several tile completion orders, against the
    plain version and the Pallas op in interpret mode, around the kernel's
    tile (4096) and at tiles of other sizes."""
    rng = np.random.default_rng(8000 + n + tile)
    g = rng.integers(-2**31, 2**31, n).astype(np.int32)
    want = dg_ops.dgap_decode_torch(t32(g))
    jwant = np.asarray(ref_dg_ops.dgap_decode(jnp.asarray(g), interpret=True))
    assert np.array_equal(want.numpy(), jwant)
    for name, order in _tile_orders(rng, -(-n // tile)).items():
        got = dg_ops.dgap_decode_lookback_torch(t32(g), tile, order)
        assert got.dtype == torch.int32 and torch.equal(got, want), name


@pytest.mark.parametrize("case", ["wraps", "negative"])
def test_dgap_decode_lookback_wraps_like_the_reference(case):
    """The wrap and negative streams of test_dgap_decode_wraps_like_the_reference
    through the tile protocol in random completion orders."""
    rng = np.random.default_rng(7)
    g = (np.full(70_000, 40_000, np.int32) if case == "wraps"
         else rng.integers(-2**31, 2**31, 70_001).astype(np.int32))
    want = np.asarray(ref_dg_ops.dgap_decode(jnp.asarray(g), interpret=True))
    for tile in (dg_ops.TILE, 1024):
        for name, order in _tile_orders(rng, -(-len(g) // tile)).items():
            got = dg_ops.dgap_decode_lookback_torch(t32(g), tile, order)
            assert np.array_equal(got.numpy(), want), (tile, name)


def test_dgap_decode_tile_matches_the_kernel_source():
    """The wrapper sizes the workspace by TILE: one status word per tile of
    the kernel's kThreads * kItems values."""
    import re
    from pathlib import Path

    src = (Path(dg_ops.__file__).resolve().parents[2] / "csrc").joinpath
    consts = {}
    for name in ("common.cuh", "dgap_decode.cu"):
        for m in re.finditer(r"constexpr int (kThreads|kItems) = (\d+);", src(name).read_text()):
            consts[m.group(1)] = int(m.group(2))
    assert consts["kThreads"] * consts["kItems"] == dg_ops.TILE


def test_dgap_decode_lookback_refuses_a_wrong_order():
    with pytest.raises(ValueError, match="permutation"):
        dg_ops.dgap_decode_lookback_torch(t32(np.ones(5000)), 4096, [0, 0])


@pytest.mark.parametrize("view", ["fresh", "offset_one", "offset_four", "empty"])
def test_dgap_decode_route(view):
    """16-byte loads (vec16) need a 16-byte aligned first element; a view one
    element in (stream[1:]) takes element loads, four elements in is aligned
    again.  A CPU call takes the plain version on every view and counts no
    launch in any route."""
    buf = torch.arange(1, 10_002, dtype=torch.int32)
    gaps, route = {"fresh": (buf, "vec16"), "offset_one": (buf[1:], "scalar"),
                   "offset_four": (buf[4:], "vec16"), "empty": (buf[:0], "vec16")}[view]
    assert dg_ops.dgap_decode_route(gaps) == route
    assert set(dg_ops.dgap_decode.launches_by_route) == {"vec16", "scalar"}
    before = (dg_ops.dgap_decode.launches, dict(dg_ops.dgap_decode.launches_by_route))
    assert torch.equal(dg_ops.dgap_decode(gaps), dg_ops.dgap_decode_torch(gaps))
    assert torch.equal(dg_ops.dgap_decode(gaps), dg_ops.dgap_decode_lookback_torch(gaps))
    assert before == (dg_ops.dgap_decode.launches, dg_ops.dgap_decode.launches_by_route)
