#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device, nvcc and no network

Builds the CUDA kernels of ``src/repro_torch/csrc`` into ``build/``, then drives
the port's paths over a seeded versioned collection, each with the kernels'
launch counts set to 0 just before it and read just after:

* mining — ``NonPositionalIndex.build(..., mine_similarity=True,
  device="cuda")`` signs the documents on the card; the same documents mined
  with the plain version on the CPU give the same similarity index;
* rlz — ``NonPositionalIndex.build(store="rlz", device="cuda")`` signs the
  posting lists on the card (the store equals the one built on the CPU, byte
  for byte), and ``Session.build`` serves AND / ``top10:`` / ``docs:`` over it
  on the card (dense layout);
* backends — the 14 inverted backends of the third slice (``rice`` …
  ``vbyte_lzend``), each built from the non-positional posting lists with
  ``build_backend`` and served by ``Session.build(..., device="cuda")``
  (dense layout) on the batch's AND / ``top10:`` / ``docs:`` queries;
* dgap — ``repro_torch.kernels.dgap_decode`` on the positional index's
  posting lists: each long list alone, then the whole concatenated d-gap
  stream in one call (its running sum passes 2^31 and wraps), then that
  stream and the longest edge length repeated ``DGAP_REPEATS`` times on
  both load routes (a look-back race would show now and then);
* anchor_probe — ``repro_torch.kernels.anchor_probe`` with the positional
  index's longest list as the anchors and the next lists' positions as the
  queries;
* serve — one mixed query batch through ``Session.execute``, fused and dense
  device layouts, ``similar:`` / ``versions-of:`` over the mined index
  included; the fused layout serves each window in two launches
  (``decode_window``, ``probe_window``), the dense one probes each term with
  ``anchor_probe_sliced``; a traced fused window at phrase2 and at and2 is
  split into host and device time beside the same window served by the
  row-given route (``decode_rows``, then ``anchor_probe_sliced`` and
  ``probe_rows`` per probed term: the fused step before the window kernels);
* ranked — a batch of ``rank10:`` queries (24 each of 2, 3 and 4 terms, an
  rng of its own) through both card sessions: the BM25 ranked step (padded
  run arrays, scatter-add, stable sort; no kernel of the table), every
  answer equal to the host-only session's and to the same step on CPU
  tensors;
* lifecycle — the full-size indexes saved as a bundle (``save_index``) and
  served through ``Session.open(..., device="cuda")``, eager and memory-mapped,
  answers and ``device_bytes()`` equal to the in-memory fused session's;
  then an ``IndexWriter`` (``repair_skip``, positional, mining on the card)
  over the first 300 documents in three commits, opened segment-aware and
  held against one-shot builds (host-only and on the card), compacted in the
  background while it serves, refreshed once;
* frontier — ``PartitionedServer`` over the full non-positional index in 2
  and 4 shards (arrays built for the card equal to a CPU build; every shard
  of a window in one batched step, ``anchor_probe_sliced`` once per probed
  term a window), the positional index of the first 1,000 documents in 2
  shards (phrases), ``replicated_session`` (2 fused replicas of the full
  indexes on the 432 queries, ``rank10:`` included; a replica failing
  mid-batch; 2 replicas x 2 shards over the cut), ``run_open_loop`` over
  the fused card session (burst, Poisson at half the burst's rate, a warm
  pass answered from the cache, an overload pass with typed rejections),
  a frontend over the lifecycle writer's segmented session through one
  more commit and ``refresh`` (cache counters equal to the host-only
  sequence's), and ``repro_torch.launch.serve.main`` in-process;
* mesh — the mesh tier over NCCL with a world of one (``RANK=0``,
  ``WORLD_SIZE=1``, a free port on 127.0.0.1, ``make_local_mesh(1, 1)`` on
  ``"cuda"``): ``PartitionedServer(mesh=..., shard_axis="data",
  probe="kernel")`` in 4 shards over the full non-positional index (the
  batch's AND queries) and over the frontier's positional cut (its phrase
  queries), every answer equal to the ``mesh=None`` server's and the host
  session's; ``make_sharded_train_step`` on qwen3-8b and moonshot-v1-16b-a3b
  as the train phase runs them (full width, 2 layers, 2 x 4,096 tokens in 2
  micro-batches, AdamW at lr 1e-5), its gradients, metrics and updated
  state bit-equal to ``make_lm_train_step``'s kernel path (a world of one
  makes every collective the identity); ``psum_int8`` / ``psum_topk`` on two
  of its gradients, bit-equal to their formula; a full-size xDeepFM train
  state resharded, saved, restored and placed back, bit for bit.
  ``--only-mesh`` runs it alone;
* lm_serve — LM serving of qwen3-8b at full width (depth cut only by
  ``--lm-layers``), random bf16 weights drawn on the card: 4 prompts of 2,048
  tokens from ``lm_batches`` prefilled through ``make_lm_prefill_step`` (the
  ``flash_attention_tpu`` kernel, once per layer), the cache padded, then 32
  greedy steps through ``make_lm_decode_step`` (``flash_decode``, a split
  and a combine pass once per layer per step); the same model through the plain attention path,
  teacher-forced on the kernel run's tokens, must give logits within
  ``LM_LOGIT_TOL`` and the same greedy tokens but where the plain path's
  logit of the kernel's token lies within one bf16 step of its maximum;
* recsys_serve — xDeepFM at full width (39 fields, 3,008,562 table rows of
  10, CIN 200-200-200, MLP 400-400), random float32 weights drawn on the
  card, serving the registry's ``serve_p99`` (512 rows), ``serve_bulk``
  (262,144) and ``retrieval_cand`` (1,000,000 candidate rows) inputs from
  ``recsys_batches`` through ``make_recsys_serve_step`` (``embedding_bag``
  twice and ``cin_layer`` once per CIN layer per call), then the same inputs
  through the plain path; FM, SASRec and two-tower (20.5 GB of tables) serve
  one ``serve_p99`` batch each and are freed;
* moe_serve — moonshot-v1-16b-a3b at full width and depth (48 layers, 64
  experts, top-6; 56.1 GB of bf16 weights),
  served as lm_serve is (``moe_gemm`` three times a layer besides the two
  attention kernels); the plain path is teacher-forced on the kernel run's
  tokens and expert choices, and the choices its own router would have made
  otherwise are counted, as are the tokens dropped at capacity;
* train — training on the card: row 7's log-sum-exp (``return_lse``) on
  both instances and the attention gradients (``FlashAttention``, the
  reference's custom VJP, over the kernel's forward against the same over
  the plain forward), ``moe_gemm``'s two backward products,
  ``embedding_bag``'s table gradient (bit for bit against the same ordered
  scatter on the CPU) and ``cin_layer``'s dx0 / dxk / dw, at edge shapes and
  at the paths'; then ``make_lm_train_step`` on qwen3-8b and
  moonshot-v1-16b-a3b at full width, 2 layers, bf16, 2 x 4,096 tokens in 2
  micro-batches, 3 AdamW steps, ``make_recsys_train_step`` on xDeepFM at full
  size on 65,536 rows (3 steps) and FM, SASRec, two-tower (one step each),
  ``make_gnn_train_step`` on the GIN (3 steps): each model's kernel path
  (rows 7, 9, 10, 11 launched in every step where it has them) against its
  plain path from the same weights (no launch), the losses falling, and
  before the steps the first step's gradients leaf by leaf against the
  plain path's, with planted faults (a base-2 lse, a dropped weight or
  table gradient) that the same check must catch; then
  ``repro_torch.launch.train.main`` on xDeepFM with checkpoints, run again
  to resume, and a bf16 qwen3-8b train state saved and restored bit for
  bit, its manifest as the reference's Checkpointer writes it.

Every answer is compared with the host-only session's, and each kernel is held
against its plain PyTorch version on the card at edge shapes and at the inputs
the paths handed it: the eight integer kernels and ``embedding_bag`` with
tolerance 0, the two attention kernels with an elementwise limit per kernel
and output dtype (``ATTENTION_TOL``: float32 sums in another order; a bf16
output one rounding apart), their path inputs widened to float32 as well,
``cin_layer`` and ``moe_gemm`` within the textbook bound of a float32 sum
taken in another order (:func:`gamma`).  ``moe_gemm`` and
``flash_attention_tpu`` pick a route before each launch (bf16 tensor cores
or not), ``flash_decode`` a load route (16-byte copies or element loads);
their comparison rows name it, ragged and cancelling edge inputs reach
every route, and on both LM paths every prefill launch of the first two
must take ``wgmma``, every MoE decode ``moe_gemm`` ``small_c`` and every
``flash_decode`` ``vec16``.  ``dgap_decode`` picks 16-byte or element loads
from the stream's alignment (offset views reach the second);
``embedding_bag`` 16-byte, 8-byte or element loads from the table's width,
row stride and alignment (the x0 lookups must take ``vec8``, the linear
terms ``scalar``); ``minhash_rows`` one launch (``one_pass``) or a clearing
kernel and a chunked one (``chunked``) from the tile's width.  float32
matrix products run without TF32.  Each phase prints one
JSON line; any failure ends the run with a non-zero exit code, and a crash in
native code prints every thread's Python stack to stderr (``faulthandler``).
The ``done`` line gives the wall time, the peak host memory and the Python
threads still alive at the end.  The last line
is ``{"ok": true, "device": {...}}``, after the card's name and power limit; the
line before those lists every kernel with its launches on its path, its error
against the plain version, its time, the plain version's time, the card's
lower bound for the same work and, where one PyTorch call computes the same
function, that call's time.

It imports ``torch``, ``numpy`` and ``repro_torch`` only.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate, the
# float32 rate outside the tensor cores (taken too for int32 ALU work), and the
# dense bf16 tensor-core rate (the peak for bf16 attention)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_FLOPS = 989e12

KERNEL_META = {
    "anchor_probe_sliced": {
        "route": "cuda", "source": "src/repro_torch/csrc/anchor_intersect.cu",
        "replaces": "src/repro/kernels/anchor_intersect/kernel.py:88"},
    "decode_rows": {
        "route": "cuda", "source": "src/repro_torch/csrc/fused_decode.cu",
        "replaces": "src/repro/kernels/fused_decode/kernel.py:71"},
    "probe_rows": {
        "route": "cuda", "source": "src/repro_torch/csrc/fused_decode.cu",
        "replaces": "src/repro/kernels/fused_decode/kernel.py:97"},
    "decode_window": {
        "route": "cuda", "source": "src/repro_torch/csrc/fused_decode.cu",
        "replaces": "src/repro/kernels/fused_decode/kernel.py:71"},
    "probe_window": {
        "route": "cuda", "source": "src/repro_torch/csrc/fused_decode.cu",
        "replaces": "src/repro/kernels/fused_decode/kernel.py:97"},
    "minhash_rows": {
        "route": "cuda", "source": "src/repro_torch/csrc/minhash_sig.cu",
        "replaces": "src/repro/kernels/minhash_sig/kernel.py:61"},
    "anchor_probe": {
        "route": "cuda", "source": "src/repro_torch/csrc/anchor_intersect.cu",
        "replaces": "src/repro/kernels/anchor_intersect/kernel.py:107"},
    "dgap_decode": {
        "route": "cuda", "source": "src/repro_torch/csrc/dgap_decode.cu",
        "replaces": "src/repro/kernels/dgap_decode/kernel.py:49"},
    "flash_attention_tpu": {
        "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:83"},
    "flash_decode": {
        "route": "cuda", "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode/kernel.py:84"},
    "embedding_bag": {
        "route": "cuda", "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:52"},
    "cin_layer": {
        "route": "cuda", "source": "src/repro_torch/csrc/cin_interaction.cu",
        "replaces": "src/repro/kernels/cin_interaction/kernel.py:49"},
    "moe_gemm": {
        "route": "cuda", "source": "src/repro_torch/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm/kernel.py:51"},
}
#: the kernels whose outputs are integers or bools, held to tolerance 0
INTEGER_KERNELS = ("anchor_probe_sliced", "decode_rows", "probe_rows", "decode_window",
                   "probe_window", "minhash_rows", "anchor_probe", "dgap_decode")
#: the attention kernels' limits against their plain versions, by kernel and
#: output dtype, elementwise: |got - want| <= rel * |want| + abs.  Both sides
#: widen their inputs to float32 and compute in float32; they differ only in
#: the order of their float32 sums, which moves an output (a weighted mean of
#: v rows) by well under ATTENTION_F32_ABS at these magnitudes (|v| up to ~5
#: at the edge shapes; the path's own v at qwen3-8b widths).  A bf16 output is
#: one rounding of such a float32 value, so the two may round to neighbours:
#: one bf16 step is at most 2^-7 of the value (8 significant bits), plus the
#: float32 difference where the value is near 0.
ATTENTION_F32_ABS = 1e-5
ATTENTION_TOL = {name: {torch.float32: (0.0, ATTENTION_F32_ABS),
                        torch.bfloat16: (2.0 ** -7, ATTENTION_F32_ABS)}
                 for name in ("flash_attention_tpu", "flash_decode")}
#: the fused layout's serving kernels (one launch of each a window), and the
#: row-given route's, which the fused step must launch no time
SERVE_KERNELS = ("decode_window", "probe_window")
ROW_GIVEN_KERNELS = ("anchor_probe_sliced", "decode_rows", "probe_rows")
#: the lm_serve phase's request: the model (full width), prompts per batch,
#: tokens per prompt and greedy decode steps
LM_CONFIG = "qwen3-8b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
#: its bound on |kernel logits - plain logits| for the bf16 model: the
#: reference's own bf16 tolerance for decode against forward
#: (tests/test_models.py:70)
LM_LOGIT_TOL = 0.15
#: the recsys_serve phase: the model at full width and the registry's shapes
#: it serves (``RECSYS_SHAPES`` of configs/base.py); the other three recsys
#: models serve one serve_p99 batch each
RECSYS_CONFIG = "xdeepfm"
RECSYS_SERVE = ("serve_p99", "serve_bulk", "retrieval_cand")
RECSYS_OTHERS = ("fm", "sasrec", "two-tower-retrieval")
#: its bound on |kernel logits - plain logits| / max |plain logit| (float32
#: model; the CIN sums differ only in order): the bound the port's float32
#: model tests hold against the reference
RECSYS_LOGIT_REL = 1e-4
#: the moe_serve phase's model (full width), served like lm_serve
MOE_CONFIG = "moonshot-v1-16b-a3b"
#: the model-side kernels of the fifth slice and how each is held against its
#: plain version: embedding_bag sums each bag in the plain version's order
#: (tolerance 0, NaN where a row is out of range); the two float32 products
#: differ from theirs only in the order of their float32 sums, so each
#: element lies within 2 * gamma_n * (the plain version on |inputs|), the
#: textbook bound on a float32 sum of n products taken in any order
#: (gamma_n = n u / (1 - n u), u = 2^-24; n = D + 1 for moe_gemm, m * Hk + 2
#: for cin_layer, whose z = x0 * xk is one rounding more)
MODEL_KERNELS = ("embedding_bag", "cin_layer", "moe_gemm")
#: calls slower than this are timed with MIN_REPS repetitions, not --reps
SLOW_CALL_MS = 100.0
MIN_REPS = 3
#: the inverted backends of the third slice; each serves through the dense layout
NEW_BACKENDS = ("rice", "rice_runs", "simple9", "pfordelta", "opt_pfd", "elias_fano",
                "ef_opt", "interpolative", "vbyte_lzma", "vbyte_cm", "vbyte_st",
                "vbyte_cmb", "vbyte_stb", "vbyte_lzend")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def emit_done(t_start: float) -> None:
    """The run's wall time, the process's peak host memory, and the Python
    threads besides the main one that are still alive as it is about to exit."""
    import resource
    import threading

    emit("done", seconds=round(time.perf_counter() - t_start, 1),
         max_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
         live_threads=[t.name for t in threading.enumerate()
                       if t is not threading.main_thread()])


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ----------------------------------------------------------------------
# timing and bounds
# ----------------------------------------------------------------------
# spin the card this long before a timed call, so that the call's launches are
# queued before the first one runs and the events bracket device time alone
PRELOAD_CYCLES = 2_000_000  # about 1 ms at the H100's clocks


def time_ms(fn, reps: int = 20, warmup: int = 2, preload: bool = True) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up.  With
    ``preload`` the device is kept busy while the host enqueues ``fn``, so the
    time is the device's; without, it is what a caller that waits sees (the
    wrapper's host side included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if preload:
            torch.cuda._sleep(PRELOAD_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_any(fn, reps: int, preload: bool = True) -> float:
    """``time_ms`` for calls of any length: a call over ``SLOW_CALL_MS`` is
    timed with ``MIN_REPS`` repetitions after one warm-up."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if (time.perf_counter() - t0) * 1e3 > SLOW_CALL_MS:
        return time_ms(fn, MIN_REPS, warmup=0, preload=preload)
    return time_ms(fn, reps, preload=preload)


def bound(bytes_moved: int, ops: int, peak_ops: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type, and which
    one it is."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / peak_ops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _search_steps(n: torch.Tensor) -> int:
    """Compares a bisection over slices of the given lengths needs:
    ceil(log2(n + 1)) per slice, summed (this run's data, not the worst case)."""
    n = n.clamp(min=0).to(torch.float64)
    return int(torch.ceil(torch.log2(n + 1)).sum().item())


def _distinct_words(start: torch.Tensor, length: torch.Tensor) -> int:
    """Words covered by the distinct ``[start, start + length)`` slices among
    the given ones (a slice many rows share is read from memory once)."""
    key = torch.unique((start.long() << 32) | length.clamp(min=0).long())
    return int((key & 0xFFFFFFFF).sum().item())


def anchor_bound(q, lo, hi, anchors):
    """16 B per query (q, lo, hi in, l out) plus the anchors this run's
    searches can reach: the distinct slices' words, or one word per compare
    where that is fewer."""
    steps = _search_steps(hi - lo)
    bytes_moved = 16 * q.numel() + 4 * min(_distinct_words(lo, hi - lo), steps)
    return bound(bytes_moved, steps)


def decode_bound(pool, ptr, lens, L, extra_bytes: int = 0):
    """12 B per row in, 5 B per lane out, plus the pool words under the
    distinct rows' L lanes (and ``extra_bytes``)."""
    out_lanes = ptr.numel() * L
    pool_words = min(int(torch.unique(ptr).numel()) * L, pool.numel(), out_lanes)
    bytes_moved = 12 * ptr.numel() + 4 * pool_words + 5 * out_lanes + extra_bytes
    return bound(bytes_moved, 2 * out_lanes)


def decode_window_bound(args, rows_given):
    """decode_window: the bound of decoding the rows it derives (the
    row-given route's ``decode_rows`` call on the same window) plus 12 B a
    query (its list id and its slice's two offsets)."""
    pool, ptr, _, lens, L = rows_given
    return decode_bound(pool, ptr, lens, L, extra_bytes=12 * args[5].numel())


def probe_window_bound(args, sliced_calls, row_calls):
    """probe_window: 6 B per candidate (value and flag in, match out) and the
    probes this run's data makes.  A candidate's loop stops at its first
    miss, so the row-given route's per-term answers on the same window say
    which probes run; each costs its anchor slice's and its row's bisection
    steps plus one compare, and reads at most the anchor and pool words
    under the distinct slices and rows probed (or one word per load where
    that is fewer)."""
    from repro_torch.kernels.fused_decode.ops import INT32_MAX, probe_rows

    cand_vals, cand_valid, _, ql = args[:4]
    phrase = args[9]
    b, c = cand_vals.shape
    cand = cand_vals.reshape(-1)
    alive = cand_valid.reshape(-1)
    loads, slices, rows = 0, [], []
    for t, (sa, ra) in enumerate(zip(sliced_calls, row_calls), start=1):
        _, lo, hi, _ = sa
        active = (t < ql).repeat_interleave(c)
        run = alive & active & (lo < hi)
        if phrase:
            run &= cand <= INT32_MAX - 1 - t
        loads += _search_steps((hi - lo)[run]) + _search_steps(ra[3][run]) + int(run.sum())
        slices.append((lo[run], (hi - lo)[run]))
        rows.append((ra[1][run], ra[3][run]))
        alive = alive & (~active | (run & probe_rows(*ra)))
    cat = lambda parts, i: torch.cat([x[i] for x in parts])  # noqa: E731
    words = (_distinct_words(cat(slices, 0), cat(slices, 1))
             + _distinct_words(cat(rows, 0), cat(rows, 1))) if slices else 0
    return bound(6 * b * c + 4 * min(words, loads), loads)


def probe_bound(pool, ptr, lens):
    """17 B per row (ptr, base, lens, target in, hit out) plus the pool words
    this run's rows can reach: the distinct rows' live lanes, or one word per
    compare where that is fewer."""
    loads = _search_steps(lens) + ptr.numel()
    bytes_moved = 17 * ptr.numel() + 4 * min(_distinct_words(ptr, lens), loads)
    return bound(bytes_moved, loads)


def minhash_bound(shingles, lens, a):
    """The live lanes' 4 B each plus 4 B per row in, 8 B per hash in, 4 B
    per (row, hash) out; 2 operations (multiply-add, min) per (live lane,
    hash)."""
    d, l = shingles.shape
    p = a.numel()
    live = int(lens.long().clamp(0, l).sum().item())
    return bound(4 * live + 4 * d + 8 * p + 4 * d * p, 2 * live * p), live


def minhash_ceiling(live: int, p: int) -> list[float]:
    """The signature kernel's own ceiling (ms), [low, high]: its inner loop
    issues one 32-bit multiply-add and one unsigned min per (live lane,
    hash), and an int32 multiply-add issues at half the float32 rate, 64
    lanes a clock on each SM (at the card's largest SM clock).  Low if the
    min issues beside it on another pipe, high if both share that rate."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True)
    hz = float(smi.stdout.split()[0]) * 1e6
    rate = torch.cuda.get_device_properties(0).multi_processor_count * 64 * hz
    return [live * p / rate * 1e3, 2 * live * p / rate * 1e3]


def diff_stats(got, want) -> tuple[int, int]:
    """(mismatching elements, max abs difference) over paired outputs."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    mism, err = 0, 0
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"shape/dtype differ: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        if g.numel():
            d = (g.to(torch.int64) - w.to(torch.int64)).abs()
            mism += int((d != 0).sum().item())
            err = max(err, int(d.max().item()))
    return mism, err


# ----------------------------------------------------------------------
# kernels phase
# ----------------------------------------------------------------------
def make_pool(rng, n_rules: int, max_len: int, dev):
    """A rule pool like CompressedAnchoredIndex builds: strictly increasing
    prefix-sum rows, one per rule, then max_len zeros of tail padding."""
    lens = rng.integers(1, max_len + 1, n_rules)
    lens[0] = max_len
    rows = [np.cumsum(rng.integers(1, 50, int(n))) for n in lens]
    pool = np.concatenate(rows + [np.zeros(max_len, np.int64)]).astype(np.int32)
    ptr = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    return torch.from_numpy(pool).to(dev), ptr, lens.astype(np.int32)


def sliced_slice_edges(dev, rng, longest_slice: int) -> list[dict]:
    """anchor_probe_sliced against its plain version on slices of 0, 1,
    2^k - 1, 2^k and 2^k + 1 anchors (k = 4, 8, 12: where the bisection takes
    one step more) and of the path's longest slice, each probed with queries
    below, on, between and above every anchor and 2^31 - 2."""
    from repro_torch.kernels.anchor_intersect.ops import (
        anchor_probe_sliced, anchor_probe_sliced_torch)

    lens = [0, 1] + [2**k + d for k in (4, 8, 12) for d in (-1, 0, 1)] + [longest_slice]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)  # noqa: E731
    rows = []
    for n in lens:
        vals = 2 * np.cumsum(rng.integers(1, 5, n)) + 10  # even, strictly increasing
        anchors = np.concatenate([[5, 7], vals, [2**31 - 3]])  # other lists around it
        lo, hi = 2, 2 + n
        q = np.concatenate([[-2**31, 0, 9, 2**31 - 2, 2**31 - 3], vals, vals - 1, vals + 1,
                            rng.integers(0, max(int(vals[-1]) if n else 20, 20) + 5, 1000)])
        nq = len(q)
        args = (t(q), t(np.full(nq, lo)), t(np.full(nq, hi)), t(anchors))
        mism, err = diff_stats(anchor_probe_sliced(*args), anchor_probe_sliced_torch(*args))
        rows.append({"kernel": "anchor_probe_sliced",
                     "shape": {"NQ": nq, "NA": len(anchors), "slice": n},
                     "mismatches": mism, "max_abs_err": err})
    return rows


def edge_cases(dev, seed: int, longest_slice: int) -> list[dict]:
    from repro_torch.kernels.anchor_intersect.ops import (
        anchor_probe_sliced, anchor_probe_sliced_torch)
    from repro_torch.kernels.fused_decode.ops import (
        decode_rows, decode_rows_torch, probe_rows, probe_rows_torch)

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
    out = []
    # anchors: 40 slices of 0..300 strictly increasing values each
    sl = rng.integers(0, 300, 40)
    sl[:3] = 0  # empty slices
    offs = np.concatenate([[0], np.cumsum(sl)])
    anchors = np.concatenate([np.cumsum(rng.integers(1, 9, int(n))) - 1 for n in sl]
                             + [np.zeros(0, np.int64)])
    for nq in (0, 1, 255, 256, 257, 100_003):
        lid = rng.integers(0, 40, nq)
        q = rng.integers(-3, 2600, nq)
        q[::7] = 2**31 - 2  # above every anchor
        args = (t(q), t(offs[lid]), t(offs[lid + 1]), t(anchors))
        mism, err = diff_stats(anchor_probe_sliced(*args), anchor_probe_sliced_torch(*args))
        out.append({"kernel": "anchor_probe_sliced", "shape": {"NQ": nq, "NA": len(anchors)},
                    "mismatches": mism, "max_abs_err": err})
    out += sliced_slice_edges(dev, rng, longest_slice)
    for L in (1, 7, 128, 129, 1100):
        pool, rptr, rlen = make_pool(rng, 64, L, dev)
        for rows in (0, 1, 255, 256, 257, 2049):
            pick = rng.integers(0, 64, rows)
            lens = np.minimum(rlen[pick], rng.integers(0, L + 1, rows))
            lens[::5] = 0  # lens == 0 rows
            base = rng.integers(0, 10**6, rows)
            args = (pool, t(rptr[pick]), t(base), t(lens))
            mism, err = diff_stats(decode_rows(*args, L), decode_rows_torch(*args, L))
            out.append({"kernel": "decode_rows", "shape": {"R": rows, "L": L},
                        "mismatches": mism, "max_abs_err": err})
            vals, _ = decode_rows_torch(*args, L)
            lane = rng.integers(0, np.maximum(lens, 1))
            hitv = vals.cpu().numpy()[np.arange(rows), lane] if rows else np.zeros(0)
            targets = np.where(np.arange(rows) % 2 == 0, hitv, base + 10**7)
            targets[3::11] = -5
            args = args + (t(targets),)
            got, want = probe_rows(*args), probe_rows_torch(*args)
            mism, err = diff_stats(got, want)
            out.append({"kernel": "probe_rows", "shape": {"R": rows, "L": L},
                        "mismatches": mism, "max_abs_err": err,
                        "hits": int(want.sum().item())})
    # top of the int32 range: base + pool wraps in the later lanes, and both
    # sides add with wraparound (targets: a wrapped lane, and the unwrapped sum)
    pool, rptr, rlen = make_pool(rng, 64, 16, dev)
    rows = 257
    pick = rng.integers(0, 64, rows)
    lens = rlen[pick]
    base = 2**31 - 1 - rng.integers(0, 60, rows)
    args = (pool, t(rptr[pick]), t(base), t(lens))
    mism, err = diff_stats(decode_rows(*args, 16), decode_rows_torch(*args, 16))
    out.append({"kernel": "decode_rows", "shape": {"R": rows, "L": 16, "wraps": True},
                "mismatches": mism, "max_abs_err": err})
    vals, _ = decode_rows_torch(*args, 16)
    lane = rng.integers(0, lens)
    wrapped = vals.cpu().numpy()[np.arange(rows), lane]
    targets = np.where(np.arange(rows) % 3 == 0, 2**31 - 1, wrapped)
    args = args + (t(targets),)
    got, want = probe_rows(*args), probe_rows_torch(*args)
    mism, err = diff_stats(got, want)
    require(int((wrapped < 0).sum()) > 0 and int(want.sum().item()) > 0,
            "the wraparound edge case does not wrap")
    out.append({"kernel": "probe_rows", "shape": {"R": rows, "L": 16, "wraps": True},
                "mismatches": mism, "max_abs_err": err, "hits": int(want.sum().item())})
    if dev.type == "cuda":
        torch.cuda.synchronize()  # a fault inside a kernel surfaces here
    return out


def window_table(rng, n_lists: int, L: int, dev) -> dict:
    """A fused entry table like CompressedAnchoredIndex builds: a rule pool of
    strictly increasing rows (``make_pool``), lists of 0..300 entries whose
    anchors increase by more than their row's last value, lists 0-2 and the
    last one empty; list 4 is list 3 moved up by 1 (its decoded postings are
    list 3's plus 1, so a phrase of the two hits) and list 5 sits at the top
    of the int32 range (its postings pass 2^31 - 2 - t, where a phrase
    target would wrap)."""
    pool, rptr, rlen = make_pool(rng, 64, L, dev)
    pool_np = pool.cpu().numpy().astype(np.int64)
    sizes = rng.integers(1, 300, n_lists)
    sizes[[0, 1, 2, n_lists - 1]] = 0
    sizes[4] = sizes[3]
    anchors, ptrs, lens = [], [], []
    for i, n in enumerate(sizes):
        pick = rng.integers(0, 64, int(n))
        if i == 4:
            pick = prev_pick
        span = pool_np[rptr[pick] + rlen[pick] - 1] + rng.integers(1, 4, int(n))
        start = 2**31 - 1 - int(span.sum()) - 3 if i == 5 else int(rng.integers(0, 1000))
        a = start + np.concatenate([[0], np.cumsum(span)[:-1]]) if n else np.zeros(0, np.int64)
        if i == 4:
            a = anchors[3] + 1
        anchors.append(a)
        ptrs.append(rptr[pick])
        lens.append(rlen[pick])
        prev_pick = pick
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)  # noqa: E731
    return {"pool": pool, "c_offsets": t(np.concatenate([[0], np.cumsum(sizes)])),
            "anchors": t(np.concatenate(anchors)), "c_ptr": t(np.concatenate(ptrs)),
            "c_len": t(np.concatenate(lens)), "sizes": sizes}


#: edge shapes of the window kernels: pool row bound L (a decode block
#: covers 256 lanes' worth of rows, at least one: 256 rows at L 1, one row
#: of 129 lanes, one of 1,500 for 256 threads), queries B, (width, phrase), and (row_start, window_rows):
#: the first, third and one past every list's end window of MAX_CAND_ROWS,
#: and windows of 1 and 5 rows
WINDOW_L = (1, 7, 75, 129, 1500)
WINDOW_B = (1, 33)
WINDOW_WIDTHS = ((1, False), (2, False), (2, True), (3, True), (9, False), (9, True))
WINDOW_ROWS = ((0, 64), (128, 64), (320, 64), (7, 1), (3, 5))
#: candidates x L past which an edge case checks the decode only
WINDOW_PROBE_ELEMS = 1 << 28


def window_edge_cases(dev, seed: int) -> list[dict]:
    """decode_window / probe_window against their plain versions on entry
    tables of ``window_table``: queries driven by and probing every kind of
    list (empty, shifted copy, top of the range, an id past the table),
    the padded row of a query with an unknown term, lengths 0, 1, W and
    W + 1, inactive columns holding other ids, candidates turned valid at
    random, ids read through a column view and terms through a wider
    matrix (row strides), in the first, the third and a past-the-end
    window and in windows of 1 and 5 rows (past ``WINDOW_PROBE_ELEMS`` the
    decode only)."""
    from repro_torch.kernels.fused_decode.ops import (
        decode_window, decode_window_torch, probe_window, probe_window_torch)

    rng = np.random.default_rng(seed + 19)
    out = []
    n_lists = 40
    for L in WINDOW_L:
        tab = window_table(rng, n_lists, L, dev)
        table = [tab[k] for k in ("c_offsets", "anchors", "c_ptr", "c_len")]
        for b in WINDOW_B:
            for width, phrase in WINDOW_WIDTHS:
                wide = rng.integers(0, n_lists, (b, width + 3))
                wide[:, 0] = rng.choice([3, 4, 5, 6, 7, 0, n_lists - 1, n_lists + 2], b)
                if width > 1:
                    wide[:, 1] = np.where(wide[:, 0] == 3, 4, wide[:, 0])  # hits: a copy, or itself
                lens = rng.integers(0, width + 2, b)
                lens[0] = width
                if b > 2:
                    wide[2], lens[2] = 0, 1  # the padded row of a query with an unknown term
                qt = torch.from_numpy(wide.astype(np.int32)).to(dev)[:, :width]
                ql = torch.from_numpy(lens.astype(np.int32)).to(dev)
                for row_start, window_rows in WINDOW_ROWS:
                    args = (tab["pool"], *table, qt[:, 0], row_start, window_rows, L)
                    got, want = decode_window(*args), decode_window_torch(*args)
                    mism, err = diff_stats(got, want)
                    shape = {"B": b, "W": width, "L": L, "row_start": row_start,
                             "window_rows": window_rows, "phrase": phrase}
                    out.append({"kernel": "decode_window", "shape": shape, "mismatches": mism,
                                "max_abs_err": err, "live": int(want[1].sum().item())})
                    if want[0].numel() * L > WINDOW_PROBE_ELEMS:
                        continue  # the plain probe would stage too many lanes
                    vals, valid = want
                    valid = valid | (torch.rand(valid.shape, device=dev) < 0.05)
                    pargs = (vals, valid, qt, ql, *table, tab["pool"], phrase)
                    got, want = probe_window(*pargs), probe_window_torch(*pargs)
                    mism, err = diff_stats(got, want)
                    out.append({"kernel": "probe_window", "shape": shape, "mismatches": mism,
                                "max_abs_err": err, "hits": int(want.sum().item())})
    require(any(r["kernel"] == "probe_window" and r["shape"]["phrase"] and r["hits"]
                and r["shape"]["W"] > 1 for r in out), "no phrase edge case hits")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


#: edge shapes of the MinHash kernel: rows, lanes (512 = one warp's chunk:
#: wider tiles take the chunked route), hashes
MINHASH_ROWS = (0, 1, 31, 32, 33, 4097)
MINHASH_LANES = (0, 1, 127, 128, 129, 512, 513, 4096)
MINHASH_PERMS = (1, 64, 200)
#: hash counts at the edges of a thread's 16 and of MAX_PERM, on a few tiles
MINHASH_EDGE_PERMS = (15, 17, 63, 65, 512, 4096)
#: the skewed tile: (rows, lanes); row 0 is long, the others short
MINHASH_SKEWED = (300, 3000)


def _minhash_row(out: list, shape: dict, s, lens, a, b) -> None:
    from repro_torch.kernels.minhash_sig.ops import (
        minhash_rows, minhash_rows_route, minhash_rows_torch)

    mism, err = diff_stats(minhash_rows(s, lens, a, b), minhash_rows_torch(s, lens, a, b))
    out.append({"kernel": "minhash_rows", "shape": shape, "route": minhash_rows_route(s),
                "mismatches": mism, "max_abs_err": err})


def minhash_edge_cases(dev, seed: int) -> list[dict]:
    """minhash_rows against its plain version at every (D, L, P) of the edge
    shapes, with garbage in the dead lanes, rows with ``lens == 0``, the
    shingles 0 and 0xFFFFFFFF among the live lanes and an ``a`` with its top
    bit set; at ``MINHASH_EDGE_PERMS`` hashes on a few tiles; and on a
    skewed tile (lens 0, 1, L and past L, a long row beside many short
    ones, rows at the chunk's edges) of both routes."""
    from repro_torch.kernels.minhash_sig.ops import CHUNK_LANES, hash_params

    g = torch.Generator(device=dev).manual_seed(seed)
    out: list = []

    def params(p: int):
        a, b = hash_params(p, seed + p)
        a[0] |= np.uint32(0x80000000)
        return [torch.from_numpy(x.view(np.int32)).to(dev) for x in (a, b)]

    def tile(d: int, l: int):
        s = torch.randint(-2**31, 2**31, (d, l), generator=g, device=dev,
                          dtype=torch.int64).to(torch.int32)
        lens = torch.randint(0, l + 1, (d,), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)
        lens[::4] = 0
        lens[2::5] = l
        if l:
            s[:, 0] = 0
            s[1::3, l // 2] = -1  # 0xFFFFFFFF
        return s, lens

    for d in MINHASH_ROWS:
        for l in MINHASH_LANES:
            s, lens = tile(d, l)
            for p in MINHASH_PERMS:
                _minhash_row(out, {"D": d, "L": l, "P": p}, s, lens, *params(p))
    for d, l in ((33, 129), (33, 513), (5, 4096)):
        s, lens = tile(d, l)
        for p in MINHASH_EDGE_PERMS:
            _minhash_row(out, {"D": d, "L": l, "P": p}, s, lens, *params(p))
    d, l = MINHASH_SKEWED
    for width in (l, CHUNK_LANES):
        s, _ = tile(d, width)
        lens = torch.randint(1, 41, (d,), generator=g, device=dev, dtype=torch.int64)
        lens[0] = width - 100  # the long row
        lens[1:6] = torch.tensor([0, 1, width, width + 7, -3])
        if width > CHUNK_LANES:  # rows at the chunks' edges
            lens[6:11] = torch.tensor([CHUNK_LANES - 1, CHUNK_LANES, CHUNK_LANES + 1,
                                       2 * CHUNK_LANES, 2 * CHUNK_LANES + 1])
        lens = lens.to(torch.int32)
        for p in (1, 64, 65):
            _minhash_row(out, {"D": d, "L": width, "P": p, "lens": "skewed"}, s, lens,
                         *params(p))
    routes = {r["route"] for r in out}
    require(routes == {"one_pass", "chunked"}, f"minhash edge cases reach the routes {routes}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


def wrapper_refusals(dev) -> int:
    """The index kernels' wrappers take contiguous int32 tensors on one CUDA
    device, the attention kernels' float32 / bf16 tensors of the head dims
    they are built for, and each raises on anything else; returns how many
    refusals were checked."""
    from repro_torch.kernels.anchor_intersect.ops import anchor_probe, anchor_probe_sliced
    from repro_torch.kernels.dgap_decode.ops import dgap_decode
    from repro_torch.kernels.flash_attention.ops import flash_attention_tpu
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.fused_decode.ops import (
        MAX_WINDOW_TERMS, decode_rows, decode_window, probe_rows, probe_window)
    from repro_torch.kernels.minhash_sig.ops import minhash_rows

    q = torch.zeros(4, dtype=torch.int32, device=dev)
    s = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    a = torch.zeros((2, 8, 4, 32), device=dev)  # (B, T or S, heads, hd)
    a48 = torch.zeros((2, 8, 4, 48), device=dev)
    wide = torch.zeros((2, 8, 34, 64), device=dev)[..., :32]  # 34 heads, strided
    cases = [
        (TypeError, "int32", lambda: anchor_probe(q.long(), q)),
        (ValueError, "lies on", lambda: anchor_probe(q, q.cpu())),
        (ValueError, "contiguous", lambda: anchor_probe(q, q[::2])),
        (ValueError, "dimension", lambda: anchor_probe(s, q)),
        (TypeError, "int32", lambda: dgap_decode(q.long())),
        (ValueError, "lies on", lambda: dgap_decode(meta)),
        (ValueError, "contiguous", lambda: dgap_decode(q[::2])),
        (ValueError, "dimension", lambda: dgap_decode(s)),
        (TypeError, "int32", lambda: anchor_probe_sliced(q.long(), q, q, q)),
        (ValueError, "lies on", lambda: anchor_probe_sliced(q, q.cpu(), q, q)),
        (ValueError, "contiguous", lambda: probe_rows(q, q[::2], q[::2], q[::2], q[::2])),
        (ValueError, "rows", lambda: decode_rows(q, q, q[:2], q, 1)),
        (TypeError, "int32", lambda: decode_window(q, q, q, q, q, q.long(), 0, 64, 1)),
        (ValueError, "lies on", lambda: decode_window(q, q, q, q, q.cpu(), q, 0, 64, 1)),
        (ValueError, "rows", lambda: decode_window(q, q, q, q[:2], q, q, 0, 64, 1)),
        (ValueError, "lies on", lambda: probe_window(s, s.bool(), s, q, q, q, q, q, q.cpu(),
                                                     False)),
        (ValueError, "contiguous", lambda: probe_window(s, s.bool(), s[:, ::2], q, q, q, q, q,
                                                        q, False)),
        (ValueError, "cand_valid", lambda: probe_window(s, s, s, q, q, q, q, q, q, False)),
        (ValueError, "at most", lambda: probe_window(
            s[:1], s[:1].bool(), torch.zeros((1, MAX_WINDOW_TERMS + 1), dtype=torch.int32,
                                             device=dev), q[:1], q, q, q, q, q, True)),
        (TypeError, "int32", lambda: minhash_rows(s.long(), q, q, q)),
        (ValueError, "lies on", lambda: minhash_rows(s, q.cpu(), q, q)),
        (ValueError, "contiguous", lambda: minhash_rows(s.t(), q, q, q)),
        (ValueError, "rows", lambda: minhash_rows(s, q[:3], q, q)),
        (TypeError, "float32 or bfloat16", lambda: flash_attention_tpu(a.half(), a, a)),
        (TypeError, "one dtype", lambda: flash_attention_tpu(a, a.bfloat16(), a)),
        (ValueError, "head_dim", lambda: flash_attention_tpu(a48, a48, a48)),
        (ValueError, "lies on", lambda: flash_attention_tpu(a, a.cpu(), a)),
        (ValueError, "contiguous", lambda: flash_attention_tpu(wide[..., ::2], a, a)),
        (NotImplementedError, "no backward", lambda: flash_attention_tpu(
            a.clone().requires_grad_(), a, a)),
        (TypeError, "int32", lambda: flash_decode(a[:, :1], a, a, q[:2].long())),
        (TypeError, "one cache dtype", lambda: flash_decode(a[:, :1], a, a.bfloat16(),
                                                             q[:2])),
        (ValueError, "at most 16", lambda: flash_decode(wide[:, :1], a[..., :1, :], a[..., :1, :],
                                                        q[:2])),
        (ValueError, "lies on", lambda: flash_decode(a[:, :1], a, a, q[:2].cpu())),
    ]
    before = launch_counts()
    for exc, text, call in cases:
        try:
            call()
        except exc as e:
            require(text in str(e), f"refusal says {e!r}, expected {text!r} in it")
        else:
            raise SmokeFailure(f"a wrapper took what its kernel does not take ({text})")
    require(launch_counts() == before, "a refused call counted as a launch")
    return len(cases)


@contextlib.contextmanager
def recorded_wrappers():
    """Put a recorder in front of each kernel wrapper for the time of the
    block, so that a device step built and run inside it tells what it handed
    each kernel.  Yields ``{kernel name: [argument tuple per call, ...]}``."""
    from repro_torch.kernels.anchor_intersect import ops as ai
    from repro_torch.kernels.fused_decode import ops as fd
    from repro_torch.kernels.minhash_sig import ops as mh

    homes = {"anchor_probe_sliced": ai, "decode_rows": fd, "probe_rows": fd,
             "decode_window": fd, "probe_window": fd, "minhash_rows": mh}
    seen = {name: [] for name in homes}
    originals = {name: getattr(mod, name) for name, mod in homes.items()}

    def recorder(name):
        def rec(*a):
            seen[name].append(a)
            return originals[name](*a)
        # a wrapper counts its launches on its module-level name (its routes'
        # counts in a dict, shared)
        rec.launches = originals[name].launches
        if hasattr(originals[name], "launches_by_route"):
            rec.launches_by_route = originals[name].launches_by_route
        return rec

    for name, mod in homes.items():
        setattr(mod, name, recorder(name))
    try:
        yield seen
    finally:
        for name, mod in homes.items():
            originals[name].launches = getattr(mod, name).launches
            setattr(mod, name, originals[name])


def row_given_step(max_terms: int, phrase: bool, max_phrase: int):
    """The fused kernel step as the port ran it before the whole-window
    kernels, kept as the route to compare with: the window's rows gathered
    by torch ops and decoded by ``decode_rows``; per probed term
    ``anchor_probe_sliced`` for the covering entry and ``probe_rows`` on its
    row, the terms combined by torch ops (``engine._probe_terms``).  Returns
    ``(candidate postings, match)``, as the fused step without top-k or doc
    listing does.  The wrappers are looked up when the step is built."""
    from repro_torch.kernels.anchor_intersect.ops import anchor_probe_sliced
    from repro_torch.kernels.fused_decode.ops import decode_rows, probe_rows
    from repro_torch.serving import engine

    def member(idx, list_ids, values):
        if idx.anchors.shape[0] == 0:
            return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
        targets = (values.to(torch.int32) + 1).contiguous()
        ids = list_ids.long()
        lo = idx.c_offsets[ids]
        hi = idx.c_offsets[ids + 1]
        l = anchor_probe_sliced(targets, lo, hi, idx.anchors)
        j = torch.maximum(l - 1, lo).long()
        hit = probe_rows(idx.pool, idx.c_ptr[j], idx.anchors[j], idx.c_len[j], targets)
        return hit & (lo < hi)

    def step(index: dict, query_terms, query_lens, row_start: int = 0):
        idx = engine._as_compressed(index, max_phrase)
        rows, valid_rows = engine._window_rows(idx.c_offsets, query_terms[:, 0], row_start,
                                               idx.anchors.shape[0])
        flat = rows.reshape(-1).long()
        lens = torch.where(valid_rows.reshape(-1), idx.c_len[flat],
                           torch.zeros((), dtype=torch.int32, device=flat.device))
        vals, valid = decode_rows(idx.pool, idx.c_ptr[flat], idx.anchors[flat], lens,
                                  max(int(max_phrase), 1))
        b = query_terms.shape[0]
        cand_vals, cand_valid = vals.reshape(b, -1), valid.reshape(b, -1)
        match = engine._probe_terms(idx, query_terms, query_lens, cand_vals, cand_valid,
                                    max_terms, phrase, member=member)
        return cand_vals - 1, match

    return step


def main_path_inputs(server, kind: str, qt: np.ndarray, ql: np.ndarray,
                     window: int = 0) -> dict:
    """What one device step of ``server`` hands each kernel: a step like the
    server's own (same layout, probe and width) is built and run on window
    ``window`` of the term-id batch with recorders in front of the wrappers.
    A fused server's window is also run through ``row_given_step``: both
    routes must give the same candidates and matches, and their calls are
    kept side by side (the row-given ones also size the window kernels'
    data-dependent bounds)."""
    from repro_torch.serving.engine import MAX_CAND_ROWS, make_serve_step
    from repro_torch.serving.plan import AND, PHRASE

    dev = server.device
    width = qt.shape[1]
    fused = server.layout == "fused"
    args = (server.arrays, torch.from_numpy(qt).to(dev), torch.from_numpy(ql).to(dev),
            window * MAX_CAND_ROWS)
    with recorded_wrappers() as seen, torch.no_grad():
        step = make_serve_step(max_terms=width, mode=PHRASE if kind == "phrase" else AND,
                               n_docs=server.n_docs, probe="kernel",
                               layout=server.layout, max_phrase=server.max_phrase)
        out = step(*args)
    got = {name: len(calls) for name, calls in seen.items()}
    want = {name: 0 for name in seen}
    want.update({"decode_window": 1, "probe_window": 1} if fused
                else {"anchor_probe_sliced": width - 1})
    require(got == want, f"a {server.layout} step of width {width} made the kernel calls "
            f"{got}, expected {want}")
    calls = {name: c for name, c in seen.items() if c}
    if fused:
        with recorded_wrappers() as seen, torch.no_grad():
            old = row_given_step(width, kind == "phrase", server.max_phrase)(*args)
        got = {name: len(c) for name, c in seen.items()}
        want = {name: 0 for name in seen}
        want.update({"decode_rows": 1, "anchor_probe_sliced": width - 1,
                     "probe_rows": width - 1})
        require(got == want, f"the row-given step of width {width} made the kernel calls "
                f"{got}, expected {want}")
        require(all(torch.equal(a, b) for a, b in zip(out, old)),
                f"the window kernels and the row-given route differ at width {width}, "
                f"window {window}")
        calls.update({f"{name} (rows given)": c for name, c in seen.items() if c})
    return {"calls": calls, "c_offsets": server.arrays["c_offsets"],
            "B": int(qt.shape[0]), "window": window}


def library_lower_bound(args, c_offsets):
    """``torch.searchsorted`` as a yardstick for anchor_probe_sliced: one call
    over composite int64 keys (slice id << 32 | value), prepared outside the
    timed call.  Never used by the port.  Returns the call and the mask of
    queries it answers (those with a non-empty slice)."""
    targets, lo, hi, anchors = args
    c_off = c_offsets.long()
    slice_of = torch.repeat_interleave(
        torch.arange(c_off.numel() - 1, device=anchors.device), c_off[1:] - c_off[:-1])
    keys = (slice_of << 32) | anchors.long()
    live = lo < hi
    qkeys = (slice_of[lo.long().clamp(max=anchors.numel() - 1)] << 32) | targets.long()
    return (lambda: torch.searchsorted(keys, qkeys)), live


def kernels_at_main_path(name: str, inp: dict, reps: int, timed: bool) -> list[dict]:
    """Every recorded call of the step against the plain version (tolerance
    0); with ``timed``, the first call of each kernel is also timed, beside
    the plain version, the bound and the library yardstick.  Calls of the
    row-given route are keyed ``"<kernel> (rows given)"``."""
    from repro_torch.kernels.anchor_intersect.ops import (
        anchor_probe_sliced, anchor_probe_sliced_torch)
    from repro_torch.kernels.fused_decode.ops import (
        decode_rows, decode_rows_torch, decode_window, decode_window_torch, probe_rows,
        probe_rows_torch, probe_window, probe_window_torch)

    pairs = {"anchor_probe_sliced": (anchor_probe_sliced, anchor_probe_sliced_torch),
             "decode_rows": (decode_rows, decode_rows_torch),
             "probe_rows": (probe_rows, probe_rows_torch),
             "decode_window": (decode_window, decode_window_torch),
             "probe_window": (probe_window, probe_window_torch)}
    given = lambda kernel: inp["calls"].get(f"{kernel} (rows given)")  # noqa: E731
    rows = []
    for key, calls in inp["calls"].items():
        kernel = key.split(" ")[0]
        fn, plain = pairs[kernel]
        mism = err = 0
        for a in calls:
            m, e = diff_stats(fn(*a), plain(*a))
            mism, err = mism + m, max(err, e)
        a = calls[0]
        if kernel == "anchor_probe_sliced":
            shape = {"NQ": a[0].numel(), "NA": a[3].numel(),
                     "longest_slice": int((a[2] - a[1]).max().item())}
        elif kernel == "decode_window":
            shape = {"B": a[5].numel(), "C": a[7] * a[8], "L": a[8], "row_start": a[6],
                     "window_rows": a[7], "P": a[0].numel()}
        elif kernel == "probe_window":
            shape = {"B": a[0].shape[0], "C": a[0].shape[1], "W": a[2].shape[1],
                     "phrase": a[9], "P": a[8].numel()}
        else:
            shape = {"R": a[1].numel(), "P": a[0].numel()}
            shape.update({"L": a[4]} if kernel == "decode_rows"
                         else {"longest_row": int(a[3].max().item())})
        row = {"kernel": kernel, "at": name + key[len(kernel):], "window": inp["window"],
               "shape": shape, "calls_compared": len(calls), "mismatches": mism,
               "max_abs_err": err}
        if timed:
            library_ms = None
            if kernel == "anchor_probe_sliced":
                lib_call, live = library_lower_bound(a, inp["c_offsets"])
                row["library"] = "torch.searchsorted on composite int64 keys"
                row["library_agrees"] = bool(torch.equal(
                    lib_call().to(torch.int32)[live], fn(*a)[live]))
                library_ms = time_ms(lib_call, reps)
                b_ms, b_by = anchor_bound(*a)
            elif kernel == "decode_rows":
                b_ms, b_by = decode_bound(a[0], a[1], a[3], a[4])
            elif kernel == "probe_rows":
                b_ms, b_by = probe_bound(a[0], a[1], a[3])
            elif kernel == "decode_window":
                b_ms, b_by = decode_window_bound(a, given("decode_rows")[0])
            else:
                b_ms, b_by = probe_window_bound(a, given("anchor_probe_sliced") or [],
                                                given("probe_rows") or [])
            row.update(ms=time_ms(lambda: fn(*a), reps),
                       call_ms=time_ms(lambda: fn(*a), reps, preload=False),
                       plain_ms=time_ms(lambda: plain(*a), reps),
                       library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
    return rows


# ----------------------------------------------------------------------
# backends phase
# ----------------------------------------------------------------------
def backends_path(built: dict, batch, device: str) -> dict:
    """The 14 inverted backends of the third slice, each built from the
    non-positional index's posting lists (the collection is not tokenised
    again) and served, each with the launch counts set to 0 just before its
    session is built and read just after it served: ``Session.build(...,
    device)`` re-anchors the store into the dense layout and answers the
    batch's AND / ``top10:`` / ``docs:`` queries, which must equal the
    host-only session's (the backend's own capability route).  Every list
    must equal the source list."""
    from repro_torch.core.registry import BuildSource, build_backend
    from repro_torch.serving.session import Session

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    base = built["idx"]
    lists = [base.store.get_list(i) for i in range(base.store.n_lists)]
    source = BuildSource.from_lists(lists)
    queries = [q for k, q in batch if k in ("and", "topk", "docs")]
    rows = {}
    for name in NEW_BACKENDS:
        t0 = time.perf_counter()
        store = build_backend(name, source)
        t1 = time.perf_counter()
        bad = [i for i, want in enumerate(lists) if not np.array_equal(store.get_list(i), want)]
        require(not bad, f"{name}: {len(bad)} lists differ from the source, first {bad[:3]}")
        t2 = time.perf_counter()
        idx = dataclasses.replace(base, store=store, store_name=name, store_kw={},
                                  similarity=None)
        reset_launch_counts()
        sess = Session.build(idx, device=device)
        t3 = time.perf_counter()
        got = sess.execute(queries)
        sync()
        t4 = time.perf_counter()
        launches = launch_counts()
        require(sess.server.layout == "dense",
                f"the {name} server took the {sess.server.layout} layout, expected dense")
        host = Session(idx)
        want = host.execute(queries)
        t5 = time.perf_counter()
        wrong = [q for q, a, b in zip(queries, got, want) if not np.array_equal(a, b)]
        require(not wrong, f"{len(wrong)} {name} answers differ from the host session's, "
                f"first: {wrong[:3]}")
        if device != "cpu":
            require(launches["anchor_probe_sliced"] > 0,
                    f"anchor_probe_sliced was not launched serving {name}: {launches}")
            require(all(t.is_cuda for t in sess.server.arrays.values()),
                    f"a {name} server array is not a CUDA tensor")
        rows[name] = {"build_s": t1 - t0, "lists_equal": len(lists), "check_lists_s": t2 - t1,
                      "size_in_bits": int(store.size_in_bits),
                      "space_fraction": idx.space_fraction,
                      "queries": len(queries), "answers_equal_host": len(queries),
                      "nonempty_answers": sum(len(r) > 0 for r in want),
                      "host_strategies": sorted({host.plan(q).strategy for q in queries}),
                      "session_build_s": t3 - t2, "serve_s": t4 - t3,
                      "host_session_s": t5 - t4, "launches": launches}
        del sess, got
    return rows


# ----------------------------------------------------------------------
# dgap_decode and anchor_probe phases: the public entry points
# ----------------------------------------------------------------------
#: edge lengths of the d-gap scan
DGAP_LENGTHS = (0, 1, 2, 255, 256, 257, 4095, 4096, 4097, 65535, 65536, 65537, 2**24 + 13)
#: edge shapes of the whole-array anchor probe
PROBE_NQ = (0, 1, 255, 256, 257, 2**20)
PROBE_NA = (0, 1, 2047, 2048, 2049)
INT32_MAX = 2**31 - 1


def _wrap_sub(a: torch.Tensor, b) -> torch.Tensor:
    """``a - b`` in int32 wraparound, as int64 in [0, 2^32)."""
    return (a.long() - b) & 0xFFFFFFFF


#: calls of dgap_decode repeated on one input, each compared (a look-back
#: race would show now and then, not every time)
DGAP_REPEATS = 50


def dgap_repeats(gaps: torch.Tensor, shape: dict, repeats: int = DGAP_REPEATS) -> dict:
    """``repeats`` calls of dgap_decode on ``gaps``, each against the plain
    version."""
    from repro_torch.kernels.dgap_decode.ops import (
        dgap_decode, dgap_decode_route, dgap_decode_torch)

    want = dgap_decode_torch(gaps)
    mism = err = bad = 0
    for _ in range(repeats):
        m, e = diff_stats(dgap_decode(gaps), want)
        mism, err, bad = mism + m, max(err, e), bad + (m > 0)
    return {"kernel": "dgap_decode", "shape": shape, "route": dgap_decode_route(gaps),
            "repeats": repeats, "calls_differing": bad, "mismatches": mism, "max_abs_err": err}


def dgap_edge_cases(dev, seed: int) -> list[dict]:
    """dgap_decode against its plain version at every edge length, on three
    gap streams each: the full int32 range (negative gaps, wraps), positive
    gaps below 2^16 (a long stream wraps) and gaps of 2^30 (wraps at once);
    each stream also as a view one element in (``buf[1:]``, 4-byte aligned:
    the element-load route).  The longest length (more tiles than the card
    holds at once, so tiles wait on tiles not yet started when they
    started) is repeated ``DGAP_REPEATS`` times on both routes."""
    from repro_torch.kernels.dgap_decode.ops import (
        dgap_decode, dgap_decode_route, dgap_decode_torch)

    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for n in DGAP_LENGTHS:
        streams = {
            "full_range": torch.randint(-2**31, 2**31, (n + 1,), generator=g, device=dev,
                                        dtype=torch.int64).to(torch.int32),
            "positive": torch.randint(1, 2**16, (n + 1,), generator=g, device=dev,
                                      dtype=torch.int32),
            "huge": torch.full((n + 1,), 2**30, dtype=torch.int32, device=dev)}
        for kind, buf in streams.items():
            for view, gaps in (("aligned", buf[:n]), ("offset", buf[1:])):
                want = dgap_decode_torch(gaps)
                mism, err = diff_stats(dgap_decode(gaps), want)
                wraps = n > 1 and bool((gaps.long().cumsum(0) > INT32_MAX).any().item())
                out.append({"kernel": "dgap_decode", "shape": {"n": n, "gaps": kind,
                                                               "view": view},
                            "route": dgap_decode_route(gaps) if n > 1 else None,
                            "wraps": wraps, "mismatches": mism, "max_abs_err": err})
        if n == max(DGAP_LENGTHS):
            buf = streams["full_range"]
            out += [dgap_repeats(buf[:n], {"n": n, "gaps": "full_range", "view": "aligned"}),
                    dgap_repeats(buf[1:], {"n": n, "gaps": "full_range", "view": "offset"})]
    require(any(r.get("wraps") for r in out), "no d-gap edge stream wraps")
    require({r["route"] for r in out} >= {"vec16", "scalar"},
            "the d-gap edge cases did not reach both load routes")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


def dgap_path(built: dict, dev, reps: int) -> dict:
    """The d-gap decode entry point on the positional index's posting lists,
    with the launch counts set to 0 just before and read just after: every
    list of 4096 positions or more decoded from its d-gaps on its own, then
    the whole concatenated d-gap stream in one call, every list recovered
    from it by subtracting (int32 wraparound) the value just before its
    offset.  All must equal the host's lists.  Then timed at the whole
    stream beside the plain version, the bound and ``torch.cumsum``."""
    from repro_torch.core.dgaps import to_dgaps
    from repro_torch.kernels.dgap_decode.ops import (
        dgap_decode, dgap_decode_route, dgap_decode_torch)

    store = built["pidx"].store
    lists = [store.get_list(i) for i in range(store.n_lists)]
    lens = np.asarray([len(x) for x in lists], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    stream = np.concatenate([to_dgaps(x) for x in lists])
    require(stream.max() <= INT32_MAX, "a d-gap does not fit int32")
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)  # noqa: E731
    long_ids = [i for i in range(len(lists)) if lens[i] >= 4096]
    inputs = {i: as_t(stream[offsets[i]:offsets[i + 1]]) for i in long_ids}
    whole = as_t(stream)
    reset_launch_counts()
    decoded = {i: dgap_decode(g) for i, g in inputs.items()}
    dec_whole = dgap_decode(whole)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = launch_counts()
    routes = route_counts()["dgap_decode"]
    bad = [i for i, d in decoded.items() if not np.array_equal(d.cpu().numpy(), lists[i])]
    require(not bad, f"{len(bad)} long lists decode differently from the host's, first {bad[:3]}")
    # list k is S[o_k + m] - S[o_k - 1] - 1 where S = dec_whole + 1
    off = torch.from_numpy(offsets).to(dev)
    prev = torch.where(off[:-1] > 0, dec_whole[(off[:-1] - 1).clamp(min=0)].long() + 1, 0)
    seg = torch.repeat_interleave(torch.arange(len(lists), device=dev),
                                  torch.from_numpy(lens).to(dev))
    recovered = _wrap_sub(dec_whole, prev[seg]).cpu().numpy()
    wrong = [k for k in range(len(lists))
             if not np.array_equal(recovered[offsets[k]:offsets[k + 1]], lists[k])]
    require(not wrong, f"{len(wrong)} lists recovered from the whole stream differ")
    running = np.cumsum(stream)
    if dev.type == "cuda":
        require(launches["dgap_decode"] == len(long_ids) + 1,
                f"dgap_decode launches on its path: {launches}")
    # the function, repeated and timed at the whole stream (also as an offset
    # view: the element-load route), the longest list and a 4,096-value list
    mism, err = diff_stats(dgap_decode(whole), dgap_decode_torch(whole))
    buf = torch.empty(whole.numel() + 1, dtype=torch.int32, device=dev)
    buf[1:] = whole
    repeats = [dgap_repeats(whole, {"n": whole.numel(), "view": "aligned"}),
               dgap_repeats(buf[1:], {"n": whole.numel(), "view": "offset"})]
    mism += sum(r["mismatches"] for r in repeats)
    err = max([err] + [r["max_abs_err"] for r in repeats])
    lib = lambda: torch.cumsum(whole, 0, dtype=torch.int32)  # noqa: E731
    lib_agrees = bool(torch.equal(_wrap_sub(lib(), 1), _wrap_sub(dec_whole, 0)))
    n = whole.numel()
    b_ms, b_by = bound(8 * n, n)
    row = {"kernel": "dgap_decode", "at": "dgap/positional-stream", "shape": {"n": n},
           "mismatches": mism, "max_abs_err": err, "repeats": repeats,
           "library": "torch.cumsum(x, 0, dtype=torch.int32)", "library_agrees": lib_agrees,
           "bound_ms": b_ms, "bound_by": b_by, "route": dgap_decode_route(whole)}
    if dev.type == "cuda":
        row.update(ms=time_ms(lambda: dgap_decode(whole), reps),
                   call_ms=time_ms(lambda: dgap_decode(whole), reps, preload=False),
                   plain_ms=time_ms(lambda: dgap_decode_torch(whole), reps),
                   library_ms=time_ms(lib, reps))
        row["ms_by_route"] = {"vec16": row["ms"],
                              "scalar": time_ms(lambda: dgap_decode(buf[1:]), reps)}
        by_len = sorted(long_ids, key=lambda i: lens[i])
        row["lists"] = []
        for i in (by_len[-1], by_len[0]):
            x = inputs[i]
            lb_ms, _ = bound(8 * x.numel(), x.numel())
            row["lists"].append({"n": x.numel(), "ms": time_ms(lambda: dgap_decode(x), reps),
                                 "bound_ms": lb_ms,
                                 "library_ms": time_ms(
                                     lambda: torch.cumsum(x, 0, dtype=torch.int32), reps)})
    return {"lists": len(lists), "positions": int(n), "longest_list": int(lens.max()),
            "long_lists_decoded_alone": len(long_ids),
            "lists_recovered_from_whole_stream": len(lists),
            "running_sum_max": int(running.max()), "wraps": bool(running.max() > INT32_MAX),
            "launches": launches, "launches_by_route": routes, "row": row}


def anchor_probe_edge_cases(dev, seed: int) -> list[dict]:
    """anchor_probe against its plain version at every (NQ, NA) edge shape:
    sorted anchors with runs of duplicates, the top ones equal to 2^31 - 1
    where NA > 2, queries below the first anchor, above the last, on
    anchors and between them."""
    from repro_torch.kernels.anchor_intersect.ops import anchor_probe, anchor_probe_torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)  # noqa: E731
    out = []
    for na in PROBE_NA:
        anchors = np.sort(rng.integers(-10**6, 10**6, na))
        if na > 8:
            anchors[na // 3: na // 3 + 5] = anchors[na // 3]  # a run of duplicates
        if na > 2:
            anchors[-2:] = INT32_MAX
        for nq in PROBE_NQ:
            q = rng.integers(-10**6 - 5, 10**6 + 5, nq)
            if na:
                q[1::3] = rng.choice(anchors, len(q[1::3]))  # hits
            q[::7] = -2**31  # below every anchor
            q[3::11] = INT32_MAX - 1  # above every anchor below 2^31 - 1
            args = (t(q), t(anchors))
            got, want = anchor_probe(*args), anchor_probe_torch(*args)
            mism, err = diff_stats(got, want)
            out.append({"kernel": "anchor_probe", "shape": {"NQ": nq, "NA": na},
                        "mismatches": mism, "max_abs_err": err,
                        "hits": int(want[1].sum().item())})
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


def anchor_probe_path(built: dict, dev, reps: int, n_query_lists: int = 4) -> dict:
    """The anchor probe entry point on real positions, with the launch
    counts set to 0 just before and read just after: the positional index's
    longest list as the anchors; as the queries, every position of the next
    few longest lists, and each of them less 1 (a phrase probe's shift: a
    hit is the anchors' term followed by the query's).  ``idx`` must equal
    ``np.searchsorted(..., side="right")`` and ``found`` ``np.isin``.  Then
    timed beside the plain version, the bound and ``torch.searchsorted`` with
    the ``found`` gather."""
    from repro_torch.kernels.anchor_intersect.ops import anchor_probe, anchor_probe_torch

    store = built["pidx"].store
    by_len = sorted(range(store.n_lists), key=lambda i: -store.list_length(i))
    anchors_np = store.get_list(by_len[0])
    positions = np.concatenate([store.get_list(i) for i in by_len[1:1 + n_query_lists]])
    queries_np = np.concatenate([positions, positions - 1])
    anchors = torch.from_numpy(anchors_np.astype(np.int32)).to(dev)
    queries = torch.from_numpy(queries_np.astype(np.int32)).to(dev)
    reset_launch_counts()
    idx, found = anchor_probe(queries, anchors)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = launch_counts()
    require(np.array_equal(idx.cpu().numpy(), np.searchsorted(anchors_np, queries_np,
                                                              side="right")),
            "anchor_probe idx differs from np.searchsorted(side='right')")
    require(np.array_equal(found.cpu().numpy().astype(bool), np.isin(queries_np, anchors_np)),
            "anchor_probe found differs from np.isin")
    if dev.type == "cuda":
        require(launches["anchor_probe"] == 1, f"anchor_probe launches on its path: {launches}")
    args = (queries, anchors)
    mism, err = diff_stats(anchor_probe(*args), anchor_probe_torch(*args))

    def lib():
        i = torch.searchsorted(anchors, queries, right=True)
        return i, (i > 0) & (anchors[(i - 1).clamp(min=0)] == queries)

    li, lf = lib()
    lib_agrees = bool(torch.equal(li.to(torch.int32), idx)
                      and torch.equal(lf.to(torch.int32), found))
    nq, na = queries.numel(), anchors.numel()
    steps = nq * int(np.ceil(np.log2(na + 1)))
    b_ms, b_by = bound(12 * nq + 4 * min(na, steps), steps + nq)
    row = {"kernel": "anchor_probe", "at": "anchor_probe/positional-lists",
           "shape": {"NQ": nq, "NA": na}, "mismatches": mism, "max_abs_err": err,
           "library": "torch.searchsorted(right=True) + the found gather",
           "library_agrees": lib_agrees, "bound_ms": b_ms, "bound_by": b_by}
    if dev.type == "cuda":
        row.update(ms=time_ms(lambda: anchor_probe(*args), reps),
                   call_ms=time_ms(lambda: anchor_probe(*args), reps, preload=False),
                   plain_ms=time_ms(lambda: anchor_probe_torch(*args), reps),
                   library_ms=time_ms(lib, reps))
    return {"anchors": na, "queries": nq, "query_lists": n_query_lists,
            "hits": int(found.sum().item()), "launches": launches, "row": row}


# ----------------------------------------------------------------------
# lm_serve phase: prefill + greedy decode of an LM, and the attention kernels
# ----------------------------------------------------------------------
#: edge shapes of the attention kernels: head dims, lengths (T == S for
#: flash_attention, cache rows S for flash_decode), query heads per KV head
ATTN_HEAD_DIMS = (16, 32, 64, 128)
ATTN_LENGTHS = (1, 7, 300, 513)
DECODE_LENGTHS = (1, 7, 300, 513, 2080)
ATTN_GROUPS = (1, 3, 4)
#: query heads per KV head of the flash_decode edge cases (up to MAX_GROUP)
DECODE_GROUPS = (1, 3, 4, 16)
#: a cache capacity far above the live lengths (most of the split pass's
#: chunks are empty) and the positions seen in it
SPARSE_CACHE = (32768, (0, 150, 299))
#: lengths (T == S) at which the tensor-core instance of flash_attention_tpu
#: is checked besides, at its head dims
WGMMA_LENGTHS = (100, 300, 2048)
WGMMA_HEAD_DIMS = (64, 128)


def _tolerance(kernel: str) -> dict:
    return {str(d).split(".")[-1]: {"rel": rel, "abs": floor}
            for d, (rel, floor) in ATTENTION_TOL[kernel].items()}


def _limit_share(kernel: str, got, want) -> tuple[float, float]:
    """The max abs difference and the largest share of its elementwise limit
    (``ATTENTION_TOL`` for ``want``'s dtype) any element takes."""
    rel, floor = ATTENTION_TOL[kernel][want.dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return float(diff.max()), float((diff / (rel * w.abs() + floor)).max())


def _attention_row(rows: list, kernel: str, shape: dict, got, want, route=None) -> None:
    """One comparison of an attention kernel with its plain version: the max
    abs difference, the largest share of its elementwise limit any element
    takes (``ATTENTION_TOL`` for the output's dtype), and whether every
    element is within it (shapes and dtypes equal, values finite); with the
    route the launch took, where the kernel has more than one."""
    ok = got.shape == want.shape and got.dtype == want.dtype
    err = used = 0.0
    if ok and want.numel():
        err, used = _limit_share(kernel, got, want)
        ok = bool(torch.isfinite(got.float()).all()) and used <= 1.0
    rows.append({"kernel": kernel, "shape": shape, "dtype": str(want.dtype).split(".")[-1],
                 **({"route": route} if route else {}),
                 "max_abs_err": err, "limit_used": used, "within_tolerance": ok})


def flash_row(rows: list, shape: dict, q, k, v, causal: bool = True,
              design: bool = False) -> None:
    """``flash_attention_tpu`` against its plain version (one row, with its
    route).  A launch on the tensor cores is also held against
    ``flash_attention_split_torch``, the plain copy of its own arithmetic
    (``limit_used_vs_split``).  With ``design``, that copy runs on float32
    widenings of the same inputs (so no final bf16 rounding, which a bf16
    comparison always has room for) and is held against the same arithmetic
    with P unsplit (``split_limit_used``: the error of splitting P alone)
    and against the plain version on them (``design_limit_used``: the split
    and the scores' own float32 order and scaling together); the split into
    two terms, against P unsplit, for comparison
    (``two_term_split_limit_used``)."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention_route,
                                                         flash_attention_split_torch,
                                                         flash_attention_torch,
                                                         flash_attention_tpu)

    route = flash_attention_route(q, k, v)
    got = flash_attention_tpu(q, k, v, causal)
    _attention_row(rows, "flash_attention_tpu", {**shape, "causal": causal}, got,
                   flash_attention_torch(q, k, v, causal), route)
    if route == "wgmma":
        rows[-1]["limit_used_vs_split"] = _limit_share(
            "flash_attention_tpu", got, flash_attention_split_torch(q, k, v, causal))[1]
        if design:
            wide = [x.float() for x in (q, k, v)]
            split = flash_attention_split_torch(*wide, causal)
            unsplit = flash_attention_split_torch(*wide, causal, terms=None)
            rows[-1]["split_limit_used"] = _limit_share("flash_attention_tpu", split, unsplit)[1]
            rows[-1]["two_term_split_limit_used"] = _limit_share(
                "flash_attention_tpu", flash_attention_split_torch(*wide, causal, terms=2),
                unsplit)[1]
            rows[-1]["design_limit_used"] = _limit_share(
                "flash_attention_tpu", split, flash_attention_torch(*wide, causal))[1]


def cancelling_attention(g, b: int, t: int, h: int, kh: int, hd: int, dev):
    """bf16 q, k, v whose keys come in near pairs (the second a 5 %
    perturbation of the first) and whose value rows come in opposite pairs
    of +-5: a pair's weights nearly agree, so each output nearly cancels to
    0 while sum(p |v|) / l is 5 (rounding p once to bf16 would break the
    limit there)."""
    randn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    q, k = randn(b, t, h, hd), randn(b, t, kh, hd)
    n = t // 2
    k[:, 1:2 * n:2] = k[:, 0:2 * n:2] + 0.05 * randn(b, n, kh, hd)
    sign = torch.where(randn(b, n, kh, hd) < 0, -5.0, 5.0)
    v = randn(b, t, kh, hd)
    v[:, 0:2 * n:2] = sign
    v[:, 1:2 * n:2] = -sign
    return tuple(x.to(torch.bfloat16) for x in (q, k, v))


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element past a 16-byte
    boundary (the view of a buffer one element longer)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def decode_row(rows: list, shape: dict, q, kc, vc, pos) -> None:
    """``flash_decode`` against its plain version (one row, with its load
    route), and against ``flash_decode_split_torch``, the plain copy of its
    split and combine arithmetic at the launch's own split count
    (``limit_used_vs_split``)."""
    from repro_torch.kernels.flash_decode.ops import (flash_decode, flash_decode_plan,
                                                      flash_decode_route,
                                                      flash_decode_split_torch,
                                                      flash_decode_torch)

    got = flash_decode(q, kc, vc, pos)
    _attention_row(rows, "flash_decode", shape, got, flash_decode_torch(q, kc, vc, pos),
                   flash_decode_route(kc, vc))
    sms = (torch.cuda.get_device_properties(q.device).multi_processor_count
           if q.device.type == "cuda" else 132)
    _, n_splits = flash_decode_plan(q.shape[0], kc.shape[2], kc.shape[1], sms)
    rows[-1].update(n_splits=n_splits, limit_used_vs_split=_limit_share(
        "flash_decode", got, flash_decode_split_torch(q, kc, vc, pos, n_splits))[1])


def attention_edge_cases(dev, seed: int) -> list[dict]:
    """Both attention kernels against their plain versions at edge shapes:
    float32 and bf16, every head dim the kernels are built for, lengths that
    are no multiple of a tile, causal and not, 1, 3 and 4 query heads per KV
    head; decode also at 16 (``DECODE_GROUPS``), at positions 0, S - 1, a
    random one and one past S, with a float32 q meeting a bf16 cache too,
    each cache read by 16-byte copies and, one element off a 16-byte
    boundary, by element loads; and a cache of ``SPARSE_CACHE`` rows whose
    positions leave most split chunks empty.  Besides: the prefill's own shape (T = S =
    ``LM_PROMPT``, 8 KV heads of 4 query heads, hd 128), the tensor-core
    instance at T = S in ``WGMMA_LENGTHS`` on normal and on cancelling value
    rows (:func:`cancelling_attention`), q read by strides (a head slice of
    a wider tensor), causal calls with T != S, and a layer's slice of a
    stacked cache read in place."""
    g = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda shape, dtype: torch.randn(  # noqa: E731
        shape, generator=g, device=dev, dtype=torch.float32).to(dtype)
    out: list = []
    kh = 2
    for dtype in (torch.float32, torch.bfloat16):
        for hd in ATTN_HEAD_DIMS:
            for t in ATTN_LENGTHS:
                for grp in ATTN_GROUPS:
                    b = 2 if t < 300 else 1
                    q = randn((b, t, kh * grp, hd), dtype)
                    k, v = randn((b, t, kh, hd), dtype), randn((b, t, kh, hd), dtype)
                    for causal in (True, False):
                        flash_row(out, {"B": b, "T": t, "H": kh * grp, "K": kh, "hd": hd},
                                  q, k, v, causal)
    for dtype in (torch.float32, torch.bfloat16):
        q = randn((1, LM_PROMPT, 32, 128), dtype)
        k, v = randn((1, LM_PROMPT, 8, 128), dtype), randn((1, LM_PROMPT, 8, 128), dtype)
        for causal in (True, False):
            flash_row(out, {"B": 1, "T": LM_PROMPT, "H": 32, "K": 8, "hd": 128}, q, k, v, causal)
        del q, k, v
    # the tensor-core instance at ragged and full tiles (T = S = 100, 300 are
    # no multiple of its 128 rows / keys), and on cancelling value rows
    for hd in WGMMA_HEAD_DIMS:
        for t in WGMMA_LENGTHS:
            b = 2 if t < 300 else 1
            q = randn((b, t, 8, hd), torch.bfloat16)
            k, v = randn((b, t, kh, hd), torch.bfloat16), randn((b, t, kh, hd), torch.bfloat16)
            for causal in (True, False):
                flash_row(out, {"B": b, "T": t, "H": 8, "K": kh, "hd": hd}, q, k, v, causal)
            q, k, v = cancelling_attention(g, b, t, 8, kh, hd, dev)
            for causal in (True, False):
                flash_row(out, {"B": b, "T": t, "H": 8, "K": kh, "hd": hd, "v": "cancelling"},
                          q, k, v, causal, design=True)
        del q, k, v
    for hd in WGMMA_HEAD_DIMS:
        wide = randn((2, 100, 12, hd), torch.bfloat16)
        q, k, v = wide[:, :, 2:10], randn((2, 100, 2, hd), torch.bfloat16), randn(
            (2, 100, 2, hd), torch.bfloat16)
        for causal in (True, False):
            flash_row(out, {"B": 2, "T": 100, "H": 8, "K": 2, "hd": hd, "q": "strided heads"},
                      q, k, v, causal)
    q, k, v = (randn((2, n, h, 32), torch.float32) for n, h in ((64, 4), (200, 2), (200, 2)))
    for causal in (True, False):
        flash_row(out, {"B": 2, "T": 64, "S": 200, "H": 4, "K": 2, "hd": 32}, q, k, v, causal)
    q, k, v = (randn((2, n, h, 64), torch.bfloat16) for n, h in ((64, 4), (200, 2), (200, 2)))
    for causal in (True, False):
        flash_row(out, {"B": 2, "T": 64, "S": 200, "H": 4, "K": 2, "hd": 64}, q, k, v, causal)
    for q_dtype, kv_dtype in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                              (torch.float32, torch.bfloat16)):
        for hd in ATTN_HEAD_DIMS:
            for s in DECODE_LENGTHS:
                for grp in DECODE_GROUPS:
                    q = randn((4, 1, kh * grp, hd), q_dtype)
                    kc, vc = randn((4, s, kh, hd), kv_dtype), randn((4, s, kh, hd), kv_dtype)
                    pos = torch.tensor([0, s - 1, int(torch.randint(0, s, (1,), generator=g,
                                                                    device=dev)), s + 5],
                                       dtype=torch.int32, device=dev)
                    shape = {"B": 4, "S": s, "H": kh * grp, "K": kh, "hd": hd,
                             "q": str(q_dtype).split(".")[-1],
                             "cache": str(kv_dtype).split(".")[-1], "positions": pos.tolist()}
                    decode_row(out, shape, q, kc, vc, pos)
                    # the same values one element off a 16-byte boundary: element loads
                    decode_row(out, {**shape, "cache": shape["cache"] + ", misaligned"}, q,
                               misaligned(kc), misaligned(vc), pos)
    s, live = SPARSE_CACHE
    for q_dtype, kv_dtype in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)):
        q = randn((3, 1, 32, 128), q_dtype)
        kc, vc = randn((3, s, 8, 128), kv_dtype), randn((3, s, 8, 128), kv_dtype)
        pos = torch.tensor(live, dtype=torch.int32, device=dev)
        shape = {"B": 3, "S": s, "H": 32, "K": 8, "hd": 128, "positions": list(live),
                 "cache": f"{str(kv_dtype).split('.')[-1]}, mostly empty chunks"}
        decode_row(out, shape, q, kc, vc, pos)
        decode_row(out, {**shape, "cache": shape["cache"] + ", misaligned"}, q, misaligned(kc),
                   misaligned(vc), pos)
        del kc, vc
    stacked = randn((2, 2, 3, 64, 2, 32), torch.bfloat16)
    q, pos = randn((3, 1, 8, 32), torch.float32), torch.tensor([63, 5, 40], dtype=torch.int32,
                                                              device=dev)
    kc, vc = stacked[1, 0], stacked[1, 1]
    decode_row(out, {"B": 3, "S": 64, "H": 8, "K": 2, "hd": 32,
                     "cache": "a layer's slice of a stacked cache"}, q, kc, vc, pos)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


@contextlib.contextmanager
def recorded_attention(keep: dict):
    """Put a recorder in front of the transformer's two attention kernel
    wrappers for the time of the block.  The calls whose index (per kernel,
    from 0) is in ``keep[name]`` have their arguments cloned into the yielded
    ``{name: {index: (args, kwargs)}}``; the launch counts stay on the
    wrappers themselves."""
    from repro_torch.models import transformer as tf

    seen = {name: {} for name in keep}
    calls = {name: 0 for name in keep}
    originals = {name: getattr(tf, name) for name in keep}

    def recorder(name):
        def rec(*a, **kw):
            if calls[name] in keep[name]:
                seen[name][calls[name]] = (
                    tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a), kw)
            calls[name] += 1
            return originals[name](*a, **kw)
        return rec

    for name in keep:
        setattr(tf, name, recorder(name))
    try:
        yield seen
    finally:
        for name in keep:
            setattr(tf, name, originals[name])


@contextlib.contextmanager
def reordered_plain_attention():
    """The model's plain attention with its float32 sums in another order, for
    the time of the block: prefill KV blocks of 512 keys (not
    ``min(1024, T)``), and decode through ``flash_decode_torch`` (one
    sentinel-masked softmax) in place of ``layers.decode_attention``."""
    from repro_torch.kernels.flash_decode.ops import flash_decode_torch
    from repro_torch.models import transformer as tf

    flash, decode = tf.flash_attention, tf.decode_attention
    tf.flash_attention = lambda q, k, v, causal, block_kv: flash(q, k, v, causal, 512)
    tf.decode_attention = flash_decode_torch
    try:
        yield
    finally:
        tf.flash_attention, tf.decode_attention = flash, decode


def bf16_step(x: float) -> float:
    """The spacing of bf16 numbers at magnitude ``|x|`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


#: kernels whose device time per decode step is reported by name (the
#: decode attention in all, and its two passes)
DECODE_NAMED = ("flash_decode", "flash_decode_split", "flash_decode_combine")


def decode_host_and_device(decode, params, tokens: list, step_pos, cache,
                           traced: int = 3, named: tuple = DECODE_NAMED) -> dict:
    """Where a decode step's time goes, on a card: the steps of the run
    again (same tokens at the same positions, so the cache keeps its
    values), as they are and with the host waiting for the card before each
    step (what a host-side position check costs), in the order A B B A; then
    ``traced`` steps under ``torch.profiler`` (device activity only): kernel
    time and kernels per step, and the device time of the kernels whose name
    holds one of ``named``.  One step runs under torch's sync debug mode
    first: it must make the host wait for the card no time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(n: int, wait: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            pos = step_pos(i)
            if wait:
                bool((pos < 0).any())
            decode(params, tokens[i][:, None].to(torch.int32), pos, cache)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            decode(params, tokens[0][:, None].to(torch.int32), step_pos(0), cache)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    waits = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    require(not waits, f"a decode step waits for the card {len(waits)} times: {waits[:2]}")
    n = len(tokens) - 1
    order = [("no_wait", False), ("wait", True), ("wait", True), ("no_wait", False)]
    ab = [(name, run(n, wait)) for name, wait in order]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(traced, False)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / traced / 1e3
    require(busy > 0, "torch.profiler saw no device time in the decode steps")
    step_ms = statistics.median(ms for name, ms in ab if name == "no_wait")
    return {"ms_per_step_abba": ab, "device_busy_ms_per_step": busy,
            **{f"{name}_ms_per_step": sum(e.self_device_time_total for e in kernels
                                          if name in e.key) / traced / 1e3
               for name in named},
            "device_ops_per_step": sum(e.count for e in kernels) / traced,
            "device_idle_share": 1 - busy / step_ms, "host_waits_per_step": len(waits),
            "what": f"the run's {n} steps again, without and with a host wait per "
                    f"step (A B B A); device time from torch.profiler over {traced} "
                    f"steps against the median step without waits"}


@contextlib.contextmanager
def routed(record: list | None = None, forced: list | None = None):
    """Put a wrapper in front of the MoE router (``layers.moe_router``) for
    the time of the block.  With ``record``, each call's (token, slot)
    expert choices are appended to it.  With ``forced`` (a recorded run's
    choices), call i routes by ``forced[i]`` — the gates its own
    probabilities at those experts, renormalised — and yields, per call,
    how many of the (token, slot) choices its own router made otherwise."""
    from repro_torch.models import layers

    original = layers.moe_router
    differ: list = []

    def router(x, router_w, top_k):
        probs, gates, experts = original(x, router_w, top_k)
        if record is not None:
            record.append(experts)
        if forced is not None:
            want = forced[len(differ)]
            same = (experts[:, :, None] == want[:, None, :]).any(dim=-1).sum()
            differ.append(want.numel() - same)
            gates = torch.gather(probs, 1, want)
            gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
            experts = want
        return probs, gates, experts

    layers.moe_router = router
    try:
        yield differ
    finally:
        layers.moe_router = original


def lm_serve_path(args, dev, name: str = LM_CONFIG, n_layers: int | None = None,
                  control: bool = True) -> tuple[dict, dict]:
    """The LM serving path at full width: ``name`` (depth cut to
    ``n_layers`` when given) with random bf16 weights drawn on ``dev``
    from ``args.seed``, ``LM_BATCH`` prompts of ``LM_PROMPT`` tokens from
    ``lm_batches`` prefilled through ``make_lm_prefill_step``, the cache
    padded by ``LM_NEW`` rows, then ``LM_NEW`` greedy steps through
    ``make_lm_decode_step`` — the kernels on a card, with the
    launch counts set to 0 just before and read just after.  Then the same
    model through the plain path (``attention="torch"``), teacher-forced on
    the kernel run's tokens — and, in a MoE model, on its expert choices
    (:func:`routed`; the choices the plain router would have made otherwise
    are counted): its prefill and step logits must be within
    ``LM_LOGIT_TOL`` of the kernel run's, and its greedy tokens equal but at
    ties (within one bf16 step, :func:`bf16_step`).  With ``control``, the
    plain path once more with its float32 sums reordered, against itself.
    Returns the phase's line and what the path handed each kernel (the first
    prefill call, and the first call of the last decode step; of
    ``moe_gemm`` also the third of each, layer 0's ``w_down`` product)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipelines import lm_batches
    from repro_torch.models import steps
    from repro_torch.models.layers import MoEDims, moe_dispatch

    on_gpu = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    cfg = get_config(name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    b, t, new, n_layers = LM_BATCH, LM_PROMPT, LM_NEW, cfg.n_layers
    if on_gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = steps.init_model_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                                     dev)
    sync()
    t1 = time.perf_counter()
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    prompts = next(lm_batches(cfg, b, t, seed=args.seed))["tokens"]
    tokens = torch.from_numpy(prompts).to(dev)
    t2 = time.perf_counter()
    prefill, decode = steps.make_lm_prefill_step(cfg), steps.make_lm_decode_step(cfg)
    plain_prefill = steps.make_lm_prefill_step(cfg, attention="torch")
    plain_decode = steps.make_lm_decode_step(cfg, attention="torch")
    pad = lambda c: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, new))  # noqa: E731
    step_pos = lambda i: torch.full((b,), t + i, dtype=torch.int32, device=dev)  # noqa: E731

    # warm-up of both paths on a short prompt (library handles, allocator)
    for pf, dc in ((prefill, decode), (plain_prefill, plain_decode)):
        lg, c = pf(params, tokens[:1, :16])
        dc(params, lg.argmax(-1)[:, None].to(torch.int32),
           torch.full((1,), 16, dtype=torch.int32, device=dev), torch.nn.functional.pad(
               c, (0, 0, 0, 0, 0, 1)))
    del lg, c
    sync()

    keep = {"flash_attention_tpu": {0}, "flash_decode": {(new - 1) * n_layers}}
    if cfg.moe:
        keep["moe_gemm"] = {0, 2, 3 * n_layers * new, 3 * n_layers * new + 2}
    choices: list = []
    reset_launch_counts()
    with recorded_attention(keep) as seen, \
            routed(record=choices) if cfg.moe else contextlib.nullcontext():
        t3 = time.perf_counter()
        logits, cache = prefill(params, tokens)
        sync()
        t4 = time.perf_counter()
        prefill_routes = route_counts()
        cache = pad(cache)
        sync()
        t5 = time.perf_counter()
        tok = logits.argmax(-1)
        out_tokens, out_logits = [tok], [logits]
        for i in range(new):
            logits, cache = decode(params, tok[:, None].to(torch.int32), step_pos(i), cache)
            tok = logits.argmax(-1)
            out_tokens.append(tok)
            out_logits.append(logits)
        sync()
        t6 = time.perf_counter()
    launches = launch_counts()
    routes = {"prefill": prefill_routes, "decode": route_diff(route_counts(), prefill_routes)}
    peak = torch.cuda.max_memory_allocated() if on_gpu else None
    cache_shape, cache_bytes = list(cache.shape), cache.numel() * cache.element_size()
    split = (decode_host_and_device(decode, params, out_tokens, step_pos, cache,
                                    named=DECODE_NAMED + (("moe_gemm",) if cfg.moe else ()))
             if on_gpu else None)
    del cache

    # the plain path, teacher-forced on the kernel run's tokens; then, as a
    # control, the plain path again with its float32 sums taken in another
    # order (prefill KV blocks of 512 keys, the kernel's plain decode)
    def teacher_forced() -> list:
        p_logits, p_cache = plain_prefill(params, tokens)
        logits_by_step = [p_logits]
        p_cache = pad(p_cache)
        for i in range(new):
            p_logits, p_cache = plain_decode(params, out_tokens[i][:, None].to(torch.int32),
                                             step_pos(i), p_cache)
            logits_by_step.append(p_logits)
        sync()
        return logits_by_step

    moe = None
    if cfg.moe:
        # tokens the kernel run dropped at capacity, and the plain router's own
        # choices against the kernel run's, in prefill and per decode step
        dims = MoEDims(cfg.moe.n_experts, cfg.moe.top_k)
        dropped = torch.stack([(~moe_dispatch(c, dims, cfg.moe_groups)["keep"]).sum()
                               for c in choices]).tolist()
        moe = {"experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
               "capacity_factor": dims.capacity_factor,
               "capacity": {"prefill": moe_dispatch(choices[0], dims, cfg.moe_groups)["cap"],
                            "decode": moe_dispatch(choices[-1], dims, cfg.moe_groups)["cap"]},
               "router_calls": len(choices),
               "dropped_prefill": sum(dropped[:n_layers]),
               "choices_prefill": choices[0].numel() * n_layers,
               "dropped_per_decode_step": [sum(dropped[n_layers * (i + 1):n_layers * (i + 2)])
                                           for i in range(new)],
               "choices_per_decode_step": choices[-1].numel() * n_layers}

    if on_gpu:
        torch.cuda.empty_cache()
    before_plain = launch_counts()
    t7 = time.perf_counter()
    with routed(forced=choices) if cfg.moe else contextlib.nullcontext() as router_differ:
        plain = teacher_forced()
    t8 = time.perf_counter()
    plain_launches = {k: n - before_plain[k] for k, n in launch_counts().items()}
    if cfg.moe:
        router_differ = torch.stack(router_differ).tolist()
        moe.update(
            plain_router_differs_prefill=sum(router_differ[:n_layers]),
            plain_router_differs_decode=sum(router_differ[n_layers:]),
            plain_router_differ_share=sum(router_differ) / (
                moe["choices_prefill"] + new * moe["choices_per_decode_step"]),
            what="(token, slot) expert choices: dropped at capacity on the kernel run; "
                 "chosen otherwise by the plain path's own router, which then routes "
                 "by the kernel run's choices")
        del choices
    control_line = None
    if control:
        with reordered_plain_attention():
            ctrl = teacher_forced()
        control_line = {
            "what": "the plain path with prefill KV blocks of 512 keys and the kernel's plain "
                    "decode, against the plain path",
            "logits_max_abs_err": max(float((a.float() - w.float()).abs().max())
                                      for a, w in zip(ctrl, plain)),
            "greedy_tokens_differ": sum(int(w[r].float().argmax()) != int(c[r].float().argmax())
                                        for c, w in zip(ctrl, plain) for r in range(b))}
        del ctrl
    errs = [float((a.float() - w.float()).abs().max()) for a, w in zip(out_logits, plain)]
    scale = max(float(w.float().abs().max()) for w in plain)
    # (step, row, how far the plain logit of the kernel's token lies below the
    # plain maximum, one bf16 step at that maximum)
    top2 = [w.float().topk(2, dim=-1).values for w in plain]
    differ = [(i, r, float(top2[i][r, 0] - w[r].float()[out_tokens[i][r]]),
               bf16_step(float(top2[i][r, 0])))
              for i, w in enumerate(plain)
              for r in range(b) if int(w[r].float().argmax()) != int(out_tokens[i][r])]
    # tokens where the exemption could apply: plain best two within one step
    near_ties = sum(float(x[r, 0] - x[r, 1]) <= bf16_step(float(x[r, 0]))
                    for x in top2 for r in range(b))
    finite = all(bool(torch.isfinite(x.float()).all()) for x in out_logits + plain)
    del params
    if on_gpu:
        torch.cuda.empty_cache()

    require(finite, "non-finite logits on the LM serving path")
    require(all(tuple(x.shape) == (b, cfg.vocab_size) for x in out_logits + plain),
            "logits of the wrong shape on the LM serving path")
    if on_gpu:
        want = {k: 0 for k in launches}
        want.update(flash_attention_tpu=n_layers, flash_decode=n_layers * new)
        if cfg.moe:
            want.update(moe_gemm=3 * n_layers * (new + 1))
        require(launches == want, f"kernel launches on the {cfg.name} serving path: "
                f"{launches}, expected {want}")
        # every prefill launch of the two routed kernels on the tensor cores;
        # every MoE decode product on the small_c weight stream; every decode
        # attention reading the cache by 16-byte copies
        want_routes = {phase: {name: {} for name in ROUTED_KERNELS}
                       for phase in ("prefill", "decode")}
        want_routes["prefill"].update(flash_attention_tpu={"wgmma": n_layers},
                                      moe_gemm={"wgmma": 3 * n_layers} if cfg.moe else {})
        want_routes["decode"].update(flash_decode={"vec16": n_layers * new},
                                     moe_gemm={"small_c": 3 * n_layers * new} if cfg.moe else {})
        got_routes = {phase: {name: {r: n for r, n in by.items() if n}
                              for name, by in counts.items()}
                      for phase, counts in routes.items()}
        require(got_routes == want_routes, f"launches by route on the {cfg.name} serving path: "
                f"{got_routes}, expected {want_routes}")
        require(not any(plain_launches.values()), "the plain path launched a kernel")
    line = {
        "config": {k: getattr(cfg, k) for k in (
            "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
            "vocab_size", "qk_norm", "rope_theta", "dtype")},
        "full_depth": get_config(name).n_layers,
        "params": n_params, "weight_bytes": weight_bytes,
        "batch": b, "prompt_tokens": t, "new_tokens": new,
        "cache_shape": cache_shape, "cache_bytes": cache_bytes,
        "init_s": t1 - t0, "prompts_s": t2 - t1,
        "prefill_s": t4 - t3, "prefill_tokens_per_s": b * t / (t4 - t3),
        "pad_cache_s": t5 - t4,
        "decode_s": t6 - t5, "decode_ms_per_step": (t6 - t5) / new * 1e3,
        "decode_tokens_per_s": b * new / (t6 - t5), "decode_step_split": split,
        "max_memory_allocated": peak, "launches": launches, "launches_by_route": routes,
        "plain_path": {"prefill_and_decode_s": t8 - t7, "launches": plain_launches},
        "control": control_line, "moe": moe,
        "logits_max_abs_err": max(errs), "logits_max_abs_err_by_step": errs,
        "logits_max_abs": scale, "logits_tolerance": LM_LOGIT_TOL,
        "greedy_tokens": b * (new + 1), "tokens_equal": b * (new + 1) - len(differ),
        "tokens_differ_at": differ, "near_ties": near_ties,
        "near_tie_share": near_ties / (b * (new + 1)),
        "first_tokens": [x.tolist() for x in out_tokens[:3]],
    }
    require(max(errs) <= LM_LOGIT_TOL,
            f"kernel and plain logits differ by {max(errs)} > {LM_LOGIT_TOL}")
    # Both paths round bf16 logits (0.031 apart at 4 <= |x| < 8) from float32
    # sums taken in another order, so where the plain path's best two logits
    # tie, the kernel path may take the other one.  A greedy token may differ
    # only there: its plain logit at most one bf16 step below the plain maximum.
    far = [d for d in differ if d[2] > d[3]]
    require(not far, f"{len(far)} greedy tokens differ between the kernel and the plain "
            f"path away from a near-tie (step, row, plain gap, bound): {far[:5]}")
    return line, seen


def attention_at_path_f32(seen: dict) -> list[dict]:
    """Both attention kernels against their plain versions at the inputs the
    lm_serve path handed them, widened to float32 (the bf16 path's own limit
    is one bf16 rounding; float32 outputs hold the kernels to their float32
    sums): the prefill call, the decode call, and the decode call with a
    float32 q meeting the path's bf16 cache."""
    rows: list = []
    (args, kw), = seen["flash_attention_tpu"].values()
    q, k, v = (x.float() for x in args)
    b, t, h, hd = q.shape
    flash_row(rows, {"B": b, "T": t, "H": h, "K": k.shape[2], "hd": hd,
                     "at": "lm_serve/prefill, layer 0, widened to float32"},
              q, k, v, kw.get("causal", True))
    del q, k, v
    (args, kw), = seen["flash_decode"].values()
    q, kc, vc, pos = args
    q = q.float()
    for cache in ("float32", "bfloat16"):
        if cache == "float32":
            kc, vc = kc.float(), vc.float()
        else:
            kc, vc = args[1], args[2]
        decode_row(rows, {"B": q.shape[0], "S": kc.shape[1], "H": q.shape[2], "K": kc.shape[2],
                          "hd": q.shape[3], "q": "float32", "cache": cache,
                          "at": "lm_serve/last decode step, layer 0, q widened to float32"},
                   q, kc, vc, pos)
    return rows


@torch.no_grad()
def attention_at_moe_path(seen: dict, reps: int, on_gpu: bool) -> list[dict]:
    """Both attention kernels against their plain versions at the inputs the
    moe_serve path handed them (16 query heads on 16 KV heads, bf16), each
    timed on a card as :func:`attention_at_path` times qwen3-8b's."""
    (args, kw), = seen["flash_attention_tpu"].values()
    rows = [flash_attention_timed(args, kw, "moe_serve/prefill, layer 0", reps, on_gpu)]
    (args, _), = seen["flash_decode"].values()
    rows.append(flash_decode_timed(args, "moe_serve/last decode step, layer 0", reps, on_gpu))
    return rows


def flash_attention_timed(args: tuple, kw: dict, at: str, reps: int, on_gpu: bool) -> dict:
    """``flash_attention_tpu`` at a prefill call of a path: against its plain
    version (:func:`flash_row`), the bound for its inputs, and on a card
    timed beside its plain version and ``scaled_dot_product_attention``
    (causal, GQA), which the port never calls."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_torch, flash_attention_tpu

    sdpa = torch.nn.functional.scaled_dot_product_attention
    size = lambda x: x.numel() * x.element_size()  # noqa: E731
    q, k, v = args
    causal = kw.get("causal", True)
    b, t, h, hd = q.shape
    s = k.shape[1]
    keys = (sum(min(i + 1, s) for i in range(t)) if causal else t * s) * b * h
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_OPS_PER_S
    got = flash_attention_tpu(q, k, v, causal)
    b_ms, b_by = bound(size(q) + size(k) + size(v) + size(got), 4 * keys * hd, peak)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)  # noqa: E731
    fa: list = []
    flash_row(fa, {"B": b, "T": t, "H": h, "K": k.shape[2], "hd": hd}, q, k, v, causal)
    row = {**fa[0], "at": at, "flops": 4 * keys * hd, "bound_ms": b_ms, "bound_by": b_by,
           "library": "torch.nn.functional.scaled_dot_product_attention(is_causal, "
                      "enable_gqa)",
           "library_max_abs_err": float((lib().transpose(1, 2).float() - got.float())
                                        .abs().max())}
    if fa[0].get("route") == "wgmma":
        # the tensor cores do Q K^T once and P V once per bf16 term of P
        from repro_torch.kernels.flash_attention.ops import P_TERMS

        row["design_ceiling_ms"] = b_ms * (1 + P_TERMS) / 2
    if on_gpu:
        row.update(ms=time_ms(lambda: flash_attention_tpu(q, k, v, causal), reps),
                   call_ms=time_ms(lambda: flash_attention_tpu(q, k, v, causal), reps,
                                   preload=False),
                   plain_ms=time_ms(lambda: flash_attention_torch(q, k, v, causal), reps),
                   library_ms=time_ms(lib, reps))
    return row


def flash_decode_timed(args: tuple, at: str, reps: int, on_gpu: bool) -> dict:
    """``flash_decode`` at a decode call of a path: against its plain version
    and its split copy (:func:`decode_row`), the bound for its inputs (the
    live cache rows of k and v, q and the output, once each), and on a card
    timed beside its plain version and ``scaled_dot_product_attention`` with
    the length mask (GQA), which the port never calls."""
    from repro_torch.kernels.flash_decode.ops import (KERNELS_PER_CALL, flash_decode,
                                                      flash_decode_torch)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    size = lambda x: x.numel() * x.element_size()  # noqa: E731
    q, kc, vc, pos = args
    b, _, h, hd = q.shape
    s, kh = kc.shape[1], kc.shape[2]
    got = flash_decode(q, kc, vc, pos)
    live = int((pos.long() + 1).clamp(0, s).sum())
    b_ms, b_by = bound(2 * live * kh * hd * kc.element_size() + size(q) + size(got),
                       4 * live * h * hd)
    qt, kt, vt = q.transpose(1, 2).contiguous(), kc.transpose(1, 2).contiguous(), \
        vc.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=q.device)[None, :] <= pos.long()[:, None])[:, None, None, :]
    lib = lambda: sdpa(qt.to(kt.dtype), kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    fd: list = []
    decode_row(fd, {"B": b, "S": s, "H": h, "K": kh, "hd": hd, "positions": pos.tolist()},
               q, kc, vc, pos)
    row = {**fd[0], "at": at, "cache_rows_read": live, "kernels_per_call": KERNELS_PER_CALL,
           "bound_ms": b_ms, "bound_by": b_by,
           "library": "torch.nn.functional.scaled_dot_product_attention(attn_mask=length "
                      "mask, enable_gqa)",
           "library_max_abs_err": float((lib().transpose(1, 2).float() - got.float())
                                        .abs().max())}
    if on_gpu:
        row.update(ms=time_ms(lambda: flash_decode(q, kc, vc, pos), reps),
                   call_ms=time_ms(lambda: flash_decode(q, kc, vc, pos), reps, preload=False),
                   plain_ms=time_ms(lambda: flash_decode_torch(q, kc, vc, pos), reps),
                   library_ms=time_ms(lib, reps))
    return row


def attention_at_path(seen: dict, reps: int, on_gpu: bool) -> list[dict]:
    """Each attention kernel at the inputs the lm_serve path handed it (the
    first prefill layer; the first layer of the last decode step) against its
    plain version; on a card timed beside the plain version, the bound and
    ``scaled_dot_product_attention`` (causal, or with the length mask),
    which the port never calls."""
    (args, kw), = seen["flash_attention_tpu"].values()
    rows = [flash_attention_timed(args, kw, "lm_serve/prefill, layer 0", reps, on_gpu)]
    (args, _), = seen["flash_decode"].values()
    rows.append(flash_decode_timed(args, "lm_serve/last decode step, layer 0", reps, on_gpu))
    return rows


# ----------------------------------------------------------------------
# model-side kernels: embedding_bag, cin_layer, moe_gemm
# ----------------------------------------------------------------------
def gamma(n: int) -> float:
    """The textbook bound n u / (1 - n u) on the relative error of a float32
    sum of n terms in any order (u = 2^-24), over the sum of |terms|."""
    u = 2.0 ** -24
    return n * u / (1 - n * u)


def _model_row(rows: list, kernel: str, shape: dict, got, want, limit=None) -> None:
    """One comparison of a model-side kernel with its plain version: NaN at
    the same places, every other element equal (``limit`` None) or within
    the elementwise ``limit``; records the max abs difference and the
    largest share of its limit an element takes."""
    ok = got.shape == want.shape and got.dtype == want.dtype
    err = used = 0.0
    if ok and want.numel():
        g, w = got.float(), want.float()
        nan = torch.isnan(w)
        ok = bool(torch.equal(torch.isnan(g), nan))
        diff = torch.where(nan, 0.0, (g - w).abs())
        err = float(diff.max())
        if limit is None:
            ok = ok and err == 0.0
        else:
            used = float((diff / limit.clamp(min=1e-38)).max())
            ok = ok and used <= 1.0
        del g, w, diff
    rows.append({"kernel": kernel, "shape": shape, "max_abs_err": err, "limit_used": used,
                 "within_tolerance": ok})


def embedding_bag_check(rows: list, shape: dict, idx, table, bag: int) -> None:
    """embedding_bag against its plain version (tolerance 0, NaN pattern
    equal), the row carrying the load route the launch took."""
    from repro_torch.kernels.embedding_bag.ops import (embedding_bag, embedding_bag_route,
                                                       embedding_bag_torch)

    _model_row(rows, "embedding_bag", shape, embedding_bag(idx, table, bag),
               embedding_bag_torch(idx, table, bag))
    rows[-1]["route"] = embedding_bag_route(table)


def cin_check(rows: list, shape: dict, x0, xk, w) -> None:
    from repro_torch.kernels.cin_interaction.ops import cin_layer, cin_layer_torch

    n = x0.shape[1] * xk.shape[1] + 2
    limit = 2 * gamma(n) * cin_layer_torch(x0.abs(), xk.abs(), w.abs())
    _model_row(rows, "cin_layer", shape, cin_layer(x0, xk, w), cin_layer_torch(x0, xk, w), limit)


def moe_gemm_check(rows: list, shape: dict, buf, w) -> None:
    """moe_gemm against its plain version within 2 gamma_(D+1) of the sum of
    |terms|, the row carrying the route the launch took.  The tensor cores
    add with truncation (relative error up to 2^-23 an add, not 2^-24): to
    first order a sum of D products is then within D 2^-23 of the sum of
    their magnitudes, which 2 gamma_(D+1) covers."""
    from repro_torch.kernels.moe_gemm.ops import moe_gemm, moe_gemm_route, moe_gemm_torch

    limit = 2 * gamma(buf.shape[2] + 1) * moe_gemm_torch(buf.abs(), w.abs())
    _model_row(rows, "moe_gemm", shape, moe_gemm(buf, w), moe_gemm_torch(buf, w), limit)
    rows[-1]["route"] = moe_gemm_route(buf, w)


def cancelling_moe(g, e: int, c: int, d: int, f: int, dev):
    """bf16 buf and w whose products cancel in pairs: buf's d-columns come in
    equal pairs and w's rows in near-opposite pairs (the second the negated
    first plus a 2 % perturbation), so each output is small beside the sum
    of its terms' magnitudes."""
    randn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    buf, w = randn(e, c, d), randn(e, d, f)
    n = d // 2
    buf[:, :, 1:2 * n:2] = buf[:, :, 0:2 * n:2]
    w[:, 1:2 * n:2] = -w[:, 0:2 * n:2] + 0.02 * randn(e, n, f)
    return buf.to(torch.bfloat16), w.to(torch.bfloat16)


#: embedding_bag's edge widths (the paths' 1, 10, 50, 256; 2 and 3 at the
#: 8-byte and element routes' edges; 128 and 130) and bag lengths (the
#: paths' 1 and 39; 0; 3; 8 and 9 at the staging pass's edge)
EB_DIMS = (1, 2, 3, 10, 50, 128, 130, 256)
EB_BAGS = (0, 1, 3, 8, 9, 39)
CIN_SHAPES = ((1, 1, 1, 1, 1), (3, 4, 6, 7, 1), (2, 5, 8, 41, 130), (300, 3, 7, 5, 10),
              (17, 39, 39, 200, 10), (9, 39, 200, 200, 10), (0, 3, 4, 5, 10), (4, 2, 3, 0, 10))
#: (B, m, Hk, H, D) at the edges of the kernel's tiles (200 rows of H, 64
#: columns of N = B D, K = m Hk in steps of 16): H 201 and 250 (a ragged row
#: tile), 400 (two whole ones) and 203 (no multiple of 4: 4-byte W copies); N
#: 65, 30 and 1; K 15, 6 and 1 (below a step) and 63 (no multiple of one)
CIN_TILE_EDGES = ((5, 3, 5, 201, 13), (1, 2, 3, 7, 1), (3, 7, 9, 250, 10), (4, 5, 20, 203, 10),
                  (7, 39, 200, 400, 10), (2, 1, 1, 3, 33))
MOE_SHAPES = ((1, 1, 1, 1), (3, 1, 2048, 1408), (2, 4, 33, 257), (4, 5, 64, 200),
              (2, 130, 70, 129), (3, 4, 0, 5), (2, 64, 16, 300))
#: bf16 shapes that reach the wgmma and small_c routes at their edges: ragged
#: 128-row / 128-column tiles, the moonshot prefill product with E cut to 3
#: (w_gate and w_down), decode at full E, C 5 and 8 (small_c) and 9 (wgmma)
MOE_ROUTE_SHAPES = ((2, 130, 64, 136), (3, 960, 2048, 1408), (3, 960, 1408, 2048),
                    (64, 1, 2048, 1408), (3, 5, 2048, 1408), (3, 8, 2048, 1408),
                    (3, 9, 64, 1408), (2, 1, 8, 8))


@torch.no_grad()
def model_kernel_edge_cases(dev, seed: int) -> list[dict]:
    """The three model-side kernels against their plain versions at edge
    shapes: embedding_bag at ``EB_DIMS`` x ``EB_BAGS``, 0, 1 and 1,000 bags,
    float32 and bf16 tables in place, one element in and at row strides of
    D + 1, 2 and 4 (every load route of both dtypes), rows out of range (NaN
    bags) on every layout, 2-D and int64 indices, rows read by stride
    (``linear[:, None]``) and bags of 0;
    cin_layer at one element, D 1, ragged H / N tiles, the path's (m, Hk, H)
    at small batches, empty outputs, the tiles' edges (``CIN_TILE_EDGES``)
    and a misaligned w; moe_gemm at one element, C 1 with
    F 1,408 (decode), ragged tiles, D 0, every dtype pair, an expert whose
    rows are all zero, and the wgmma and small_c routes at
    ``MOE_ROUTE_SHAPES`` on normal and on cancelling products."""
    g = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *shape, dtype=torch.float32: torch.randn(  # noqa: E731
        shape, generator=g, device=dev).to(dtype)
    randint = lambda lo, hi, *shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=g, device=dev, dtype=torch.int32)
    rows: list = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for d in EB_DIMS:
            # in place, one element in (misaligned: the element route), and
            # rows 1, 2 and 4 elements further apart than D (row strides that
            # break the vector routes or keep the 8-byte one)
            tables = {"contiguous": randn(1000, d, dtype=dtype),
                      "one element in": randn(1000 * d + 1, dtype=dtype)[1:].view(1000, d)}
            tables.update({f"row stride D + {k}": randn(1000, d + k, dtype=dtype)[:, :d]
                           for k in (1, 2, 4)})
            for layout, table in tables.items():
                for bag in EB_BAGS if layout == "contiguous" else (1, 39):
                    for n_bags in (0, 1, 1000) if layout == "contiguous" else (1000,):
                        shape = {"V": 1000, "D": d, "bag": bag, "n_bags": n_bags,
                                 "dtype": name, "table": layout}
                        # bags of 0 only exist as (n_bags, 0) indices
                        embedding_bag_check(rows, shape, randint(0, 1000, n_bags, bag),
                                            table, bag)
                # rows outside [0, V): their bags NaN on every route
                embedding_bag_check(rows, {"V": 1000, "D": d, "bag": 3, "n_bags": 300,
                                           "dtype": name, "table": layout,
                                           "indices": "some outside [0, 1000)"},
                                    randint(-5, 1005, 900), table, 3)
    for dtype in (torch.float32, torch.bfloat16):
        seen = {r["route"] for r in rows if r["kernel"] == "embedding_bag"
                and r["shape"].get("dtype") == str(dtype).split(".")[-1]}
        require(seen == {"scalar", "vec8", "vec16"},
                f"embedding_bag edge cases reach the routes {seen} in {dtype}")
    table = randn(50, 10)
    idx = randint(-3, 53, 40, 4)
    embedding_bag_check(rows, {"indices": "(40, 4), some outside [0, 50)"}, idx, table, 1)
    embedding_bag_check(rows, {"indices": "int64"}, idx.long().clamp(0, 49).reshape(-1),
                        table, 4)
    embedding_bag_check(rows, {"table": "linear[:, None] of 300", "bag": 39},
                        randint(0, 300, 64 * 39), randn(300)[:, None], 39)
    embedding_bag_check(rows, {"indices": "(5, 0)"},
                        torch.zeros((5, 0), dtype=torch.int32, device=dev), table, 1)
    for b, m, hk, h, d in CIN_SHAPES + CIN_TILE_EDGES:
        cin_check(rows, {"B": b, "m": m, "Hk": hk, "H": h, "D": d},
                  randn(b, m, d), randn(b, hk, d), randn(m * hk, h))
    w = randn(39 * 39 * 200 + 1)[1:].view(39 * 39, 200)
    cin_check(rows, {"B": 9, "m": 39, "Hk": 39, "H": 200, "D": 10,
                     "w": "one element off a 16-byte boundary: 4-byte copies"},
              randn(9, 39, 10), randn(9, 39, 10), w)
    cin_check(rows, {"B": 6, "m": 5, "Hk": 7, "H": 9, "D": 10, "dtype": "bfloat16 inputs"},
              randn(6, 5, 10, dtype=torch.bfloat16), randn(6, 7, 10, dtype=torch.bfloat16),
              randn(35, 9))
    for e, c, d, f in MOE_SHAPES:
        for bt, wt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                       (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
            moe_gemm_check(rows, {"E": e, "C": c, "D": d, "F": f,
                                  "dtypes": f"{str(bt).split('.')[-1]} x {str(wt).split('.')[-1]}"},
                           randn(e, c, d, dtype=bt), randn(e, d, f, dtype=wt))
    buf = randn(3, 17, 64, dtype=torch.bfloat16)
    buf[1] = 0
    moe_gemm_check(rows, {"E": 3, "C": 17, "D": 64, "F": 96, "empty expert": 1}, buf,
                   randn(3, 64, 96, dtype=torch.bfloat16))
    for e, c, d, f in MOE_ROUTE_SHAPES:
        shape = {"E": e, "C": c, "D": d, "F": f, "dtypes": "bfloat16 x bfloat16"}
        moe_gemm_check(rows, shape, randn(e, c, d, dtype=torch.bfloat16),
                       randn(e, d, f, dtype=torch.bfloat16))
        moe_gemm_check(rows, {**shape, "products": "cancelling in pairs"},
                       *cancelling_moe(g, e, c, d, f, dev))
    return rows


def embedding_bag_bound(idx, table, bag: int):
    """4 B per index, one table row per index and 4 B per output element
    (the rows an index names, once each); one add per element read."""
    n, d = idx.numel(), table.shape[1]
    return bound(4 * n + n * d * table.element_size() + 4 * (n // max(bag, 1)) * d, n * d)


def embedding_bag_ceiling(idx, table, bag: int) -> float:
    """The design's own ceiling (ms): the bound's bytes, but each lookup's
    row counted as the 32-byte sectors it spans (what a gather moves from
    device memory when the row is not in L2; a row outside [0, V) moves
    nothing)."""
    n, d = idx.numel(), table.shape[1]
    size = table.element_size()
    r = idx.reshape(-1).long()
    r = r[(r >= 0) & (r < table.shape[0])]
    first = table.data_ptr() + r * table.stride(0) * size
    sectors = int(((first + d * size - 1) // 32 - first // 32 + 1).sum().item())
    return (4 * n + 32 * sectors + 4 * (n // max(bag, 1)) * d) / PEAK_BYTES_PER_S * 1e3


def cin_bound(x0, xk, w):
    """x0, xk, w in and out once, in float32; 2 H K N FLOPs of the product and
    K N multiplies of the outer product (K = m Hk, N = B D)."""
    b, m, d = x0.shape
    hk, h = xk.shape[1], w.shape[1]
    k, n = m * hk, b * d
    return bound(4 * (x0.numel() + xk.numel() + w.numel() + b * h * d), 2 * h * k * n + k * n)


def moe_gemm_bound(buf, w):
    """buf and w in once, the float32 output once; 2 E C D F FLOPs at the
    tensor cores' bf16 peak for bf16 operands, else the float32 peak."""
    e, c, d = buf.shape
    f = w.shape[2]
    peak = (PEAK_BF16_FLOPS if buf.dtype == w.dtype == torch.bfloat16 else PEAK_OPS_PER_S)
    size = lambda x: x.numel() * x.element_size()  # noqa: E731
    return bound(size(buf) + size(w) + 4 * e * c * f, 2 * e * c * d * f, peak)


def _cin_library(x0, xk, w):
    """The library yardstick of cin_layer: one three-operand ``torch.einsum``
    per batch chunk of the plain version (a whole serve_bulk batch's outer
    product, which einsum forms first, would be 81.8 GB)."""
    from repro_torch.kernels.cin_interaction.ops import plain_chunk_rows

    b, m, d = x0.shape
    hk, h = xk.shape[1], w.shape[1]
    w3 = w.view(m, hk, h)
    step = plain_chunk_rows(m, hk, d)
    out = torch.empty((b, h, d), dtype=torch.float32, device=x0.device)
    for s in range(0, b, step):
        out[s:s + step] = torch.einsum("bid,bjd,ijh->bhd", x0[s:s + step], xk[s:s + step], w3)
    return out


@torch.no_grad()
def model_kernel_at_path(kernel: str, args: tuple, at: str, reps: int, timed: bool = True
                         ) -> dict:
    """One model-side kernel at a call its path made: against its plain
    version (the tolerance of the edge cases), and, when ``timed``, timed
    beside its plain version, the bound and one library call that computes
    the same function (``F.embedding_bag(mode="sum")``, a three-operand
    ``torch.einsum``, ``torch.bmm`` in the operands' dtype); the port never
    calls the library."""
    from repro_torch.kernels.cin_interaction.ops import (cin_layer, cin_layer_torch,
                                                         plain_chunk_rows)
    from repro_torch.kernels.embedding_bag.ops import embedding_bag, embedding_bag_torch
    from repro_torch.kernels.moe_gemm.ops import moe_gemm, moe_gemm_torch

    rows: list = []
    extra: dict = {}
    if kernel == "embedding_bag":
        idx, table, bag = args
        shape = {"n_bags": idx.numel() // bag, "bag": bag, "V": table.shape[0],
                 "D": table.shape[1], "row_stride": table.stride(0),
                 "dtype": str(table.dtype).split(".")[-1]}
        embedding_bag_check(rows, shape, idx, table, bag)
        extra["design_ceiling_ms"] = embedding_bag_ceiling(idx, table, bag)
        fn = lambda: embedding_bag(idx, table, bag)  # noqa: E731
        plain = lambda: embedding_bag_torch(idx, table, bag)  # noqa: E731
        bags = idx.reshape(-1, bag)
        lib = lambda: torch.nn.functional.embedding_bag(bags, table, mode="sum")  # noqa: E731
        lib_name = 'torch.nn.functional.embedding_bag(mode="sum")'
        b_ms, b_by = embedding_bag_bound(idx, table, bag)
    elif kernel == "cin_layer":
        x0, xk, w = args
        shape = {"B": x0.shape[0], "m": x0.shape[1], "Hk": xk.shape[1], "H": w.shape[1],
                 "D": x0.shape[2]}
        cin_check(rows, shape, x0, xk, w)
        fn = lambda: cin_layer(x0, xk, w)  # noqa: E731
        plain = lambda: cin_layer_torch(x0, xk, w)  # noqa: E731
        lib = lambda: _cin_library(x0, xk, w)  # noqa: E731
        rows_per_call = plain_chunk_rows(x0.shape[1], xk.shape[1], x0.shape[2])
        calls = -(-x0.shape[0] // rows_per_call)
        lib_name = (f'torch.einsum("bid,bjd,ijh->bhd"), one call per batch chunk of '
                    f'{rows_per_call} rows ({calls} calls)')
        b_ms, b_by = cin_bound(x0, xk, w)
    else:
        buf, w = args
        shape = {"E": buf.shape[0], "C": buf.shape[1], "D": buf.shape[2], "F": w.shape[2],
                 "dtype": str(buf.dtype).split(".")[-1]}
        moe_gemm_check(rows, shape, buf, w)
        fn = lambda: moe_gemm(buf, w)  # noqa: E731
        plain = lambda: moe_gemm_torch(buf, w)  # noqa: E731
        lib = lambda: torch.bmm(buf, w)  # noqa: E731
        lib_name = f"torch.bmm in {str(buf.dtype).split('.')[-1]} (its output rounded to it)"
        b_ms, b_by = moe_gemm_bound(buf, w)
    row = {**rows[0], "at": at, "bound_ms": b_ms, "bound_by": b_by, "library": lib_name, **extra}
    if timed:
        row["library_max_abs_err"] = float((lib().float() - fn()).abs().nan_to_num().max())
        row.update(ms=time_any(fn, reps), call_ms=time_any(fn, reps, preload=False),
                   plain_ms=time_any(plain, reps), library_ms=time_any(lib, reps))
    return row


def model_refusals(dev) -> int:
    """The model-side wrappers refuse what their kernels do not take (a
    float16 table, indices elsewhere, float indices, a non-contiguous or
    ill-fitting operand, an integer tensor); returns how many were checked."""
    from repro_torch.kernels.cin_interaction.ops import cin_layer
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.moe_gemm.ops import moe_gemm

    t = torch.zeros((10, 4), device=dev)
    i = torch.zeros(6, dtype=torch.int32, device=dev)
    x = torch.zeros((2, 3, 5), device=dev)
    b = torch.zeros((2, 4, 8), device=dev)
    w = torch.zeros((2, 8, 6), device=dev)
    cases = [
        (TypeError, "float32 or bfloat16", lambda: embedding_bag(i, t.half(), 2)),
        (ValueError, "lie on", lambda: embedding_bag(i.cpu(), t, 2)),
        (TypeError, "integer", lambda: embedding_bag(i.float(), t, 2)),
        (ValueError, "bags of", lambda: embedding_bag(i, t, 4)),
        (ValueError, "lies on", lambda: cin_layer(x, x.cpu(), torch.zeros((9, 2), device=dev))),
        (TypeError, "float tensor", lambda: cin_layer(x.int(), x, torch.zeros((9, 2), device=dev))),
        (ValueError, "do not fit", lambda: cin_layer(x, x, torch.zeros((8, 2), device=dev))),
        (ValueError, "contiguous", lambda: moe_gemm(b, w.transpose(1, 2).contiguous().transpose(1, 2))),
        (ValueError, "lies on", lambda: moe_gemm(b, w.cpu())),
        (TypeError, "float tensor", lambda: moe_gemm(b.int(), w)),
        (ValueError, "do not fit", lambda: moe_gemm(b, w[:, :7])),
    ]
    before = launch_counts()
    for exc, text, call in cases:
        try:
            call()
        except exc as e:
            require(text in str(e), f"refusal says {e!r}, expected {text!r} in it")
        else:
            raise SmokeFailure(f"a model-side wrapper took what its kernel does not take ({text})")
    require(launch_counts() == before, "a refused call counted as a launch")
    return len(cases)


# ----------------------------------------------------------------------
# recsys_serve phase
# ----------------------------------------------------------------------
@contextlib.contextmanager
def recsys_kernels(plain: bool = False, seen: list | None = None,
                   names: tuple = ("embedding_bag", "cin_layer")):
    """For the time of the block, the recsys models' two kernel names point
    at the plain versions (``plain``), or at recorders that append each
    call's ``(kernel, args)`` to ``seen`` (by reference: the models never
    change a kernel's inputs; only the calls of the kernels in ``names``)
    and call the wrapper."""
    from repro_torch.kernels.cin_interaction.ops import cin_layer_torch
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_torch
    from repro_torch.models import recsys

    originals = {"embedding_bag": recsys.embedding_bag, "cin_layer": recsys.cin_layer}
    if plain:
        swap = {"embedding_bag": embedding_bag_torch, "cin_layer": cin_layer_torch}
    else:
        def recorder(name):
            def rec(*a):
                if name in names:
                    seen.append((name, a))
                return originals[name](*a)
            return rec
        swap = {name: recorder(name) for name in originals}
    for name, fn in swap.items():
        setattr(recsys, name, fn)
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(recsys, name, fn)


def _recsys_inputs(cfg, shape: str, seed: int, dev) -> tuple[dict, int]:
    """The inputs of one of the registry's recsys shapes from the port's
    ``recsys_batches`` (the candidates of a retrieval shape are a click-log
    batch of ``n_candidates`` rows), and its row count."""
    from repro_torch.data.pipelines import recsys_batches

    spec = cfg.shapes[shape]
    if spec.kind == "retrieval":
        n = spec.dims["n_candidates"]
        cand = next(recsys_batches(cfg, n, seed=seed))["fields"]
        return {"candidates": torch.from_numpy(cand).to(dev)}, n
    b = spec.dims["batch"]
    batch = next(recsys_batches(cfg, b, seed=seed))
    keys = {"fm-2way": ("fields",), "cin": ("fields",), "self-attn-seq": ("hist", "target"),
            "dot": ("user_feats", "item_ids")}[cfg.interaction]
    return {k: torch.from_numpy(batch[k]).to(dev) for k in keys}, b


def _n_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def recsys_serve_path(args, dev) -> tuple[dict, list]:
    """The recsys serving path at full width: ``RECSYS_CONFIG`` with random
    float32 weights drawn on ``dev`` from ``args.seed``, serving each shape
    of ``RECSYS_SERVE`` from ``recsys_batches`` through
    ``make_recsys_serve_step`` — the kernels on a card, with the launch
    counts set to 0 just before and read just after the run over all shapes
    — then the same inputs through the plain path (the models' kernel names
    pointing at the plain versions): logits within ``RECSYS_LOGIT_REL`` of
    the plain path's largest.  Then each of ``RECSYS_OTHERS`` serves one
    serve_p99 batch the same two ways and is freed.  Returns the phase's
    line and the kernel calls of the serve_bulk run."""
    from repro_torch.configs import get_config
    from repro_torch.models import steps

    on_gpu = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    cfg = get_config(RECSYS_CONFIG)
    if on_gpu:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = steps.init_model_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                                     dev)
    sync()
    init_s = time.perf_counter() - t0
    serve = {kind: steps.make_recsys_serve_step(cfg, retrieval=kind == "retrieval")
             for kind in ("serve", "retrieval")}
    warm, _ = _recsys_inputs(cfg, "serve_p99", args.seed + 1, dev)
    serve["serve"](params, **warm)
    with recsys_kernels(plain=True):
        serve["serve"](params, **warm)
    sync()

    inputs = {shape: _recsys_inputs(cfg, shape, args.seed, dev) for shape in RECSYS_SERVE}
    by_shape: dict = {}
    seen: list = []
    recorded = {"serve_bulk": ("embedding_bag", "cin_layer"), "retrieval_cand": ("embedding_bag",)}
    reset_launch_counts()
    for shape in RECSYS_SERVE:
        inp, rows = inputs[shape]
        step = serve[cfg.shapes[shape].kind]
        if on_gpu:
            torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        with (recsys_kernels(seen=seen, names=recorded[shape]) if shape in recorded
              else contextlib.nullcontext()):
            sync()
            t1 = time.perf_counter()
            logits = step(params, **inp)
            sync()
            secs = time.perf_counter() - t1
        by_shape[shape] = {"rows": rows, "seconds": secs, "rows_per_s": rows / secs,
                           "launches": {k: n - before[k] for k, n in launch_counts().items()
                                        if n - before[k]},
                           "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                                    if on_gpu else None)}
        by_shape[shape]["logits"] = logits
    launches = launch_counts()
    routes = route_counts()
    for shape in RECSYS_SERVE:
        inp, _ = inputs[shape]
        with recsys_kernels(plain=True):
            sync()
            t1 = time.perf_counter()
            plain = serve[cfg.shapes[shape].kind](params, **inp)
            sync()
            plain_s = time.perf_counter() - t1
        got = by_shape[shape].pop("logits")
        err, scale = float((got - plain).abs().max()), float(plain.abs().max())
        require(bool(torch.isfinite(got).all()) and tuple(got.shape) == (by_shape[shape]["rows"],),
                f"recsys {shape}: logits of shape {tuple(got.shape)} or not finite")
        require(err <= RECSYS_LOGIT_REL * scale, f"recsys {shape}: kernel and plain logits "
                f"differ by {err} > {RECSYS_LOGIT_REL} x {scale}")
        by_shape[shape].update(plain_s=plain_s, logits_max_abs_err=err, logits_max_abs=scale,
                               first_logits=got[:4].tolist())
        del got, plain
    if on_gpu:
        n = len(RECSYS_SERVE)
        want = {name: 0 for name in launches}
        want.update(embedding_bag=2 * n, cin_layer=len(cfg.cin_layers) * n)
        require(launches == want, f"kernel launches on the recsys_serve path: {launches}, "
                f"expected {want}")
        # the x0 lookups read 40-byte float32 rows 8 bytes a load, the linear
        # terms linear[:, None] an element a load
        eb = {"scalar": n, "vec8": n, "vec16": 0}
        require(routes["embedding_bag"] == eb, f"embedding_bag routes on the recsys_serve "
                f"path: {routes['embedding_bag']}, expected {eb}")
    line = {"config": {"name": cfg.name, "embed_dim": cfg.embed_dim, "n_fields": cfg.n_fields,
                       "table_rows": sum(cfg.field_vocab_sizes),
                       "cin_layers": list(cfg.cin_layers), "mlp_dims": list(cfg.mlp_dims)},
            "params": _n_params(params), "n_params_config": cfg.n_params(), "init_s": init_s,
            "logits_tolerance_rel": RECSYS_LOGIT_REL, "launches": launches,
            "launches_by_route": {"embedding_bag": routes["embedding_bag"]},
            "shapes": by_shape}
    del params, inputs
    if on_gpu:
        torch.cuda.empty_cache()

    others = {}
    for name in RECSYS_OTHERS:
        ocfg = get_config(name)
        if on_gpu:
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        oparams = steps.init_model_params(
            ocfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
        sync()
        t2 = time.perf_counter()
        step = steps.make_recsys_serve_step(ocfg)
        inp, rows = _recsys_inputs(ocfg, "serve_p99", args.seed, dev)
        step(oparams, **inp)  # warm-up
        before = launch_counts()
        sync()
        t3 = time.perf_counter()
        got = step(oparams, **inp)
        sync()
        t4 = time.perf_counter()
        olaunches = {k: n - before[k] for k, n in launch_counts().items() if n - before[k]}
        with recsys_kernels(plain=True):
            plain = step(oparams, **inp)
        err, scale = float((got - plain).abs().max()), float(plain.abs().max())
        require(bool(torch.isfinite(got).all()) and tuple(got.shape) == (rows,),
                f"{name}: scores of shape {tuple(got.shape)} or not finite")
        require(err <= RECSYS_LOGIT_REL * scale,
                f"{name}: kernel and plain scores differ by {err} > {RECSYS_LOGIT_REL} x {scale}")
        if on_gpu:
            require(olaunches.get("embedding_bag", 0) > 0,
                    f"{name}: embedding_bag was not launched: {olaunches}")
        others[name] = {"params": _n_params(oparams), "n_params_config": ocfg.n_params(),
                        "rows": rows, "init_s": t2 - t1, "seconds": t4 - t3,
                        "rows_per_s": rows / (t4 - t3), "launches": olaunches,
                        "max_abs_err": err, "max_abs": scale,
                        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                                 if on_gpu else None)}
        del oparams, got, plain
        if on_gpu:
            torch.cuda.empty_cache()
    line["others_serve_p99"] = others
    return line, seen


def recsys_kernels_at_path(seen: list, reps: int) -> list[dict]:
    """The recsys path's recorded kernel calls against their plain
    versions: at serve_bulk the x0 lookup (bags of 1), the linear term (bags
    of n_fields) and each CIN layer, at retrieval_cand the x0 lookup and the
    linear term; timed: both lookups at both shapes and CIN layers 1 and 2
    (layer 3 has layer 2's shape)."""
    rows = []
    names = [name for name, _ in seen]
    require(names == ["embedding_bag", "embedding_bag", "cin_layer", "cin_layer", "cin_layer",
                      "embedding_bag", "embedding_bag"],
            f"the serve_bulk and retrieval_cand runs made the kernel calls {names}")
    labels = ["recsys_serve/serve_bulk/x0 lookup", "recsys_serve/serve_bulk/linear term",
              "recsys_serve/serve_bulk/CIN layer 1", "recsys_serve/serve_bulk/CIN layer 2",
              "recsys_serve/serve_bulk/CIN layer 3", "recsys_serve/retrieval_cand/x0 lookup",
              "recsys_serve/retrieval_cand/linear term"]
    for i, ((name, args), at) in enumerate(zip(seen, labels)):
        rows.append(model_kernel_at_path(name, args, at, reps, timed=i != 4))
    return rows


# ----------------------------------------------------------------------
# serve phase
# ----------------------------------------------------------------------
def make_batch(docs, idx, rng, per_cell: int) -> list[tuple[str, str]]:
    """(kind label, query string) pairs: words, ANDs of 2-4 terms (half random
    vocabulary words, half words that co-occur in one document), phrases of
    2-4 tokens from real text, top10:, docs: and docs: "..." queries."""
    from repro_torch.data.queries import sample_traffic
    from repro_torch.data.text import tokenize

    words = sorted(idx.vocab.token_to_id)

    def cooccurring(n_terms: int) -> str:
        toks = [t for t in tokenize(docs[int(rng.integers(len(docs)))])
                if idx.lookup(t) is not None]
        i = int(rng.integers(0, max(1, len(toks) - 8)))
        picked = list(dict.fromkeys(toks[i:i + 8]))[:n_terms]
        return " ".join(picked)

    def ands(n_terms: int, n: int) -> list[str]:
        half = sample_traffic("and", n // 2, docs, words, rng, n_terms=n_terms)
        return half + [cooccurring(n_terms) for _ in range(n - n // 2)]

    out = [("word", q) for q in sample_traffic("word", per_cell, docs, words, rng)]
    for nt in (2, 3, 4):
        out += [("and", q) for q in ands(nt, per_cell)]
        out += [("phrase", q) for q in
                sample_traffic("phrase", per_cell, docs, words, rng, n_terms=nt)]
    for nt in (2, 3):
        out += [("topk", f"top10: {q}") for q in ands(nt, per_cell)]
        out += [("docs", f"docs: {q}") for q in ands(nt, per_cell)]
        out += [("docs-phrase", q) for q in
                sample_traffic("docs-phrase", per_cell, docs, words, rng, n_terms=nt)]
    out += [("similar", f"similar:{int(d)}") for d in rng.integers(0, len(docs), per_cell)]
    out += [("versions", f"versions-of:{int(d)}")
            for d in rng.integers(0, len(docs), per_cell)]
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def _wrappers() -> dict:
    """Every kernel wrapper by its kernel's name (each counts its launches)."""
    from repro_torch.kernels.anchor_intersect.ops import anchor_probe, anchor_probe_sliced
    from repro_torch.kernels.dgap_decode.ops import dgap_decode
    from repro_torch.kernels.flash_attention.ops import flash_attention_tpu
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.fused_decode.ops import (
        decode_rows, decode_window, probe_rows, probe_window)
    from repro_torch.kernels.minhash_sig.ops import minhash_rows
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.cin_interaction.ops import cin_layer
    from repro_torch.kernels.moe_gemm.ops import moe_gemm
    return {"anchor_probe_sliced": anchor_probe_sliced, "decode_rows": decode_rows,
            "probe_rows": probe_rows, "decode_window": decode_window,
            "probe_window": probe_window, "minhash_rows": minhash_rows,
            "anchor_probe": anchor_probe, "dgap_decode": dgap_decode,
            "flash_attention_tpu": flash_attention_tpu, "flash_decode": flash_decode,
            "embedding_bag": embedding_bag, "cin_layer": cin_layer, "moe_gemm": moe_gemm}


def ptxas_by_kernel(log: str) -> dict:
    """What ``ptxas -v`` said of each kernel: its mangled name -> registers,
    stack frame and spill bytes."""
    out: dict = {}
    name = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
            out[name] = {}
        elif name is not None and "spill" in ln:
            out[name]["spill"] = ln.strip()
        elif name is not None and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used")[1].split("registers")[0])
    return out


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


#: the kernels whose wrappers pick a route before each launch
ROUTED_KERNELS = ("dgap_decode", "flash_attention_tpu", "flash_decode", "moe_gemm",
                  "embedding_bag", "minhash_rows")


def route_counts() -> dict:
    """Launches by route of the kernels that have more than one."""
    wrappers = _wrappers()
    return {name: dict(wrappers[name].launches_by_route) for name in ROUTED_KERNELS}


def by_route(rows: list, keys: tuple) -> dict:
    """Per routed kernel and route: how many comparison rows, and the
    largest value of each of ``keys`` among them."""
    out: dict = {}
    for r in rows:
        if "route" not in r:
            continue
        slot = out.setdefault(r["kernel"], {}).setdefault(r["route"], {"rows": 0})
        slot["rows"] += 1
        for k in keys:
            if k in r:
                slot[k] = max(slot.get(k, 0.0), r[k])
    return out


def route_diff(after: dict, before: dict) -> dict:
    return {name: {r: n - before[name][r] for r, n in by.items()} for name, by in after.items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0
        for extra in ("launches_lse", "launches_backward"):
            if hasattr(fn, extra):
                setattr(fn, extra, 0)


def build_indexes(args, device: str) -> dict:
    """The collection and its two indexes.  The non-positional build mines the
    version structure on ``device``: that is the mining path, driven with the
    launch counts set to 0 just before it and read just after, and with a
    recorder in front of the signature wrapper (``built["mining_calls"]``)."""
    from repro_torch.core.index import NonPositionalIndex, PositionalIndex
    from repro_torch.data import generate_collection

    t0 = time.perf_counter()
    col = generate_collection(n_articles=args.articles,
                              versions_per_article=args.versions,
                              words_per_doc=args.words, seed=args.seed)
    t1 = time.perf_counter()
    reset_launch_counts()
    with recorded_wrappers() as seen:
        idx = NonPositionalIndex.build(col.docs, store="repair_skip",
                                       mine_similarity=True, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    mining_launches = launch_counts()
    mining_routes = route_counts()["minhash_rows"]
    t2 = time.perf_counter()
    pidx = PositionalIndex.build(col.docs, store="repair_skip")
    t3 = time.perf_counter()
    if device != "cpu":
        require(mining_launches["minhash_rows"] > 0,
                f"minhash_rows was not launched on the mining path: {mining_launches}")
    return {"docs": col.docs, "idx": idx, "pidx": pidx,
            "mining_launches": mining_launches, "mining_routes": mining_routes,
            "mining_calls": seen["minhash_rows"],
            "info": {"articles": args.articles, "versions_per_article": args.versions,
                     "words_per_doc": args.words, "seed": args.seed,
                     "documents": len(col.docs), "tokens": int(pidx.n_tokens),
                     "collection_bytes": int(col.total_bytes),
                     "generate_s": round(t1 - t0, 3),
                     "build_nonpositional_mined_s": round(t2 - t1, 3),
                     "build_positional_s": round(t3 - t2, 3)}}


def doc_terms(idx, docs) -> list[np.ndarray]:
    """Each document's analyzed term ids, as the index build collects them
    for mining."""
    from repro_torch.data.text import tokenize

    out = []
    for doc in docs:
        kept = (idx.analyzer.normalize(t) for t in tokenize(doc))
        out.append(np.asarray([idx.vocab.get(w) for w in kept if w is not None],
                              dtype=np.int64))
    return out


def mining_check(built: dict, device: str) -> dict:
    """Mine the same documents twice more — on ``device`` step by step (host
    seconds per step), and with the plain version on the CPU — and require the
    three similarity indexes to be equal."""
    from repro_torch.core.similarity import SimilarityIndex
    from repro_torch.core.similarity.cluster import _elect_heads, cluster_union
    from repro_torch.core.similarity.minhash import shingle_hashes, signature_matrix

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    mined = built["idx"].similarity
    cfg = mined.config
    terms = doc_terms(built["idx"], built["docs"])
    t0 = time.perf_counter()
    sets = [shingle_hashes(t, cfg.shingle) for t in terms]
    t1 = time.perf_counter()
    sigs = signature_matrix(sets, cfg, device=device)
    sync()
    t2 = time.perf_counter()
    n_shingles = np.asarray([len(s) for s in sets], dtype=np.int64)
    labels = cluster_union(sigs, n_shingles, cfg)
    t3 = time.perf_counter()
    heads = _elect_heads(sigs, labels)
    t4 = time.perf_counter()
    plain = SimilarityIndex.mine(terms, cfg, device="cpu")
    t5 = time.perf_counter()
    for name, got in (("sigs", sigs), ("n_shingles", n_shingles), ("labels", labels),
                      ("heads", heads)):
        want = getattr(mined, name)
        require(np.array_equal(got, want) and np.array_equal(getattr(plain, name), want),
                f"mined {name} differ between the index build on {device}, the "
                f"step-by-step mining on {device} and the plain version on the CPU")
    return {"documents": len(terms), "clusters": int(mined.n_clusters),
            "live_shingles": int(n_shingles.sum()), "longest_row": int(n_shingles.max()),
            "equal_device_plain": True,
            "host_s": {"shingle": t1 - t0, "signatures_on_device": t2 - t1,
                       "cluster_union": t3 - t2, "elect_heads": t4 - t3,
                       "mining_total": t4 - t0, "plain_mining_on_cpu": t5 - t4},
            "launches_on_mining_path": built["mining_launches"]}


def rlz_path(built: dict, batch, device: str) -> dict:
    """The rlz path, with the launch counts set to 0 just before it and read
    just after: the store built on ``device``, then a session over it serving
    the batch's AND / ``top10:`` / ``docs:`` queries.  Its store must equal the
    one built with the plain version on the CPU, byte for byte, and its
    answers the host-only session's."""
    from repro_torch.core.index import NonPositionalIndex
    from repro_torch.serving.session import Session

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    docs = built["docs"]
    queries = [q for k, q in batch if k in ("and", "topk", "docs")]
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_wrappers() as seen:
        idx = NonPositionalIndex.build(docs, store="rlz", device=device)
    sync()
    t1 = time.perf_counter()
    build_launches = launch_counts()
    build_routes = route_counts()["minhash_rows"]
    sess = Session.build(idx, device=device)
    t2 = time.perf_counter()
    got = sess.execute(queries)
    sync()
    t3 = time.perf_counter()
    launches = launch_counts()
    require(sess.server.layout == "dense",
            f"the rlz server took the {sess.server.layout} layout, expected dense")
    want = Session(idx).execute(queries)
    t4 = time.perf_counter()
    wrong = [q for q, a, b in zip(queries, got, want) if not np.array_equal(a, b)]
    require(not wrong, f"{len(wrong)} rlz answers differ from the host session's, "
            f"first: {wrong[:3]}")
    cpu = NonPositionalIndex.build(docs, store="rlz", device="cpu")
    t5 = time.perf_counter()
    a, b = idx.store, cpu.store
    require(a._data == b._data and a._payload_bits == b._payload_bits
            and np.array_equal(a.bit_offsets, b.bit_offsets)
            and np.array_equal(a.head_ref, b.head_ref)
            and a.size_in_bits == b.size_in_bits,
            "the rlz store built on the card differs from the one built on the CPU")
    require(idx.store_kw == {}, f"the device leaked into store_kw: {idx.store_kw}")
    if device != "cpu":
        require(launches["minhash_rows"] > 0 and launches["anchor_probe_sliced"] > 0,
                f"a kernel of the rlz path was not launched: {launches}")
        require(all(t.is_cuda for t in sess.server.arrays.values()),
                "an rlz server array is not a CUDA tensor")
    return {"lists": a.n_lists, "heads": a.n_heads, "size_in_bits": a.size_in_bits,
            "space_fraction": idx.space_fraction, "stores_equal_device_cpu": True,
            "queries": len(queries), "answers_equal_host": True,
            "nonempty_answers": sum(len(r) > 0 for r in want),
            "layout": sess.server.layout, "device_bytes": sess.server.device_bytes(),
            "build_s": t1 - t0, "session_build_s": t2 - t1, "serve_s": t3 - t2,
            "host_session_s": t4 - t3, "build_on_cpu_s": t5 - t4,
            "launches_build": build_launches, "minhash_rows_routes_build": build_routes,
            "launches": launches, "calls": seen["minhash_rows"]}


def minhash_at_mining(inputs: dict, reps: int) -> list[dict]:
    """minhash_rows at the inputs the two paths handed it (documents, posting
    lists): against its plain version (tolerance 0), timed beside the plain
    version and the bound, and beside the host-to-device copy of the padded
    shingle matrix that each call needs first; and timed once more with every
    row's length set to 0 (``ms_no_live_lanes``: the launches, the lengths'
    reads and the writes, no hashing)."""
    from repro_torch.kernels.minhash_sig.ops import (minhash_rows, minhash_rows_route,
                                                     minhash_rows_torch)

    rows = []
    for at, calls in inputs.items():
        require(len(calls) == 1, f"the {at} build made {len(calls)} signature calls")
        args = calls[0]
        mism, err = diff_stats(minhash_rows(*args), minhash_rows_torch(*args))
        (b_ms, b_by), live = minhash_bound(args[0], args[1], args[2])
        host = args[0].cpu()
        no_lanes = torch.zeros_like(args[1])
        row = {"kernel": "minhash_rows", "at": at, "route": minhash_rows_route(args[0]),
               "shape": {"D": args[0].shape[0], "L": args[0].shape[1],
                         "P": args[2].numel(), "live_lanes": live},
               "design_ceiling_ms": minhash_ceiling(live, args[2].numel()),
               "mismatches": mism, "max_abs_err": err,
               "ms": time_ms(lambda: minhash_rows(*args), reps),
               "call_ms": time_ms(lambda: minhash_rows(*args), reps, preload=False),
               "plain_ms": time_ms(lambda: minhash_rows_torch(*args), reps),
               "ms_no_live_lanes": time_ms(lambda: minhash_rows(args[0], no_lanes, *args[2:]),
                                           reps),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "copy_bytes": host.numel() * host.element_size(),
               "copy_ms": time_ms(lambda: host.to(args[0].device), reps, preload=False)}
        rows.append(row)
    return rows


def window_splits(sessions: dict, batch, reps: int) -> dict:
    """The fused layout's phrase2 and and2 batches (as ``group_terms`` cuts
    them from the mixed batch), on a card: their first window through the
    session's kind of step (the window kernels) and through
    ``row_given_step``, each split into host and device time by
    ``ab_timing.window_split``.  (Both routes' answers on every recorded
    window are compared in ``main_path_inputs``; parent against change is
    ``ab_timing.py --windows``.)"""
    from repro_torch.kernels.ab_timing import window_split
    from repro_torch.serving.engine import make_serve_step

    out = {}
    for name, srv, kind in (("phrase2", sessions["fused"].positional_server, "phrase"),
                            ("and2", sessions["fused"].server, "and")):
        qt, ql, n_win = group_terms(srv, batch, kind, (2,))
        width = qt.shape[1]
        routes = {"window_kernels": make_serve_step(
                      max_terms=width, mode=kind, n_docs=srv.n_docs, probe="kernel",
                      layout="fused", max_phrase=srv.max_phrase),
                  "rows_given": row_given_step(width, kind == "phrase", srv.max_phrase)}
        split = {route: window_split(torch, step, srv.arrays, qt, ql, 0, reps)
                 for route, step in routes.items()}
        require(split["window_kernels"]["answer"] == split["rows_given"]["answer"],
                f"{name}: the two routes' first windows differ: {split}")
        out[name] = {"queries": int(qt.shape[0]), "width": width, "windows": n_win, **split}
    return out


def save_windows(sessions: dict, batch, sig_calls: dict, path: str) -> None:
    """The fused servers' arrays and the phrase2 / and2 term batches, and the
    shingles, lens and hash parameters of the two signature calls, for
    ``src/repro_torch/kernels/ab_timing.py --windows`` (parent against
    change on the inputs the paths record)."""
    from repro_torch.kernels.ab_timing import FUSED_ARRAYS, SIGNATURE_ARGS

    data = {}
    for at, calls in sig_calls.items():
        data.update({f"{at}/{k}": t.cpu().numpy() for k, t in zip(SIGNATURE_ARGS, calls[0])})
    for name, srv, kind in (("phrase2", sessions["fused"].positional_server, "phrase"),
                            ("and2", sessions["fused"].server, "and")):
        qt, ql, _ = group_terms(srv, batch, kind, (2,))
        data.update({f"{name}/qt": qt, f"{name}/ql": ql,
                     f"{name}/max_phrase": np.asarray(srv.max_phrase)})
        data.update({f"{name}/{k}": srv.arrays[k].cpu().numpy() for k in FUSED_ARRAYS})
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **data)


def serve(built: dict, sessions: dict, batch: list[tuple[str, str]], device: str,
          reps: int = 20) -> dict:
    """Drive the mixed batch through the fused session (the main path, with
    the launch counts read around it), the dense session and the host-only
    session, and compare every answer exactly; on a card, also
    ``window_splits``."""
    from repro_torch.serving.engine import RANK_ARRAYS
    from repro_torch.serving.session import Session

    on_gpu = device != "cpu"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    queries = [q for _, q in batch]
    kinds = [k for k, _ in batch]
    fused, dense = sessions["fused"], sessions["dense"]
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    t0 = time.perf_counter()
    got_fused = fused.execute(queries)
    sync()
    fused_s = time.perf_counter() - t0
    fused_launches = launch_counts()
    windows = {"fused/nonpositional": fused.server.windows_swept,
               "fused/positional": fused.positional_server.windows_swept}

    reset_launch_counts()
    t0 = time.perf_counter()
    got_dense = dense.execute(queries)
    sync()
    dense_s = time.perf_counter() - t0
    dense_launches = launch_counts()
    windows.update({"dense/nonpositional": dense.server.windows_swept,
                    "dense/positional": dense.positional_server.windows_swept})

    t0 = time.perf_counter()
    host = Session(built["idx"], positional=built["pidx"])
    got_host = host.execute(queries)
    host_s = time.perf_counter() - t0

    wrong = [q for q, a, b, c in zip(queries, got_fused, got_dense, got_host)
             if not (np.array_equal(a, c) and np.array_equal(b, c))]
    require(not wrong, f"{len(wrong)} answers differ between fused / dense / host, "
            f"first: {wrong[:3]}")
    for g in (got_fused, got_dense):
        require(all(isinstance(r, np.ndarray) and r.ndim == 1 and r.dtype == np.int64
                    for r in g), "an answer is not a 1-D int64 array")

    # second pass per kind (steps and plans are warm): queries/s per kind, layout
    per_kind: dict = {}
    for name, sess in (("fused", fused), ("dense", dense)):
        per_kind[name] = {}
        for kind in sorted(set(kinds)):
            sub = [q for k, q in batch if k == kind]
            sync()
            t0 = time.perf_counter()
            sess.execute(sub)
            sync()
            per_kind[name][kind] = {"queries": len(sub),
                                    "queries_per_s": len(sub) / (time.perf_counter() - t0)}

    servers = {f"{lay}/{which}": getattr(sessions[lay], attr)
               for lay in ("fused", "dense")
               for which, attr in (("nonpositional", "server"),
                                   ("positional", "positional_server"))}
    dev_bytes = {}
    for name, srv in servers.items():
        if on_gpu:
            require(all(t.is_cuda for t in srv.arrays.values()),
                    f"{name}: a server array is not a CUDA tensor")
        want = sum(int(np.prod(srv.arrays[k].shape))
                   * (1 if srv.arrays[k].dtype == torch.bool else 4)
                   for k in srv._LAYOUT_ARRAYS[srv.layout])
        require(srv.device_bytes() == want,
                f"{name}: device_bytes() {srv.device_bytes()} != {want} from array sizes")
        # the layout arrays and doc_starts are int32 or bool; the ranked step's
        # arrays (non-positional servers) carry the reference's dtypes, float32
        # among them, and stay outside device_bytes()
        rank_keys = {k for k in srv.arrays if k.startswith("rank_")}
        require(all(srv.arrays[k].dtype in (torch.int32, torch.bool)
                    for k in set(srv.arrays) - rank_keys),
                f"{name}: a layout array is neither int32 nor bool")
        want_keys = set(RANK_ARRAYS) if name.endswith("/nonpositional") else set()
        require(rank_keys == want_keys and all(
                    srv.arrays[k].dtype == torch.from_numpy(np.zeros(0, RANK_ARRAYS[k])).dtype
                    for k in rank_keys),
                f"{name}: rank arrays {sorted(rank_keys)} or their dtypes differ from "
                f"the reference's")
        dev_bytes[name] = srv.device_bytes()
    splits = None
    if on_gpu:
        fused_windows = windows["fused/nonpositional"] + windows["fused/positional"]
        require(all(fused_launches[k] == fused_windows for k in SERVE_KERNELS),
                f"the fused main path swept {fused_windows} windows but launched "
                f"{ {k: fused_launches[k] for k in SERVE_KERNELS} }")
        require(all(fused_launches[k] == 0 for k in ROW_GIVEN_KERNELS),
                f"the fused main path launched a row-given kernel: {fused_launches}")
        require(dense_launches["anchor_probe_sliced"] > 0
                and all(dense_launches[k] == 0 for k in SERVE_KERNELS),
                f"the dense path's kernels: {dense_launches}")
        splits = window_splits(sessions, batch, reps)
    n = len(queries)
    return {
        "queries": n, "kinds": {k: kinds.count(k) for k in sorted(set(kinds))},
        "answers_equal_fused_dense_host": True,
        "nonempty_answers": sum(len(r) > 0 for r in got_host),
        "mixed_batch": {"fused_s": fused_s, "dense_s": dense_s, "host_s": host_s,
                        "fused_queries_per_s": n / fused_s,
                        "dense_queries_per_s": n / dense_s,
                        "host_queries_per_s": n / host_s},
        "queries_per_s_by_kind": per_kind,
        "launches_fused": fused_launches, "launches_dense": dense_launches,
        "windows_swept": windows,
        "window_split": splits,
        "device_steps_built": {"fused": fused.jit_traces, "dense": dense.jit_traces},
        "device_bytes": dev_bytes,
        "max_phrase": {name: srv.max_phrase for name, srv in servers.items()
                       if srv.layout == "fused"},
        "c_entries": {name: int(srv.arrays["anchors"].numel())
                      for name, srv in servers.items() if srv.layout == "fused"},
        "max_memory_allocated": torch.cuda.max_memory_allocated() if on_gpu else None,
    }


RANK_PER_CELL = 24  # rank10: queries per term count (2, 3, 4) of the ranked batch
WRITER_DOCS = 300  # the writer's documents (the Python Re-Pair build bounds it)
WRITER_COMMITS = 3
LIFECYCLE_DIR = ROOT / "build" / "lifecycle"


def rank_batch(docs, idx, seed: int) -> list[str]:
    """``rank10:`` queries, ``RANK_PER_CELL`` each of 2, 3 and 4 random
    vocabulary words, from an rng of their own (the mixed batch's stream is
    not touched)."""
    from repro_torch.data.queries import sample_traffic

    rng = np.random.default_rng(seed)
    words = sorted(idx.vocab.token_to_id)
    return [q for nt in (2, 3, 4)
            for q in sample_traffic("rank", RANK_PER_CELL, docs, words, rng, n_terms=nt, k=10)]


def _differ(queries, got, want) -> list[str]:
    return [q for q, a, b in zip(queries, got, want) if not np.array_equal(a, np.asarray(b))]


def ranked(built: dict, sessions: dict, queries: list[str], device: str,
           reps: int = 20) -> dict:
    """The ``rank10:`` batch through the fused and the dense card sessions
    (the ranked step, counts read around each), held exactly against the
    host-only session and against the same step on CPU tensors (the same
    float32 arithmetic); queries/s per session, the step's device ms per
    call and calls per batch, the rank arrays' bytes."""
    from repro_torch.serving.engine import RANK_ARRAYS, BatchedServer
    from repro_torch.serving.plan import RANK
    from repro_torch.serving.session import Session

    on_gpu = device != "cpu"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    host = Session(built["idx"])
    src = sessions["fused"].server
    cpu = Session(built["idx"], server=BatchedServer.from_arrays(
        built["idx"], {k: v.cpu().numpy() for k, v in src.arrays.items()},
        layout=src.layout, max_phrase=src.max_phrase, n_docs=src.n_docs, device="cpu"))
    t0 = time.perf_counter()
    want = host.execute(queries)
    host_s = time.perf_counter() - t0
    want_cpu = cpu.execute(queries)
    require(not _differ(queries, want_cpu, want), f"the ranked step on CPU tensors differs "
            f"from the host scorer: {_differ(queries, want_cpu, want)[:3]}")
    out: dict = {"queries": len(queries), "host_queries_per_s": len(queries) / host_s}
    for name in ("fused", "dense"):
        sess = sessions[name]
        srv = sess.server
        require(RANK in srv.kinds, f"{name}: the server lists no 'rank'")
        routes = [sess.plan(q).route for q in queries]
        require(all(r == "device" for r in routes),
                f"{name}: {routes.count('host')} rank queries routed to the host")
        steps0, batches0 = srv.ranked_steps, sess.device_batches
        reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        got = sess.execute(queries)
        sync()
        first_s = time.perf_counter() - t0
        launches = {k: n for k, n in launch_counts().items() if n}
        calls = srv.ranked_steps - steps0
        require(calls == sess.device_batches - batches0 and calls > 0,
                f"{name}: {calls} ranked steps for {sess.device_batches - batches0} batches")
        bad = _differ(queries, got, want)
        require(not bad, f"{name}: {len(bad)} rank answers differ from the host "
                f"session's, first {bad[:3]}")
        require(not _differ(queries, got, want_cpu), f"{name}: differs from the CPU step")
        sync()
        t0 = time.perf_counter()
        sess.execute(queries)
        sync()
        warm_s = time.perf_counter() - t0
        out[name] = {"queries_per_s": len(queries) / warm_s, "first_pass_s": first_s,
                     "warm_pass_s": warm_s, "ranked_steps_per_batch": calls,
                     "launches": launches,
                     "rank_array_bytes": sum(srv.arrays[k].numel() * srv.arrays[k].element_size()
                                             for k in RANK_ARRAYS),
                     "rank_arrays": {k: [list(srv.arrays[k].shape), str(srv.arrays[k].dtype)]
                                     for k in RANK_ARRAYS},
                     "device_bytes": srv.device_bytes()}
    srv = sessions["fused"].server
    live = int(srv.arrays["rank_run_valid"].sum().item())
    out["live_slots"] = live
    out["live_share"] = live / srv.arrays["rank_run_valid"].numel()
    steps = {}
    if on_gpu:
        # the step alone, per width group of the batch: CUDA events around it
        # with the card kept busy (ms), then split by ab_timing.window_split
        # into its host side, the call with its outputs' copies, and the
        # traced device time and kernels a call
        from repro_torch.kernels.ab_timing import window_split
        from repro_torch.serving.plan import parse_query, width_bucket

        parsed = [parse_query(q) for q in queries]
        for width in sorted({width_bucket(len(pq.terms)) for pq in parsed}):
            qs = [list(dict.fromkeys(pq.terms)) for pq in parsed
                  if width_bucket(len(pq.terms)) == width]
            qt, ql, _ = srv.encode(qs, width=width)
            step = srv._step(RANK, width, topk=10)
            qt_d, ql_d = torch.from_numpy(qt).cuda(), torch.from_numpy(ql).cuda()
            with torch.no_grad():
                ms = time_ms(lambda: step(srv.arrays, qt_d, ql_d), reps)
            split = window_split(torch, step, srv.arrays, qt, ql, 0, reps)
            split.pop("answer")
            steps[f"width {width}"] = {"queries": len(qs), "ms": ms, **split}
    out["step"] = steps
    return out


def lifecycle(built: dict, sessions: dict, batch: list[tuple[str, str]],
              rank_queries: list[str], args, device: str) -> dict:
    """(a) Save the full-size indexes as a bundle and serve it through
    ``Session.open`` (eager verify, then memory maps); (b) an ``IndexWriter``
    over the first ``WRITER_DOCS`` documents in ``WRITER_COMMITS`` commits
    (mining on ``device``), opened segment-aware, held against one-shot
    builds, then compacted in the background while it serves.  The writer's
    directory and its queries stay for the frontier phase (``writer_dir``,
    ``writer_queries``), which removes the directory."""
    import shutil

    from repro_torch.core.artifact import save_index
    from repro_torch.core.index import NonPositionalIndex, PositionalIndex
    from repro_torch.core.writer import IndexWriter
    from repro_torch.serving.session import Session

    on_gpu = device != "cpu"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    probe = "kernel" if on_gpu else "torch"
    shutil.rmtree(LIFECYCLE_DIR, ignore_errors=True)
    LIFECYCLE_DIR.mkdir(parents=True)
    out: dict = {}
    try:
        # (a) the full-size indexes, saved and opened
        queries = [q for _, q in batch] + rank_queries
        fused = sessions["fused"]
        want = fused.execute(queries)
        bundle = LIFECYCLE_DIR / "bundle"
        t0 = time.perf_counter()
        save_index(built["idx"], bundle / "nonpositional")
        save_index(built["pidx"], bundle / "positional")
        out["save_s"] = time.perf_counter() - t0
        out["bundle_bytes"] = sum(p.stat().st_size for p in bundle.rglob("*") if p.is_file())
        for mode, kw in (("eager", {}), ("mmap", {"mmap": True})):
            t0 = time.perf_counter()
            sess = Session.open(bundle, device=device, probe=probe, **kw)
            sync()
            open_s = time.perf_counter() - t0
            pairs = (("nonpositional", sess.server, fused.server),
                     ("positional", sess.positional_server, fused.positional_server))
            for which, srv, mem in pairs:
                require(srv.layout == "fused" and srv.probe == probe,
                        f"opened {mode}: {which} server is {srv.layout} / {srv.probe}")
                require(srv.device_bytes() == mem.device_bytes(),
                        f"opened {mode}: {which} device_bytes() {srv.device_bytes()} != "
                        f"{mem.device_bytes()} in memory")
                require(set(srv.arrays) == set(mem.arrays) and all(
                    torch.equal(srv.arrays[k], mem.arrays[k]) for k in mem.arrays),
                    f"opened {mode}: {which} server arrays differ from the in-memory ones")
            reset_launch_counts()
            t0 = time.perf_counter()
            got = sess.execute(queries)
            sync()
            first_s = time.perf_counter() - t0
            launches = launch_counts()
            windows = sess.server.windows_swept + sess.positional_server.windows_swept
            bad = _differ(queries, got, want)
            require(not bad, f"opened {mode}: {len(bad)} answers differ from the in-memory "
                    f"fused session's, first {bad[:3]}")
            if on_gpu:
                require(all(launches[k] == windows for k in SERVE_KERNELS),
                        f"opened {mode}: {windows} windows swept but launched "
                        f"{ {k: launches[k] for k in SERVE_KERNELS} }")
                require(all(launches[k] == 0 for k in ROW_GIVEN_KERNELS),
                        f"opened {mode}: a row-given kernel was launched: {launches}")
            out[f"open_{mode}"] = {
                "open_s": open_s, "first_answer_s": first_s,
                "queries": len(queries), "answers_equal_in_memory": True,
                "windows_swept": windows, "ranked_steps": sess.server.ranked_steps,
                "launches": {k: n for k, n in launches.items() if n},
                "device_bytes": {"nonpositional": sess.server.device_bytes(),
                                 "positional": sess.positional_server.device_bytes()}}
            del sess, got
        del want
        shutil.rmtree(bundle)

        # (b) a writer over the first WRITER_DOCS documents
        docs = built["docs"][:WRITER_DOCS]
        wdir = LIFECYCLE_DIR / "writer"
        writer = IndexWriter(wdir, store="repair_skip", positional=True,
                             mine_similarity=True, device=device)
        commit_s = []
        reset_launch_counts()
        step = WRITER_DOCS // WRITER_COMMITS
        for lo in range(0, WRITER_DOCS, step):
            t0 = time.perf_counter()
            writer.add_documents(docs[lo:lo + step])
            writer.commit()
            sync()
            commit_s.append(time.perf_counter() - t0)
        commit_launches = launch_counts()
        require(len(writer.segments) == WRITER_COMMITS, f"{len(writer.segments)} segments")
        if on_gpu:
            require(commit_launches["minhash_rows"] >= WRITER_COMMITS,
                    f"the commits launched minhash_rows {commit_launches['minhash_rows']} "
                    f"times for {WRITER_COMMITS} mined segments")
        t0 = time.perf_counter()
        one_np = NonPositionalIndex.build(docs, store="repair_skip", mine_similarity=True,
                                          device=device)
        one_pos = PositionalIndex.build(docs, store="repair_skip")
        one_shot_build_s = time.perf_counter() - t0
        rng = np.random.default_rng(args.seed + 2)
        wbatch = make_batch(docs, one_np, rng, args.per_cell) \
            + [("rank", q) for q in rank_batch(docs, one_np, args.seed + 3)]
        wq = [q for _, q in wbatch]
        # similar: / versions-of: hash segment-local term ids: a segmented
        # collection answers them per segment, so they are compared with the
        # host-only session over the same segments, the rest with one-shot builds
        seg_local = [k in ("similar", "versions") for k, _ in wbatch]
        t0 = time.perf_counter()
        seg = Session.open(wdir, device=device, probe=probe)
        sync()
        open_s = time.perf_counter() - t0
        seg_host = Session.open(wdir, device=device, attach=False)
        one_card = Session.build(one_np, positional=one_pos, device=device, probe=probe)
        one_host = Session(one_np, positional=one_pos)
        reset_launch_counts()
        t0 = time.perf_counter()
        got = seg.execute(wq)
        sync()
        first_s = time.perf_counter() - t0
        seg_launches = launch_counts()
        windows = sum(s.session.server.windows_swept + s.session.positional_server.windows_swept
                      for s in seg._segments)
        if on_gpu:
            require(all(seg_launches[k] == windows for k in SERVE_KERNELS),
                    f"segmented: {windows} windows swept but launched "
                    f"{ {k: seg_launches[k] for k in SERVE_KERNELS} }")
        want_seg = seg_host.execute(wq)
        want_card, want_host = one_card.execute(wq), one_host.execute(wq)
        terms = [i for i, local in enumerate(seg_local) if not local]
        bad = ([wq[i] for i in range(len(wq)) if not np.array_equal(got[i], want_seg[i])]
               + [wq[i] for i in terms if not (np.array_equal(got[i], want_host[i])
                                              and np.array_equal(got[i], want_card[i]))])
        require(not bad, f"segmented: {len(bad)} answers differ, first {bad[:3]}")
        # compaction in the background while the session serves
        fired = []
        seg.add_refresh_hook(lambda old, new, added: fired.append((old, new, added is None)))
        t0 = time.perf_counter()
        handle = writer.compact_async()
        served_during = 0
        while not handle.done:
            during = seg.execute(wq)
            served_during += 1
            bad = _differ(wq, during, got)
            require(not bad, f"answers changed while compacting: {bad[:3]}")
        handle.wait()
        compact_s = time.perf_counter() - t0
        opened = seg.refresh()
        require(opened >= 1 and len(fired) == 1 and fired[0][1] == (1,),
                f"refresh after the swap opened {opened} segments, hooks {fired}")
        after = seg.execute(wq)
        after_host = Session.open(wdir, device=device, attach=False).execute(wq)
        bad = [wq[i] for i in terms if not np.array_equal(after[i], got[i])]
        bad += _differ(wq, after, after_host)
        require(not bad, f"answers after the compaction differ: {bad[:3]}")
        changed_local = sum(not np.array_equal(after[i], got[i])
                            for i, local in enumerate(seg_local) if local)
        out["writer"] = {
            "documents": WRITER_DOCS, "commits": WRITER_COMMITS,
            "commit_s": commit_s, "commit_launches": {k: n for k, n in commit_launches.items()
                                                      if n},
            "one_shot_build_s": one_shot_build_s, "open_s": open_s,
            "first_answer_s": first_s, "queries": len(wq),
            "kinds": {k: [x for x, _ in wbatch].count(k) for k in sorted({x for x, _ in wbatch})},
            "compared_with_one_shot": len(terms),
            "compared_with_segmented_host": len(wq),
            "windows_swept": windows,
            "launches": {k: n for k, n in seg_launches.items() if n},
            "compaction_s": compact_s, "batches_served_during_compaction": served_during,
            "refresh_opened": opened, "hook_calls": len(fired),
            "segment_local_answers_changed_by_compaction": changed_local}
    except BaseException:
        shutil.rmtree(LIFECYCLE_DIR, ignore_errors=True)
        raise
    out["writer_dir"], out["writer_queries"] = wdir, wq
    return out


FRONTIER_SHARDS = (2, 4)  # shard counts of the full non-positional index
FRONTIER_CUT_DOCS = 1000  # the positional cut: the Python Re-Pair build bounds it
FRONTIER_REFRESH_DOCS = 50  # the refresh phase's one more commit
FRONTIER_CONFIG = {"max_batch": 32, "max_delay": 0.002, "max_pending": 1024}
FRONTIER_OVERLOAD_PENDING = 16
FRONTIER_DRIVER = ["--articles", "8", "--versions", "10", "--queries", "64", "--mode",
                   "mixed", "--frontend", "--replicas", "2", "--shards", "2"]


def shard_probes(sess, queries: list[str], servers: dict) -> int:
    """The probe launches a batch needs on partitioned servers (``servers``
    by the index a route names): per device group of the session, its
    windows x (width - 1), whatever the shard count (all shards of a window
    probe in one launch a term)."""
    from repro_torch.serving.plan import PHRASE, parse_query

    groups: dict = {}
    for q in queries:
        pq = parse_query(q)
        rt = sess.plan(pq)
        if rt.route == "device":
            groups.setdefault((rt.index, pq.kind, rt.width), []).append(list(pq.terms))
    total = 0
    for (index, kind, width), terms in groups.items():
        server = servers[index]
        c = server._c_offsets_np
        qt, _, ok = server.encode(terms, sort_by_length=(kind != PHRASE), width=width)
        first = qt[:, 0][ok] if ok.any() else qt[:1, 0]
        rows = int((c[:, first + 1] - c[:, first]).max())
        total += max(1, -(-rows // 64)) * (width - 1)
    return total


def _latency(report: dict) -> dict:
    lat = report["latency"]
    return {"achieved_qps": report["achieved_qps"], "offered_qps": report["offered_qps"],
            **{k: lat.get(k) for k in ("p50_ms", "p95_ms", "p99_ms", "max_ms", "mean_ms",
                                       "queue_depth_max")},
            "rejected": report["rejected"], "reject_rate": report["reject_rate"],
            "cache_hit_rate": report["cache_hit_rate"], "mean_batch": report["mean_batch"]}


def frontier(built: dict, sessions: dict, batch: list[tuple[str, str]],
             rank_queries: list[str], life: dict, args, device: str) -> dict:
    """The serving frontier on ``device``: (1) ``PartitionedServer`` over the
    full non-positional index at ``FRONTIER_SHARDS`` shards (arrays equal to
    a CPU build), serving the batch's AND queries; (2) the positional index
    of the first ``FRONTIER_CUT_DOCS`` documents in 2 shards, serving a
    phrase batch; (3) ``replicated_session`` — 2 fused replicas of the full
    indexes on the 432 queries, 2 replicas x 2 shards over the cut, a
    replica failing mid-batch; (4) ``run_open_loop`` over the fused card
    session: burst, Poisson at half the burst's rate, a warm pass, an
    overload pass; (5) a frontend over the lifecycle writer's segmented
    session through one more commit and ``refresh``, beside the same
    sequence host-only; (6) ``repro_torch.launch.serve.main``.  Every
    answer equal to a host-only session's; launch counts read around each."""
    import asyncio
    import contextlib
    import io
    import shutil

    from repro_torch.core.index import NonPositionalIndex, PositionalIndex
    from repro_torch.core.writer import IndexWriter
    from repro_torch.serving.frontend import (FrontendConfig, MicroBatchFrontend,
                                              replicated_session, run_open_loop)
    from repro_torch.serving.partitioned import PartitionedAnchoredIndex, PartitionedServer
    from repro_torch.serving.session import Session

    on_gpu = device != "cpu"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    probe = "kernel" if on_gpu else "torch"
    t_phase = time.perf_counter()
    out: dict = {"card_probe": probe}
    total: dict = {}

    def read() -> dict:
        """The launches since the last reset, added to the phase's total."""
        got = {k: n for k, n in launch_counts().items() if n}
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        return got

    try:
        queries = [q for _, q in batch] + rank_queries
        host = Session(built["idx"], positional=built["pidx"])
        want = host.execute(queries)

        # (1) the full non-positional index in shards
        and_at = [i for i, (k, _) in enumerate(batch) if k == "and"]
        and_q = [queries[i] for i in and_at]
        part: dict = {}
        for n_shards in FRONTIER_SHARDS:
            t0 = time.perf_counter()
            srv = PartitionedServer.from_index(built["idx"], n_shards=n_shards,
                                               device=device, probe=probe)
            sync()
            build_s = time.perf_counter() - t0
            cpu = PartitionedAnchoredIndex.from_index(built["idx"], n_shards=n_shards,
                                                      device="cpu")
            on_card = srv.pidx.step_arrays()
            require(set(on_card) == set(cpu.step_arrays()) and all(
                on_card[k].dtype == v.dtype and torch.equal(on_card[k].cpu(), v)
                for k, v in cpu.step_arrays().items()),
                f"shards={n_shards}: the arrays built for the card differ from a CPU build")
            sess = Session(built["idx"], server=srv)
            routes = [sess.plan(q).route for q in and_q]
            require(routes.count("device") == len(and_q),
                    f"shards={n_shards}: {routes.count('host')} AND queries routed to the host")
            reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            got = sess.execute(and_q)
            sync()
            first_s = time.perf_counter() - t0
            launches = read()
            windows = srv.windows_swept
            bad = _differ(and_q, got, [want[i] for i in and_at])
            require(not bad, f"shards={n_shards}: {len(bad)} AND answers differ from the "
                    f"host session's, first {bad[:3]}")
            expected = shard_probes(sess, and_q, {"nonpositional": srv})
            if on_gpu:
                require(launches == {"anchor_probe_sliced": expected},
                        f"shards={n_shards}: launched {launches}, expected "
                        f"{expected} anchor_probe_sliced")
            sync()
            t0 = time.perf_counter()
            sess.execute(and_q)
            sync()
            warm_s = time.perf_counter() - t0
            part[f"shards_{n_shards}"] = {
                "build_s": build_s, "arrays_equal_cpu_build": True,
                "max_nc": int(srv.pidx.arrays["anchors"].shape[1]),
                "expand_len": srv.pidx.expand_len, "device_bytes": srv.pidx.device_bytes(),
                "queries": len(and_q), "windows_swept": windows,
                "launches": launches, "expected_probe_launches": expected,
                "first_pass_s": first_s, "warm_pass_s": warm_s,
                "queries_per_s": len(and_q) / warm_s}
            del srv, sess, cpu, on_card
        out["partitioned"] = part

        # (2) the positional cut in 2 shards
        docs = built["docs"][:FRONTIER_CUT_DOCS]
        t0 = time.perf_counter()
        idx_cut = NonPositionalIndex.build(docs, store="repair_skip", mine_similarity=True,
                                           device=device)
        t1 = time.perf_counter()
        pidx_cut = PositionalIndex.build(docs, store="repair_skip")
        cut_build_s = {"build_nonpositional_mined_s": t1 - t0,
                       "build_positional_s": time.perf_counter() - t1}
        cut_batch = make_batch(docs, idx_cut, np.random.default_rng(args.seed + 4),
                               args.per_cell)
        cut_q = [q for _, q in cut_batch]
        host_cut = Session(idx_cut, positional=pidx_cut)
        want_cut = host_cut.execute(cut_q)
        phrase_at = [i for i, (k, _) in enumerate(cut_batch) if k == "phrase"]
        phrase_q = [cut_q[i] for i in phrase_at]
        t3 = time.perf_counter()
        psrv = PartitionedServer.from_index(pidx_cut, n_shards=2, device=device, probe=probe)
        sync()
        shard_s = time.perf_counter() - t3
        cut_at = int(psrv.pidx.doc_bounds[1])
        require(cut_at in set(np.asarray(pidx_cut.doc_starts).tolist()),
                f"the positional cut {cut_at} is not a document start")
        sess = Session(idx_cut, positional=pidx_cut, positional_server=psrv)
        reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        got = sess.execute(phrase_q)
        sync()
        first_s = time.perf_counter() - t0
        launches = read()
        windows = psrv.windows_swept
        bad = _differ(phrase_q, got, [want_cut[i] for i in phrase_at])
        require(not bad, f"positional shards: {len(bad)} phrase answers differ, first {bad[:3]}")
        expected = shard_probes(sess, phrase_q, {"positional": psrv})
        if on_gpu:
            require(launches == {"anchor_probe_sliced": expected},
                    f"positional shards: launched {launches}, expected {expected}")
        t0 = time.perf_counter()
        sess.execute(phrase_q)
        sync()
        warm_s = time.perf_counter() - t0
        out["positional_cut"] = {
            "reduced": f"the first {FRONTIER_CUT_DOCS} of the {len(built['docs'])} documents: "
                       f"the Python Re-Pair build of the positional shards bounds it",
            "documents": len(docs), "tokens": int(pidx_cut.n_tokens),
            **cut_build_s,
            "shard_build_s": shard_s, "doc_bounds": [int(b) for b in psrv.pidx.doc_bounds],
            "device_bytes": psrv.pidx.device_bytes(), "queries": len(phrase_q),
            "windows_swept": windows, "launches": launches,
            "expected_probe_launches": expected, "first_pass_s": first_s,
            "warm_pass_s": warm_s, "queries_per_s": len(phrase_q) / warm_s}
        # the cut and its phrase batch, for the mesh phase (main pops it)
        out["_mesh_cut"] = {"idx": idx_cut, "pidx": pidx_cut, "phrase": phrase_q,
                            "want": [want_cut[i] for i in phrase_at]}
        del psrv, sess

        # (3) replicas: fused over the full indexes, 2 x 2 shards over the cut
        rep: dict = {}
        t0 = time.perf_counter()
        rs = replicated_session(built["idx"], positional=built["pidx"], n_replicas=2,
                                n_shards=1, device=device, probe=probe)
        sync()
        build_s = time.perf_counter() - t0
        layouts = {r.server.layout for s in (rs.server, rs.positional_server)
                   for r in s._replicas}
        require(layouts == {"fused"}, f"replicas' layouts {layouts}")
        require("rank" in rs.server.kinds, f"replicated kinds {sorted(rs.server.kinds)}")
        reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        got = rs.execute(queries)
        sync()
        first_s = time.perf_counter() - t0
        launches = read()
        windows = sum(r.server.windows_swept for s in (rs.server, rs.positional_server)
                      for r in s._replicas)
        ranked_steps = sum(r.server.ranked_steps for r in rs.server._replicas)
        bad = _differ(queries, got, want)
        require(not bad, f"replicated (fused): {len(bad)} answers differ, first {bad[:3]}")
        if on_gpu:
            require(all(launches.get(k, 0) == windows for k in SERVE_KERNELS) and set(
                launches) <= set(SERVE_KERNELS), f"replicated (fused): {windows} windows, "
                f"launched {launches}")
        require(ranked_steps > 0, "no rank10: batch reached a replica")
        t0 = time.perf_counter()
        rs.execute(queries)
        sync()
        warm_s = time.perf_counter() - t0
        rep["fused_2x1"] = {"build_s": build_s, "queries": len(queries),
                            "windows_swept": windows, "ranked_steps": ranked_steps,
                            "launches": launches, "first_pass_s": first_s,
                            "warm_pass_s": warm_s, "queries_per_s": len(queries) / warm_s,
                            "replica_status": {"nonpositional": rs.server.replica_status(),
                                               "positional": rs.positional_server.replica_status()}}
        # a replica raises after doing its work for a group: the whole group
        # fails over to the other one, every answer unchanged
        victim_rep = rs.server._pick()
        victim = victim_rep.server
        real = victim.conjunctive
        fired = []

        def failing(qs, width=None):
            real(qs, width=width)
            fired.append(len(qs))
            raise RuntimeError("replica failed mid-batch (injected by chip_smoke.py)")

        victim.conjunctive = failing
        failovers0 = rs.server.failovers
        got = rs.execute(queries)
        sync()
        victim.conjunctive = real
        bad = _differ(queries, got, want)
        require(not bad, f"failover: {len(bad)} answers differ, first {bad[:3]}")
        require(len(fired) == 1 and rs.server.failovers == failovers0 + 1
                and not victim_rep.healthy, f"failover: fired {fired}, failovers "
                f"{rs.server.failovers - failovers0}, healthy {victim_rep.healthy}")
        rep["failover"] = {"failed_replica": victim_rep.name, "failed_group_queries": fired[0],
                           "failovers": rs.server.failovers - failovers0,
                           "answers_equal": True,
                           "replica_status": rs.server.replica_status()}
        del rs, victim, victim_rep, real
        t0 = time.perf_counter()
        rs = replicated_session(idx_cut, positional=pidx_cut, n_replicas=2, n_shards=2,
                                device=device, probe=probe)
        sync()
        build_s = time.perf_counter() - t0
        reset_launch_counts()
        t0 = time.perf_counter()
        got = rs.execute(cut_q)
        sync()
        first_s = time.perf_counter() - t0
        launches = read()
        windows = sum(r.server.windows_swept for s in (rs.server, rs.positional_server)
                      for r in s._replicas)
        bad = _differ(cut_q, got, want_cut)
        require(not bad, f"replicated 2 x 2 (cut): {len(bad)} answers differ, first {bad[:3]}")
        expected = shard_probes(rs, cut_q, {"nonpositional": rs.server._replicas[0].server,
                                            "positional": rs.positional_server._replicas[0].server})
        if on_gpu:
            require(launches == {"anchor_probe_sliced": expected},
                    f"replicated 2 x 2 (cut): launched {launches}, expected {expected}")
        t0 = time.perf_counter()
        rs.execute(cut_q)
        sync()
        warm_s = time.perf_counter() - t0
        rep["sharded_2x2_cut"] = {
            "build_s": build_s, "queries": len(cut_q),
            "device_routed": sum(rs.plan(q).route == "device" for q in cut_q),
            "windows_swept": windows, "launches": launches,
            "expected_probe_launches": expected, "first_pass_s": first_s,
            "warm_pass_s": warm_s, "queries_per_s": len(cut_q) / warm_s,
            "replica_status": {"nonpositional": rs.server.replica_status(),
                               "positional": rs.positional_server.replica_status()}}
        out["replicated"] = rep
        del rs, idx_cut, pidx_cut, host_cut

        # (4) the frontend over the fused card session
        fused = sessions["fused"]
        fe_out: dict = {"config": FRONTIER_CONFIG}

        def checked(label: str, results: list, allow_rejected: bool = False) -> int:
            rejected = sum(r is None for r in results)
            require(allow_rejected or rejected == 0, f"frontend {label}: {rejected} rejected")
            idx_ok = [i for i, r in enumerate(results) if r is not None]
            bad = [queries[i] for i in idx_ok if not np.array_equal(results[i], want[i])]
            require(not bad, f"frontend {label}: {len(bad)} answers differ, first {bad[:3]}")
            return rejected

        cfg = FrontendConfig(**FRONTIER_CONFIG)
        fe = MicroBatchFrontend(fused, cfg)
        reset_launch_counts()
        results, report = run_open_loop(fused, queries, 0.0, frontend=fe, seed=args.seed)
        sync()
        launches = read()
        checked("burst", results)
        fe_out["burst"] = {**_latency(report), "launches": launches,
                           "flushes": dict(fe.flushes), "batches": fe.batches,
                           "coalesced": fe.coalesced}
        if on_gpu:
            require(all(launches.get(k, 0) > 0 for k in SERVE_KERNELS),
                    f"frontend burst: launched {launches}")
        asyncio.run(fe.close())
        rate = report["achieved_qps"] / 2
        fe = MicroBatchFrontend(fused, cfg)
        results, report = run_open_loop(fused, queries, rate, frontend=fe, seed=args.seed + 1)
        checked("poisson", results)
        fe_out["poisson"] = {**_latency(report), "flushes": dict(fe.flushes),
                             "batches": fe.batches}
        served0 = fe.cache_served
        results, report = run_open_loop(fused, queries, 0.0, frontend=fe, seed=args.seed + 2)
        checked("warm", results)
        from_cache = fe.cache_served - served0
        require(from_cache == len(queries),
                f"frontend warm pass: {from_cache} of {len(queries)} answers from the cache")
        fe_out["warm"] = {**_latency(report), "from_cache": from_cache,
                          "session_metrics_frontend": fused.metrics()["frontend"]}
        asyncio.run(fe.close())
        fe = MicroBatchFrontend(fused, FrontendConfig(
            **{**FRONTIER_CONFIG, "max_pending": FRONTIER_OVERLOAD_PENDING}))
        results, report = run_open_loop(fused, queries, 0.0, frontend=fe, seed=args.seed + 3)
        rejected = checked("overload", results, allow_rejected=True)
        require(rejected > 0 and rejected == report["rejected"] == fe.rejected,
                f"frontend overload: {rejected} None results, report {report['rejected']}, "
                f"frontend {fe.rejected}")
        fe_out["overload"] = {**_latency(report), "max_pending": FRONTIER_OVERLOAD_PENDING,
                              "typed_rejections": fe.rejected}
        asyncio.run(fe.close())
        fused.frontend = None
        out["frontend"] = fe_out

        # (5) refresh through the frontend, beside the same sequence host-only
        wdir, wq = life["writer_dir"], life["writer_queries"]
        card = Session.open(wdir, device=device, probe=probe)
        host_seg = Session.open(wdir, device=device, attach=False)
        fes = {"card": MicroBatchFrontend(card, cfg), "host": MicroBatchFrontend(host_seg, cfg)}
        before = {k: run_open_loop(fe.session, wq, 0.0, frontend=fe)[0] for k, fe in fes.items()}
        require(not _differ(wq, before["card"], before["host"]),
                "refresh: the card frontend differs from the host-only one before the commit")
        writer = IndexWriter.open(wdir, device=device)
        new_docs = built["docs"][WRITER_DOCS:WRITER_DOCS + FRONTIER_REFRESH_DOCS]
        reset_launch_counts()
        t0 = time.perf_counter()
        writer.add_documents(new_docs)
        writer.commit()
        sync()
        commit_s = time.perf_counter() - t0
        commit_launches = read()
        t0 = time.perf_counter()
        opened = {k: asyncio.run(fe.refresh()) for k, fe in fes.items()}
        refresh_s = time.perf_counter() - t0
        caches = {k: fe.cache.metrics() for k, fe in fes.items()}
        counts = {k: (c["invalidated"], c["migrated"]) for k, c in caches.items()}
        require(opened["card"] == opened["host"] == 1 and counts["card"] == counts["host"],
                f"refresh: opened {opened}, (invalidated, migrated) {counts}")
        after = {k: run_open_loop(fe.session, wq, 0.0, frontend=fe)[0] for k, fe in fes.items()}
        cold = Session.open(wdir, device=device, attach=False).execute(wq)
        bad = _differ(wq, after["card"], after["host"]) + _differ(wq, after["card"], cold)
        require(not bad, f"refresh: {len(bad)} answers after the refresh differ, first {bad[:3]}")
        for fe in fes.values():
            asyncio.run(fe.close())
        out["refresh"] = {"writer_documents": WRITER_DOCS, "committed": len(new_docs),
                          "commit_s": commit_s, "commit_launches": commit_launches,
                          "refresh_s": refresh_s, "opened": opened["card"],
                          "queries": len(wq), "cache": caches["card"],
                          "host_cache": caches["host"], "answers_equal": True}
        del card, host_seg, fes, writer

        # (6) the serving driver, in-process
        from repro_torch.launch.serve import main as serve_main

        text = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            serve_main([*FRONTIER_DRIVER, "--device", device])
        sync()
        driver_s = time.perf_counter() - t0
        lines = text.getvalue().splitlines()
        agree = {}
        for label in ("host/planned", "host/frontend"):
            ln = [x for x in lines if x.startswith(f"{label} agreement")]
            require(len(ln) == 1, f"driver: no '{label} agreement' line in {lines[-5:]}")
            agreed, asked = ln[0].split(": ")[1].split()[0].split("/")
            require(agreed == asked, f"driver: {ln[0]}")
            agree[label] = ln[0]
        out["driver"] = {"argv": [*FRONTIER_DRIVER, "--device", device], "seconds": driver_s, "agreement": agree,
                         "launches": read(),
                         "lines": [x for x in lines if x.startswith(
                             ("planner", "frontend", "replicated"))]}
    finally:
        shutil.rmtree(LIFECYCLE_DIR, ignore_errors=True)
    out["launches"] = total  # summed over the sub-paths, each read around itself
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------------
# train phase: training on the card
# ----------------------------------------------------------------------
#: the LMs train at full width cut to TRAIN_LM_LAYERS layers, on train_4k's
#: 4,096 tokens a row, TRAIN_LM_BATCH rows in TRAIN_LM_MICRO micro-batches
#: (the registry's global batch of 256 is a pod's); the recsys models on the
#: registry's train_batch (65,536 rows), but two-tower on TRAIN_TT_ROWS rows
#: of TRAIN_TT_VOCAB-row tables (its in-batch softmax is B x B, and AdamW
#: state for its two 10 M-row tables would not fit the card); the GIN on the
#: training driver's graph (``launch.train.build_training``) with
#: TRAIN_GIN_SEEDS seed nodes.  Every step of a model trains on one fixed
#: batch, so that a falling loss checks the gradients' direction, not the data.
TRAIN_LM_LAYERS = 2
TRAIN_LM_BATCH, TRAIN_LM_SEQ, TRAIN_LM_MICRO = 2, 4096, 2
TRAIN_STEPS = {"qwen3-8b": 3, "moonshot-v1-16b-a3b": 3, "xdeepfm": 3, "fm": 1, "sasrec": 1,
               "two-tower-retrieval": 1, "gin-tu": 3}
TRAIN_TT_ROWS, TRAIN_TT_VOCAB = 16384, 1_000_000
TRAIN_RECSYS_ROWS = None  # None: the registry's train_batch
TRAIN_GIN_SEEDS = 512
#: the phase's optimiser: AdamW (the reference's other defaults) at lr 1e-5,
#: no warm-up: about the rate of the reference's schedule over its first
#: steps (3e-4 warmed up over 100 steps: 3e-6, 6e-6, 9e-6).  Adam's first
#: steps move every parameter by about lr in the sign of its gradient; at
#: 1e-5 that is a small first-order step, so the loss of the fixed batch
#: must fall (in bf16 only weights below ~0.003 move at all: their rounding
#: step is under 2e-5)
TRAIN_OPT = {"kind": "adamw", "lr": 1e-5, "warmup_steps": 0}
#: kernel path against plain path, per step: an LM's mean NLL moves by at
#: most twice the largest change of a logit (log-softmax is 2-Lipschitz in
#: the max norm), so 2 x LM_LOGIT_TOL; a float32 recsys loss (BCE, BPR or
#: in-batch softmax, at most 2-Lipschitz in the logits) within 2 x
#: RECSYS_LOGIT_REL of max(1, |loss|)
TRAIN_LM_LOSS_TOL = 2 * LM_LOGIT_TOL
TRAIN_RECSYS_LOSS_REL = 2 * RECSYS_LOGIT_REL
#: kernel path against plain path on the first step's gradients (at the
#: initial weights, accumulated as the step accumulates them): each leaf's
#: ||g_kernel - g_plain|| / ||g_plain|| at most this, by the model's dtype.
#: The loss limits above bound a whole step but see no wrong backward at lr
#: 1e-5.  These sit between the gaps of sound runs and those of the faults
#: that ``_planted`` plants (a wrong lse, a zeroed weight gradient), which
#: every run also measures and must find above the limit.  Readings on an
#: H100 at 700 W: sound bf16 LMs 0.0032 (qwen3-8b) and 0.0075 (moonshot's
#: router: a few top-k ties flip), float32 recsys 1.9e-6 (xDeepFM's CIN
#: sums in another order) or 0; every planted fault 0.987-1.0
TRAIN_GRAD_GAP = {"bfloat16": 0.05, "float32": 1e-4}
#: the attention backward, kernel forward against plain forward (the same
#: backward behind both): float32 gradients within ATTN_GRAD_F32_REL of the
#: tensor's largest |value| plus 1e-6 (out and lse differ within their
#: limits, ~1e-6 relative, and enter every p and delta); bf16 gradients within one bf16
#: step of the value (2^-7 |want| + 1e-5) plus 2^-9 of the tensor's largest
#: |value| (a p or dS one float32 ulp apart may round to the neighbouring
#: bf16 value before its product: one term of a sum moves by a bf16 step)
ATTN_GRAD_F32_REL = 1e-4
ATTN_GRAD_BF16 = (2.0 ** -7, 1e-5, 2.0 ** -9)
#: lse and gradient edge shapes (B, T, H, K, hd), T = S; each in bf16 (the
#: wgmma instance at hd 64 / 128, fma below) and float32 (fma)
TRAIN_ATTN_SHAPES = ((1, 1, 2, 2, 64), (2, 7, 8, 2, 128), (1, 100, 4, 4, 64),
                     (2, 300, 8, 2, 128), (1, 129, 4, 1, 16), (1, 257, 4, 4, 32))
#: cin_layer backward edge shapes (B, m, Hk, H, D) and the path's widths at
#: a cut row count (the plain autograd it is held against keeps every
#: chunk's outer product: 20 GB a layer at 65,536 rows)
CIN_GRAD_SHAPES = ((1, 1, 1, 1, 1), (3, 4, 6, 7, 1), (33, 5, 8, 41, 10))
CIN_GRAD_PATH_ROWS = 4096
TRAIN_CKPT_DIR = ROOT / "build" / "train_ckpt"


def lse_limit(q, k, lse, causal: bool):
    """Elementwise bound on |kernel lse - plain lse| (B, T, H): a score's
    float32 dot product over hd exact products (any order) is within
    2 gamma_hd of its |terms|' sum, and lse moves by at most the largest
    score change; l's sum over S keys adds 2 gamma_S relatively (log: that
    much absolutely); exp2 / log2 / the base-2 conversion add a few ulp,
    covered by 2^-20 (1 + |lse|)."""
    hd, s = q.shape[3], k.shape[1]
    g = q.shape[2] // k.shape[2]
    qa = q.float().abs() / math.sqrt(hd)
    ka = k.float().abs().repeat_interleave(g, dim=2)
    mag = torch.einsum("bthd,bshd->bhts", qa, ka)
    if causal:
        t = q.shape[1]
        mag = mag.masked_fill(torch.arange(s, device=q.device)[None, :]
                              > torch.arange(t, device=q.device)[:, None], 0.0)
    mag = mag.amax(dim=-1).transpose(1, 2)  # (B, T, H)
    return 2 * gamma(hd) * mag + 2 * gamma(s) + 2.0 ** -20 * (1 + lse.abs())


def _grad_limit(want: torch.Tensor) -> torch.Tensor:
    w = want.float()
    if want.dtype == torch.float32:  # plus a floor for gradients that are 0 (T = 1)
        return torch.full_like(w, ATTN_GRAD_F32_REL * float(w.abs().max()) + 1e-6)
    rel, floor, slack = ATTN_GRAD_BF16
    return rel * w.abs() + floor + slack * float(w.abs().max())


def attention_train_rows(rows: list, shape: dict, q, k, v, causal: bool, grads: bool) -> None:
    """``flash_attention_tpu(..., return_lse=True)`` against its plain
    version: out within ``ATTENTION_TOL``, lse within :func:`lse_limit`, and
    under causal row 0's lse (one live key) against that key's score; with
    ``grads``, ``models.flash.FlashAttention`` (the reference's VJP) over the
    kernel's forward against the same over the plain forward on
    one output gradient: dq / dk / dv within :func:`_grad_limit`."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention_route,
                                                         flash_attention_torch,
                                                         flash_attention_tpu,
                                                         flash_attention_tpu_fwd)
    from repro_torch.models.flash import FlashAttention

    route = flash_attention_route(q, k, v)
    out, lse = flash_attention_tpu(q, k, v, causal, return_lse=True)
    p_out, p_lse = flash_attention_torch(q, k, v, causal, return_lse=True)
    _attention_row(rows, "flash_attention_tpu", {**shape, "causal": causal, "lse": True}, out,
                   p_out, route)
    limit = lse_limit(q, k, p_lse, causal)
    diff = (lse - p_lse).abs()
    used = float((diff / limit).max())
    row = rows[-1]
    row.update(lse_max_abs_err=float(diff.max()), lse_limit_used=used)
    row["within_tolerance"] = row["within_tolerance"] and used <= 1.0 and bool(
        torch.isfinite(lse).all())
    if causal:  # row 0 sees key 0 alone: its lse is that scaled score
        g = q.shape[2] // k.shape[2]
        score = (q[:, 0].float() * k[:, 0].float().repeat_interleave(g, dim=1)).sum(-1) \
            / math.sqrt(q.shape[3])
        one = float(((lse[:, 0] - score).abs() / limit[:, 0]).max())
        row["one_key_limit_used"] = one
        row["within_tolerance"] = row["within_tolerance"] and one <= 1.0
    if not grads:
        return
    blk = min(1024, q.shape[1])
    gen = torch.Generator(device=q.device).manual_seed(q.shape[1])
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    got, want = [], []
    for fwd, sink in ((flash_attention_tpu_fwd, got), (None, want)):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        FlashAttention.apply(*xs, causal, blk, fwd).backward(dout)
        sink.extend(x.grad for x in xs)
        del xs
    used = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        used[name] = float(((a.float() - b.float()).abs() / _grad_limit(b)).max())
    row.update(grad_limit_used=used)
    row["within_tolerance"] = row["within_tolerance"] and max(used.values()) <= 1.0


def train_attention_pieces(dev, seed: int) -> list[dict]:
    """Row 7's log-sum-exp and the attention gradients at edge shapes (both
    instances, T not a multiple of a tile, T = 1, GQA groups 1 and 4,
    causal and not) and at the two LM paths' layer shapes (qwen3-8b 32 / 8
    heads, moonshot 16 / 16, hd 128, T = 4,096, bf16: wgmma)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows: list = []
    for b, t, h, kh, hd in TRAIN_ATTN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(s, generator=g, device=dev).to(dtype)
                       for s in ((b, t, h, hd), (b, t, kh, hd), (b, t, kh, hd)))
            for causal in (True, False):
                attention_train_rows(rows, {"B": b, "T": t, "H": h, "K": kh, "hd": hd}, q, k, v,
                                     causal, grads=causal)
    for name, h, kh in (("qwen3-8b", 32, 8), ("moonshot-v1-16b-a3b", 16, 16)):
        q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                   for s in ((1, TRAIN_LM_SEQ, h, 128), (1, TRAIN_LM_SEQ, kh, 128),
                             (1, TRAIN_LM_SEQ, kh, 128)))
        attention_train_rows(rows, {"at": f"train/{name} layer", "B": 1, "T": TRAIN_LM_SEQ,
                                    "H": h, "K": kh, "hd": 128}, q, k, v, True, grads=True)
        del q, k, v
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    return rows


def lse_timing(dev, reps: int) -> dict:
    """The qwen3-8b prefill layer's attention (4 x 2,048 tokens, 32 / 8
    heads, hd 128, bf16: wgmma) with the log-sum-exp off and on, in turns."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_tpu

    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
               for s in ((LM_BATCH, LM_PROMPT, 32, 128), (LM_BATCH, LM_PROMPT, 8, 128),
                         (LM_BATCH, LM_PROMPT, 8, 128)))
    off = lambda: flash_attention_tpu(q, k, v, True)  # noqa: E731
    on = lambda: flash_attention_tpu(q, k, v, True, return_lse=True)  # noqa: E731
    times = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        times[which].append(time_ms(off if which == "off" else on, reps))
    return {"shape": {"B": LM_BATCH, "T": LM_PROMPT, "H": 32, "K": 8, "hd": 128},
            "ms_lse_off": times["off"], "ms_lse_on": times["on"]}


def train_model_pieces(dev, seed: int, reps: int) -> tuple[list, dict]:
    """The gradient pieces of rows 9, 10, 11 on the card against their plain
    versions: ``moe_gemm``'s two backward products (edge shapes, ragged and
    small C, and moonshot's: E 64, C 480, D 2,048, F 1,408, bf16) within 2
    gamma_n, those at the path timed; ``embedding_bag``'s table gradient
    (xDeepFM's two lookups at 65,536 rows, and an edge case with repeated
    ids and ids outside the table) bit for bit against the same ordered
    scatter on the CPU; ``cin_layer``'s dx0 / dxk / dw (``CinLayer``, kernel
    forward) against autograd through the plain layer, within 2 gamma_n
    of the same on |inputs|."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipelines import recsys_batches
    from repro_torch.kernels.cin_interaction.ops import CinLayer, cin_layer_backward, cin_layer_torch
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_backward
    from repro_torch.models.recsys import field_offsets

    g = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    rows: list = []
    timed: dict = {}
    # moe_gemm: dbuf = dout @ w^T, dw = buf^T @ dout
    moe = get_config(MOE_CONFIG)
    e, f, d = moe.moe.n_experts, moe.moe.d_ff_expert, moe.d_model
    cap = math.ceil(TRAIN_LM_SEQ * moe.moe.top_k / e * 1.25)
    for (e_, c_, d_, f_), at in (((3, 33, 24, 40), None), ((2, 5, 64, 72), None),
                                 ((e, cap, d, f), "w_gate"), ((e, cap, f, d), "w_down")):
        buf, w = randn(e_, c_, d_).to(torch.bfloat16), randn(e_, d_, f_).to(torch.bfloat16)
        dout = randn(e_, c_, f_).to(torch.bfloat16)
        for which, args in (("dbuf", (dout, w.transpose(1, 2).contiguous())),
                            ("dw", (buf.transpose(1, 2).contiguous(), dout))):
            name = f"train/moonshot backward {which}, {at}" if at else f"backward {which}"
            r = model_kernel_at_path("moe_gemm", args, name, reps, timed=bool(at))
            rows.append(r)
            if at:
                timed[name] = r
        del buf, w, dout
    # embedding_bag: the table gradient, card against CPU, bit for bit
    cfg = get_config(RECSYS_CONFIG)
    fields = torch.from_numpy(next(recsys_batches(cfg, 65536, seed=seed))["fields"]).to(dev)
    ids = (fields + torch.from_numpy(field_offsets(cfg)[:-1]).to(dev)).to(torch.int32)
    v = int(field_offsets(cfg)[-1])
    edge = torch.randint(0, 9, (40, 3), generator=g, device=dev, dtype=torch.int32)
    edge[3, 1] = 12
    for at, idx, n_rows, bag, width in (("edge (repeated ids, one outside)", edge, 10, 3, 4),
                                        ("train/xdeepfm x0 lookup", ids.reshape(-1), v, 1, 10),
                                        ("train/xdeepfm linear", ids, v, 39, 1)):
        n_bags = idx.numel() // bag
        dout = randn(n_bags, width)
        got = embedding_bag_backward(idx, dout, n_rows, bag)
        want = embedding_bag_backward(idx.cpu(), dout.cpu(), n_rows, bag)
        same = bool(torch.equal(got.cpu(), want))
        rows.append({"kernel": "embedding_bag", "backward": True, "at": at,
                     "shape": {"n_bags": n_bags, "bag": bag, "V": n_rows, "D": width},
                     "max_abs_err": float((got.cpu() - want).abs().max()),
                     "within_tolerance": same})
        if at.startswith("train/"):
            ms = time_ms(lambda: embedding_bag_backward(idx, dout, n_rows, bag), 5)
            timed[at] = {"backward_ms": ms}
        del got, want, dout
    # cin_layer: CinLayer (kernel forward, chunked backward) against autograd
    # through the plain layer
    m, k_ = cfg.n_fields, cfg.embed_dim
    shapes = list(CIN_GRAD_SHAPES) + [(CIN_GRAD_PATH_ROWS, m, m, cfg.cin_layers[0], k_),
                                      (CIN_GRAD_PATH_ROWS, m, cfg.cin_layers[0],
                                       cfg.cin_layers[1], k_)]
    for bb, mm, hk, hh, dd in shapes:
        x0, xk, w = randn(bb, mm, dd), randn(bb, hk, dd), randn(mm * hk, hh)
        dout = randn(bb, hh, dd)
        xs = [t.clone().requires_grad_(True) for t in (x0, xk, w)]
        CinLayer.apply(*xs).backward(dout)
        ys = [t.clone().requires_grad_(True) for t in (x0, xk, w)]
        cin_layer_torch(*ys).backward(dout)
        mag = cin_layer_backward(x0.abs(), xk.abs(), w.abs(), dout.abs())
        ns = (hh + hk + 2, hh + mm + 2, bb * dd + 2)
        used = {name: float(((a.grad - b.grad).abs() / (2 * gamma(n) * lim).clamp(min=1e-38))
                            .max()) for name, a, b, lim, n in zip(("dx0", "dxk", "dw"), xs, ys,
                                                                  mag, ns)}
        rows.append({"kernel": "cin_layer", "backward": True,
                     "shape": {"B": bb, "m": mm, "Hk": hk, "H": hh, "D": dd},
                     "max_abs_err": max(float((a.grad - b.grad).abs().max())
                                        for a, b in zip(xs, ys)),
                     "limit_used": max(used.values()), "limit_used_by_grad": used,
                     "within_tolerance": max(used.values()) <= 1.0})
        del xs, ys, mag, x0, xk, w, dout
    return rows, timed


def _clone_params(model) -> dict:
    from repro_torch.train.optimizer import param_tree

    return {k: p.detach().clone() for k, p in param_tree(model).items()}


@torch.no_grad()
def _load_params(model, values: dict) -> None:
    from repro_torch.train.optimizer import param_tree

    for k, p in param_tree(model).items():
        p.copy_(values[k])


TRAIN_KERNELS = ("flash_attention_tpu", "embedding_bag", "cin_layer", "moe_gemm")


def _train_launches() -> dict:
    from repro_torch.kernels.flash_attention.ops import flash_attention_tpu
    from repro_torch.kernels.moe_gemm.ops import moe_gemm

    counts = {k: v for k, v in launch_counts().items() if k in TRAIN_KERNELS}
    counts.update(flash_attention_tpu_lse=flash_attention_tpu.launches_lse,
                  moe_gemm_backward=moe_gemm.launches_backward)
    return counts


def train_steps(state, step_fn, batch, n: int, dev) -> tuple:
    """``n`` steps of ``step_fn`` on ``batch``, each with the launch counts
    set to 0 just before it and read just after: losses, wall ms (the host
    waits for the step's loss), the CUDA-event span of the step on the
    device, launches and routes by step."""
    on_gpu = dev.type == "cuda"
    out = {"loss": [], "wall_ms": [], "device_span_ms": [], "launches": [], "routes": []}
    for _ in range(n):
        reset_launch_counts()
        routes0 = route_counts()
        if on_gpu:
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if on_gpu:
            b.record()
        loss = float(metrics["loss"])  # waits for the step
        if on_gpu:
            torch.cuda.synchronize()
        out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        out["device_span_ms"].append(a.elapsed_time(b) if on_gpu else None)
        out["loss"].append(loss)
        out["launches"].append(_train_launches())
        diff = route_diff(route_counts(), routes0)
        out["routes"].append({k: {r: n for r, n in diff[k].items() if n}
                              for k in ("flash_attention_tpu", "moe_gemm", "embedding_bag")})
    return state, out


def train_one_model(name: str, params, step_fns: tuple, batch: dict, n: int, dev,
                    plain_ctx=None) -> dict:
    """``n`` kernel-path steps of ``params`` on ``batch``, then ``n``
    plain-path steps from the same weights (cloned before the first step: a
    step updates in place) and a fresh optimiser state; both paths' losses
    and launches, peak memory."""
    from repro_torch.models import steps
    from repro_torch.train.optimizer import OptConfig

    opt = OptConfig(**TRAIN_OPT)
    kernel_step, plain_step = step_fns
    init = _clone_params(params)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    state, kernel = train_steps(steps.init_state(params, opt), kernel_step, batch, n, dev)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    del state
    _load_params(params, init)
    del init
    plain = None
    if plain_step is not None:
        with plain_ctx() if plain_ctx else contextlib.nullcontext():
            state, plain = train_steps(steps.init_state(params, opt), plain_step, batch, n, dev)
        del state
    return {"model": name, "steps": n, "kernel_path": kernel, "plain_path": plain,
            "peak_memory_bytes": peak,
            "n_params": sum(p.numel() for p in params.parameters())}


#: what the train phase found wrong, gathered so that one run reports all
TRAIN_FAILURES: list = []


def _train_check(cond: bool, what: str) -> None:
    if not cond:
        TRAIN_FAILURES.append(what)


def _check_train(r: dict, kernels: tuple, tol) -> None:
    """Losses finite and falling on the kernel path (for more than one
    step), each listed kernel launched on every kernel-path step and no
    kernel of the four on a plain-path step, and the two paths' losses
    within ``tol(loss)``."""
    k, p = r["kernel_path"], r["plain_path"]
    name = r["model"]
    _train_check(all(math.isfinite(x) for x in k["loss"]), f"train {name}: a loss is not finite")
    if r["steps"] > 1:
        _train_check(k["loss"][-1] < k["loss"][0], f"train {name}: loss {k['loss']} did not fall")
    for step in k["launches"]:
        for kern in kernels:
            _train_check(step[kern] > 0, f"train {name}: {kern} was not launched in a step: {step}")
    if p is not None:
        for step in p["launches"]:
            _train_check(all(step[kern] == 0 for kern in TRAIN_KERNELS),
                    f"train {name}: the plain path launched a kernel: {step}")
        diffs = [abs(a - b) for a, b in zip(k["loss"], p["loss"])]
        r["loss_diff"] = diffs
        r["loss_limit"] = [tol(x) for x in p["loss"]]
        _train_check(all(d <= tol(x) for d, x in zip(diffs, p["loss"])),
                f"train {name}: kernel and plain losses differ by {diffs}")


@contextlib.contextmanager
def _planted(fault: str):
    """For the time of the block, the kernel path's backward carries
    ``fault``: ``lse_base2`` (the attention residual in base 2, as the
    kernel keeps its running state, without the ln 2 factor),
    ``moe_dw_zero`` / ``cin_dw_zero`` (the weight gradient of ``MoeGemm`` /
    ``CinLayer`` dropped), ``table_grad_zero`` (``EmbeddingBag``'s table
    gradient dropped)."""
    from unittest import mock

    from repro_torch.kernels.cin_interaction.ops import CinLayer
    from repro_torch.kernels.embedding_bag.ops import EmbeddingBag
    from repro_torch.kernels.flash_attention.ops import flash_attention_tpu_fwd
    from repro_torch.kernels.moe_gemm.ops import MoeGemm
    from repro_torch.models import transformer

    def zeroed(fn, i):
        def backward(ctx, *douts):
            grads = list(fn(ctx, *douts))
            grads[i] = None if grads[i] is None else torch.zeros_like(grads[i])
            return tuple(grads)
        return staticmethod(backward)

    def base2(q, k, v, causal, block_kv):
        out, lse = flash_attention_tpu_fwd(q, k, v, causal, block_kv)
        return out, lse / math.log(2.0)

    patch = {"lse_base2": lambda: mock.patch.object(transformer, "flash_attention_tpu_fwd",
                                                    base2),
             "moe_dw_zero": lambda: mock.patch.object(MoeGemm, "backward",
                                                      zeroed(MoeGemm.backward, 1)),
             "cin_dw_zero": lambda: mock.patch.object(CinLayer, "backward",
                                                      zeroed(CinLayer.backward, 2)),
             "table_grad_zero": lambda: mock.patch.object(EmbeddingBag, "backward",
                                                          zeroed(EmbeddingBag.backward, 1))}
    with patch[fault]():
        yield


def train_grad_check(name: str, grads, plain_grads, faults: tuple, limit: float) -> dict:
    """The first step's gradients ``{leaf: tensor}``, ``grads()`` on the
    kernel path against ``plain_grads()``: each leaf's relative L2 gap
    within ``limit``; then ``grads()`` under each planted fault of
    ``faults`` (see :func:`_planted`), whose largest gap must exceed the
    limit, so that the check is seen to catch a wrong backward in this run.
    Launches here are comparisons: the steps count theirs anew."""
    want = plain_grads()

    def gaps(got: dict) -> dict:
        out = {}
        for k, g in got.items():
            num = float(torch.linalg.vector_norm(g.float() - want[k].float()))
            den = float(torch.linalg.vector_norm(want[k].float()))
            out[k] = num / den if den > 0 else (0.0 if num == 0 else math.inf)
        return out

    sound = gaps(grads())
    worst = max(sound, key=sound.get)
    r = {"limit": limit, "max_gap": sound[worst], "leaf": worst, "gaps": sound,
         "planted": {}}
    _train_check(sound[worst] <= limit,
                 f"train {name}: gradient of {worst} off the plain path's by {sound[worst]}")
    for fault in faults:
        with _planted(fault):
            g = gaps(grads())
        w = max(g, key=g.get)
        r["planted"][fault] = {"max_gap": g[w], "leaf": w}
        _train_check(g[w] > limit,
                     f"train {name}: planted {fault} left every gradient within "
                     f"{limit} (largest {g[w]} at {w})")
    return r


def _free(dev) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def train_lm(name: str, args, dev, checkpoint: bool = False) -> dict:
    """``name`` at full width, ``TRAIN_LM_LAYERS`` layers, bf16: the
    kernel path (attention through ``FlashAttention`` over the kernel's
    forward, MoE products
    through ``MoeGemm``) against the plain path (``attention="torch"``);
    every attention launch must write the log-sum-exp and take ``wgmma``,
    every ``moe_gemm`` launch too.  With ``checkpoint``, then
    :func:`train_checkpoint` on the model."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipelines import lm_batches
    from repro_torch.models import steps, transformer
    from repro_torch.train.optimizer import OptConfig

    cfg = dataclasses.replace(get_config(name), n_layers=TRAIN_LM_LAYERS)
    opt = OptConfig(**TRAIN_OPT)
    t0 = time.perf_counter()
    params = steps.init_model_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             next(lm_batches(cfg, TRAIN_LM_BATCH, TRAIN_LM_SEQ, seed=args.seed)).items()}
    fns = (steps.make_lm_train_step(cfg, opt, n_micro=TRAIN_LM_MICRO),
           steps.make_lm_train_step(cfg, opt, n_micro=TRAIN_LM_MICRO, attention="torch"))

    def grads_of(attention):
        def loss(p, bt):
            return transformer.loss_fn(cfg, p, bt["tokens"], bt["targets"], attention=attention)
        return lambda: steps._accum_grads(loss, params, batch, TRAIN_LM_MICRO)[2]

    grad_check = train_grad_check(name, grads_of(None), grads_of("torch"), (
        "lse_base2",) + (("moe_dw_zero",) if cfg.moe else ()), TRAIN_GRAD_GAP[cfg.dtype])
    _free(dev)
    r = train_one_model(name, params, fns, batch, TRAIN_STEPS[name], dev)
    r["grad_check"] = grad_check
    r.update(layers=cfg.n_layers, tokens_per_step=TRAIN_LM_BATCH * TRAIN_LM_SEQ,
             n_micro=TRAIN_LM_MICRO, dtype=cfg.dtype, seconds=time.perf_counter() - t0)
    kernels = ("flash_attention_tpu", "flash_attention_tpu_lse") + (
        ("moe_gemm", "moe_gemm_backward") if cfg.moe else ())
    _check_train(r, kernels, lambda loss: TRAIN_LM_LOSS_TOL)
    for step in r["kernel_path"]["launches"]:
        _train_check(step["flash_attention_tpu_lse"] == step["flash_attention_tpu"]
                == TRAIN_LM_LAYERS * TRAIN_LM_MICRO,
                f"train {name}: attention launches {step}, expected one with lse a layer a "
                f"micro-batch")
    if dev.type == "cuda":
        for routes in r["kernel_path"]["routes"]:
            _train_check(set(routes["flash_attention_tpu"]) == {"wgmma"}
                    and set(routes["moe_gemm"]) <= {"wgmma"},
                    f"train {name}: a launch off the tensor-core routes: {routes}")
    if checkpoint:
        r["checkpoint"] = train_checkpoint(params, cfg, fns[0], batch, dev)
    del params
    return r


def train_recsys(name: str, args, dev) -> dict:
    """``name`` (float32) on one ``recsys_batches`` batch of the registry's
    train_batch rows (two-tower cut, see ``TRAIN_TT_ROWS``): the kernel path
    against the plain path (this module's ``recsys_kernels(plain=True)``:
    the lookups and the CIN run their plain versions under the same
    autograd Functions)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipelines import recsys_batches
    from repro_torch.models import steps
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config(name)
    rows = TRAIN_RECSYS_ROWS or cfg.shapes["train_batch"].dims["batch"]
    if name == "two-tower-retrieval":
        cfg = dataclasses.replace(cfg, n_users=TRAIN_TT_VOCAB, n_items=TRAIN_TT_VOCAB)
        rows = TRAIN_TT_ROWS
    opt = OptConfig(**TRAIN_OPT)
    t0 = time.perf_counter()
    params = steps.init_model_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(recsys_batches(cfg, rows, seed=args.seed)).items()}
    step = steps.make_recsys_train_step(cfg, opt)

    def grads():
        return steps._grads(lambda p, bt: steps._recsys_loss(cfg, p, bt), params, batch)[2]

    def plain_grads():
        with recsys_kernels(plain=True):
            return grads()

    grad_check = train_grad_check(name, grads, plain_grads, ("table_grad_zero",) + (
        ("cin_dw_zero",) if cfg.interaction == "cin" else ()), TRAIN_GRAD_GAP["float32"])
    _free(dev)
    r = train_one_model(name, params, (step, step), batch, TRAIN_STEPS[name], dev,
                        plain_ctx=lambda: recsys_kernels(plain=True))
    r["grad_check"] = grad_check
    r.update(rows=rows, seconds=time.perf_counter() - t0)
    if name == "two-tower-retrieval":
        r["cut"] = f"tables of {TRAIN_TT_VOCAB} rows (10,000,000 in the registry)"
    kernels = ("embedding_bag", "cin_layer") if cfg.interaction == "cin" else ("embedding_bag",)
    _check_train(r, kernels, lambda loss: TRAIN_RECSYS_LOSS_REL * max(1.0, abs(loss)))
    del params
    return r


def train_gin(args, dev) -> dict:
    """The GIN on the training driver's graph (2,000 nodes, degree 8, 32
    features, 5 classes) with ``TRAIN_GIN_SEEDS`` seeds of fanout (10, 5):
    no kernel of the table; the losses must fall and no kernel launch."""
    from repro_torch.configs import get_config
    from repro_torch.data import graphs
    from repro_torch.models import gnn, steps
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config("gin-tu")
    t0 = time.perf_counter()
    g = graphs.synthetic_graph(2000, 8, 32, 5, args.seed)
    params = gnn.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), 32, 5, dev)
    batch = next(graphs.graph_batches(g, TRAIN_GIN_SEEDS, (10, 5), args.seed))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    opt = OptConfig(**TRAIN_OPT)
    r = train_one_model("gin-tu", params, (steps.make_gnn_train_step(cfg, opt), None),
                        batch, TRAIN_STEPS["gin-tu"], dev)
    r.update(nodes=int(batch["node_feat"].shape[0]), edges=int(batch["edge_src"].shape[0]),
             seconds=time.perf_counter() - t0)
    _check_train(r, (), None)
    _train_check(all(all(v == 0 for v in step.values()) for step in r["kernel_path"]["launches"]),
            "train gin-tu: a kernel launched (the GIN has none)")
    return r


def train_driver(dev) -> dict:
    """``repro_torch.launch.train.main`` in-process: xDeepFM at full size,
    4 steps with a checkpoint every 2, then the same command again, which
    resumes from step 4."""
    import shutil

    from repro_torch.launch import train as launch_train

    d = TRAIN_CKPT_DIR / "driver"
    shutil.rmtree(d, ignore_errors=True)
    argv = ["--arch", RECSYS_CONFIG, "--steps", "4", "--ckpt-every", "2", "--ckpt-dir", str(d),
            "--batch", "4096", "--device", dev.type]
    t0 = time.perf_counter()
    reset_launch_counts()
    first = launch_train.main(argv)
    launches = _train_launches()
    second = launch_train.main(argv)
    steps_on_disk = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
    _train_check([r["step"] for r in first] == [0, 1, 2, 3] and [r["step"] for r in second]
            == [4, 5, 6, 7], "launch.train did not resume from step 4")
    _train_check(steps_on_disk == [4, 6, 8], f"launch.train kept steps {steps_on_disk}")
    _train_check(launches["embedding_bag"] > 0 and launches["cin_layer"] > 0,
            f"launch.train launched {launches}")
    shutil.rmtree(d, ignore_errors=True)
    return {"argv": argv, "losses": [r["loss"] for r in first + second],
            "steps_on_disk": steps_on_disk, "launches_first_run": launches,
            "seconds": time.perf_counter() - t0}


def train_checkpoint(params, cfg, step_fn, batch: dict, dev) -> dict:
    """The bf16 qwen3-8b state (``TRAIN_LM_LAYERS`` layers, one train step
    of ``step_fn`` on ``batch`` from a fresh AdamW state, so that m and v
    hold values) saved with the port's Checkpointer, restored into the same
    tensors zeroed:
    every leaf equal bit for bit; its manifest opened again and held, from
    the manifest alone, against what the reference's Checkpointer writes
    for this state (:func:`expected_lm_manifest`: keys in its order,
    shapes, dtypes)."""
    import shutil

    from repro_torch.checkpoint.checkpointer import Checkpointer, flatten
    from repro_torch.models import steps
    from repro_torch.train.optimizer import OptConfig

    opt = OptConfig(**TRAIN_OPT)
    state, _ = step_fn(steps.init_state(params, opt), batch)
    d = TRAIN_CKPT_DIR / "lm"
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    Checkpointer(str(d), async_save=False).save(1, state)
    t1 = time.perf_counter()
    want = {k: v.detach().clone() for k, v in flatten(state).items()}
    with torch.no_grad():
        for v in flatten(state).values():
            v.zero_()
    t2 = time.perf_counter()
    restored, step = Checkpointer(str(d)).restore(state)
    torch.cuda.synchronize() if dev.type == "cuda" else None
    t3 = time.perf_counter()
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t  # noqa: E731
    differ = [k for k, v in flatten(restored).items() if not torch.equal(bits(v), bits(want[k]))]
    manifest = json.loads((d / "step_0000000001" / "manifest.json").read_text())
    leaves = {k: (r["shape"], r["dtype"]) for k, r in manifest["leaves"].items()}
    expected = expected_lm_manifest(cfg, cfg.n_layers)
    size = sum(p.stat().st_size for p in (d / "step_0000000001").iterdir())
    shutil.rmtree(d, ignore_errors=True)
    _train_check(step == 1 and not differ, f"checkpoint: {len(differ)} leaves differ after restore, "
                                      f"first {differ[:3]}")
    _train_check(list(leaves) == list(expected) and leaves == expected,
            "checkpoint: the manifest differs from the reference's layout")
    return {"leaves": len(leaves), "bytes": size, "save_s": t1 - t0, "restore_s": t3 - t2,
            "bit_equal": True, "manifest_as_reference": True}


def _qwen_leaves(cfg, n_layers: int) -> dict:
    """The reference's qwen3-8b parameter leaves and shapes
    (``repro.models.transformer.init_params``: qk-norm on, embeddings
    untied), written out here from its layout (no JAX on the card)."""
    d, hd, h, kh, f, v = (cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
                          cfg.vocab_size)
    layers = {"attn_norm": (d,), "ffn_norm": (d,), "k_norm": (hd,), "q_norm": (hd,),
              "w_down": (f, d), "w_gate": (d, f), "w_up": (d, f), "wk": (d, kh * hd),
              "wo": (h * hd, d), "wq": (d, h * hd), "wv": (d, kh * hd)}
    out = {"embed": [v, d], "final_norm": [d], "lm_head": [d, v]}
    out.update({f"layers/{k}": [n_layers, *s] for k, s in layers.items()})
    return out


def expected_lm_manifest(cfg, n_layers: int) -> dict:
    """path -> (shape, dtype) of an AdamW train state of the bf16 qwen3-8b,
    in the reference's leaf order (jax sorts dict keys at every level:
    ``opt/m/...``, ``opt/step``, ``opt/v/...``, ``params/...``, ``step``)."""
    leaves = _qwen_leaves(cfg, n_layers)
    names = sorted(leaves)  # embed < final_norm < layers/... < lm_head
    out = {f"opt/m/{k}": (leaves[k], "float32") for k in names}
    out["opt/step"] = ([], "int32")
    out.update({f"opt/v/{k}": (leaves[k], "float32") for k in names})
    out.update({f"params/{k}": (leaves[k], "bfloat16") for k in names})
    out["step"] = ([], "int32")
    return out


def train_phase(args, dev) -> dict:
    """The train phase: the kernel pieces against their plain versions,
    then the training steps of every family, the driver and the
    checkpointer (see the module docstring)."""
    t0 = time.perf_counter()
    attn = train_attention_pieces(dev, args.seed)
    lse_ms = lse_timing(dev, args.reps) if dev.type == "cuda" else None
    pieces, timed = train_model_pieces(dev, args.seed, args.reps)
    bad = [r for r in attn + pieces if not r["within_tolerance"]]
    emit("train_pieces", rows=len(attn) + len(pieces), outside_limits=bad,
         attention=[r for r in attn if r["dtype"] == "bfloat16" or "at" in r["shape"]],
         model_kernels=pieces, lse_timing=lse_ms, seconds=time.perf_counter() - t0)
    require(not bad, f"{len(bad)} train pieces outside their limits, first {bad[:2]}")
    _free(dev)
    t1 = time.perf_counter()
    models = []
    for name in (LM_CONFIG, MOE_CONFIG):
        models.append(train_lm(name, args, dev, checkpoint=name == LM_CONFIG))
        _free(dev)
    for name in (RECSYS_CONFIG, *RECSYS_OTHERS):
        models.append(train_recsys(name, args, dev))
        _free(dev)
    models.append(train_gin(args, dev))
    _free(dev)
    t2 = time.perf_counter()
    driver = train_driver(dev)
    _free(dev)
    by_kernel = lambda key: {k: max((r[key] for r in attn + pieces  # noqa: E731
                                     if r["kernel"] == k and key in r), default=None)
                             for k in TRAIN_KERNELS}
    return {"pieces": {"rows": len(attn) + len(pieces), "max_abs_err": by_kernel("max_abs_err"),
                       "limit_used": by_kernel("limit_used"),
                       "lse_limit_used": max(r.get("lse_limit_used", 0.0) for r in attn),
                       "one_key_limit_used": max(r.get("one_key_limit_used", 0.0) for r in attn),
                       "grad_limit_used": {g: max(r["grad_limit_used"][g] for r in attn
                                                  if "grad_limit_used" in r)
                                           for g in ("dq", "dk", "dv")},
                       "attention_at_path": [r for r in attn if "at" in r["shape"]],
                       "timed": timed, "lse_timing": lse_ms},
            "models": models, "checkpoint": models[0].pop("checkpoint"), "driver": driver,
            "tolerance": {"lm_loss_abs": TRAIN_LM_LOSS_TOL,
                          "recsys_loss_rel": TRAIN_RECSYS_LOSS_REL,
                          "grad_gap": TRAIN_GRAD_GAP,
                          "attention_grad": {"float32_of_max": ATTN_GRAD_F32_REL,
                                             "bfloat16": ATTN_GRAD_BF16},
                          "lse": "2 gamma_hd max_s |q||k| scale + 2 gamma_S + 2^-20 (1 + |lse|)",
                          "moe_gemm_backward": "2 gamma(inner + 1) x plain(|a|, |b|)",
                          "cin_layer_backward": "2 gamma_n x the same on |inputs|",
                          "embedding_bag_backward": 0},
            "pieces_s": t1 - t0, "models_s": t2 - t1, "phase_s": time.perf_counter() - t0,
            "failures": list(TRAIN_FAILURES)}


# ----------------------------------------------------------------------
# the mesh tier: NCCL with a world of one on the card
# ----------------------------------------------------------------------
MESH_SHARDS = 4  # the partitioned server's shards, all on the one rank's data axis
MESH_LMS = (LM_CONFIG, MOE_CONFIG)  # at the train phase's depth, tokens and rate
MESH_PSUM_LEAVES = ("layers/wq", "final_norm")  # a large leaf and a 1-D leaf
MESH_TOPK_FRAC = 0.01
MESH_STATE = RECSYS_CONFIG  # the reshard / restore state: restores in seconds
MESH_CKPT_DIR = ROOT / "build" / "mesh_ckpt"


@contextlib.contextmanager
def world_of_one(dev):
    """``RANK=0``, ``WORLD_SIZE=1``, a free ``MASTER_PORT`` on 127.0.0.1, and
    a (1, 1) ``("data", "model")`` mesh (``make_local_mesh``) on ``dev``'s
    type: NCCL on the card (gloo when a CPU rehearsal asks for ``"cpu"``),
    taken down after."""
    import os
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    mesh = make_local_mesh(1, 1, device_type=dev.type)
    want = "nccl" if dev.type == "cuda" else "gloo"
    require(dist.get_backend() == want, f"the world's backend is {dist.get_backend()}")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def mesh_cut(built: dict, args, device: str) -> dict:
    """The frontier phase's positional cut, built here when that phase did
    not run (``--only-mesh``): its first ``FRONTIER_CUT_DOCS`` documents and
    the phrase queries of a batch over them."""
    from repro_torch.core.index import NonPositionalIndex, PositionalIndex
    from repro_torch.serving.session import Session

    docs = built["docs"][:FRONTIER_CUT_DOCS]
    idx_cut = NonPositionalIndex.build(docs, store="repair_skip", mine_similarity=True,
                                       device=device)
    pidx_cut = PositionalIndex.build(docs, store="repair_skip")
    cut_batch = make_batch(docs, idx_cut, np.random.default_rng(args.seed + 4), args.per_cell)
    phrase = [q for k, q in cut_batch if k == "phrase"]
    return {"idx": idx_cut, "pidx": pidx_cut, "phrase": phrase,
            "want": Session(idx_cut, positional=pidx_cut).execute(phrase)}


def _whole_on(pidx, dev):
    from repro_torch.serving.partitioned import PartitionedAnchoredIndex

    return PartitionedAnchoredIndex(arrays={k: v.to(dev) for k, v in pidx.arrays.items()},
                                    doc_bounds=pidx.doc_bounds, n_shards=pidx.n_shards,
                                    expand_len=pidx.expand_len)


def mesh_partitioned(mesh, built: dict, cut: dict, and_q: list, and_want: list, dev) -> dict:
    """``PartitionedServer(mesh=...)`` with ``shard_axis="data"`` and
    ``probe="kernel"`` at ``MESH_SHARDS`` shards: the full non-positional
    index on the batch's AND queries, the positional cut on its phrase
    queries; every answer equal to the ``mesh=None`` server's and the host
    session's, ``anchor_probe_sliced`` launched once per probed term per
    window (launch counts read around the mesh servers' passes alone)."""
    from repro_torch.serving.partitioned import PartitionedAnchoredIndex, PartitionedServer
    from repro_torch.serving.session import Session

    on_gpu = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    probe = "kernel" if on_gpu else "torch"
    out, launches = {}, {}
    for name, index, kwargs, queries, want in (
            ("and", built["idx"], {}, and_q, and_want),
            ("phrase", cut["idx"], {"positional": cut["pidx"]}, cut["phrase"], cut["want"])):
        host_index = index if name == "and" else cut["pidx"]
        t0 = time.perf_counter()
        whole = PartitionedAnchoredIndex.from_index(host_index, n_shards=MESH_SHARDS,
                                                    device="cpu")
        build_s = time.perf_counter() - t0
        servers = {m: PartitionedServer(whole if m == "mesh" else _whole_on(whole, dev),
                                        host_index, mesh=mesh if m == "mesh" else None,
                                        probe=probe) for m in ("mesh", "one")}
        role = "server" if name == "and" else "positional_server"
        sessions = {m: Session(index, **kwargs, **{role: s}) for m, s in servers.items()}
        answers = {}
        for m, sess in sessions.items():
            reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            answers[m] = sess.execute(queries)
            sync()
            out[f"{name}_{m}_s"] = time.perf_counter() - t0
            if m == "mesh":
                launches[name] = {k: n for k, n in launch_counts().items() if n}
        for m in ("mesh", "one"):
            bad = _differ(queries, answers[m], want)
            require(not bad, f"mesh {name} ({m}): {len(bad)} answers differ from the host "
                    f"session's, first {bad[:3]}")
        bad = _differ(queries, answers["mesh"], answers["one"])
        require(not bad, f"mesh {name}: {len(bad)} answers differ from mesh=None's")
        srv = servers["mesh"]
        expected = shard_probes(sessions["mesh"], queries,
                                {"nonpositional" if name == "and" else "positional": srv})
        require(launches[name] == ({"anchor_probe_sliced": expected} if on_gpu else {}),
                f"mesh {name}: launched {launches[name]}, expected {expected} "
                f"anchor_probe_sliced")
        require(srv.pidx.device_bytes() == servers["one"].pidx.device_bytes(),
                f"mesh {name}: a world of one holds {srv.pidx.device_bytes()} bytes, one "
                f"device {servers['one'].pidx.device_bytes()}")
        out[name] = {"queries": len(queries), "shards": MESH_SHARDS,
                     "local_shards": srv.pidx.n_shards, "layout_build_s": build_s,
                     "windows_swept": srv.windows_swept, "launches": launches[name],
                     "expected_probe_launches": expected,
                     "device_bytes": srv.pidx.device_bytes(), "answers_equal": True}
        del servers, sessions, whole, srv
    out["launches"] = {"anchor_probe_sliced": sum(x.get("anchor_probe_sliced", 0)
                                                  for x in launches.values())}
    return out


def _equal_trees(a: dict, b: dict) -> list:
    """Paths whose leaves differ in any bit (``b`` may hold DTensors)."""
    from torch.distributed.tensor import DTensor

    bad = []
    for k, v in a.items():
        w = b[k].full_tensor() if isinstance(b[k], DTensor) else b[k]
        v = v.detach()
        if v.dtype != w.dtype or v.shape != w.shape or not torch.equal(v, w):
            bad.append(k)
    return bad


def mesh_train_lm(name: str, mesh, args, dev) -> tuple[dict, dict]:
    """``make_sharded_train_step`` for ``name`` at full width with the train
    phase's depth, tokens, micro-batches and rate, against
    ``make_lm_train_step``'s kernel path from the same weights: gradients,
    loss, metrics and the updated state bit-equal (a world of one makes
    every collective the identity).  Launch counts are read around the
    sharded step alone.  Returns the result and two of the sharded step's
    gradients (``MESH_PSUM_LEAVES``)."""
    from repro_torch.checkpoint.checkpointer import flatten, reshard
    from repro_torch.configs import get_config
    from repro_torch.data.pipelines import lm_batches
    from repro_torch.models import steps
    from repro_torch.sharding import spmd
    from repro_torch.sharding.specs import input_specs_sharding_for
    from repro_torch.train.optimizer import OptConfig

    cfg = dataclasses.replace(get_config(name), n_layers=TRAIN_LM_LAYERS)
    opt = OptConfig(**TRAIN_OPT)
    t0 = time.perf_counter()
    params = steps.init_model_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             next(lm_batches(cfg, TRAIN_LM_BATCH, TRAIN_LM_SEQ, seed=args.seed)).items()}
    specs = spmd.state_specs_for(cfg, spmd.meta_state(cfg, opt), mesh)
    bspecs = input_specs_sharding_for(cfg, "train_4k", mesh, False)
    sharded = reshard(steps.init_state(params, opt), mesh, specs)
    sstep = spmd.make_sharded_train_step(cfg, opt, mesh, specs, bspecs, n_micro=TRAIN_LM_MICRO)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    _free(dev)
    setup_s = time.perf_counter() - t0
    # the gradients of the first step, both ways
    want_g = steps._accum_grads(steps.loss_for(cfg), params, batch, TRAIN_LM_MICRO)[2]
    got_g, _ = sstep.grads(sharded, batch)
    grad_bad = [k for k in want_g if not torch.equal(want_g[k].float(), got_g[k])]
    keep = {k: got_g[k] for k in MESH_PSUM_LEAVES}
    del want_g, got_g
    _free(dev)
    # one step each: the unsharded kernel path, then the sharded step (counted)
    state = steps.init_state(params, opt)
    sync()
    t1 = time.perf_counter()
    state, m1 = steps.make_lm_train_step(cfg, opt, n_micro=TRAIN_LM_MICRO)(state, batch)
    sync()
    unsharded_ms = (time.perf_counter() - t1) * 1e3
    reset_launch_counts()
    sync()
    t1 = time.perf_counter()
    sharded, m2 = sstep(sharded, batch)
    sync()
    sharded_ms = (time.perf_counter() - t1) * 1e3
    launches = _train_launches()
    metric_bad = [k for k in m1 if not torch.equal(m1[k].float(), m2[k].float())]
    state_bad = _equal_trees(flatten(state), flatten(sharded))
    del state, sharded, params, sstep
    _free(dev)
    require(not grad_bad, f"mesh {name}: sharded gradients differ from the unsharded "
            f"kernel path's in {grad_bad[:4]}")
    require(not metric_bad, f"mesh {name}: metrics {metric_bad} differ")
    require(not state_bad, f"mesh {name}: updated state differs in {state_bad[:4]}")
    per_step = TRAIN_LM_LAYERS * TRAIN_LM_MICRO if dev.type == "cuda" else 0
    require(launches["flash_attention_tpu"] == launches["flash_attention_tpu_lse"] == per_step,
            f"mesh {name}: attention launches {launches}, expected {per_step} with lse")
    if cfg.moe and dev.type == "cuda":
        require(launches["moe_gemm"] > 0 and launches["moe_gemm_backward"] > 0,
                f"mesh {name}: moe_gemm launches {launches}")
    return {"model": name, "layers": cfg.n_layers, "dtype": cfg.dtype,
            "tokens_per_step": TRAIN_LM_BATCH * TRAIN_LM_SEQ, "n_micro": TRAIN_LM_MICRO,
            "loss": float(m2["loss"]), "grad_norm": float(m2["grad_norm"]),
            "bit_equal": {"gradients": True, "metrics": True, "state": True},
            "leaves": len(flatten(specs)), "launches": launches,
            "sharded_step_wall_ms": sharded_ms, "unsharded_step_wall_ms": unsharded_ms,
            "setup_s": setup_s, "seconds": time.perf_counter() - t0}, keep


def mesh_compression(mesh, grads: dict, reps: int) -> dict:
    """``psum_int8`` and ``psum_topk`` over the data axis on the sharded
    step's float32 gradients: bit-equal to the port's formula on the same
    tensor (in a world of one the MAX and SUM all-reduces are the
    identity), timed with CUDA events."""
    from repro_torch.train import grad_compression as gc

    out = {}
    for leaf, g in grads.items():
        got = gc.psum_int8(g, (mesh, "data"))
        q, scale = gc._quantize_int8(g)
        want = gc._dequantize_int8(q, scale, g.shape, g.dtype)
        require(torch.equal(got, want), f"psum_int8 on {leaf} differs from its formula")
        total, resid = gc.psum_topk(g, (mesh, "data"), MESH_TOPK_FRAC)
        kept, idx, want_resid = gc.topk_sparsify(g, MESH_TOPK_FRAC)
        dense = torch.zeros(g.numel(), dtype=g.dtype, device=g.device)
        dense[idx] = kept
        require(torch.equal(total, dense.reshape(g.shape)) and torch.equal(resid, want_resid),
                f"psum_topk on {leaf} differs from its formula")
        out[leaf] = {"shape": list(g.shape), "int8_ms": time_ms(
            lambda g=g: gc.psum_int8(g, (mesh, "data")), reps),
            "topk_ms": time_ms(lambda g=g: gc.psum_topk(g, (mesh, "data"), MESH_TOPK_FRAC),
                               max(MIN_REPS, reps // 4)),
            "int8_max_abs_err": float((got - g).abs().max()), "bit_equal": True}
    return out


def mesh_checkpoint(mesh, args, dev) -> dict:
    """A train state of ``MESH_STATE`` at full size (AdamW, its moments
    drawn at random) placed on the mesh, saved (async: the gathers run on
    the calling thread), restored unsharded and resharded, restored with
    ``sharding_tree=``, and restored into a sharded state: every leaf
    bit-equal to the saved one."""
    import shutil

    from repro_torch.checkpoint.checkpointer import Checkpointer, flatten, reshard
    from repro_torch.configs import get_config
    from repro_torch.models import steps
    from repro_torch.sharding import spmd
    from repro_torch.sharding.compat import NamedSharding, flatten_specs
    from repro_torch.train.optimizer import OptConfig

    cfg, opt = get_config(MESH_STATE), OptConfig(**TRAIN_OPT)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = steps.init_state(steps.init_model_params(cfg, gen, dev), opt)
    with torch.no_grad():
        for k, t in flatten(state["opt"]).items():
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    specs = spmd.state_specs_for(cfg, state, mesh)
    sharded = reshard(state, mesh, specs)
    saved = flatten(state)
    require(not _equal_trees(saved, flatten(sharded)), "reshard changed a leaf")
    fresh = lambda: steps.init_state(  # noqa: E731
        steps.init_model_params(cfg, None, "meta").to_empty(device=dev), opt)
    shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
    try:
        ck = Checkpointer(str(MESH_CKPT_DIR), async_save=True)
        t0 = time.perf_counter()
        ck.save(1, sharded)
        ck.wait()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, step = ck.restore(fresh())
        again = reshard(restored, mesh, specs)
        reshard_s = time.perf_counter() - t0
        named = {k: NamedSharding(mesh, v) for k, v in flatten_specs(specs).items()}
        t0 = time.perf_counter()
        via_tree, _ = ck.restore(fresh(), sharding_tree=named)
        tree_s = time.perf_counter() - t0
        into_sharded, _ = ck.restore(reshard(fresh(), mesh, specs))
        bad = {name: _equal_trees(saved, flatten(s)) for name, s in
               (("reshard", again), ("sharding_tree", via_tree), ("into_sharded", into_sharded))}
    finally:
        shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
    require(step == 1 and not any(bad.values()), f"mesh checkpoint: leaves differ {bad}")
    return {"model": MESH_STATE, "leaves": len(saved),
            "bytes": sum(t.numel() * t.element_size() for t in saved.values()),
            "save_async_s": save_s, "restore_reshard_s": reshard_s,
            "restore_sharding_tree_s": tree_s, "bit_equal": True}


def mesh_phase(args, dev, built: dict, cut: dict | None) -> dict:
    """The mesh tier on the card over NCCL with a world of one (see the
    module docstring): the partitioned server, the sharded LM / MoE train
    steps, the compressed all-reduce, reshard and restore."""
    t0 = time.perf_counter()
    if cut is None:
        cut = mesh_cut(built, args, dev.type)
    from repro_torch.serving.session import Session

    and_q = [q for k, q in make_batch(built["docs"], built["idx"],
                                      np.random.default_rng(args.seed), args.per_cell)
             if k == "and"]
    and_want = Session(built["idx"], positional=built["pidx"]).execute(and_q)
    t1 = time.perf_counter()
    with world_of_one(dev) as mesh:
        backend = torch.distributed.get_backend()
        part = mesh_partitioned(mesh, built, cut, and_q, and_want, dev)
        t2 = time.perf_counter()
        lms, psum_grads = [], None
        for name in MESH_LMS:
            r, keep = mesh_train_lm(name, mesh, args, dev)
            lms.append(r)
            psum_grads = psum_grads or keep
        t3 = time.perf_counter()
        compression = mesh_compression(mesh, psum_grads, args.reps)
        del psum_grads
        _free(dev)
        ckpt = mesh_checkpoint(mesh, args, dev)
        mesh_desc = {"shape": list(mesh.shape), "axes": list(mesh.mesh_dim_names),
                     "device_type": mesh.device_type}
    _free(dev)
    launches = {"anchor_probe_sliced": part["launches"]["anchor_probe_sliced"],
                "flash_attention_tpu": sum(r["launches"]["flash_attention_tpu"] for r in lms),
                "moe_gemm": sum(r["launches"]["moe_gemm"] for r in lms)}
    return {"backend": backend, "world_size": 1, "mesh": mesh_desc,
            "partitioned": part, "train": lms, "compression": compression,
            "checkpoint": ckpt, "launches": launches,
            "queries_s": t1 - t0, "partitioned_s": t2 - t1, "train_s": t3 - t2,
            "phase_s": time.perf_counter() - t1}


def build_sessions(built: dict, device: str, probe: str | None) -> tuple[dict, dict]:
    from repro_torch.serving.session import Session

    sessions, secs = {}, {}
    for layout in ("fused", "dense"):
        t0 = time.perf_counter()
        sessions[layout] = Session.build(built["idx"], positional=built["pidx"],
                                         device=device, probe=probe, layout=layout)
        secs[layout] = round(time.perf_counter() - t0, 3)
    return sessions, secs


def group_terms(server, batch, kind: str, n_terms: tuple[int, ...]):
    """(term ids, lengths, windows) of the ``kind`` queries with one of
    ``n_terms`` known terms — one device batch of the main path, padded to
    the width bucket the session would give it."""
    from repro_torch.serving.plan import PHRASE, parse_query, width_bucket

    qs = [parse_query(q) for k, q in batch if k == kind]
    qs = [list(pq.terms) for pq in qs if len(pq.terms) in n_terms
          and all(server.host_index.lookup(t) is not None for t in pq.terms)]
    require(len(qs) > 0, f"no {kind} query of {n_terms} known terms in the batch")
    qt, ql, ok = server.encode(qs, sort_by_length=(kind != PHRASE),
                               width=width_bucket(max(n_terms)))
    return qt, ql, server._n_windows(qt, ok)


# ----------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--articles", type=int, default=80)
    ap.add_argument("--versions", type=int, default=50)
    ap.add_argument("--words", type=int, default=400)
    ap.add_argument("--per-cell", type=int, default=24,
                    help="queries per (kind, term count) cell of the mixed batch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--save-windows", default=None, metavar="FILE.npz",
                    help="also write the fused servers' arrays, the phrase2 / and2 "
                         "batches and the two signature calls' inputs for "
                         "ab_timing.py --windows")
    ap.add_argument("--lm-layers", type=int, default=None,
                    help="cut the lm_serve phase's model to this many layers "
                         "(default: full depth)")
    ap.add_argument("--only-train", action="store_true",
                    help="run the device, build and train phases alone (a quick check "
                         "of the training path; prints no kernels line and no result)")
    ap.add_argument("--only-mesh", action="store_true",
                    help="run the device and build phases, the collection and its "
                         "indexes, and the mesh phase alone (a quick check of the mesh "
                         "tier; prints no kernels line and no result)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA device and has no CPU mode", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # float32 products in full float32 (no TF32), so that the float32
    # comparisons on the card mean what they say
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else "nvidia-smi unavailable"
    kind = torch.cuda.get_device_name(0)
    emit("device", card=card, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    cuda_build.load()
    info = cuda_build.build_info
    emit("build", seconds=info["seconds"], nvcc=info.get("nvcc"), library=info["library"],
         reused=info["reused"], sources=info["sources"],
         ptxas=ptxas_by_kernel(info["log"]))

    if args.only_train:
        train = train_phase(args, torch.device("cuda"))
        emit("train", card=card, **train)
        require(not train["failures"], f"train: {train['failures']}")
        emit_done(t_start)
        return 0
    if args.only_mesh:
        built = build_indexes(args, "cuda")
        mesh = mesh_phase(args, torch.device("cuda"), built, None)
        emit("mesh", card=card, **mesh)
        emit_done(t_start)
        return 0

    built = build_indexes(args, "cuda")  # the mining path
    emit("mining", card=card, **mining_check(built, "cuda"))
    sessions, session_s = build_sessions(built, "cuda", "kernel")
    rng = np.random.default_rng(args.seed)
    batch = make_batch(built["docs"], built["idx"], rng, args.per_cell)
    require(len(batch) >= 256, f"mixed batch has {len(batch)} < 256 queries")
    rlz = rlz_path(built, batch, "cuda")
    rlz_calls = rlz.pop("calls")
    emit("rlz", card=card, **rlz)
    emit("backends", card=card, backends=backends_path(built, batch, "cuda"))

    # the two public entry points of this slice, each against its plain version
    # at edge shapes, then on its path (launch counts read around it) and timed
    dev = torch.device("cuda")
    entry = {}
    for phase, name, edge_fn, path_fn in (
            ("dgap", "dgap_decode", dgap_edge_cases, dgap_path),
            ("anchor_probe", "anchor_probe", anchor_probe_edge_cases, anchor_probe_path)):
        edges_here = edge_fn(dev, args.seed)
        path = path_fn(built, dev, args.reps)
        row = path.pop("row")
        mism = sum(r["mismatches"] for r in edges_here) + row["mismatches"]
        emit(phase, card=card, tolerance=0,
             edge_cases=len(edges_here), mismatches=mism,
             edge_mismatches=[r for r in edges_here if r["mismatches"]], path=path,
             at_path=row)
        require(mism == 0, f"{mism} elements differ between {name} and its plain version")
        require(row["library_agrees"], f"the library yardstick disagrees with {name}")
        entry[name] = {"row": row, "launches": path["launches"][name],
                       "max_abs_err": max(r["max_abs_err"] for r in edges_here + [row])}
        if "launches_by_route" in path:
            entry[name].update(kernel_route=row["route"],
                               launches_by_route=path["launches_by_route"],
                               ms_by_route=row["ms_by_route"])

    # kernels, against their plain versions on the card: edge shapes, then what
    # a device step hands them on each path that launches one — both layouts,
    # both indexes, 2-term and 3-4-term batches, first and last window — and
    # what mining handed the signature kernel.  The 2-term first-window steps
    # and both signature calls are also timed.
    longest_slice = int(torch.diff(
        sessions["fused"].positional_server.arrays["c_offsets"]).max().item())
    edges = (edge_cases(dev, args.seed, longest_slice) + window_edge_cases(dev, args.seed)
             + minhash_edge_cases(dev, args.seed))
    refusals = wrapper_refusals(dev)
    measured = []
    for layout in ("fused", "dense"):
        for which, srv, mode in (("nonpositional", sessions[layout].server, "and"),
                                 ("positional", sessions[layout].positional_server,
                                  "phrase")):
            for n_terms in ((2,), (3, 4)):
                qt, ql, n_win = group_terms(srv, batch, mode, n_terms)
                for window in sorted({0, n_win - 1}):
                    timed = n_terms == (2,) and window == 0
                    if layout == "dense" and not timed:
                        continue  # its one kernel sees the fused step's inputs again
                    name = f"{layout}/{which}/{mode}{'-'.join(map(str, n_terms))}"
                    inp = main_path_inputs(srv, mode, qt, ql, window)
                    measured += kernels_at_main_path(name, inp, args.reps, timed)
                    del inp
    sig_calls = {"mining/documents": built.pop("mining_calls"), "rlz/posting-lists": rlz_calls}
    measured += minhash_at_mining(sig_calls, args.reps)
    torch.cuda.synchronize()
    total_mism = sum(r["mismatches"] for r in edges + measured)
    emit("kernels", tolerance={name: 0 for name in INTEGER_KERNELS},
         timing=f"CUDA events, median of {args.reps} after warm-up; ms, plain_ms, library_ms: "
                f"device time (card kept busy while the call is queued); call_ms: the "
                f"wrapper as a waiting caller sees it",
         mismatches=total_mism, edge_cases=len(edges), wrapper_refusals=refusals,
         edge_mismatches=[r for r in edges if r["mismatches"]],
         main_path=measured, launches_so_far=launch_counts())
    require(total_mism == 0, f"{total_mism} elements differ between a kernel and its "
            f"plain version")
    require(all(r.get("library_agrees", True) for r in measured),
            "torch.searchsorted yardstick disagrees with anchor_probe_sliced")

    if args.save_windows:
        save_windows(sessions, batch, sig_calls, args.save_windows)
    del sig_calls, rlz_calls
    result = serve(built, sessions, batch, "cuda", args.reps)
    emit("serve", card=card, collection=built["info"], session_build_s=session_s, **result)

    # rank10: on the card (the ranked step), then the index lifecycle: the
    # full-size indexes saved and opened, a writer's segments served and compacted
    t0 = time.perf_counter()
    rank_queries = rank_batch(built["docs"], built["idx"], args.seed + 1)
    emit("ranked", card=card, **ranked(built, sessions, rank_queries, "cuda", args.reps))
    t1 = time.perf_counter()
    life = lifecycle(built, sessions, batch, rank_queries, args, "cuda")
    t2 = time.perf_counter()
    emit("lifecycle", card=card, ranked_phase_s=t1 - t0, lifecycle_phase_s=t2 - t1,
         writer_reduction=f"{WRITER_DOCS} of the {len(built['docs'])} documents: the Python "
                          f"Re-Pair build bounds it",
         **{k: v for k, v in life.items() if k not in ("writer_dir", "writer_queries")})

    # the serving frontier: shards, replicas, the micro-batch frontend, a
    # refresh through it, and the serving driver
    front = frontier(built, sessions, batch, rank_queries, life, args, "cuda")
    cut = front.pop("_mesh_cut")
    emit("frontier", card=card, **front)
    del sessions, life
    torch.cuda.empty_cache()

    # the mesh tier over NCCL with a world of one: the partitioned server on
    # the frontier's collection, the sharded LM / MoE train steps, the
    # compressed all-reduce, reshard and restore
    mesh = mesh_phase(args, dev, built, cut)
    del cut
    emit("mesh", card=card, **mesh)

    # the LM serving path (qwen3-8b at full width) with both attention kernels,
    # then the kernels at edge shapes and at the inputs the path handed them
    lm, seen = lm_serve_path(args, dev, LM_CONFIG, args.lm_layers)
    emit("lm_serve", card=card, **lm)
    routes_before = route_counts()
    attn_edges = attention_edge_cases(dev, args.seed) + attention_at_path_f32(seen)
    attn_path = attention_at_path(seen, args.reps, True)
    del seen
    torch.cuda.empty_cache()
    bad = [r for r in attn_edges + attn_path if not r["within_tolerance"]]
    by_dtype = lambda key: {k: {d: max([r[key] for r in attn_edges + attn_path  # noqa: E731
                                        if r["kernel"] == k and r["dtype"] == d], default=None)
                                for d in ("float32", "bfloat16")} for k in ATTENTION_TOL}
    emit("attention_kernels", card=card,
         tolerance={k: _tolerance(k) for k in ATTENTION_TOL},
         edge_cases=len(attn_edges), outside_tolerance=bad,
         max_abs_err=by_dtype("max_abs_err"), limit_used=by_dtype("limit_used"),
         by_route=by_route(attn_edges + attn_path, ("limit_used", "limit_used_vs_split",
                                                    "split_limit_used", "two_term_split_limit_used",
                                                    "design_limit_used")),
         widened_path=attn_edges[-3:], at_path=attn_path,
         flash_decode={"launches_by_route": route_diff(route_counts(),
                                                       routes_before)["flash_decode"],
                       "kernels_per_call": attn_path[-1]["kernels_per_call"],
                       "limit_used_vs_split": max(r["limit_used_vs_split"] for r in attn_edges
                                                  + attn_path if r["kernel"] == "flash_decode")})
    require(not bad, f"{len(bad)} attention kernel outputs outside their tolerance, "
            f"first {bad[:2]}")

    # the recsys serving path (xDeepFM at full width, then FM, SASRec and
    # two-tower at serve_p99), the MoE LM serving path (moonshot-v1-16b-a3b
    # at full width), and the three model-side kernels at edge shapes and at
    # the inputs the two paths handed them
    rec, rec_calls = recsys_serve_path(args, dev)
    rec_path = recsys_kernels_at_path(rec_calls, args.reps)
    del rec_calls
    torch.cuda.empty_cache()
    emit("recsys_serve", card=card, **rec)
    moe, moe_seen = lm_serve_path(args, dev, MOE_CONFIG, None, control=False)
    moe_attn = attention_at_moe_path(moe_seen, args.reps, True)
    # layer 0's w_gate and w_down products (D 2,048 / 1,408), the first timed
    moe_path = [model_kernel_at_path("moe_gemm", moe_seen["moe_gemm"][i][0], at, args.reps,
                                     timed=at.endswith("w_gate"))
                for at, i in zip(("moe_serve/prefill, layer 0, w_gate",
                                  "moe_serve/prefill, layer 0, w_down",
                                  "moe_serve/last decode step, layer 0, w_gate",
                                  "moe_serve/last decode step, layer 0, w_down"),
                                 sorted(moe_seen["moe_gemm"]))]
    del moe_seen
    torch.cuda.empty_cache()
    emit("moe_serve", card=card, attention_at_path=moe_attn, **moe)
    require(all(r["within_tolerance"] for r in moe_attn),
            f"an attention kernel at the moe_serve path is outside its tolerance: {moe_attn}")
    model_edges = model_kernel_edge_cases(dev, args.seed)
    model_path = rec_path + moe_path
    bad = [r for r in model_edges + model_path if not r["within_tolerance"]]
    emit("model_kernels", card=card,
         tolerance={"embedding_bag": 0, "cin_layer": "2 gamma(m Hk + 2) x plain(|x0|, |xk|, |w|)",
                    "moe_gemm": "2 gamma(D + 1) x plain(|buf|, |w|)"},
         timing=f"CUDA events, median of {args.reps} (of {MIN_REPS} for calls over "
                f"{SLOW_CALL_MS} ms) after warm-up",
         edge_cases=len(model_edges), wrapper_refusals=model_refusals(dev),
         outside_tolerance=bad,
         max_abs_err={k: max(r["max_abs_err"] for r in model_edges + model_path
                             if r["kernel"] == k) for k in MODEL_KERNELS},
         limit_used={k: max(r["limit_used"] for r in model_edges + model_path
                            if r["kernel"] == k) for k in MODEL_KERNELS},
         by_route=by_route(model_edges + model_path, ("limit_used",)),
         at_path=model_path)
    require(not bad, f"{len(bad)} model-side kernel outputs outside their tolerance, "
            f"first {bad[:2]}")
    torch.cuda.empty_cache()

    # training on the card: the kernels' gradient pieces against their plain
    # versions, then the LM, MoE, recsys and GIN train steps (kernel path
    # against plain path), the training driver and the checkpointer
    train = train_phase(args, dev)
    emit("train", card=card, **train)
    require(not train["failures"], f"train: {train['failures']}")

    # one entry per kernel: the serving kernels at the positional phrase2
    # shape (the serve path's most frequent) — the window kernels on the fused
    # path, anchor_probe_sliced on the dense one, decode_rows / probe_rows
    # timed at the row-given route's calls on the same windows (no layout's
    # main path launches them any more: their launches are the fused path's,
    # 0) — the signature kernel at the documents of the mining path with its
    # posting-list shape beside it; the per-shape list is in the "kernels"
    # phase line above
    at = "fused/positional/phrase2"
    max_err = lambda name: max(x["max_abs_err"] for x in edges + measured  # noqa: E731
                               if x["kernel"] == name)
    timing_keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    serving = {"decode_window": (at, "fused"), "probe_window": (at, "fused"),
               "anchor_probe_sliced": ("dense/positional/phrase2", "dense"),
               "decode_rows": (f"{at} (rows given)", "fused"),
               "probe_rows": (f"{at} (rows given)", "fused")}
    kernels = []
    for name, (where, layout) in serving.items():
        r, = [x for x in measured if x["kernel"] == name and x["at"] == where and "ms" in x]
        kernels.append({"name": name, **KERNEL_META[name],
                        "launches": result[f"launches_{layout}"][name],
                        "launches_on": f"serve ({layout})",
                        "launches_by_layout": {lay: result[f"launches_{lay}"][name]
                                               for lay in ("fused", "dense")},
                        "launches_frontier": front["launches"].get(name, 0),
                        "max_abs_err": max_err(name),
                        **{k: r[k] for k in timing_keys}, "at": where})
    mh = {r["at"]: r for r in measured if r["kernel"] == "minhash_rows"}
    by_path = {"mining": built["mining_launches"]["minhash_rows"],
               "rlz": rlz["launches_build"]["minhash_rows"]}
    sig_keys = timing_keys + ("route", "design_ceiling_ms", "ms_no_live_lanes", "copy_ms")
    kernels.append({"name": "minhash_rows", **KERNEL_META["minhash_rows"],
                    "launches": sum(by_path.values()), "launches_by_path": by_path,
                    "launches_by_route": {"mining": built["mining_routes"],
                                          "rlz": rlz["minhash_rows_routes_build"]},
                    "kernels_per_call": {"one_pass": ["minhash_rows_kernel"],
                                         "chunked": ["minhash_clear_kernel",
                                                     "minhash_rows_kernel"]},
                    "max_abs_err": max_err("minhash_rows"),
                    **{k: mh["mining/documents"][k] for k in sig_keys}, "at": "mining/documents",
                    "at_posting_lists": {k: mh["rlz/posting-lists"][k] for k in sig_keys}})
    for name, e in entry.items():
        kernels.append({"name": name, **KERNEL_META[name], "launches": e["launches"],
                        "max_abs_err": e["max_abs_err"],
                        **{k: e["row"][k] for k in timing_keys}, "at": e["row"]["at"]})
        kernels[-1].update({k: e[k] for k in ("kernel_route", "launches_by_route", "ms_by_route")
                            if k in e})
    for r in attn_path:
        name = r["kernel"]
        kernels.append({"name": name, **KERNEL_META[name], "launches": lm["launches"][name],
                        "max_abs_err": max(x["max_abs_err"] for x in attn_edges + attn_path
                                           if x["kernel"] == name),
                        "tolerance": _tolerance(name),
                        **{k: r[k] for k in timing_keys}, "at": r["at"]})
        if name in ROUTED_KERNELS:
            kernels[-1].update(kernel_route=r["route"], launches_by_route={
                phase: by[name] for phase, by in lm["launches_by_route"].items()})
    for name, at in (("embedding_bag", "recsys_serve/serve_bulk/x0 lookup"),
                     ("cin_layer", "recsys_serve/serve_bulk/CIN layer 2"),
                     ("moe_gemm", "moe_serve/prefill, layer 0, w_gate")):
        r, = [x for x in model_path if x["at"] == at]
        kernels.append({"name": name, **KERNEL_META[name],
                        "launches": (rec if name != "moe_gemm" else moe)["launches"][name],
                        "max_abs_err": max(x["max_abs_err"] for x in model_edges + model_path
                                           if x["kernel"] == name),
                        **{k: r[k] for k in timing_keys}, "at": at})
        if name == "embedding_bag":
            lookups = {x["at"]: {k: x[k] for k in timing_keys + ("route", "design_ceiling_ms")}
                       for x in model_path if x["kernel"] == name and "ms" in x}
            kernels[-1].update(kernel_route=r["route"], design_ceiling_ms=r["design_ceiling_ms"],
                               launches_by_route=rec["launches_by_route"][name],
                               at_path=lookups)
        elif name in ROUTED_KERNELS:
            kernels[-1].update(kernel_route=r["route"], launches_by_route={
                phase: by[name] for phase, by in moe["launches_by_route"].items()})
    # the train phase's launches beside the serving ones: per model, the
    # launches of its kernel-path steps (row 7's with the log-sum-exp, row
    # 11's backward products), and row 11's backward products timed
    for k in kernels:
        if k["name"] in TRAIN_KERNELS:
            by_model = {r["model"]: sum(step[k["name"]] for step in r["kernel_path"]["launches"])
                        for r in train["models"]}
            k["launches_train"] = {m: n for m, n in by_model.items() if n}
    row7, = [k for k in kernels if k["name"] == "flash_attention_tpu"]
    row7["launches_train_lse"] = {r["model"]: sum(s["flash_attention_tpu_lse"] for s in
                                                  r["kernel_path"]["launches"])
                                  for r in train["models"] if r["model"] in (LM_CONFIG,
                                                                            MOE_CONFIG)}
    row7["lse_timing"] = train["pieces"]["lse_timing"]
    row11, = [k for k in kernels if k["name"] == "moe_gemm"]
    row11["launches_train_backward"] = sum(s["moe_gemm_backward"] for r in train["models"]
                                           for s in r["kernel_path"]["launches"])
    row11["backward_at_path"] = {at: {key: r[key] for key in timing_keys + ("route",)}
                                 for at, r in train["pieces"]["timed"].items()
                                 if at.startswith("train/moonshot")}
    # the mesh phase's launches beside the others (rows 1, 7 and 11)
    for k in kernels:
        if k["name"] in mesh["launches"]:
            k["launches_mesh"] = mesh["launches"][k["name"]]
    require(len(kernels) == len(KERNEL_META), f"the kernels line lists {len(kernels)} "
            f"kernels, expected {len(KERNEL_META)}")
    emit_done(t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    # a crash in native code (the kernel library, NCCL, CUPTI) prints every
    # thread's Python stack to stderr before the process dies
    faulthandler.enable(all_threads=True)
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
