"""Decode / probe ragged C-entry expansions straight from the rule pool.

A row is one Re-Pair C entry of the fused layout: ``ptr[r]`` points at its
prefix-summed leaf d-gaps in the shared ``pool``, ``lens[r]`` counts them,
``base[r]`` is the entry's anchor.  The ragged read ``pool[ptr[r] + l]``
happens inside the ops, so no ``(R, L)`` gather is staged by the caller.

Two routes over the same two kernel bodies of ``csrc/fused_decode.cu``:

* rows given — the public ops :func:`decode_rows` / :func:`probe_rows`: the
  caller gathers each row's ``(ptr, base, lens)``;
* whole window — :func:`decode_window` / :func:`probe_window`, the fused
  serving step: the rows of a candidate window (``window_rows`` entries of
  each query's driving list), and for each probe the covering entry of the
  term's anchor slice, are found inside the kernels, so a window is two
  launches for any query width.

On CUDA tensors the wrappers launch their kernels (or raise); on CPU tensors
they run the plain PyTorch versions (``*_torch``).  Every read is clamped
the same way in every implementation, so they agree lane for lane.
"""

from __future__ import annotations

import torch

from ...core.anchors import lower_bound_sliced
from .. import cuda_build

#: the most terms a query of probe_window may have (its slices are staged
#: in 8 B a term of shared memory per block)
MAX_WINDOW_TERMS = 4096
INT32_MAX = 2**31 - 1

#: elements one chunk of the plain probe's (rows, L) gather may hold
PROBE_CHUNK_ELEMS = 1 << 26


def _pool_rows(pool: torch.Tensor, ptr: torch.Tensor, L: int) -> torch.Tensor:
    lane = torch.arange(L, dtype=torch.int64, device=pool.device)
    at = (ptr.long()[:, None] + lane[None, :]).clamp_(0, pool.shape[0] - 1)
    return pool[at]


def decode_rows_torch(pool: torch.Tensor, ptr: torch.Tensor, base: torch.Tensor,
                      lens: torch.Tensor, L: int):
    """Plain PyTorch version of :func:`decode_rows`."""
    lane = torch.arange(L, dtype=torch.int32, device=pool.device)
    return base[:, None] + _pool_rows(pool, ptr, L), lane[None, :] < lens[:, None]


def probe_rows_torch(pool: torch.Tensor, ptr: torch.Tensor, base: torch.Tensor,
                     lens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`probe_rows`: decode every row to its
    longest length and compare all lanes (rows staged in chunks).  It does
    not use the rows' order, so it also checks the kernel's binary search."""
    r = ptr.shape[0]
    hit = torch.zeros(r, dtype=torch.bool, device=pool.device)
    if r == 0:
        return hit
    L = max(1, int(lens.max()))
    step = max(1, PROBE_CHUNK_ELEMS // L)
    for s in range(0, r, step):
        e = s + step
        vals, live = decode_rows_torch(pool, ptr[s:e], base[s:e], lens[s:e], L)
        hit[s:e] = (live & (vals == targets[s:e, None])).any(dim=1)
    return hit


def _check_rows(pool, named: tuple) -> int:
    cuda_build.require_int32("pool", pool)
    if pool.shape[0] == 0:
        raise ValueError("pool is empty (a pool carries at least its tail padding)")
    rows = named[0][1].shape[0]
    for name, t in named:
        cuda_build.require_int32(name, t)
        if t.device != pool.device:
            raise ValueError(f"{name} lies on {t.device}, pool on {pool.device}")
        if t.shape[0] != rows:
            raise ValueError(f"{name} has {t.shape[0]} rows, {named[0][0]} has {rows}")
    return rows


def decode_rows(pool: torch.Tensor, ptr: torch.Tensor, base: torch.Tensor,
                lens: torch.Tensor, L: int):
    """pool (P,) int32 prefix-sum rows; ptr/base/lens (R,) int32 ->
    (values (R, L) int32, valid (R, L) bool).

    ``values[r, l] = base[r] + pool[ptr[r] + l]`` in cumulative-gap space
    (posting + 1) for every lane, ``valid[r, l] = l < lens[r]`` — the
    fused-layout equivalent of the dense ``expand`` / ``expand_valid`` rows.
    """
    L = int(L)
    if L < 1:
        raise ValueError(f"L must be >= 1, got {L}")
    if not pool.is_cuda:
        return decode_rows_torch(pool, ptr, base, lens, L)
    rows = _check_rows(pool, (("ptr", ptr), ("base", base), ("lens", lens)))
    values = torch.empty((rows, L), dtype=torch.int32, device=pool.device)
    valid = torch.empty((rows, L), dtype=torch.bool, device=pool.device)
    if rows == 0:
        return values, valid
    lib = cuda_build.load()
    with torch.cuda.device(pool.device):
        code = lib.decode_rows_launch(
            pool.data_ptr(), pool.shape[0], ptr.data_ptr(), base.data_ptr(),
            lens.data_ptr(), values.data_ptr(), valid.data_ptr(), rows, L,
            cuda_build.stream_ptr())
    cuda_build.check(code, "decode_rows")
    decode_rows.launches += 1
    return values, valid


def probe_rows(pool: torch.Tensor, ptr: torch.Tensor, base: torch.Tensor,
               lens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Fused decode + membership: (R,) bool, True where ``targets[r]``
    (cumulative-gap space) occurs among row r's first ``lens[r]`` decoded
    lanes.  The kernel searches the row by bisection, which is exact because
    pool rows are strictly increasing (prefix sums of gaps >= 1).  The sum
    ``base + pool`` is an int32 add with wraparound on both sides, as in
    :func:`decode_rows`."""
    if not pool.is_cuda:
        return probe_rows_torch(pool, ptr, base, lens, targets)
    rows = _check_rows(pool, (("ptr", ptr), ("base", base), ("lens", lens),
                              ("targets", targets)))
    hit = torch.empty(rows, dtype=torch.bool, device=pool.device)
    if rows == 0:
        return hit
    lib = cuda_build.load()
    with torch.cuda.device(pool.device):
        code = lib.probe_rows_launch(
            pool.data_ptr(), pool.shape[0], ptr.data_ptr(), base.data_ptr(),
            lens.data_ptr(), targets.data_ptr(), hit.data_ptr(), rows,
            cuda_build.stream_ptr())
    cuda_build.check(code, "probe_rows")
    probe_rows.launches += 1
    return hit


#: kernel launches made by each wrapper (never raised by the plain versions)
decode_rows.launches = 0
probe_rows.launches = 0


# ----------------------------------------------------------------------
# whole-window route (the fused serving step)
# ----------------------------------------------------------------------
def _list_slices(c_offsets: torch.Tensor, list_ids: torch.Tensor):
    """``[lo, hi)`` anchor slice of each list, int64; an id outside the
    offsets table reads its nearest entry (the kernels clamp the same way),
    so nothing is read out of range."""
    top = c_offsets.shape[0] - 1
    ids = list_ids.long()
    return c_offsets[ids.clamp(0, top)].long(), c_offsets[(ids + 1).clamp(0, top)].long()


def _empty_window(b: int, lanes: int, device):
    """The window of a table without entries: every lane 0 and invalid."""
    return (torch.zeros((b, lanes), dtype=torch.int32, device=device),
            torch.zeros((b, lanes), dtype=torch.bool, device=device))


def decode_window_torch(pool, c_offsets, anchors, c_ptr, c_len, list_ids, row_start: int,
                        window_rows: int, L: int):
    """Plain PyTorch version of :func:`decode_window`: the window's rows as
    ``serving.engine.fused_candidates_for`` derives them, then
    :func:`decode_rows_torch`."""
    b = list_ids.shape[0]
    n = anchors.shape[0]
    if n == 0:
        return _empty_window(b, window_rows * L, pool.device)
    lo, hi = _list_slices(c_offsets, list_ids)
    rows = lo[:, None] + int(row_start) + torch.arange(window_rows, device=pool.device)
    live = (rows < hi[:, None]).reshape(-1)
    flat = rows.clamp(0, n - 1).reshape(-1)
    lens = torch.where(live, c_len[flat], torch.zeros((), dtype=torch.int32,
                                                      device=pool.device))
    vals, valid = decode_rows_torch(pool, c_ptr[flat], anchors[flat], lens, L)
    return vals.reshape(b, -1), valid.reshape(b, -1)


def probe_window_torch(cand_vals, cand_valid, query_terms, query_lens, c_offsets, anchors,
                       c_ptr, c_len, pool, phrase: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`probe_window`: term by term, the
    covering entry from :func:`lower_bound_sliced`, then membership by
    comparing every lane of its row (:func:`probe_rows_torch`) — the same
    function as the kernel, without its row bisection."""
    b, nc = cand_vals.shape
    n = anchors.shape[0]
    match = cand_valid.clone()
    for t in range(1, query_terms.shape[1]):
        active = (t < query_lens)[:, None]
        if phrase:
            safe = cand_vals <= INT32_MAX - 1 - t
            targets = torch.where(safe, cand_vals, torch.zeros_like(cand_vals)) + t
        else:
            safe, targets = None, cand_vals
        targets = targets.reshape(-1)
        if n == 0:
            hit = torch.zeros(b * nc, dtype=torch.bool, device=cand_vals.device)
        else:
            lo, hi = (x.repeat_interleave(nc) for x in _list_slices(c_offsets, query_terms[:, t]))
            l = lower_bound_sliced(anchors, lo, hi, targets)
            j = torch.maximum(l - 1, lo).clamp(0, n - 1)
            hit = probe_rows_torch(pool, c_ptr[j], anchors[j], c_len[j], targets) & (lo < hi)
        hit = hit.reshape(b, nc)
        if safe is not None:
            hit = hit & safe
        match = match & (hit | ~active)
    return match


def _check_table(pool, tables: tuple) -> None:
    """The index arrays a window kernel reads: 1-D contiguous int32 on the
    pool's device; c_ptr / c_len as long as anchors; pool and offsets
    non-empty."""
    cuda_build.require_cuda("pool", pool)
    for name, t in tables:
        cuda_build.require_int32(name, t)
        if t.device != pool.device:
            raise ValueError(f"{name} lies on {t.device}, pool on {pool.device}")
    named = dict(tables)
    if pool.shape[0] == 0:
        raise ValueError("pool is empty (a pool carries at least its tail padding)")
    if named["c_offsets"].shape[0] == 0:
        raise ValueError("c_offsets is empty (it holds n_lists + 1 offsets)")
    n = named["anchors"].shape[0]
    for name in ("c_ptr", "c_len"):
        if named[name].shape[0] != n:
            raise ValueError(f"{name} has {named[name].shape[0]} rows, anchors has {n}")


def _check_on(name: str, t, device, rows: int | None = None) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, pool on {device}")
    if rows is not None and t.shape[0] != rows:
        raise ValueError(f"{name} has {t.shape[0]} rows, expected {rows}")


def decode_window(pool, c_offsets, anchors, c_ptr, c_len, list_ids, row_start: int,
                  window_rows: int, L: int):
    """The fused layout's candidate window in one launch.

    ``list_ids`` (B,) int32 (any stride: a column of the term matrix) names
    each query's driving list; rows ``c_offsets[id] + row_start + k`` for
    ``k < window_rows`` are decoded to ``L`` lanes each.  Returns (values
    (B, window_rows * L) int32, valid bool), lane for lane what
    ``serving.engine.fused_candidates_for`` returns (``window_rows`` =
    ``MAX_CAND_ROWS`` there): a row past the list's end reads the entry
    table's last row (clamped) with no live lane.  With no entries at all
    every lane is 0 and invalid.
    """
    window_rows, L, row_start = int(window_rows), int(L), int(row_start)
    if L < 1 or window_rows < 1:
        raise ValueError(f"window_rows and L must be >= 1, got {window_rows} and {L}")
    if row_start < 0:
        raise ValueError(f"row_start must be >= 0, got {row_start}")
    if pool.device.type == "cpu":
        return decode_window_torch(pool, c_offsets, anchors, c_ptr, c_len, list_ids,
                                   row_start, window_rows, L)
    _check_table(pool, (("c_offsets", c_offsets), ("anchors", anchors), ("c_ptr", c_ptr),
                        ("c_len", c_len)))
    cuda_build.require_int32("list_ids", list_ids, row_stride=True)
    _check_on("list_ids", list_ids, pool.device)
    b = list_ids.shape[0]
    n = anchors.shape[0]
    if b == 0 or n == 0:  # nothing to decode
        return _empty_window(b, window_rows * L, pool.device)
    values = torch.empty((b, window_rows * L), dtype=torch.int32, device=pool.device)
    valid = torch.empty((b, window_rows * L), dtype=torch.bool, device=pool.device)
    lib = cuda_build.load()
    with torch.cuda.device(pool.device):
        code = lib.decode_window_launch(
            pool.data_ptr(), pool.shape[0], c_offsets.data_ptr(), c_offsets.shape[0],
            anchors.data_ptr(), c_ptr.data_ptr(), c_len.data_ptr(), n, list_ids.data_ptr(),
            list_ids.stride(0), row_start, window_rows, values.data_ptr(), valid.data_ptr(),
            b, L, cuda_build.stream_ptr())
    cuda_build.check(code, "decode_window")
    decode_window.launches += 1
    return values, valid


def probe_window(cand_vals, cand_valid, query_terms, query_lens, c_offsets, anchors, c_ptr,
                 c_len, pool, phrase: bool) -> torch.Tensor:
    """The fused step's whole probe loop in one launch: (B, C) bool, True
    where candidate ``cand_vals[b, c]`` (cumulative-gap space) is valid and
    every active term ``t = 1 .. min(query_lens[b], W) - 1`` of
    ``query_terms[b]`` holds it (AND) or holds it + t (phrase; a candidate
    whose shift would pass 2^31 - 2 matches nothing) — exactly
    ``serving.engine._probe_terms`` with the fused kernel member.  The
    kernel finds each term's covering entry by bisecting its anchor slice
    and then bisects that entry's pool row; anchors and pool rows are
    strictly increasing inside a list / row (``CompressedAnchoredIndex``).
    ``query_terms`` (B, W) may have a row stride."""
    if cand_vals.device.type == "cpu":
        return probe_window_torch(cand_vals, cand_valid, query_terms, query_lens, c_offsets,
                                  anchors, c_ptr, c_len, pool, phrase)
    _check_table(pool, (("c_offsets", c_offsets), ("anchors", anchors), ("c_ptr", c_ptr),
                        ("c_len", c_len)))
    cuda_build.require_int32("cand_vals", cand_vals, 2)
    if cand_vals.device != pool.device:
        raise ValueError(f"cand_vals lies on {cand_vals.device}, pool on {pool.device}")
    b, nc = cand_vals.shape
    if (cand_valid.dtype != torch.bool or cand_valid.shape != cand_vals.shape
            or not cand_valid.is_contiguous() or cand_valid.device != pool.device):
        raise ValueError(f"cand_valid: expected a contiguous bool tensor of shape {(b, nc)} "
                         f"on {pool.device}, got {cand_valid.dtype} {tuple(cand_valid.shape)} "
                         f"on {cand_valid.device}")
    cuda_build.require_int32("query_terms", query_terms, 2, row_stride=True)
    _check_on("query_terms", query_terms, pool.device, b)
    cuda_build.require_int32("query_lens", query_lens)
    _check_on("query_lens", query_lens, pool.device, b)
    w = query_terms.shape[1]
    if w > MAX_WINDOW_TERMS:
        raise ValueError(f"probe_window takes at most {MAX_WINDOW_TERMS} terms a query, got {w}")
    hit = torch.empty((b, nc), dtype=torch.bool, device=pool.device)
    if b == 0 or nc == 0:
        return hit
    lib = cuda_build.load()
    with torch.cuda.device(pool.device):
        code = lib.probe_window_launch(
            cand_vals.data_ptr(), cand_valid.data_ptr(), nc, query_terms.data_ptr(),
            query_terms.stride(0), w, query_lens.data_ptr(), c_offsets.data_ptr(),
            c_offsets.shape[0], anchors.data_ptr(), c_ptr.data_ptr(), c_len.data_ptr(),
            anchors.shape[0], pool.data_ptr(), pool.shape[0], int(bool(phrase)),
            hit.data_ptr(), b, cuda_build.stream_ptr())
    cuda_build.check(code, "probe_window")
    probe_window.launches += 1
    return hit


#: kernel launches made by each wrapper (never raised by the plain versions)
decode_window.launches = 0
probe_window.launches = 0
