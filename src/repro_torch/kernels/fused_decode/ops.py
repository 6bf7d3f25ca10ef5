"""Decode / probe ragged C-entry expansions straight from the rule pool.

A row is one Re-Pair C entry of the fused layout: ``ptr[r]`` points at its
prefix-summed leaf d-gaps in the shared ``pool``, ``lens[r]`` counts them,
``base[r]`` is the entry's anchor.  The ragged read ``pool[ptr[r] + l]``
happens inside the ops, so no ``(R, L)`` gather is staged by the caller.

On CUDA tensors the wrappers launch the kernels of ``csrc/fused_decode.cu``
(or raise); on CPU tensors they run the plain PyTorch versions
``decode_rows_torch`` / ``probe_rows_torch``.  All pool reads clamp to the
pool's last element in every implementation, so they agree lane for lane.
"""

from __future__ import annotations

import torch

from .. import cuda_build

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
