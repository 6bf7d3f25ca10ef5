"""MinHash signatures of any (D, L) shingle tile.

``sig[d, p]`` is the unsigned minimum over the live lanes ``[0, lens[d])`` of
row ``d`` of ``a[p] * s + b[p]`` in wraparound uint32 arithmetic; an empty row
signs as ``2^32 - 1`` (``ref.EMPTY_SIG``).  ``minhash_rows`` is the wrapper
on int32 tensors that carry the uint32 bits: on a CUDA tensor it launches the
kernel of ``csrc/minhash_sig.cu`` (or raises), by the route
:func:`minhash_rows_route` picks from the tile's width before the launch
(``one_pass``: one kernel; ``chunked``: a clearing kernel, then the
signature kernel, whose warps combine a long row's chunks by an unsigned
atomic min); on a CPU tensor it runs ``minhash_rows_torch``, the plain
PyTorch version of the same function.
``minhash_signatures`` is the NumPy-in, NumPy-out entry point the miners
call; its ``device`` is the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.device import resolve_device
from .. import cuda_build

#: most hash permutations one launch takes
MAX_PERM = 4096
#: lanes of one row that one warp of the kernel takes (``kChunkLanes`` in
#: ``csrc/minhash_sig.cu``): a wider tile takes the ``chunked`` route
CHUNK_LANES = 512
#: the kernel's routes and the codes its launch function takes
ROUTE_CODES = {"one_pass": 0, "chunked": 1}

_MASK32 = 0xFFFFFFFF


def minhash_rows_torch(shingles: torch.Tensor, lens: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, one hash at a time (never a (D, L, P) tensor).

    PyTorch has no uint32 arithmetic, so the values are widened to int64 in
    ``[0, 2^32)`` and the product is split at 16 bits, which keeps every
    intermediate below 2^50 (no int64 overflow):
    ``a*s mod 2^32 = (a_lo*s + ((a_hi*(s mod 2^16)) << 16)) mod 2^32``.
    Dead lanes are set to ``2^32 - 1`` before the min; the result is the
    int32 bit pattern of the uint32 minima.
    """
    d, l = shingles.shape
    out = torch.full((d, a.shape[0]), _MASK32, dtype=torch.int64, device=shingles.device)
    if d and l:
        s = shingles.long() & _MASK32
        s_lo = s & 0xFFFF
        dead = (torch.arange(l, device=s.device)[None, :]
                >= lens.long().reshape(d, 1))
        a64, b64 = a.long() & _MASK32, b.long() & _MASK32
        a_lo, a_hi = a64 & 0xFFFF, a64 >> 16
        for p in range(a.shape[0]):
            h = (s * a_lo[p] + ((s_lo * a_hi[p]) << 16) + b64[p]) & _MASK32
            out[:, p] = h.masked_fill_(dead, _MASK32).amin(dim=1)
    # [0, 2^32) -> the same bits as int32, without relying on a narrowing cast
    return (out - ((out >> 31) << 32)).to(torch.int32)


def minhash_rows_route(shingles: torch.Tensor) -> str:
    """The route of a launch on a (D, L) tile: ``"one_pass"`` when every row
    fits one warp's chunk (L <= :data:`CHUNK_LANES`), else ``"chunked"``."""
    return "one_pass" if shingles.shape[1] <= CHUNK_LANES else "chunked"


def minhash_rows(shingles: torch.Tensor, lens: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """MinHash signature matrix of a shingle tile.

    shingles (D, L) int32 (uint32 bits; lanes at or past ``lens[d]`` are never
    read), lens (D,) int32, a/b (P,) int32 (uint32 bits).  Returns (D, P)
    int32 holding the uint32 signatures' bits.
    """
    if not shingles.is_cuda:
        return minhash_rows_torch(shingles, lens, a, b)
    cuda_build.require_int32("shingles", shingles, ndim=2)
    for name, t in (("lens", lens), ("a", a), ("b", b)):
        cuda_build.require_int32(name, t)
        if t.device != shingles.device:
            raise ValueError(f"{name} lies on {t.device}, shingles on {shingles.device}")
    d, l = shingles.shape
    p = a.shape[0]
    if lens.shape[0] != d:
        raise ValueError(f"lens has {lens.shape[0]} rows, shingles {d}")
    if b.shape[0] != p:
        raise ValueError(f"a and b hold {p} and {b.shape[0]} hash parameters")
    if p > MAX_PERM:
        raise ValueError(f"{p} hash permutations; one launch takes at most {MAX_PERM}")
    out = torch.empty((d, p), dtype=torch.int32, device=shingles.device)
    if d == 0 or p == 0:
        return out
    route = minhash_rows_route(shingles)
    lib = cuda_build.load()
    with torch.cuda.device(shingles.device):
        code = lib.minhash_rows_launch(
            shingles.data_ptr(), lens.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), d, l, p, ROUTE_CODES[route], cuda_build.stream_ptr())
    cuda_build.check(code, f"minhash_rows ({route})")
    minhash_rows.launches += 1
    minhash_rows.launches_by_route[route] += 1
    return out


#: calls that launched the kernel (one kernel on ``one_pass``, the clearing
#: kernel and the signature kernel on ``chunked``), in all and by route
#: (never raised by the plain version)
minhash_rows.launches = 0
minhash_rows.launches_by_route = dict.fromkeys(ROUTE_CODES, 0)


def hash_params(num_perm: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic per-permutation multipliers/offsets: ``a`` odd (a
    bijection mod 2^32), ``b`` arbitrary, both uint32."""
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, 2**32, size=num_perm, dtype=np.uint32) | 1)
    b = rng.integers(0, 2**32, size=num_perm, dtype=np.uint32)
    return a, b


def minhash_signatures(shingles: np.ndarray, lens: np.ndarray, a: np.ndarray,
                       b: np.ndarray, device="cuda") -> np.ndarray:
    """MinHash signature matrix: (D, L) uint32 shingle rows (row d live in
    lanes ``[0, lens[d])``) × (P,) hash params -> (D, P) uint32, computed on
    ``device`` (the GPU unless the caller asks for ``"cpu"``).

    Empty rows sign as 2^32 - 1 (``ref.EMPTY_SIG``).
    """
    dev = resolve_device(device)
    shingles = np.ascontiguousarray(shingles, dtype=np.uint32)
    d = shingles.shape[0]
    as_i32 = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(np.asarray(x, dtype=np.uint32).view(np.int32))).to(dev)
    out = minhash_rows(as_i32(shingles),
                       torch.from_numpy(np.asarray(lens, dtype=np.int64).reshape(d)
                                        .astype(np.int32)).to(dev),
                       as_i32(a), as_i32(b))
    return out.cpu().numpy().view(np.uint32)
