"""Decode a 1-D d-gap stream: ``posting = cumsum(gaps) - 1``, in int32 with
wraparound (a long stream's running sum passes 2^31 and wraps, as the
reference's does).

On a CUDA tensor ``dgap_decode`` launches the single-pass scan of
``csrc/dgap_decode.cu`` (one clearing kernel and the look-back scan, its
programmatic dependent, or raises); on a CPU tensor it runs
``dgap_decode_torch``, the plain PyTorch version of the same function.  ``dgap_decode_lookback_torch`` replays the kernel's tile protocol
(aggregates, inclusive prefixes, look-back) in tensor code, for the tests.
"""

from __future__ import annotations

import torch

from .. import cuda_build

#: values one block of the kernel scans (``kTile`` of the source); the
#: wrapper allocates one 8-byte status word per tile, plus the tile counter
TILE = 4096
#: load routes by the code the launch function takes
ROUTE_CODES = {"scalar": 0, "vec16": 1}

_MASK32 = 0xFFFFFFFF


def dgap_decode_torch(gaps: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dgap_decode`.  ``torch.cumsum`` of an
    int32 tensor would promote to int64, so the sum is taken in int64 and
    its low 32 bits are handed back as int32 explicitly."""
    return _as_int32(torch.cumsum(gaps.long(), 0) - 1)


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 values, as int32."""
    low = x & _MASK32
    return (low - ((low >> 31) << 32)).to(torch.int32)


def dgap_decode_lookback_torch(gaps: torch.Tensor, tile: int = TILE,
                               order=None) -> torch.Tensor:
    """The kernel's single-pass protocol in tensor code.  Tiles of ``tile``
    values publish their aggregates in ``order`` (a permutation of the tile
    indices; ascending by default); tile 0 publishes its inclusive prefix at
    once.  Each other tile then looks back over its predecessors' status
    words, nearest first, summing aggregates up to the nearest inclusive
    prefix, and publishes its own.  A tile that meets a predecessor with
    nothing published waits for it (the kernel re-reads its window of 32
    words, which decides as this walk does: by the nearest word that is not
    an aggregate).  Sums are taken modulo 2^32,
    as in the kernel.  Equals :func:`dgap_decode_torch` for every order."""
    g = gaps.to(torch.int64).reshape(-1)
    n = g.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=gaps.device)
    n_tiles = -(-n // tile)
    order = list(range(n_tiles)) if order is None else [int(t) for t in order]
    if sorted(order) != list(range(n_tiles)):
        raise ValueError(f"order is not a permutation of the {n_tiles} tiles")
    padded = torch.zeros(n_tiles * tile, dtype=torch.int64, device=gaps.device)
    padded[:n] = g
    local = torch.cumsum(padded.view(n_tiles, tile), 1) & _MASK32
    aggregate = local[:, -1].tolist()
    empty, agg, inc = 0, 1, 2
    flag, value, prefix = [empty] * n_tiles, [0] * n_tiles, [0] * n_tiles
    waiting_on: dict[int, list[int]] = {}  # an empty tile -> the tiles waiting for it
    for t in order:
        flag[t], value[t] = (inc if t == 0 else agg), aggregate[t]
        ready = waiting_on.pop(t, []) + ([t] if t else [])
        while ready:
            w = ready.pop()
            acc, p = 0, w - 1
            while p >= 0 and flag[p] == agg:
                acc += value[p]
                p -= 1
            if p >= 0 and flag[p] == empty:
                waiting_on.setdefault(p, []).append(w)
                continue
            prefix[w] = (acc + (value[p] if p >= 0 else 0)) & _MASK32
            flag[w], value[w] = inc, (prefix[w] + aggregate[w]) & _MASK32
    out = local + torch.tensor(prefix, dtype=torch.int64, device=gaps.device)[:, None] - 1
    return _as_int32(out.reshape(-1)[:n])


def dgap_decode_route(gaps: torch.Tensor) -> str:
    """The load route of a launch on ``gaps``: ``"vec16"`` (16-byte loads
    and stores) when its first element is 16-byte aligned, else
    ``"scalar"`` (a view such as ``stream[1:]`` is only 4-byte aligned)."""
    return "vec16" if gaps.data_ptr() % 16 == 0 else "scalar"


def dgap_decode(gaps: torch.Tensor) -> torch.Tensor:
    """(n,) int32 gaps -> (n,) int32 absolute values, ``cumsum - 1``.

    ``n == 0`` gives an empty tensor and ``n == 1`` gives ``gaps - 1``;
    neither launches.  A launch clears its own workspace (``n / TILE + 1``
    words of 8 bytes, allocated per call) with one kernel and scans in a
    second.
    """
    if gaps.device.type == "cpu":
        return dgap_decode_torch(gaps)
    cuda_build.require_cuda("gaps", gaps)
    cuda_build.require_int32("gaps", gaps)
    n = gaps.shape[0]
    if n <= 1:
        return dgap_decode_torch(gaps)
    out = torch.empty(n, dtype=torch.int32, device=gaps.device)
    workspace = torch.empty(-(-n // TILE) + 1, dtype=torch.int64, device=gaps.device)
    route = dgap_decode_route(gaps)
    lib = cuda_build.load()
    with torch.cuda.device(gaps.device):
        code = lib.dgap_decode_launch(gaps.data_ptr(), out.data_ptr(), workspace.data_ptr(),
                                      workspace.shape[0], n, ROUTE_CODES[route],
                                      cuda_build.stream_ptr())
    cuda_build.check(code, f"dgap_decode ({route})")
    dgap_decode.launches += 1
    dgap_decode.launches_by_route[route] += 1
    return out


#: kernel launches made by the wrapper, in all and by load route (never
#: raised by the plain version)
dgap_decode.launches = 0
dgap_decode.launches_by_route = dict.fromkeys(ROUTE_CODES, 0)
