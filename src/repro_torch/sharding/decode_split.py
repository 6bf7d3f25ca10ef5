"""The decode's attention over a KV cache split over T across ranks
(flash-decoding across ranks, the reference's "split-KV" layout of
``repro.sharding.specs``: the cache's T over ``"model"``, or over
``("data", "model")`` when the batch is one row).

Each rank attends over its own slice of the cache for every head
(``kernels.flash_decode.flash_decode_partial``: float32 ``o`` normalised
over the slice's live rows and ``lse``, the log of their summed
``e^score``), and :func:`combine_partials` joins the ranks' partials:

    LSE = log sum_r e^{lse_r},   out = sum_r e^{lse_r - LSE} o_r

computed as ``M = max_r lse_r`` (one max all-reduce, so no ``exp``
overflows), ``w_r = e^{lse_r - M}``, and one sum all-reduce of ``(w_r o_r,
w_r)``: ``(B, H, hd + 1)`` floats a layer, the cache never moves.  A rank
whose slice has no live row (``lse = NEG_INF``) weighs ``e^{NEG_INF - M} =
0``; a row with no live key anywhere has every weight 1 and every ``o_r =
0``, so it is 0, as in the whole kernel.  The result is rounded once, to
``out_dtype``.  Over a group of one rank nothing is issued and the partial
is the whole call's result, rounded as the whole kernel rounds it.
"""

from __future__ import annotations

import torch

from ..models.flash import NEG_INF
from . import tp


def _live_groups(group) -> list:
    groups = list(group) if isinstance(group, (list, tuple)) else [group]
    return [g for g in groups if tp.group_size(g) > 1]


def _join(num: torch.Tensor, den: torch.Tensor, m: torch.Tensor, out_dtype: torch.dtype):
    """``(num / den`` rounded once, ``LSE)`` from the summed ``w o``, ``w``
    and the max ``m`` (den >= 1: the largest lse's weight is 1)."""
    out = num / den[..., None]
    total = torch.where(m > NEG_INF, m + torch.log(den), torch.full_like(m, NEG_INF))
    return out[:, None].to(out_dtype), total


def combine_stacked(o: torch.Tensor, lse: torch.Tensor, out_dtype: torch.dtype):
    """The same join over the leading axis of ``o`` (n, B, 1, H, hd) and
    ``lse`` (n, B, H): the partials of n slices of a cache in one process
    (tests and ``chip_smoke.py``, which cut one cache into slices)."""
    m = lse.amax(dim=0)
    w = torch.exp(lse - m)
    return _join((o[:, :, 0] * w[..., None]).sum(dim=0), w.sum(dim=0), m, out_dtype)


def combine_partials(o: torch.Tensor, lse: torch.Tensor, group, out_dtype: torch.dtype):
    """The ranks' partials ``o`` (B, 1, H, hd) and ``lse`` (B, H), float32,
    joined over ``group`` (a process group, or a sequence of them: the axes
    that split the cache's T, summed over in turn): ``(out (B, 1, H, hd) in
    out_dtype, LSE (B, H) float32)`` (see the module docstring)."""
    groups = _live_groups(group)
    if not groups:
        return o.to(out_dtype), lse
    m = tp.max_into(lse.clone(), groups)
    w = torch.exp(lse - m)
    packed = torch.cat([o[:, 0] * w[..., None], w[..., None]], dim=-1)
    packed = tp.sum_into(packed, groups)
    return _join(packed[..., :-1], packed[..., -1], m, out_dtype)
