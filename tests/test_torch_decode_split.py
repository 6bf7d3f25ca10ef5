"""Row 8's partial mode and the cross-rank combine, in one process:
``kernels.flash_decode.flash_decode_partial`` (on a CPU tensor its plain
version, ``flash_decode_partial_torch``) over m slices of a cache, joined by
``sharding.decode_split.combine_stacked`` (the arithmetic of
``combine_partials`` over a leading axis instead of ranks), against the
whole ``flash_decode_torch`` and the reference's ``decode_attention``.

Tolerance: ``chip_smoke.py``'s ``ATTENTION_TOL`` — float32 within 1e-5
absolute, bfloat16 within ``2^-7 |want| + 1e-5``.  The partials and the
join are float32 (the per-slice softmax sums regrouped, the weights
``e^(lse - M)`` one rounding each, inputs of magnitude about 1), so a
float32 result moves by a few 2^-24 of ``sum p |v| / l``; a bf16 result is
rounded once from a float32 value that close to the whole call's, so at
most one bf16 step apart.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models.flash import NEG_INF
from repro_torch.sharding import decode_split

B, S, H, KH, HD = 4, 48, 8, 2, 16


def _tol(want: torch.Tensor) -> torch.Tensor:
    if want.dtype == torch.float32:
        return torch.full_like(want, 1e-5)
    return want.float().abs() * 2.0 ** -7 + 1e-5


def _inputs(seed: int, q_dtype, kv_dtype, b=B, s=S):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, 1, H, HD)).astype(np.float32)).to(q_dtype)
    k, v = (torch.from_numpy(rng.normal(size=(b, s, KH, HD)).astype(np.float32)).to(kv_dtype)
            for _ in range(2))
    return q, k, v


def _sliced(q, k, v, pos, m: int, dtype):
    """Each of m slices' partial, then the join."""
    s = k.shape[1] // m
    parts = [fd_ops.flash_decode_partial(q, k[:, j * s:(j + 1) * s], v[:, j * s:(j + 1) * s],
                                         pos, j * s) for j in range(m)]
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    return decode_split.combine_stacked(o, lse, dtype), parts


#: a position at 0, at a slice's first and last row (slices of 3, 16 or 24
#: rows), inside, and past S (the whole cache)
POSITIONS = [0, 24, 47, 100]


@pytest.mark.parametrize("m", [1, 2, 3, 16])
@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16)])
def test_slices_combined_equal_the_whole_call(m, q_dtype, kv_dtype):
    q, k, v = _inputs(m, q_dtype, kv_dtype)
    pos = torch.tensor(POSITIONS, dtype=torch.int32)
    (got, lse), parts = _sliced(q, k, v, pos, m, q_dtype)
    want = fd_ops.flash_decode_torch(q, k, v, pos)
    assert got.dtype == q_dtype and got.shape == want.shape
    assert bool(((got.float() - want.float()).abs() <= _tol(want)).all())
    # the joined lse is the whole cache's: log sum e^score over the live rows
    whole = fd_ops.flash_decode_partial_torch(q, k, v, pos, 0)[1]
    assert torch.allclose(lse, whole, atol=1e-5, rtol=1e-6)
    for o, part_lse in parts:
        assert o.dtype == part_lse.dtype == torch.float32


@pytest.mark.parametrize("m", [1, 2, 3, 16])
def test_slices_combined_match_the_reference(m):
    """The same inputs, made with NumPy, through the reference's
    ``decode_attention`` (positions within [0, S): the reference's mask)."""
    from repro.models.layers import decode_attention as ref_decode_attention

    q, k, v = _inputs(100 + m, torch.float32, torch.float32)
    pos = torch.tensor([0, 3, 24, 47], dtype=torch.int32)
    (got, _), _ = _sliced(q, k, v, pos, m, torch.float32)
    want = np.asarray(ref_decode_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                           jnp.asarray(v.numpy()), jnp.asarray(pos.numpy())))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5


def test_partial_edge_cases():
    """A slice with no live row (lse NEG_INF, o 0), a position at a slice's
    first row (that row alone) and last row (the whole slice), and a
    position past the slice (the whole slice)."""
    q, k, v = _inputs(7, torch.float32, torch.float32, b=4, s=12)
    start = 24
    pos = torch.tensor([23, 24, 35, 1000], dtype=torch.int32)
    o, lse = fd_ops.flash_decode_partial(q, k, v, pos, start)
    assert bool((lse[0] == NEG_INF).all()) and bool((o[0] == 0).all())
    g = H // KH
    first = v[1, 0].repeat_interleave(g, dim=0)
    assert torch.allclose(o[1, 0], first, atol=1e-6, rtol=0)
    whole = fd_ops.flash_decode_torch(q, k, v, torch.full((4,), 11, dtype=torch.int32))
    for row in (2, 3):
        assert torch.allclose(o[row], whole[row], atol=1e-5, rtol=0)
    # lse of one live row: its scaled score
    score = (q[1, 0].reshape(KH, g, HD) * k[1, 0][:, None]).sum(-1).reshape(H) / math.sqrt(HD)
    assert torch.allclose(lse[1], score, atol=1e-5, rtol=0)


def test_no_live_row_anywhere_is_zero():
    """Every slice empty for a row: every weight e^0 = 1 and every o = 0."""
    q, k, v = _inputs(3, torch.float32, torch.float32, b=2, s=8)
    pos = torch.tensor([-1, 5], dtype=torch.int32)
    parts = [fd_ops.flash_decode_partial(q, k[:, :4], v[:, :4], pos, 0),
             fd_ops.flash_decode_partial(q, k[:, 4:], v[:, 4:], pos, 4)]
    got, lse = decode_split.combine_stacked(torch.stack([p[0] for p in parts]),
                                            torch.stack([p[1] for p in parts]), torch.float32)
    assert bool((got[0] == 0).all()) and bool((lse[0] == NEG_INF).all())
    assert torch.allclose(got[1], fd_ops.flash_decode_torch(q, k, v, pos.clamp(min=0))[1],
                          atol=1e-5, rtol=0)


def test_combine_over_a_group_of_one_is_the_partial_rounded():
    q, k, v = _inputs(4, torch.bfloat16, torch.bfloat16)
    pos = torch.tensor(POSITIONS, dtype=torch.int32)
    o, lse = fd_ops.flash_decode_partial(q, k, v, pos, 0)
    got, total = decode_split.combine_partials(o, lse, [None], torch.bfloat16)
    assert torch.equal(got, o.to(torch.bfloat16)) and torch.equal(total, lse)


def test_partial_refuses_a_negative_start():
    q, k, v = _inputs(5, torch.float32, torch.float32)
    with pytest.raises(ValueError, match="cannot start"):
        fd_ops.flash_decode_partial(q, k, v, torch.zeros(B, dtype=torch.int32), -1)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["dtype", "positions_dtype", "device"])
def test_partial_refuses_what_the_kernel_does_not_take(case):
    """The CUDA path's checks on ``meta`` tensors (neither CUDA nor CPU):
    refused, and no launch counted."""
    q, c = _meta(2, 1, 4, 32), _meta(2, 16, 2, 32)
    pos = _meta(2, dtype=torch.int32)
    args = {"dtype": (_meta(2, 1, 4, 32, dtype=torch.float16), c, c, pos),
            "positions_dtype": (q, c, c, _meta(2, dtype=torch.int64)),
            "device": (q, c, c, pos)}[case]
    text = {"dtype": "float32 or bfloat16", "positions_dtype": "int32",
            "device": "lies on meta"}[case]
    before = fd_ops.flash_decode_partial.launches
    with pytest.raises((TypeError, ValueError), match=text):
        fd_ops.flash_decode_partial(*args, 16)
    assert fd_ops.flash_decode_partial.launches == before


def test_partial_counts_no_launch_on_cpu():
    before = fd_ops.flash_decode_partial.launches
    q, k, v = _inputs(6, torch.float32, torch.float32)
    fd_ops.flash_decode_partial(q, k, v, torch.zeros(B, dtype=torch.int32), 0)
    assert fd_ops.flash_decode_partial.launches == before
