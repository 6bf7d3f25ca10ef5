"""GQA flash attention forward in model layout: q (B, T, H, hd), k / v
(B, S, K, hd), head ``h`` reading KV head ``h // (H // K)``.

On a CUDA tensor ``flash_attention_tpu`` launches ``csrc/flash_attention.cu``
(or raises), by the instance :func:`flash_attention_route` picks from the
operands before the launch: ``wgmma`` (bf16 tensor cores, hd 64 / 128,
strides and bases TMA can read) or ``fma`` (CUDA cores, everything else).
On a CPU tensor it runs ``flash_attention_torch``, the plain PyTorch
version of the same function: the model's plain attention
(``models.flash.flash_attention``) over one KV block of all S keys.  Both
follow the TPU kernel's order of operations: cast to float32 first, then
scale q by ``1/sqrt(hd)``; masked scores take the sentinel ``NEG_INF`` and
their probabilities 0; the output is ``acc / max(l, 1e-30)`` in q's dtype.

``flash_attention_split_torch`` repeats the ``wgmma`` instance's arithmetic
in plain PyTorch (scores scaled after the sum, ``exp2``, P split into bf16
terms); tests and ``chip_smoke.py`` hold it against the reference, the
model never calls it.

With ``return_lse`` both (the kernel's two instances and the plain version)
also return each row's natural log-sum-exp of its scaled scores, float32
(B, T, H): the residual of the backward.  :func:`flash_attention_tpu_fwd`
is that launch as the forward of ``models.flash.FlashAttention``, whose
backward is the reference's custom VJP in plain PyTorch (the reference has
no backward kernel).
"""

from __future__ import annotations

import math

import torch

from ...models.flash import NEG_INF, flash_attention_fwd
from .. import cuda_build

#: head dims the kernel is built for (one template instance each)
HEAD_DIMS = (16, 32, 64, 128)
#: the head dims of the wgmma instance
WGMMA_HEAD_DIMS = (64, 128)
#: the kernel's instances and the codes its launch function takes
ROUTE_CODES = {"fma": 0, "wgmma": 1}
#: bf16 terms the wgmma instance splits P into (``kPTerms`` of the source)
P_TERMS = 3
LOG2E = 1.4426950408889634


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q (B, T, H, hd) and k, v (B, S, K, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} KV heads")
    if k.shape[1] == 0:
        raise ValueError("no keys (S == 0)")


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, return_lse: bool = False):
    """Plain PyTorch version of :func:`flash_attention_tpu`: one block of all
    S keys, so the whole (B, T, K, G, S) score tensor in float32 at once (a
    softmax over every key, which is what the kernel's online recurrence
    computes)."""
    _check_shapes(q, k, v)
    out, lse = flash_attention_fwd(q, k, v, causal, block_kv=k.shape[1])
    return (out, lse.reshape(q.shape[:3])) if return_lse else out


def _tma_ready(t: torch.Tensor) -> bool:
    """TMA reads the tensor in place: 16-byte aligned base, positive
    strides of whole 16-byte units (8 bf16) but the last, which is 1."""
    return (t.data_ptr() % 16 == 0 and t.stride(3) == 1
            and all(t.stride(i) > 0 and t.stride(i) % 8 == 0 for i in range(3)))


def flash_attention_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The instance a launch on these operands takes, from their dtypes,
    shapes, strides and alignment alone: ``"wgmma"`` for bf16 q, k and v
    with hd in :data:`WGMMA_HEAD_DIMS` that TMA can read in place, else
    ``"fma"``."""
    _check_shapes(q, k, v)
    if (q.dtype == k.dtype == v.dtype == torch.bfloat16 and q.shape[3] in WGMMA_HEAD_DIMS
            and all(_tma_ready(x) for x in (q, k, v))):
        return "wgmma"
    return "fma"


def flash_attention_split_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                causal: bool = True, terms: int | None = P_TERMS
                                ) -> torch.Tensor:
    """Plain PyTorch copy of the ``wgmma`` instance's arithmetic, for tests
    and ``chip_smoke.py`` only: float32 scores from the operands (exact
    products of bf16 values), scaled by ``scale * log2(e)`` after the sum;
    masked scores ``NEG_INF`` and their p 0; ``p = exp2(x - max)``; P split
    into ``terms`` bf16 terms (each the rounding of what the earlier ones
    left; ``None``: the float32 P itself, unsplit), each multiplied by v in
    float32 and added; ``l`` the float32 sum of p; ``out = acc / max(l,
    1e-30)`` in q's dtype.  One softmax over all S keys (the kernel's online
    recurrence computes the same)."""
    _check_shapes(q, k, v)
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, t, kh, h // kh, hd)
    scale_log2 = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32)).item()
    x = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * scale_log2
    if causal:
        live = (torch.arange(s, device=q.device)[None, :]
                <= torch.arange(t, device=q.device)[:, None])
        x = torch.where(live, x, torch.tensor(NEG_INF, dtype=x.dtype, device=x.device))
    mx = x.amax(dim=-1, keepdim=True)
    p = torch.where(x == NEG_INF, torch.zeros((), dtype=x.dtype, device=x.device),
                    torch.exp2(x - mx))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.zeros((b, kh, h // kh, t, hd), dtype=torch.float32, device=q.device)
    rest = p
    for _ in range(1 if terms is None else terms):
        part = rest if terms is None else rest.to(torch.bfloat16).float()
        acc = acc + torch.einsum("bkgts,bskd->bkgtd", part, v.float())
        rest = rest - part
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).to(q.dtype)


def flash_attention_tpu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, return_lse: bool = False):
    """q (B, T, H, hd); k, v (B, S, K, hd), GQA with H a multiple of K.
    Returns (B, T, H, hd) in q's dtype, and with ``return_lse`` also the
    rows' log-sum-exp (B, T, H) float32.

    The kernel takes float32 or bfloat16 (q, k and v of one dtype), head dims
    :data:`HEAD_DIMS`, and any strides whose last one is 1 (the model layout
    is read in place).  Under ``causal`` key ``s`` is seen by query ``t`` when
    ``s <= t``, both counted from 0.  It has no backward: a call that would
    need one is refused.
    """
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal, return_lse)
    dtype = cuda_build.require_float("q", q, 4)
    for name, t in (("k", k), ("v", v)):
        if cuda_build.require_float(name, t, 4) != dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}: the kernel takes one dtype")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    _check_shapes(q, k, v)
    b, t, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel is built for {HEAD_DIMS}")
    cuda_build.require_cuda("q", q)
    cuda_build.require_no_grad("flash_attention_tpu", q, k, v)
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, t, h), dtype=torch.float32, device=q.device) if return_lse else None
    if b == 0 or t == 0 or h == 0:
        return (out, lse) if return_lse else out
    route = flash_attention_route(q, k, v)
    lib = cuda_build.load()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, t, s, h, kh, hd, dtype, int(causal), 1.0 / math.sqrt(hd),
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), ROUTE_CODES[route], cuda_build.stream_ptr())
    cuda_build.check(code, f"flash_attention_tpu ({route})")
    flash_attention_tpu.launches += 1
    flash_attention_tpu.launches_by_route[route] += 1
    if return_lse:
        flash_attention_tpu.launches_lse += 1
    return (out, lse) if return_lse else out


#: kernel launches made by the wrapper (never raised by the plain version),
#: in all, by instance, and those that also wrote the log-sum-exp
flash_attention_tpu.launches = 0
flash_attention_tpu.launches_by_route = dict.fromkeys(ROUTE_CODES, 0)
flash_attention_tpu.launches_lse = 0


def flash_attention_tpu_fwd(q, k, v, causal: bool = True, block_kv: int | None = None):
    """``(out, lse)`` from the kernel, launched with ``return_lse``: the
    forward that ``models.flash.FlashAttention`` takes to train through the
    kernel (``FlashAttention.apply(q, k, v, causal, block_kv,
    flash_attention_tpu_fwd)``).  ``block_kv`` is the plain recurrence's KV
    block; the kernel has its own tiles and ignores it."""
    return flash_attention_tpu(q, k, v, causal, return_lse=True)
