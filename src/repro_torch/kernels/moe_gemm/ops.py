"""The grouped expert product over the MoE dispatch buffer:
``out[e] = buf[e] @ w[e]``, buf (E, C, D), w (E, D, F), out (E, C, F)
float32.

On a CUDA tensor ``moe_gemm`` launches ``csrc/moe_gemm.cu`` (or raises), one
launch for every expert, by the route :func:`moe_gemm_route` picks from the
operands' dtypes, shapes and alignment before the launch (never after a
failure): ``wgmma`` (bf16 tensor cores, prefill), ``small_c`` (C <= 8 rows,
a weight stream, decode) or ``fma`` (CUDA cores, everything else).  On a
CPU tensor it runs ``moe_gemm_torch``, the plain PyTorch version: both
operands widened to float32, one batched product.  All sum exact products
of the widened operands in float32 (the tensor cores with truncating
adds); they differ only in the order and rounding of the sums.  None pads
C, D or F (the reference's op pads them to its TPU tiles).

Training goes through :class:`MoeGemm`, whose forward and both backward
products are grouped products of the same kind, each one call of the gemm
it is given (default :func:`moe_gemm`: three launches of the kernel): ``out
= buf @ w``, ``dbuf = dout @ w^T`` (E, C, F) x (E, F, D) and ``dw = buf^T @
dout`` (E, D, C) x (E, C, F), on contiguous transposed copies.
"""

from __future__ import annotations

import torch

from .. import cuda_build

#: most experts one launch takes (the grid's z extent)
MAX_EXPERTS = 65535
#: the kernel's routes and the codes its launch function takes
ROUTE_CODES = {"fma": 0, "wgmma": 1, "small_c": 2}
#: most rows (C) the small_c route takes
SMALL_C = 8


def _check_shapes(buf: torch.Tensor, w: torch.Tensor) -> None:
    if buf.dim() != 3 or w.dim() != 3:
        raise ValueError(f"expected buf (E, C, D) and w (E, D, F), got {tuple(buf.shape)}, "
                         f"{tuple(w.shape)}")
    if buf.shape[0] != w.shape[0] or buf.shape[2] != w.shape[1]:
        raise ValueError(f"buf {tuple(buf.shape)} and w {tuple(w.shape)} do not fit")


def moe_gemm_torch(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`moe_gemm`."""
    _check_shapes(buf, w)
    return torch.bmm(buf.float(), w.float())


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def moe_gemm_route(buf: torch.Tensor, w: torch.Tensor) -> str:
    """The route a launch on these operands takes, from their dtypes,
    shapes, strides and alignment alone: ``"small_c"`` for bf16 operands
    with C <= :data:`SMALL_C`, F a multiple of 8 and w 16-byte aligned (each
    thread reads w 16 bytes at a time); ``"wgmma"`` for bf16 operands with D
    and F multiples of 8 and both 16-byte aligned (TMA's 16-byte rule for
    row strides and bases); ``"fma"`` for the rest (float32 or mixed
    operands, bf16 shapes the other two cannot take)."""
    _check_shapes(buf, w)
    d, f = buf.shape[2], w.shape[2]
    bf16 = torch.bfloat16
    if (buf.dtype == w.dtype == bf16 and buf.is_contiguous() and w.is_contiguous()
            and f % 8 == 0 and _aligned16(w)):
        if buf.shape[1] <= SMALL_C:
            return "small_c"
        if d > 0 and d % 8 == 0 and _aligned16(buf):
            return "wgmma"
    return "fma"


def _operand(name: str, t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The kernel reads float32 or bfloat16 in place; another float dtype is
    widened to float32 first (the reference's kernel casts in its body)."""
    if not t.is_floating_point():
        raise TypeError(f"{name}: expected a float tensor, got {t.dtype}")
    if str(t.dtype) not in cuda_build.FLOAT_CODES:
        t = t.float()
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t, cuda_build.require_float(name, t, 3)


def moe_gemm(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """buf (E, C, D), w (E, D, F), contiguous, of any float dtypes (not
    necessarily the same) on one device -> (E, C, F) float32.  It has no
    backward: a call that would need one is refused."""
    _check_shapes(buf, w)
    if buf.device.type == "cpu":
        return moe_gemm_torch(buf, w)
    cuda_build.require_cuda("buf", buf)
    if w.device != buf.device:
        raise ValueError(f"w lies on {w.device}, buf on {buf.device}")
    cuda_build.require_no_grad("moe_gemm", buf, w)
    buf, buf_dtype = _operand("buf", buf)
    w, w_dtype = _operand("w", w)
    e, c, d = buf.shape
    f = w.shape[2]
    if e > MAX_EXPERTS:
        raise ValueError(f"{e} experts: one launch takes at most {MAX_EXPERTS}")
    out = torch.empty((e, c, f), dtype=torch.float32, device=buf.device)
    if out.numel() == 0:
        return out
    route = moe_gemm_route(buf, w)
    lib = cuda_build.load()
    with torch.cuda.device(buf.device):
        code = lib.moe_gemm_launch(buf.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                                   buf_dtype, w_dtype, ROUTE_CODES[route],
                                   cuda_build.stream_ptr())
    cuda_build.check(code, f"moe_gemm ({route})")
    moe_gemm.launches += 1
    moe_gemm.launches_by_route[route] += 1
    return out


#: kernel launches made by the wrapper (never raised by the plain version),
#: in all and by route
moe_gemm.launches = 0
moe_gemm.launches_by_route = dict.fromkeys(ROUTE_CODES, 0)

#: launches made by :class:`MoeGemm`'s backward (also counted in ``launches``)
moe_gemm.launches_backward = 0


class MoeGemm(torch.autograd.Function):
    """``MoeGemm.apply(buf, w, gemm)``: ``gemm(buf, w)`` (default
    :func:`moe_gemm`) cast to buf's dtype, which is what the MoE layer uses
    (the reference's einsum gives its operands' dtype).  So the output
    gradient arrives in that dtype, and the backward's two products take
    operands of the forward's dtypes: bf16 x bf16 for a bf16 model, the
    route the forward takes, with no rounding the plain path's float32
    products would not also make (a bf16 gradient widens to float32
    exactly).  Each gradient comes back in its input's dtype."""

    @staticmethod
    def forward(ctx, buf, w, gemm=None):
        ctx.save_for_backward(buf, w)
        ctx.gemm = gemm or moe_gemm
        return ctx.gemm(buf, w).to(buf.dtype)

    @staticmethod
    def backward(ctx, dout):
        buf, w = ctx.saved_tensors
        n0 = moe_gemm.launches
        dout = dout.contiguous()
        dbuf = dw = None
        if ctx.needs_input_grad[0]:
            dbuf = ctx.gemm(dout, w.transpose(1, 2).contiguous()).to(buf.dtype)
        if ctx.needs_input_grad[1]:
            dw = ctx.gemm(buf.transpose(1, 2).contiguous(), dout).to(w.dtype)
        moe_gemm.launches_backward += moe_gemm.launches - n0
        return dbuf, dw, None
