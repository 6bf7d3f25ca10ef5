"""One xDeepFM CIN layer,
``out[b, h, d] = sum_{i, j} w[i * Hk + j, h] * x0[b, i, d] * xk[b, j, d]``,
in float32.

On a CUDA tensor ``cin_layer`` launches ``csrc/cin_interaction.cu`` (or
raises), which never writes the (B, m * Hk, D) outer product to memory; on a
CPU tensor it runs ``cin_layer_torch``, the plain PyTorch version: the
reference's two einsums (outer product, then the contraction with w), in
batch chunks whose outer product stays under :data:`PLAIN_CHUNK_BYTES` (at
xDeepFM's widths the whole product of a 262,144-row batch is 81.8 GB).  As
the reference's op, both cast every input to float32 first; neither pads.

Training goes through :class:`CinLayer`: its forward is the kernel (or the
layer the caller passes), its backward :func:`cin_layer_backward`, plain
PyTorch in the same batch chunks as the plain forward (at 65,536 rows of
xDeepFM the whole outer product would be 20 GB).
"""

from __future__ import annotations

import torch

from .. import cuda_build

#: bytes of outer product the plain version holds at once
PLAIN_CHUNK_BYTES = 1 << 30


def _check_shapes(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor) -> None:
    if x0.dim() != 3 or xk.dim() != 3 or w.dim() != 2:
        raise ValueError(f"expected x0 (B, m, D), xk (B, Hk, D) and w (m * Hk, H), got "
                         f"{tuple(x0.shape)}, {tuple(xk.shape)}, {tuple(w.shape)}")
    b, m, d = x0.shape
    if xk.shape[0] != b or xk.shape[2] != d or w.shape[0] != m * xk.shape[1]:
        raise ValueError(f"x0 {tuple(x0.shape)}, xk {tuple(xk.shape)} and w "
                         f"{tuple(w.shape)} do not fit")


def plain_chunk_rows(m: int, hk: int, d: int) -> int:
    """Batch rows per chunk of the plain version: the float32 outer product
    of a chunk, (rows, m * Hk, D), stays within :data:`PLAIN_CHUNK_BYTES`."""
    return max(1, PLAIN_CHUNK_BYTES // max(4 * m * hk * d, 1))


def cin_layer_torch(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`cin_layer`."""
    _check_shapes(x0, xk, w)
    x0, xk, w = x0.float(), xk.float(), w.float()
    b, m, d = x0.shape
    hk = xk.shape[1]
    out = torch.empty((b, w.shape[1], d), dtype=torch.float32, device=x0.device)
    step = plain_chunk_rows(m, hk, d)
    for s in range(0, b, step):
        inter = torch.einsum("bmd,bhd->bmhd", x0[s:s + step], xk[s:s + step])
        out[s:s + step] = torch.einsum("bid,ih->bhd", inter.reshape(len(inter), m * hk, d), w)
    return out


def cin_layer(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x0 (B, m, D), xk (B, Hk, D), w (m * Hk, H), any float dtype, on one
    device -> (B, H, D) float32.  Inputs that are not contiguous float32 are
    copied to that first (the reference's op casts them too).  It has no
    backward: a call that would need one is refused."""
    _check_shapes(x0, xk, w)
    if x0.device.type == "cpu":
        return cin_layer_torch(x0, xk, w)
    cuda_build.require_cuda("x0", x0)
    for name, t in (("xk", xk), ("w", w)):
        if t.device != x0.device:
            raise ValueError(f"{name} lies on {t.device}, x0 on {x0.device}")
        if not t.is_floating_point():
            raise TypeError(f"{name}: expected a float tensor, got {t.dtype}")
    if not x0.is_floating_point():
        raise TypeError(f"x0: expected a float tensor, got {x0.dtype}")
    cuda_build.require_no_grad("cin_layer", x0, xk, w)
    x0, xk, w = (t.float().contiguous() for t in (x0, xk, w))
    b, m, d = x0.shape
    hk, h = xk.shape[1], w.shape[1]
    out = torch.empty((b, h, d), dtype=torch.float32, device=x0.device)
    if out.numel() == 0:
        return out
    if m * hk == 0:
        return out.zero_()
    lib = cuda_build.load()
    with torch.cuda.device(x0.device):
        code = lib.cin_layer_launch(x0.data_ptr(), xk.data_ptr(), w.data_ptr(), out.data_ptr(),
                                    b, m, hk, h, d, cuda_build.stream_ptr())
    cuda_build.check(code, "cin_layer")
    cin_layer.launches += 1
    return out


#: kernel launches made by the wrapper (never raised by the plain version)
cin_layer.launches = 0


def cin_layer_backward(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor,
                       dout: torch.Tensor):
    """``(dx0, dxk, dw)`` float32 of :func:`cin_layer` for the output
    gradient ``dout`` (B, H, D): with ``z[b, i*Hk + j, d] = x0[b, i, d] *
    xk[b, j, d]`` and ``dz = w @ dout``, ``dw = sum_{b, d} z dout``, ``dx0 =
    sum_j dz xk`` and ``dxk = sum_i dz x0``; z and dz one batch chunk of
    :func:`plain_chunk_rows` rows at a time, dw summed over the chunks in
    order."""
    _check_shapes(x0, xk, w)
    x0, xk, w, dout = x0.float(), xk.float(), w.float(), dout.float()
    b, m, d = x0.shape
    hk = xk.shape[1]
    dx0, dxk = torch.empty_like(x0), torch.empty_like(xk)
    dw = torch.zeros_like(w)
    step = plain_chunk_rows(m, hk, d)
    for s in range(0, b, step):
        a, bk, g = x0[s:s + step], xk[s:s + step], dout[s:s + step]
        z = torch.einsum("bmd,bhd->bmhd", a, bk).reshape(len(a), m * hk, d)
        dw = dw + torch.einsum("bid,bhd->ih", z, g)
        del z
        dz = torch.einsum("ih,bhd->bid", w, g).reshape(len(a), m, hk, d)
        dx0[s:s + step] = torch.einsum("bmhd,bhd->bmd", dz, bk)
        dxk[s:s + step] = torch.einsum("bmhd,bmd->bhd", dz, a)
    return dx0, dxk, dw


class CinLayer(torch.autograd.Function):
    """``CinLayer.apply(x0, xk, w, layer)``: ``layer(x0, xk, w)`` (default
    :func:`cin_layer`: the kernel on CUDA) as the forward, (B, H, D)
    float32; :func:`cin_layer_backward` as the backward, each gradient in
    its input's dtype."""

    @staticmethod
    def forward(ctx, x0, xk, w, layer=None):
        ctx.save_for_backward(x0, xk, w)
        return (layer or cin_layer)(x0, xk, w)

    @staticmethod
    def backward(ctx, dout):
        x0, xk, w = ctx.saved_tensors
        dx0, dxk, dw = cin_layer_backward(x0, xk, w, dout)
        return dx0.to(x0.dtype), dxk.to(xk.dtype), dw.to(w.dtype), None
