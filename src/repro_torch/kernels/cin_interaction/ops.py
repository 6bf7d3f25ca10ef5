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
