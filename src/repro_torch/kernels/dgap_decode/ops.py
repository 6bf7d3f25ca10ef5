"""Decode a 1-D d-gap stream: ``posting = cumsum(gaps) - 1``, in int32 with
wraparound (a long stream's running sum passes 2^31 and wraps, as the
reference's does).

On a CUDA tensor ``dgap_decode`` launches the three-phase scan of
``csrc/dgap_decode.cu`` (or raises); on a CPU tensor it runs
``dgap_decode_torch``, the plain PyTorch version of the same function.
"""

from __future__ import annotations

import torch

from .. import cuda_build

#: values one block of the kernel scans (``kTile`` of ``csrc/dgap_decode.cu``);
#: the wrapper allocates one workspace word per tile
TILE = 4096

_MASK32 = 0xFFFFFFFF


def dgap_decode_torch(gaps: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dgap_decode`.  ``torch.cumsum`` of an
    int32 tensor would promote to int64, so the sum is taken in int64 and
    its low 32 bits are handed back as int32 explicitly."""
    low = (torch.cumsum(gaps.long(), 0) - 1) & _MASK32
    return (low - ((low >> 31) << 32)).to(torch.int32)


def dgap_decode(gaps: torch.Tensor) -> torch.Tensor:
    """(n,) int32 gaps -> (n,) int32 absolute values, ``cumsum - 1``.

    ``n == 0`` gives an empty tensor and ``n == 1`` gives ``gaps - 1``;
    neither launches.
    """
    if gaps.device.type == "cpu":
        return dgap_decode_torch(gaps)
    cuda_build.require_cuda("gaps", gaps)
    cuda_build.require_int32("gaps", gaps)
    n = gaps.shape[0]
    if n <= 1:
        return dgap_decode_torch(gaps)
    out = torch.empty(n, dtype=torch.int32, device=gaps.device)
    workspace = torch.empty(-(-n // TILE), dtype=torch.int32, device=gaps.device)
    lib = cuda_build.load()
    with torch.cuda.device(gaps.device):
        code = lib.dgap_decode_launch(gaps.data_ptr(), out.data_ptr(), workspace.data_ptr(),
                                      workspace.shape[0], n, cuda_build.stream_ptr())
    cuda_build.check(code, "dgap_decode")
    dgap_decode.launches += 1
    return out


#: kernel launches made by the wrapper (never raised by the plain version)
dgap_decode.launches = 0
