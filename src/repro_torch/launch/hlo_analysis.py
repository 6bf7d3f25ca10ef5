"""Roofline terms of one rank's step (``repro.launch.hlo_analysis``, with
the NVIDIA H100's constants in place of the reference's TPU ones).

The :class:`Roofline` record and :func:`roofline_terms` are the reference's:
compute time = FLOPs / peak FLOP/s, memory time = HBM bytes / HBM rate,
collective time = collective bytes / link rate, the largest of the three
dominant; ``useful_fraction`` = model FLOPs / (FLOPs per rank x ranks).

Hardware model: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit.
These are datasheet peaks, not measurements:

* ``PEAK_FLOPS`` 989e12: dense bf16 tensor-core FLOP/s (NVIDIA H100
  datasheet, SXM, without sparsity).
* ``HBM_BW`` 3.35e12 bytes/s: HBM3 (same datasheet).
* ``COLL_BW`` 50e9 bytes/s a rank: one 400 Gb/s InfiniBand NDR port a GPU
  (ConnectX-7, eight to a DGX H100 host; DGX H100 datasheet).  The
  production meshes hold 256 or 512 ranks, 32 or 64 hosts of eight cards,
  and the port's collectives (the whole-weight gather and the gradient
  all-reduce over every mesh axis, :mod:`repro_torch.sharding.spmd`) cross
  hosts, so each rank's bytes leave through its own NIC: that port, not
  NVLink's 450e9 bytes/s each way inside a host of eight, bounds them.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s per card (datasheet)
HBM_BW = 3.35e12  # HBM3 bytes/s per card (datasheet)
COLL_BW = 50e9  # bytes/s per rank across hosts: one 400 Gb/s NDR port (datasheet)

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "fn": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1,
}


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    n_chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    useful_fraction: float = 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "n_chips": self.n_chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_fraction": self.useful_fraction,
        }


def roofline_terms(cost: dict, coll, n_chips: int,
                   model_flops: float = 0.0) -> Roofline:
    """``coll`` is any object with a ``total_bytes`` attribute; ``cost``
    holds ``"flops"`` and ``"bytes accessed"`` of one rank's step."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    cb = float(coll.total_bytes)
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm / HBM_BW
    coll_s = cb / COLL_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    useful = 0.0
    if model_flops and flops:
        useful = model_flops / (flops * n_chips)
    return Roofline(
        flops=flops, hbm_bytes=hbm, collective_bytes=cb, n_chips=n_chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dominant, model_flops=model_flops, useful_fraction=useful,
    )
