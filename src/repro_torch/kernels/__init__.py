"""Hand-written CUDA kernels (sources under ``repro_torch/csrc``) with their
PyTorch wrappers.  Each family keeps three files: ``ops.py`` (the wrapper,
its launch count and the plain PyTorch version of the same function),
``ref.py`` (a NumPy oracle) and the ``.cu`` source.  Nothing here builds or
loads a kernel at import: that happens inside the first launch.

* dgap_decode      — device-wide prefix sum: posting-list decompression
* anchor_intersect — anchor probes: whole-array searchsorted (``anchor_probe``)
                     and the serving path's per-slice lower bound
* fused_decode     — per-row bounded rule expansion (+ fused membership
                     probe) for the fused device layout
* minhash_sig      — batched MinHash signatures (version-structure mining)
* flash_attention  — causal / non-causal GQA attention forward (LM prefill)
* flash_decode     — one-token attention over a KV cache (LM decode)
* embedding_bag    — bag sums of table rows (recsys lookups)
* cin_interaction  — one xDeepFM CIN layer, fused with its outer product
* moe_gemm         — the grouped expert product of the MoE layers

The public ops are the reference's, under its names.
"""

from .anchor_intersect.ops import anchor_probe
from .cin_interaction.ops import cin_layer
from .dgap_decode.ops import dgap_decode
from .embedding_bag.ops import embedding_bag
from .flash_attention.ops import flash_attention_tpu
from .flash_decode.ops import flash_decode
from .fused_decode.ops import decode_rows, probe_rows
from .minhash_sig.ops import hash_params, minhash_signatures
from .moe_gemm.ops import moe_gemm

__all__ = ["anchor_probe", "cin_layer", "decode_rows", "dgap_decode", "embedding_bag",
           "flash_attention_tpu", "flash_decode", "hash_params", "minhash_signatures",
           "moe_gemm", "probe_rows"]
