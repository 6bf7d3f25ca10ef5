"""The grouped expert product of the MoE layers (``csrc/moe_gemm.cu``)."""
