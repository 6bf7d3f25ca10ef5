"""Bounded rule expansion for the fused layout (``csrc/fused_decode.cu``)."""
