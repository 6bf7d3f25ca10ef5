"""GQA flash attention forward (``csrc/flash_attention.cu``)."""
