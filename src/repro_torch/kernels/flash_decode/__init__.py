"""One-token attention over a KV cache (``csrc/flash_decode.cu``)."""
