"""Batched MinHash signatures over hashed shingles (``csrc/minhash_sig.cu``)."""
