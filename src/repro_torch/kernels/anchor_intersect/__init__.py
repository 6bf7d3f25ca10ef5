"""Per-query lower bound inside a list's anchor slice (``csrc/anchor_intersect.cu``)."""
