"""Anchor probes: per-slice lower bound and whole-array searchsorted (``csrc/anchor_intersect.cu``)."""
