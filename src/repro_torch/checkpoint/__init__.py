"""Checkpoints of train states in the reference's on-disk format."""
