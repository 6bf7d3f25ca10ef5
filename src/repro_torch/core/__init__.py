"""Index structures: d-gaps, codecs, Re-Pair stores, anchored device arrays."""
