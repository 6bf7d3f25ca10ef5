"""Bag sums of table rows (``csrc/embedding_bag.cu``)."""
