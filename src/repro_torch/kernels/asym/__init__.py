"""Batched asymmetric-LSH exp-similarity: similarity, segment sum and
per-tile top-k."""
