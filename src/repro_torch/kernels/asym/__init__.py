"""Batched asymmetric-LSH exp-similarity: similarity and segment sum."""
