"""Index, LSH and sampling: the paper's core, on torch."""
