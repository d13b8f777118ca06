"""Statistics helpers (``stats``) and tree math over nested dicts of
tensors (``trees``)."""
