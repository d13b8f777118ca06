"""Statistics helpers (``stats``) and tree math over nested dicts of
tensors (``trees``)."""
from repro_torch.utils.trees import (  # noqa: F401
    tree_bytes,
    tree_global_norm,
    tree_param_count,
    tree_zeros_like,
)
from repro_torch.utils.stats import t_critical_value  # noqa: F401
