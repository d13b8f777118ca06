"""Spherical k-means assignment (document allocation)."""
from repro_torch.kernels.kmeans.ops import assign, assign_with_scores  # noqa: F401
