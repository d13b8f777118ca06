"""Fused PV-DBOW negative-sampling gradients and the SGD step."""
from repro_torch.kernels.negsamp.ops import negsamp_grads, negsamp_step  # noqa: F401
