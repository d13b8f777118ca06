"""Fused attention forward (the prefill's self-attention)."""
from repro_torch.kernels.attention.kernel import fused_attention_kernel  # noqa: F401
from repro_torch.kernels.attention.ops import takes_kernel  # noqa: F401
