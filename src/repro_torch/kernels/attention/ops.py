"""The rule that sends a self-attention call to the fused attention
forward (``kernel.py``).

``models/attention.attention_apply`` launches the kernel where
``takes_kernel``: for CUDA tensors whose call autograd does not record
(a prefill).  The kernel has no backward, so a call that records a
gradient (the train step), and CPU tensors, keep ``dense_attention``
(``ref.py``) or the chunked path; there is no fallback from the kernel
to either.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def takes_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether a self-attention call goes to the fused kernel: its
    tensors lie on CUDA and autograd does not record it."""
    return common.on_cuda(q, k, v) and not records_grad(q, k, v)
