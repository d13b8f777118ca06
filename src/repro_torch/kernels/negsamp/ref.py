"""Plain PyTorch version of the negative-sampling gradient kernel: the
same function as ``csrc/negsamp.cu`` written as ordinary tensor ops.
CPU tensors take it; ``chip_smoke.py`` holds the kernel against it on
the card.  It mirrors the JAX package's ``kernels/negsamp/ref.py``."""
from __future__ import annotations

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def negsamp_grads_ref(d: torch.Tensor, w: torch.Tensor, wn: torch.Tensor,
                      temperature: float = 1.0):
    """d, w [B, dim], wn [B, K, dim] float32 -> (loss [B], grad_d [B, dim],
    grad_w [B, dim], grad_wn [B, K, dim]) of the per-row SGNS loss
    softplus(-t w.d) + sum_k softplus(t wn_k.d)."""
    t = temperature
    pos = (w * d).sum(dim=-1) * t
    neg = torch.einsum("bkd,bd->bk", wn, d) * t
    loss = softplus(-pos) + softplus(neg).sum(dim=-1)
    gpos = (torch.sigmoid(pos) - 1.0) * t
    gneg = torch.sigmoid(neg) * t
    grad_d = gpos[:, None] * w + torch.einsum("bk,bkd->bd", gneg, wn)
    grad_w = gpos[:, None] * d
    grad_wn = gneg[:, :, None] * d[:, None, :]
    return loss, grad_d, grad_w, grad_wn
