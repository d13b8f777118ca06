"""Plain PyTorch and numpy pieces shared by the references: matrix
products at a stated precision, RMSNorm, the AdamW step and its
learning-rate schedule, and the packing of documents into training
rows.  Imports nothing of the program.

Precision: "fp32" is float32 throughout with TF32 off.  "fp8" is the
control: every operand of every matrix product (the weights', the
activations', the attention's inner products) rounded to
float8 e4m3 with one scale per tensor (its largest magnitude to 448),
and the gradient flowing back into each operand rounded to e5m2 the
same way; accumulation stays float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x / scale).to(dtype).to(x.dtype)) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return x
    if precision == "fp8":
        return _Fp8.apply(x)
    raise ValueError(precision)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return operand(a, precision) @ operand(b, precision)


def einsum(eq: str, *ops: torch.Tensor, precision: str) -> torch.Tensor:
    return torch.einsum(eq, *[operand(o, precision) for o in ops])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross-entropy of float32 ``logits``."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -lp.gather(-1, labels[..., None].long()).sum()


def lr_scale(step: int, warmup: int, total: int, min_ratio: float) -> float:
    """Linear warm-up, then a cosine to ``min_ratio``, at the number of
    updates made before this one."""
    warm = min(step / max(warmup, 1), 1.0)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return warm * (min_ratio + (1 - min_ratio) * 0.5
                   * (1 + math.cos(math.pi * prog)))


def adamw_step(params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor],
               m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor],
               t: int, opt: dict) -> float:
    """The ``t``-th update (from 1), in place, float32: the gradient
    clipped to a global norm of ``grad_clip``; decoupled decay added to
    the Adam direction of every leaf not in ``decay_exempt``.  Returns
    the gradient's global norm before clipping."""
    gnorm = math.sqrt(sum(float(g.double().pow(2).sum())
                          for g in grads.values()))
    clip = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9)) \
        if opt["grad_clip"] > 0 else 1.0
    lr = opt["lr"] * lr_scale(t - 1, opt["warmup_steps"],
                              opt["total_steps"], opt["min_lr_ratio"])
    b1, b2 = opt["b1"], opt["b2"]
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k] * clip
            m[k].mul_(b1).add_((1 - b1) * g)
            v[k].mul_(b2).add_((1 - b2) * g * g)
            d = (m[k] / (1 - b1 ** t)) / (
                torch.sqrt(v[k] / (1 - b2 ** t)) + opt["eps"])
            if k not in opt["decay_exempt"]:
                d = d + opt["weight_decay"] * p
            p.sub_(lr * d)
    return gnorm


def pack_rows(docs: Sequence[np.ndarray], first_row: int, rows: int,
              seq: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rows ``first_row`` .. ``first_row + rows - 1`` of the documents
    laid end to end in order and cut into rows of ``seq + 1`` tokens:
    (tokens, next-token labels), each [rows, seq]."""
    need = (first_row + rows) * (seq + 1)
    parts: List[np.ndarray] = []
    have = 0
    for d in docs:
        parts.append(d)
        have += len(d)
        if have >= need:
            break
    if have < need:
        raise ValueError("the documents hold fewer rows than asked for")
    flat = np.concatenate(parts)[first_row * (seq + 1):need]
    block = flat.reshape(rows, seq + 1).astype(np.int64)
    return block[:, :-1], block[:, 1:]


def loss_and_grads(model, params: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, labels: torch.Tensor,
                   block: int, scale_rows: int | None = None):
    """Mean next-token loss over all rows and its gradient, computed
    ``block`` rows at a time (the mean of a sum is linear in the
    rows).  ``scale_rows`` counts the rows the mean divides by (all of
    them unless given)."""
    n = (scale_rows or tokens.shape[0]) * tokens.shape[1]
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    total = 0.0
    for i in range(0, tokens.shape[0], block):
        for p in params.values():
            p.grad = None
        loss = model.nll_sum(tokens[i:i + block], labels[i:i + block]) / n
        loss.backward()
        total += float(loss.detach())
        for k, p in params.items():
            if p.grad is not None:
                grads[k] += p.grad
    for p in params.values():
        p.grad = None
    return total, grads
