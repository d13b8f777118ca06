"""Plain PyTorch version of the fused attention forward: the port's
dense GQA attention, which materialises the scores [B, KH, G, S, T].
CPU tensors take it, every call that records a gradient takes it (the
train step), and ``chip_smoke.py`` holds the kernel against it on the
card.  It mirrors the JAX package's ``models/attention.py``
``dense_attention``; ``models/attention.py`` imports it from here, with
the helpers its decode paths share."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _sqrt_in(hd: int, dtype) -> float:
    """sqrt(hd) computed in float32 and rounded to ``dtype``, as the
    reference's ``jnp.sqrt(hd).astype(q.dtype)``."""
    return float(torch.sqrt(torch.tensor(float(hd))).to(dtype))


def _divisor(hd: int, dtype, scale: Optional[float] = None) -> float:
    """The scores' divisor: ``_sqrt_in(hd, dtype)``, or where a
    configuration states its score scale (Granite's
    ``attention_multiplier``), 1 / ``scale`` rounded to ``dtype``."""
    if scale is None:
        return _sqrt_in(hd, dtype)
    return float(torch.tensor(1.0 / scale).to(dtype))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B, S, KH, G, hd], k: [B, T, KH, hd] -> [B, KH, G, S, T]."""
    return torch.einsum("bskgd,btkd->bkgst", q, k)


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: [B, KH, G, S, T], v: [B, T, KH, hd] -> [B, S, KH, G, hd]."""
    return torch.einsum("bkgst,btkd->bskgd", p, v)


def _causal_mask(s: int, t: int, offset: int, window: int,
                 device) -> torch.Tensor:
    """[S, T] True = visible.  offset positions precede the queries."""
    qpos = torch.arange(s, device=device)[:, None] + offset
    kpos = torch.arange(t, device=device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > (qpos - window)
    return mask


def dense_attention(
    q: torch.Tensor,              # [B, S, H, hd]
    k: torch.Tensor,              # [B, T, KH, hd]
    v: torch.Tensor,              # [B, T, KH, hd]
    *,
    causal: bool,
    window: int = 0,
    q_offset: int = 0,
    kv_valid_len: Optional[torch.Tensor] = None,   # [B] for decode masking
    scale: Optional[float] = None,                 # None: 1 / sqrt(hd)
) -> torch.Tensor:
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, hd)
    scores = _gqa_scores(qg, k) / _divisor(hd, q.dtype, scale)
    mask = None
    if causal:
        mask = _causal_mask(s, t, q_offset, window, q.device)[None, None, None]
    if kv_valid_len is not None:
        valid = (torch.arange(t, device=q.device)[None, :]
                 < kv_valid_len[:, None])                    # [B, T]
        valid = valid[:, None, None, None, :]
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = _gqa_out(p, v)
    return out.reshape(b, s, h, hd)
