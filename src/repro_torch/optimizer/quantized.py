"""Blockwise int8 quantization for optimizer state and gradients.

Dynamic blockwise quantization (Dettmers et al., 8-bit optimizers):
flatten, split into blocks of 256, store int8 codes + one fp32 absmax
scale per block.  Linear codes, as the JAX package's.  The division is
``blocks / scales`` in fp32 and ``torch.round`` rounds half to even as
``jnp.round`` does, so the codes are the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

BLOCK = 256


class Q8State(NamedTuple):
    codes: torch.Tensor    # int8  [n_blocks, BLOCK]
    scales: torch.Tensor   # float32 [n_blocks]
    size: int              # original element count (static: not a leaf)

    _static = ("size",)    # see utils/trees.py


def q8_quantize(x: torch.Tensor) -> Q8State:
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    pad = (-n) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    absmax = torch.amax(torch.abs(blocks), dim=1)
    scales = torch.clamp(absmax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127
                        ).to(torch.int8)
    return Q8State(codes, scales, n)


def q8_dequantize(s: Q8State, shape: Tuple[int, ...]) -> torch.Tensor:
    flat = (s.codes.float() * s.scales[:, None]).reshape(-1)
    return flat[: s.size].reshape(shape)
