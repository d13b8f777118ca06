"""Shared layers + the parameter-definition machinery.

Parameters are declared as ``ParamDef``s (shape, logical sharding axes,
initializer).  ``materialize`` draws them from one ``torch.Generator``;
``logical_axes_tree`` returns the same tree filled with logical-axis
tuples.  Weights keep the JAX package's ``[in, out]`` layout: a layer
computes ``x @ w``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.collectives import NO_TP, TPShard


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 1.0

    def initializer(self, generator: torch.Generator, dtype,
                    device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        # the reference's rule, kept: a stacked definition's fan-in is
        # its leading (layer) axis
        fan_in = self.shape[0] if len(self.shape) >= 2 else max(self.shape[-1], 1)
        std = self.scale / math.sqrt(fan_in)
        draw = torch.randn(self.shape, generator=generator,
                           device=generator.device, dtype=torch.float32)
        return (draw * std).to(device=device, dtype=dtype)


ParamTree = Dict  # nested dict of ParamDef / tensors


def tree_paths(tree, path=()):
    """(key path, leaf) pairs of a nested dict, in sorted-key order."""
    if not isinstance(tree, dict):
        return [(path, tree)]
    return [pair for k in sorted(tree) for pair in tree_paths(tree[k], path + (k,))]


def _rebuild(defs, fn, path=()):
    if not isinstance(defs, dict):
        return fn(path, defs)
    return {k: _rebuild(v, fn, path + (k,)) for k, v in defs.items()}


def materialize(defs: ParamTree, generator: torch.Generator, dtype,
                device: torch.device) -> ParamTree:
    """Turn a tree of ParamDefs into tensors on ``device``, drawn from
    ``generator`` one leaf after another in sorted-key order."""
    vals = {path: d.initializer(generator, dtype, device)
            for path, d in tree_paths(defs)}
    return _rebuild(defs, lambda path, d: vals[path])


def logical_axes_tree(defs: ParamTree) -> ParamTree:
    return _rebuild(defs, lambda path, d: d.logical_axes)


# ----------------------------------------------------------------------
# normalization / activations
#
# The activations follow jax.nn's formulas op by op in the input's
# dtype, each op rounded to it as XLA evaluates them, so that a bf16
# compute dtype rounds where the reference rounds (one fused
# F.silu / F.gelu rounds once and drifts from the reference by an ulp
# at a time).
# ----------------------------------------------------------------------
def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu: x * (1 / (1 + exp(-x)))."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _in_dtype(c: float, dtype) -> float:
    """A Python constant rounded to ``dtype``: JAX casts a weakly typed
    scalar to the array's dtype before the op; torch would not."""
    return float(torch.tensor(c).to(dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), its constants rounded to x's dtype."""
    c = _in_dtype(math.sqrt(2 / math.pi), x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(
        c * (x + _in_dtype(0.044715, x.dtype) * (x * x * x))))
    return x * cdf


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, tp: TPShard = NO_TP,
           d_ff: int = 0) -> torch.Tensor:
    """The SwiGLU MLP.  Where ``tp`` splits ``d_ff`` (the full width),
    this rank's ``d_ff`` columns of ``w_gate`` / ``w_up`` and rows of
    ``w_down``, the partial output summed over the split."""
    split = tp.splits(d_ff)
    if split:
        x = tp.region_in(x)
        w_gate, w_up = tp.part(w_gate, 1, d_ff), tp.part(w_up, 1, d_ff)
        w_down = tp.part(w_down, 0, d_ff)
    y = (silu(x @ w_gate) * (x @ w_up)) @ w_down
    return tp.region_out(y) if split else y


def dot_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b, the bias added to the float32 dot and the sum rounded
    once to x's dtype: XLA fuses a bias add into the dot's output, and
    two roundings under bf16 (the dot's, then the add's) drift from it."""
    return (x.float() @ w.float() + b.float()).to(x.dtype)


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor, tp: TPShard = NO_TP,
             d_ff: int = 0) -> torch.Tensor:
    """The GELU MLP, split over ``d_ff`` as ``swiglu``; ``b_out`` is
    added once, to the float32 sum of the partials, which is rounded
    once to x's dtype (``dot_bias``'s rounding)."""
    split = tp.splits(d_ff)
    if split:
        x = tp.region_in(x)
        w_in, b_in = tp.part(w_in, 1, d_ff), tp.part(b_in, 0, d_ff)
        w_out = tp.part(w_out, 0, d_ff)
    h = gelu_tanh(dot_bias(x, w_in, b_in))
    y = h.float() @ w_out.float()
    if split:
        y = tp.region_out(y)
    return (y + b_out.float()).to(x.dtype)


# ----------------------------------------------------------------------
# rotary position embeddings (split-half layout)
# ----------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device: "torch.device | None" = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # [hd/2]
    angles = positions[..., :, None].float() * freqs           # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]                   # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
