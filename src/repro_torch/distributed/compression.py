"""Gradient compression for the cross-pod all-reduce.

At 1000+ nodes the gradient all-reduce across pods rides the slow
inter-pod links, not the links within a pod.  Only that hop is
compressed: gradients are reduced *within* a pod at full precision,
then the cross-pod exchange runs on int8 blockwise-quantized tensors
with error feedback (the residual from quantization is added to the
next step's gradient, which keeps SGD convergence — Karimireddy et al.
2019).

    g_pod = all_reduce(g) over "data"                     # fast intra-pod
    g_all, new_err = compressed_psum(g_pod, "pod", err)

The sum is an ``all_reduce`` of the dequantized approximation on the
mesh's process group for the axis (``mesh.get_group(axis)``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import current_mesh
from repro_torch.optimizer.quantized import q8_dequantize, q8_quantize
from repro_torch.utils.trees import tree_leaves, tree_unflatten


def quantize_roundtrip(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dequantized int8 approximation, residual error)."""
    q = q8_quantize(x)
    approx = q8_dequantize(q, x.shape).to(x.dtype)
    return approx, x - approx


def compressed_psum(x: torch.Tensor, axis: str, error: torch.Tensor,
                    mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed sum of ``x`` over the mesh axis ``axis`` (of
    ``mesh``, the ambient mesh when None) with error feedback.

    ``error`` is this worker's residual buffer from the previous step
    (same shape as x; zeros at step 0).  Returns (the sum, the new
    residual)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("compressed_psum needs a DeviceMesh: pass mesh= "
                         "or call it under use_mesh")
    approx, new_error = quantize_roundtrip(x + error)
    dist.all_reduce(approx, group=mesh.get_group(axis))
    return approx, new_error


def compressed_tree_psum(tree, axis: str, error_tree, mesh=None):
    """``compressed_psum`` over every leaf; returns (summed tree, new
    errors)."""
    out = [compressed_psum(x, axis, e, mesh)
           for x, e in zip(tree_leaves(tree), tree_leaves(error_tree))]
    return (tree_unflatten(tree, [o[0] for o in out]),
            tree_unflatten(tree, [o[1] for o in out]))
