"""Public wrappers for the spherical k-means assignment, with the
semantics of the JAX package's ``kernels/kmeans/ops.py``.

The call goes by where the tensors lie: CUDA tensors launch the
hand-written kernel (``kernel.py``), CPU tensors take the plain version
(``ref.py``); there is no fallback from one to the other.  The TPU
wrapper's row tile (``tn``) and its padding have no counterpart: the
CUDA kernel masks its ragged edges itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.kmeans import kernel as _k
from repro_torch.kernels.kmeans import ref as _ref


def assign_with_scores(x: torch.Tensor, c: torch.Tensor):
    """(assignment int32 [N], best score float32 [N]) of unit rows x
    [N, dim] against unit centroids c [K, dim]."""
    if common.on_cuda(x, c):
        return _k.assign_kernel(x.contiguous(), c.contiguous())
    return _ref.assign_ref(x, c)


def assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Assignment only (int32 [N]): each row's first maximal centroid."""
    return assign_with_scores(x, c)[0]
