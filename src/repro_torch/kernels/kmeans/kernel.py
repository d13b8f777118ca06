"""Launch wrapper for the hand-written Hopper k-means assignment kernel
(``csrc/kmeans.cu``; see its header for the design and what bounds it).

``assign_kernel`` replaces the JAX package's
``kernels/kmeans/kernel.py::assign_kernel``: each row's first maximal
centroid by dot product and that score, in fp32 on the CUDA cores,
without the [N, K] scores reaching device memory.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take, allocates its outputs with
``torch.empty``, launches on the current stream, raises if the launch
reported a CUDA error, and adds one to its ``launches`` counter.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

_INT32_MAX = 2 ** 31 - 1
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = common.load_library("kmeans")
    if not getattr(lib, "_kmeans_typed", False):
        lib.kmeans_max_dim.argtypes = []
        lib.kmeans_max_dim.restype = _I
        lib.kmeans_assign_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
        lib.kmeans_assign_launch.restype = _I
        lib._kmeans_typed = True
    return lib


def assign_kernel(x: torch.Tensor, c: torch.Tensor):
    """x [N, dim], c [K >= 1, dim] contiguous float32 CUDA tensors ->
    (assignment int32 [N], best score float32 [N]), on the hand-written
    CUDA kernel."""
    for name, t in (("x", x), ("c", c)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if x.device != c.device:
        raise ValueError("x and c must lie on one device")
    n, dim = x.shape
    k = c.shape[0]
    if c.shape[1] != dim:
        raise ValueError(f"x and c must have one dim, got {dim} and "
                         f"{c.shape[1]}")
    if k < 1:
        raise ValueError("at least one centroid is needed")
    if not 0 < dim <= _lib().kmeans_max_dim():
        raise ValueError(f"dim={dim} outside 1..{_lib().kmeans_max_dim()}")
    if n > _INT32_MAX or k > _INT32_MAX:
        raise ValueError(f"too many rows for int32 indexing: N={n}, K={k}")
    assign = torch.empty(n, dtype=torch.int32, device=x.device)
    best = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return assign, best
    rc = _lib().kmeans_assign_launch(
        x.data_ptr(), c.data_ptr(), assign.data_ptr(), best.data_ptr(), n, k,
        dim, common.stream_ptr(x.device))
    common.check_launch(rc, "kmeans_assign")
    assign_kernel.launches += 1
    return assign, best


assign_kernel.launches = 0
