"""Launch wrapper for the hand-written Hopper negative-sampling kernel
(``csrc/negsamp.cu``; see its header for the design and what bounds
it).

``negsamp_grads_kernel`` replaces the JAX package's
``kernels/negsamp/kernel.py::negsamp_grads_kernel``: per (doc, word,
K negatives) row, the SGNS loss and the gradients with respect to the
gathered doc, word and negative vectors, one warp per row, no atomics.

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
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = common.load_library("negsamp")
    if not getattr(lib, "_negsamp_typed", False):
        lib.negsamp_max_dim.argtypes = []
        lib.negsamp_max_dim.restype = _I
        lib.negsamp_grads_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P]
        lib.negsamp_grads_launch.restype = _I
        lib._negsamp_typed = True
    return lib


def negsamp_grads_kernel(d: torch.Tensor, w: torch.Tensor, wn: torch.Tensor,
                         *, temperature: float = 1.0):
    """d, w [B, dim], wn [B, K, dim] contiguous float32 CUDA tensors ->
    (loss [B], grad_d [B, dim], grad_w [B, dim], grad_wn [B, K, dim])
    float32, on the hand-written CUDA kernel."""
    for name, t in (("d", d), ("w", w), ("wn", wn)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != d.device:
            raise ValueError("d, w and wn must lie on one device")
    if d.dim() != 2 or w.shape != d.shape or wn.dim() != 3:
        raise ValueError(f"want d, w [B, dim] and wn [B, K, dim], got "
                         f"{tuple(d.shape)}, {tuple(w.shape)}, "
                         f"{tuple(wn.shape)}")
    b, dim = d.shape
    k = wn.shape[1]
    if wn.shape[0] != b or wn.shape[2] != dim or k < 1:
        raise ValueError(f"wn must be [{b}, K >= 1, {dim}], got "
                         f"{tuple(wn.shape)}")
    if not 0 < dim <= _lib().negsamp_max_dim():
        raise ValueError(f"dim={dim} outside 1..{_lib().negsamp_max_dim()}")
    if b > _INT32_MAX:
        raise ValueError(f"too many rows for one launch: B={b}")
    loss = torch.empty(b, dtype=torch.float32, device=d.device)
    gd = torch.empty_like(d)
    gw = torch.empty_like(d)
    gwn = torch.empty_like(wn)
    if b == 0:
        return loss, gd, gw, gwn
    rc = _lib().negsamp_grads_launch(
        d.data_ptr(), w.data_ptr(), wn.data_ptr(), loss.data_ptr(),
        gd.data_ptr(), gw.data_ptr(), gwn.data_ptr(), b, k, dim,
        float(temperature), common.stream_ptr(d.device))
    common.check_launch(rc, "negsamp_grads")
    negsamp_grads_kernel.launches += 1
    return loss, gd, gw, gwn


negsamp_grads_kernel.launches = 0
