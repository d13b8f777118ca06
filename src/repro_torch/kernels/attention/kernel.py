"""Launch wrapper for the hand-written Hopper fused attention forward
(``csrc/attention.cu``; see its header for the design and what bounds
it).

``fused_attention_kernel`` replaces no TPU kernel: the JAX package's
attention is plain ``jnp``.  It computes ``dense_attention``
(``ref.py``) for q [B, S, H, hd] against k, v [B, T, KH, hd], GQA with
G = H / KH query heads a KV head, the causal mask at ``q_offset`` and
the sliding ``window`` (which, as in ``dense_attention``, applies only
under the causal mask), without writing the scores to device memory.
It has no backward: the wrapper refuses a call that autograd records.

The wrapper checks device, dtype, shape, strides and alignment and
raises on anything the kernel does not take, allocates its output with
``torch.empty``, launches on the current stream, raises if the launch
reported a CUDA error, and adds one to its ``launches`` counter.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels.attention.ops import records_grad
from repro_torch.kernels.attention.ref import _divisor

HEAD_DIMS = (16, 32, 64, 128)
# the entry point's dtype codes
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_INT32_MAX = 2 ** 31 - 1
_GRID_Y_MAX = 65535
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = common.load_library("attention")
    if not getattr(lib, "_attention_typed", False):
        lib.fused_attention_launch.argtypes = (
            [_I, _P, _P, _P, _P] + [_L] * 12 + [_I] * 9
            + [ctypes.c_float, _P])
        lib.fused_attention_launch.restype = _I
        lib._attention_typed = True
    return lib


def _extent(t: torch.Tensor) -> int:
    return sum((n - 1) * st for n, st in zip(t.shape, t.stride())) + 1


def fused_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool,
                           window: int = 0, q_offset: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q [B, S, H, hd], k and v [B, T, KH, hd] CUDA tensors of one dtype
    (bfloat16, float16 or float32), hd in ``HEAD_DIMS``, the last
    dimension contiguous and 16-bit rows on 16-byte boundaries ->
    [B, S, H, hd] contiguous, on the hand-written CUDA kernel.  The
    scores are divided by ``dense_attention``'s divisor: sqrt(hd), or
    1 / ``scale`` where given (both rounded to q's dtype)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on q's device, "
                             f"got {t.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} must be one of {tuple(DTYPES)} and of "
                            f"q's dtype, got {t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-d with a contiguous last "
                             f"dimension, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
        if t.dtype != torch.float32 and (
                t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"{name}'s rows must start on 16-byte "
                             f"boundaries, got strides {t.stride()}")
        if _extent(t) > _INT32_MAX:
            raise ValueError(f"{name} spans more than 2^31 elements")
    if records_grad(q, k, v):
        raise RuntimeError("the fused attention has no backward: a call "
                           "that records a gradient takes dense_attention")
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != hd \
            or kh < 1 or h % kh:
        raise ValueError(f"want q [B, S, H, hd], k and v [B, T, KH, hd] "
                         f"with KH dividing H, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must "
                         f"be >= 0")
    if t < 1 or (causal and q_offset + s > t):
        raise ValueError(f"every query row must see a key: S={s}, T={t}, "
                         f"q_offset={q_offset}, causal={causal}")
    if b * kh > _GRID_Y_MAX:
        raise ValueError(f"B * KH = {b * kh} blocks over {_GRID_Y_MAX}")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    rc = _lib().fused_attention_launch(
        DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], b, s, t, kh, h // kh, hd, q_offset, window,
        int(bool(causal)), _divisor(hd, q.dtype, scale),
        common.stream_ptr(q.device))
    common.check_launch(rc, "fused_attention")
    fused_attention_kernel.launches += 1
    return out


fused_attention_kernel.launches = 0
