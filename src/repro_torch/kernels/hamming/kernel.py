"""Launch wrappers for the hand-written Hopper Hamming kernels
(``csrc/hamming.cu``; see its header for the design and what bounds
it).

  * ``hamming_distance_kernel`` replaces the JAX package's
    ``kernels/hamming/kernel.py::hamming_distance_kernel``: the exact
    [N, M] int32 Hamming distances of packed signatures.
  * ``hamming_similarity_kernel`` replaces
    ``kernels/hamming/kernel.py::hamming_similarity_kernel``: [N, M]
    float32 exp(beta * cos(pi * m / bits)), read from ``value_table``.
  * ``hamming_segment_similarity_kernel`` replaces
    ``kernels/hamming/kernel.py::hamming_segment_similarity_kernel``:
    per-segment sums of the same values over CSR-sorted rows, [N, S]
    float32; the [N, M] intermediate never reaches device memory and
    the sum is bitwise deterministic (no float atomics).

Each wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take, allocates its output with
``torch.empty``, launches on the current stream, raises if the launch
reported a CUDA error, and adds one to its ``launches`` counter.
Signatures are packed int32 words (the uint32 bit pattern).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.hamming.ref import value_table

_GRID_Y_MAX = 65535
_INT32_MAX = 2 ** 31 - 1
# words per signature the kernels take: their shared memory (the query
# words and the 32 W + 1 table entries) stays under 48 KB
MAX_WORDS = 256
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = common.load_library("hamming")
    if not getattr(lib, "_hamming_typed", False):
        lib.hamming_query_tile.argtypes = []
        lib.hamming_query_tile.restype = _I
        lib.hamming_distance_launch.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        lib.hamming_distance_launch.restype = _I
        lib.hamming_similarity_launch.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _P]
        lib.hamming_similarity_launch.restype = _I
        lib.hamming_segment_sum_launch.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.hamming_segment_sum_launch.restype = _I
        lib._hamming_typed = True
    return lib


def check_operands(q: torch.Tensor, db: torch.Tensor
                   ) -> "tuple[int, int, int]":
    """Validate packed query and row signatures; returns (N, M, W)."""
    for name, t in (("q", q), ("db", db)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must hold packed int32 words, "
                            f"got {t.dtype}")
    if q.device != db.device:
        raise ValueError("q and db must lie on one device")
    n, w = q.shape
    m, w2 = db.shape
    if w != w2 or not 0 < w <= MAX_WORDS:
        raise ValueError(f"q and db must have the same 1..{MAX_WORDS} "
                         f"words per signature, got {w} and {w2}")
    if m > _INT32_MAX:
        raise ValueError(f"too many rows for int32 indexing: M={m}")
    if -(-n // _lib().hamming_query_tile()) > _GRID_Y_MAX:
        raise ValueError(f"too many queries for one launch: N={n}")
    return n, m, w


def check_bits(bits: int) -> None:
    """Raise unless ``bits``, the denominator of cos(pi * m / bits), is
    positive."""
    if bits <= 0:
        raise ValueError(f"bits={bits} must be positive")


def hamming_distance_kernel(q: torch.Tensor, db: torch.Tensor
                            ) -> torch.Tensor:
    """[N, W] x [M, W] packed int32 -> [N, M] int32 Hamming distances,
    on the hand-written CUDA kernel."""
    n, m, w = check_operands(q, db)
    out = torch.empty((n, m), dtype=torch.int32, device=q.device)
    if n == 0 or m == 0:
        return out
    rc = _lib().hamming_distance_launch(
        q.data_ptr(), db.data_ptr(), out.data_ptr(), n, m, w,
        common.stream_ptr(q.device))
    common.check_launch(rc, "hamming_distance")
    hamming_distance_kernel.launches += 1
    return out


hamming_distance_kernel.launches = 0


def hamming_similarity_kernel(q: torch.Tensor, db: torch.Tensor, bits: int,
                              *, temperature: float = 1.0) -> torch.Tensor:
    """[N, W] x [M, W] packed int32 -> [N, M] float32 exp(temperature *
    cos(pi * m / bits)), on the hand-written CUDA kernel."""
    n, m, w = check_operands(q, db)
    check_bits(bits)
    out = torch.empty((n, m), dtype=torch.float32, device=q.device)
    if n == 0 or m == 0:
        return out
    table = value_table(bits, w, temperature, q.device)
    rc = _lib().hamming_similarity_launch(
        q.data_ptr(), db.data_ptr(), table.data_ptr(), out.data_ptr(), n, m,
        w, common.stream_ptr(q.device))
    common.check_launch(rc, "hamming_similarity")
    hamming_similarity_kernel.launches += 1
    return out


hamming_similarity_kernel.launches = 0


def hamming_segment_similarity_kernel(q: torch.Tensor, db_sorted: torch.Tensor,
                                      seg_offsets: torch.Tensor, bits: int, *,
                                      temperature: float = 1.0
                                      ) -> torch.Tensor:
    """[N, W] packed int32 x segment-sorted [M, W] rows with CSR
    ``seg_offsets`` [S + 1] int32 (segment s owns rows
    ``seg_offsets[s]:seg_offsets[s + 1]``) -> [N, S] float32 sums of
    exp(temperature * cos(pi * m / bits)), on the hand-written CUDA
    kernel."""
    n, m, w = check_operands(q, db_sorted)
    check_bits(bits)
    if (seg_offsets.device != q.device or seg_offsets.dtype != torch.int32
            or seg_offsets.dim() != 1 or not seg_offsets.is_contiguous()
            or seg_offsets.shape[0] < 1):
        raise ValueError("seg_offsets must be a contiguous 1-D int32 CUDA "
                         "tensor of S + 1 offsets on q's device")
    s = seg_offsets.shape[0] - 1
    out = torch.empty((n, s), dtype=torch.float32, device=q.device)
    if n == 0 or s == 0:
        return out
    table = value_table(bits, w, temperature, q.device)
    rc = _lib().hamming_segment_sum_launch(
        q.data_ptr(), db_sorted.data_ptr(), seg_offsets.data_ptr(),
        table.data_ptr(), out.data_ptr(), n, m, w, s,
        common.stream_ptr(q.device))
    common.check_launch(rc, "hamming_segment_sum")
    hamming_segment_similarity_kernel.launches += 1
    return out


hamming_segment_similarity_kernel.launches = 0
