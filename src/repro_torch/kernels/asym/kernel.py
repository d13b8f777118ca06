"""Launch wrappers for the hand-written Hopper asym kernels
(``csrc/asym.cu``; see its header for the design and what bounds it).

  * ``asym_similarity_kernel`` replaces the JAX package's
    ``kernels/asym/kernel.py::asym_similarity_kernel``: [B, M] float32
    exp(beta * asym-cos), the projection q . planes^T computed inside
    the kernel.
  * ``asym_segment_sum_kernel`` replaces
    ``kernels/asym/kernel.py::asym_segment_sum_kernel``: per-segment
    sums of the same values over CSR-sorted rows, [B, S] float32,
    scored by 4-bit table lookup (``testing.lut_segment_sums`` is the
    same arithmetic in PyTorch); the [B, M] intermediate never reaches
    device memory and the sum is bitwise deterministic (no float
    atomics).  Its tables take ``bits * 128`` bytes of shared memory a
    block: a ``bits`` whose block does not fit raises.
  * ``asym_topk_kernel`` replaces
    ``kernels/asym/kernel.py::asym_topk_kernel``: per tile of
    ``topk_tile(k)`` docs, each query's k best (value, global doc
    index), value descending and ties by ascending index; [B, J*k]
    float32 values and int32 indices, J the number of tiles.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take, allocates its output with
``torch.empty``, launches on the current stream, raises if the launch
reported a CUDA error, and adds one to its ``launches`` counter.  The
wrappers take query rows already unit-normalised (``ops`` does that).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import common

_GRID_Y_MAX = 65535
_INT32_MAX = 2 ** 31 - 1
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = common.load_library("asym")
    if not getattr(lib, "_asym_typed", False):
        lib.asym_query_tile.argtypes = []
        lib.asym_query_tile.restype = _I
        lib.asym_exp_similarity_launch.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P]
        lib.asym_exp_similarity_launch.restype = _I
        lib.asym_exp_segment_sum_launch.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]
        lib.asym_exp_segment_sum_launch.restype = _I
        lib.asym_exp_topk_launch.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
        lib.asym_exp_topk_launch.restype = _I
        lib.asym_topk_smem.argtypes = [_I, _I, _I, _I]
        lib.asym_topk_smem.restype = ctypes.c_size_t
        lib.asym_topk_warp_k.argtypes = []
        lib.asym_topk_warp_k.restype = _I
        lib.asym_smem_limit.argtypes = []
        lib.asym_smem_limit.restype = _I
        lib.asym_lut_smem.argtypes = [_I, _I]
        lib.asym_lut_smem.restype = ctypes.c_size_t
        lib.asym_segsum_grid_x.argtypes = [_I, _I, _I, _I]
        lib.asym_segsum_grid_x.restype = _I
        lib._asym_typed = True
    return lib


def _check(q: torch.Tensor, planes: torch.Tensor, db: torch.Tensor,
           bits: int) -> "tuple[int, int, int, int]":
    """Validate the shared operands; returns (B, dim, M, W)."""
    for name, t in (("q", q), ("planes", planes), ("db", db)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if not (q.device == planes.device == db.device):
        raise ValueError("q, planes and db must lie on one device")
    if q.dtype != torch.float32 or planes.dtype != torch.float32:
        raise TypeError("q and planes must be float32")
    if db.dtype != torch.int32:
        raise TypeError(f"db must hold packed int32 words, got {db.dtype}")
    b, dim = q.shape
    m, w = db.shape
    if bits <= 0 or bits % 32 or w * 32 < bits:
        raise ValueError(f"bits={bits} must be a positive multiple of 32 "
                         f"covered by the {w} packed words per row")
    if planes.shape != (bits, dim):
        raise ValueError(f"planes must be [{bits}, {dim}], "
                         f"got {tuple(planes.shape)}")
    if m > _INT32_MAX:
        raise ValueError(f"too many rows for int32 indexing: M={m}")
    return b, dim, m, w


def _scale(bits: int) -> float:
    return 1.0 / (bits * math.sqrt(2.0 / math.pi))


def _check_grid(b: int) -> None:
    """Raise if B queries need more query tiles than one launch has."""
    if -(-b // _lib().asym_query_tile()) > _GRID_Y_MAX:
        raise ValueError(f"too many queries for one launch: B={b}")


def _check_smem(bits: int, dim: int, tm: int, k: int, what: str) -> None:
    """Raise if a top-k block's shared memory (``asym_tile.cuh``, shared
    by every top-k kernel: the projection and, for a k the warp
    selection does not take, the ``tm``-row tile) does not fit."""
    lib = _lib()
    smem = lib.asym_topk_smem(bits, dim, tm, k)
    limit = lib.asym_smem_limit()
    if smem > limit:
        raise ValueError(
            f"{what} needs {smem} bytes of shared memory per block at "
            f"bits={bits}, dim={dim}, over this device's limit of {limit} "
            f"bytes")


def check_lut_smem(bits: int, dim: int, what: str) -> None:
    """Raise if a segment-sum block's shared memory (``asym_tile.cuh``,
    shared by rows 2 and 7: the projection, the query tile and the 4-bit
    lookup tables) does not fit this device."""
    lib = _lib()
    smem = lib.asym_lut_smem(bits, dim)
    limit = lib.asym_smem_limit()
    if smem > limit:
        raise ValueError(
            f"{what} needs {smem} bytes of shared memory per block for its "
            f"lookup tables at bits={bits}, dim={dim}, over this device's "
            f"limit of {limit} bytes")


def launch_shape(grid_x, bits: int, dim: int, s: int, b: int) -> dict:
    """A segment-sum launch's shared memory per block and grid, from the
    library's ``grid_x(bits, dim, S, B)``."""
    x = grid_x(bits, dim, s, b)
    if x < 0:
        raise RuntimeError(f"segment-sum grid: CUDA error {-x}")
    return dict(smem_bytes=int(_lib().asym_lut_smem(bits, dim)),
                grid=(x, -(-b // _lib().asym_query_tile())))


def segsum_launch_shape(bits: int, dim: int, s: int, b: int) -> dict:
    """``asym_segment_sum_kernel``'s launch at these widths."""
    return launch_shape(_lib().asym_segsum_grid_x, bits, dim, s, b)


def asym_similarity_kernel(q: torch.Tensor, planes: torch.Tensor,
                           db: torch.Tensor, bits: int, *,
                           temperature: float = 1.0) -> torch.Tensor:
    """[B, dim] unit rows x [M, W] packed int32 -> [B, M] float32
    exp(temperature * asym-cos), on the hand-written CUDA kernel."""
    b, dim, m, w = _check(q, planes, db, bits)
    out = torch.empty((b, m), dtype=torch.float32, device=q.device)
    if b == 0 or m == 0:
        return out
    _check_grid(b)
    rc = _lib().asym_exp_similarity_launch(
        q.data_ptr(), planes.data_ptr(), db.data_ptr(), out.data_ptr(),
        b, dim, bits, m, w, _scale(bits), float(temperature),
        common.stream_ptr(q.device))
    common.check_launch(rc, "asym_exp_similarity")
    asym_similarity_kernel.launches += 1
    return out


asym_similarity_kernel.launches = 0


def asym_segment_sum_kernel(q: torch.Tensor, planes: torch.Tensor,
                            db_sorted: torch.Tensor,
                            seg_offsets: torch.Tensor, bits: int, *,
                            temperature: float = 1.0) -> torch.Tensor:
    """[B, dim] unit rows x segment-sorted [M, W] packed int32 rows with
    CSR ``seg_offsets`` [S + 1] int32 (segment s owns rows
    ``seg_offsets[s]:seg_offsets[s + 1]``) -> [B, S] float32 sums of
    exp(temperature * asym-cos), on the hand-written CUDA kernel."""
    b, dim, m, w = _check(q, planes, db_sorted, bits)
    if (seg_offsets.device != q.device or seg_offsets.dtype != torch.int32
            or seg_offsets.dim() != 1 or not seg_offsets.is_contiguous()
            or seg_offsets.shape[0] < 1):
        raise ValueError("seg_offsets must be a contiguous 1-D int32 CUDA "
                         "tensor of S + 1 offsets on q's device")
    s = seg_offsets.shape[0] - 1
    out = torch.empty((b, s), dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return out
    _check_grid(b)
    check_lut_smem(bits, dim, "the segment sum")
    rc = _lib().asym_exp_segment_sum_launch(
        q.data_ptr(), planes.data_ptr(), db_sorted.data_ptr(),
        seg_offsets.data_ptr(), out.data_ptr(),
        b, dim, bits, m, w, s, _scale(bits), float(temperature),
        common.stream_ptr(q.device))
    common.check_launch(rc, "asym_exp_segment_sum")
    asym_segment_sum_kernel.launches += 1
    return out


asym_segment_sum_kernel.launches = 0


def topk_tile(k: int) -> int:
    """Docs per tile of the top-k kernel: a power of two, at least 256
    and at least k."""
    return max(256, 1 << max(0, int(k) - 1).bit_length())


def topk_selection(k: int) -> str:
    """How the top-k kernels select k per tile: ``"warp"`` (in
    registers, k up to ``asym_tile.cuh``'s WARP_K) or ``"sort"`` (a
    bitonic sort in shared memory)."""
    return "warp" if k <= _lib().asym_topk_warp_k() else "sort"


def asym_topk_kernel(q: torch.Tensor, planes: torch.Tensor,
                     db: torch.Tensor, bits: int, k: int, *,
                     temperature: float = 1.0
                     ) -> "tuple[torch.Tensor, torch.Tensor]":
    """[B, dim] unit rows x [M, W] packed int32 -> per-tile top-k
    candidates ([B, J*k] float32 values, [B, J*k] int32 doc indices),
    J = ceil(M / topk_tile(k)), on the hand-written CUDA kernel.  A k
    past the warp selection sorts its tile in shared memory; one whose
    tile does not fit there raises."""
    b, dim, m, w = _check(q, planes, db, bits)
    if not 0 < k <= m:
        raise ValueError(f"k={k} must be in [1, M={m}]")
    tm = topk_tile(k)
    n_tiles = -(-m // tm)
    vals = torch.empty((b, n_tiles * k), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n_tiles * k), dtype=torch.int32, device=q.device)
    if b == 0:
        return vals, idx
    _check_grid(b)
    if m + tm > _INT32_MAX:
        raise ValueError(f"too many rows for int32 indexing: M={m}")
    _check_smem(bits, dim, tm, k, f"k={k}'s {tm}-doc tile")
    rc = _lib().asym_exp_topk_launch(
        q.data_ptr(), planes.data_ptr(), db.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), b, dim, bits, m, w, tm, k, _scale(bits),
        float(temperature), common.stream_ptr(q.device))
    common.check_launch(rc, "asym_exp_topk")
    asym_topk_kernel.launches += 1
    return vals, idx


asym_topk_kernel.launches = 0
