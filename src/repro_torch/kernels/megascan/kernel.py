"""Launch wrappers for the hand-written Hopper megascan kernels
(``csrc/megascan.cu``; see its header for the design and what bounds
it).

  * ``asym_megascan_segsum_kernel`` replaces the JAX package's
    ``kernels/megascan/kernel.py::asym_megascan_segsum_db_kernel``:
    [B, S] float32 per-(query, shard-slot) sums of exp(beta *
    asym-cos) over a block-aligned payload, one launch; slot s owns the
    real rows ``[row_start[s], row_start[s] + row_count[s])`` and no
    padding row is read.  Scored by 4-bit table lookup with the
    segment sum's per-slot sum (``csrc/asym_tile.cuh``), so bitwise
    equal to the slice-1 segment sum over the same rows, and
    deterministic (no float atomics); a ``bits`` whose tables do not fit
    a block's shared memory raises.
  * ``asym_megascan_topk_kernel`` replaces both
    ``asym_megascan_topk_kernel`` and ``asym_megascan_topk_db_kernel``
    (one function on two TPU schedules): per payload block of ``tm``
    rows, each query's k best (value, payload position), value
    descending and ties by ascending position, rows whose slot is not
    below ``n_valid_slots`` at -inf; [B, n_blocks*k] float32 values and
    int32 positions.
  * ``hamming_megascan_segsum_kernel`` replaces
    ``kernels/megascan/kernel.py::hamming_megascan_segsum_db_kernel``:
    the sum in sym mode, [B, S] float32 per-slot sums of exp(beta *
    cos(pi * m / bits)) over each slot's real rows, m the Hamming
    distance of packed signatures; bitwise equal to the Hamming segment
    sum (``kernels/hamming``) over the same rows and to
    ``testing.hamming_warp_sums``, its exact model.  Queries come 16 to
    a block (B <= 16 is one tile), one warp per slot.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take, allocates its outputs with
``torch.empty``, launches on the current stream, raises if the launch
reported a CUDA error, and adds one to its ``launches`` counter.  asym
query rows arrive unit-normalised (``ops`` does that); sym queries are
packed int32 signatures.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.asym.kernel import (_F, _I, _P, _check,
                                             _check_grid, _check_smem, _scale,
                                             check_lut_smem, grid_shape,
                                             launch_shape)
from repro_torch.kernels.hamming.kernel import check_bits, check_operands
from repro_torch.kernels.hamming.ref import value_table


def _lib() -> ctypes.CDLL:
    lib = common.load_library("megascan")
    if not getattr(lib, "_megascan_typed", False):
        lib.megascan_segsum_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]
        lib.megascan_segsum_launch.restype = _I
        lib.megascan_topk_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
            _P]
        lib.megascan_topk_launch.restype = _I
        lib.hamming_megascan_segsum_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.hamming_megascan_segsum_launch.restype = _I
        lib.megascan_segsum_grid_x.argtypes = [_I, _I, _I, _I]
        lib.megascan_segsum_grid_x.restype = _I
        lib.hamming_megascan_smem.argtypes = [_I]
        lib.hamming_megascan_smem.restype = ctypes.c_size_t
        lib.hamming_megascan_grid_x.argtypes = [_I, _I, _I]
        lib.hamming_megascan_grid_x.restype = _I
        lib.hamming_megascan_query_tile.argtypes = []
        lib.hamming_megascan_query_tile.restype = _I
        lib._megascan_typed = True
    return lib


def _check_index(t: torch.Tensor, name: str, device: torch.device,
                 n: "int | None" = None) -> None:
    if (t.device != device or t.dtype != torch.int32 or t.dim() != 1
            or not t.is_contiguous() or (n is not None and t.shape[0] != n)):
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor on "
                         f"{device}" + (f" of length {n}" if n is not None
                                        else ""))


def asym_megascan_segsum_kernel(q: torch.Tensor, planes: torch.Tensor,
                                sig: torch.Tensor, row_start: torch.Tensor,
                                row_count: torch.Tensor, bits: int, *,
                                temperature: float = 1.0) -> torch.Tensor:
    """[B, dim] unit rows x a payload's [n_rows, W] packed int32 rows
    with per-slot real-row ranges -> [B, S] float32 sums of
    exp(temperature * asym-cos), on the hand-written CUDA kernel."""
    b, dim, n_rows, w = _check(q, planes, sig, bits)
    _check_index(row_start, "row_start", q.device)
    s = row_start.shape[0]
    _check_index(row_count, "row_count", q.device, s)
    out = torch.empty((b, s), dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return out
    _check_grid(b)
    check_lut_smem(bits, dim, "the megascan sum")
    rc = _lib().megascan_segsum_launch(
        q.data_ptr(), planes.data_ptr(), sig.data_ptr(), row_start.data_ptr(),
        row_count.data_ptr(), out.data_ptr(), b, dim, bits, n_rows, w, s,
        _scale(bits), float(temperature), common.stream_ptr(q.device))
    common.check_launch(rc, "megascan_segsum")
    asym_megascan_segsum_kernel.launches += 1
    return out


asym_megascan_segsum_kernel.launches = 0


def segsum_launch_shape(bits: int, dim: int, s: int, b: int) -> dict:
    """``asym_megascan_segsum_kernel``'s launch at these widths."""
    return launch_shape(_lib().megascan_segsum_grid_x, bits, dim, s, b)


def asym_megascan_topk_kernel(q: torch.Tensor, planes: torch.Tensor,
                              sig: torch.Tensor, slots: torch.Tensor,
                              bits: int, k: int, n_valid_slots: int,
                              tm: int, *, temperature: float = 1.0
                              ) -> "tuple[torch.Tensor, torch.Tensor]":
    """[B, dim] unit rows x a payload's [n_blocks*tm, W] rows and [n_rows]
    int32 row -> slot map -> per-block top-k candidates ([B,
    n_blocks*k] float32 values, [B, n_blocks*k] int32 payload
    positions), on the hand-written CUDA kernel."""
    b, dim, n_rows, w = _check(q, planes, sig, bits)
    _check_index(slots, "slots", q.device, n_rows)
    if tm <= 0 or tm & (tm - 1) or n_rows % tm:
        raise ValueError(f"tm={tm} must be a power of two dividing the "
                         f"{n_rows} payload rows")
    if not 0 < k <= tm:
        raise ValueError(f"k={k} must be in [1, tm={tm}]")
    n_blocks = n_rows // tm
    vals = torch.empty((b, n_blocks * k), dtype=torch.float32,
                       device=q.device)
    pos = torch.empty((b, n_blocks * k), dtype=torch.int32, device=q.device)
    if b == 0 or n_blocks == 0:
        return vals, pos
    _check_grid(b)
    _check_smem(bits, dim, tm, k, f"k={k} at tm={tm}")
    rc = _lib().megascan_topk_launch(
        q.data_ptr(), planes.data_ptr(), sig.data_ptr(), slots.data_ptr(),
        vals.data_ptr(), pos.data_ptr(), b, dim, bits, n_rows, w, tm, k,
        int(n_valid_slots), _scale(bits), float(temperature),
        common.stream_ptr(q.device))
    common.check_launch(rc, "megascan_topk")
    asym_megascan_topk_kernel.launches += 1
    return vals, pos


asym_megascan_topk_kernel.launches = 0


def hamming_megascan_segsum_kernel(q: torch.Tensor, sig: torch.Tensor,
                                   row_start: torch.Tensor,
                                   row_count: torch.Tensor, bits: int, *,
                                   temperature: float = 1.0) -> torch.Tensor:
    """[B, W] packed int32 query signatures x a payload's [n_rows, W]
    packed rows with per-slot real-row ranges -> [B, S] float32 sums of
    exp(temperature * cos(pi * m / bits)), on the hand-written CUDA
    kernel."""
    b, n_rows, w = check_operands(q, sig)
    check_bits(bits)
    _check_index(row_start, "row_start", q.device)
    s = row_start.shape[0]
    _check_index(row_count, "row_count", q.device, s)
    out = torch.empty((b, s), dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return out
    table = value_table(bits, w, temperature, q.device)
    rc = _lib().hamming_megascan_segsum_launch(
        q.data_ptr(), sig.data_ptr(), row_start.data_ptr(),
        row_count.data_ptr(), table.data_ptr(), out.data_ptr(), b, n_rows,
        w, s, common.stream_ptr(q.device))
    common.check_launch(rc, "hamming_megascan_segsum")
    hamming_megascan_segsum_kernel.launches += 1
    return out


hamming_megascan_segsum_kernel.launches = 0


def hamming_segsum_launch_shape(w: int, s: int, b: int) -> dict:
    """``hamming_megascan_segsum_kernel``'s launch at W words, S slots
    and B queries (``grid_shape``)."""
    lib = _lib()
    return grid_shape(lib.hamming_megascan_grid_x(w, s, b),
                      -(-b // lib.hamming_megascan_query_tile()),
                      lib.hamming_megascan_smem(w), "Hamming sum")
