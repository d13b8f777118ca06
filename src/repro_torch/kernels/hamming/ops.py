"""Public wrappers for the Hamming (sym-mode) kernels, with the
arguments and semantics of the JAX package's ``kernels/hamming/ops.py``.

Signatures are packed int32 tensors (the uint32 bit pattern, see
``core/lsh.py``); a 1-D query is one row.  The call goes by where the
tensors lie: CUDA tensors launch the hand-written kernels
(``kernel.py``), CPU tensors take the plain versions (``ref.py``).  The
TPU wrappers' tile arguments (``tn``, ``tm``) have no counterpart: the
CUDA kernels mask their ragged edges themselves, so nothing is padded.

The segment sum takes any doc -> slot map: ``segment_csr`` sorts the
rows by slot (stably) and builds CSR offsets, and slots outside
``[0, n_segments)`` — padding docs — fall outside every segment, so
they contribute nothing.  Callers that already hold rows in slot order
(the index caches them) call ``hamming_segment_similarity_csr``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.asym.ops import segment_csr
from repro_torch.kernels.hamming import kernel as _k
from repro_torch.kernels.hamming import ref as _ref


def _rows(q_packed: torch.Tensor) -> torch.Tensor:
    return q_packed[None, :] if q_packed.dim() == 1 else q_packed


def hamming_distance(q_packed: torch.Tensor, db_packed: torch.Tensor
                     ) -> torch.Tensor:
    """[N, W] x [M, W] packed signatures -> [N, M] int32 Hamming
    distances (exact)."""
    q = _rows(q_packed)
    if common.on_cuda(q, db_packed):
        return _k.hamming_distance_kernel(q.contiguous(),
                                          db_packed.contiguous())
    return _ref.hamming_distance_ref(q, db_packed)


def hamming_similarity(q_packed: torch.Tensor, db_packed: torch.Tensor,
                       bits: int, *, temperature: float = 1.0
                       ) -> torch.Tensor:
    """[N, W] x [M, W] -> [N, M] float32 exp(temperature * cos(pi * m /
    bits)), the paper's approximation of exp(beta * x . y) (Sec.
    III-B)."""
    q = _rows(q_packed)
    if common.on_cuda(q, db_packed):
        return _k.hamming_similarity_kernel(
            q.contiguous(), db_packed.contiguous(), bits,
            temperature=temperature)
    return _ref.hamming_similarity_ref(q, db_packed, bits, temperature)


def hamming_segment_similarity(q_packed: torch.Tensor,
                               db_packed: torch.Tensor, bits: int,
                               seg_ids: torch.Tensor, n_segments: int, *,
                               temperature: float = 1.0) -> torch.Tensor:
    """Fused scoring + reduction: [N, W] x [M, W] -> [N, n_segments]
    sums of exp(temperature * cos(pi * m / bits)) grouped by
    ``seg_ids`` (the doc -> segment slot map, [M], any order)."""
    order, offsets = segment_csr(seg_ids.to(db_packed.device), n_segments)
    return hamming_segment_similarity_csr(q_packed, db_packed[order], bits,
                                          offsets, temperature=temperature)


def hamming_segment_similarity_csr(q_packed: torch.Tensor,
                                   db_sorted: torch.Tensor, bits: int,
                                   seg_offsets: torch.Tensor, *,
                                   temperature: float = 1.0) -> torch.Tensor:
    """``hamming_segment_similarity`` over rows already sorted by slot,
    with int32 CSR ``seg_offsets`` [n_segments + 1]."""
    q = _rows(q_packed)
    if common.on_cuda(q, db_sorted, seg_offsets):
        return _k.hamming_segment_similarity_kernel(
            q.contiguous(), db_sorted.contiguous(), seg_offsets.contiguous(),
            bits, temperature=temperature)
    return _ref.hamming_segment_similarity_csr_ref(q, db_sorted, bits,
                                                   seg_offsets, temperature)
