"""Public wrappers for the batched asym scoring kernels, with the
arguments and semantics of the JAX package's ``kernels/asym/ops.py``.

Query rows are unit-normalised here (``max(norm, 1e-9)``), then the
call goes by where the tensors lie: CUDA tensors launch the
hand-written kernels (``kernel.py``), CPU tensors take the plain
versions (``ref.py``).  The TPU wrappers' tile arguments (``tb``,
``tm``) and ``pad_lanes`` have no counterpart: the CUDA kernels mask
their ragged edges themselves, so neither rows nor K are padded.

The segment sum takes any doc -> slot map: ``segment_csr`` sorts the
rows by slot (stably) and builds CSR offsets, and slots outside
``[0, n_segments)`` — padding docs — fall outside every segment, so
they contribute nothing.  Callers that already hold rows in slot order
(the index caches them) call ``asym_exp_segment_sum_csr`` directly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.asym import kernel as _k
from repro_torch.kernels.asym import ref as _ref


def _prep_queries(query_vecs: torch.Tensor) -> torch.Tensor:
    """[B, dim] float32 unit rows (a 1-D query becomes one row)."""
    q = query_vecs.to(torch.float32)
    if q.dim() == 1:
        q = q[None, :]
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=1e-9)


def asym_exp_similarity(query_vecs: torch.Tensor, db_packed: torch.Tensor,
                        planes: torch.Tensor, bits: int, *,
                        temperature: float = 1.0) -> torch.Tensor:
    """[B, dim] queries x [M, W] packed int32 signatures -> [B, M]
    float32 exp(temperature * asym-cos).  Queries may have any norm."""
    q = _prep_queries(query_vecs)
    if common.on_cuda(q, db_packed, planes):
        return _k.asym_similarity_kernel(
            q.contiguous(), planes.to(torch.float32).contiguous(),
            db_packed.contiguous(), bits, temperature=temperature)
    return _ref.asym_exp_similarity_ref(q, db_packed,
                                        planes.to(torch.float32), bits,
                                        temperature)


def segment_csr(seg_ids: torch.Tensor, n_segments: int
                ) -> "tuple[torch.Tensor, torch.Tensor]":
    """(order, offsets): ``order`` stably sorts rows by slot with
    out-of-range slots last, and int32 ``offsets`` [n_segments + 1]
    delimit each slot's rows in that order."""
    seg = seg_ids.to(torch.int64).reshape(-1)
    valid = (seg >= 0) & (seg < n_segments)
    key = torch.where(valid, seg, torch.full_like(seg, n_segments))
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=n_segments + 1)[:n_segments]
    offsets = torch.zeros(n_segments + 1, dtype=torch.int32,
                          device=seg.device)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return order, offsets


def asym_exp_segment_sum(query_vecs: torch.Tensor, db_packed: torch.Tensor,
                         planes: torch.Tensor, bits: int,
                         seg_ids: torch.Tensor, n_segments: int, *,
                         temperature: float = 1.0) -> torch.Tensor:
    """Fused scoring + reduction: [B, dim] x [M, W] -> [B, n_segments]
    sums of exp(temperature * asym-cos) grouped by ``seg_ids`` (the
    doc -> segment slot map, [M], any order)."""
    order, offsets = segment_csr(seg_ids.to(db_packed.device), n_segments)
    return asym_exp_segment_sum_csr(query_vecs, db_packed[order], planes,
                                    bits, offsets, temperature=temperature)


def asym_exp_segment_sum_csr(query_vecs: torch.Tensor,
                             db_sorted: torch.Tensor, planes: torch.Tensor,
                             bits: int, seg_offsets: torch.Tensor, *,
                             temperature: float = 1.0) -> torch.Tensor:
    """``asym_exp_segment_sum`` over rows already sorted by slot, with
    int32 CSR ``seg_offsets`` [n_segments + 1]."""
    q = _prep_queries(query_vecs)
    if common.on_cuda(q, db_sorted, planes, seg_offsets):
        return _k.asym_segment_sum_kernel(
            q.contiguous(), planes.to(torch.float32).contiguous(),
            db_sorted.contiguous(), seg_offsets.contiguous(), bits,
            temperature=temperature)
    return _ref.asym_exp_segment_sum_csr_ref(
        q, db_sorted, planes.to(torch.float32), bits, seg_offsets,
        temperature)


def asym_exp_topk(query_vecs: torch.Tensor, db_packed: torch.Tensor,
                  planes: torch.Tensor, bits: int, k: int, *,
                  temperature: float = 1.0
                  ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Fused scoring + ranked reduction: ([B, k] int32 doc indices,
    [B, k] float32 values), k = min(k, M), each row descending with
    ties to the lowest doc index (the order of ``jax.lax.top_k``).
    Stage 1 (the kernel, or its plain version) keeps each tile's top-k;
    stage 2, here, is a stable sort of the [B, ceil(M/TM)*k]
    candidates — tile order, then rank in tile, so ties still go to the
    lowest index.  The [B, M] matrix never reaches device memory."""
    q = _prep_queries(query_vecs)
    k = min(int(k), db_packed.shape[0])
    if k <= 0:
        return (torch.zeros((q.shape[0], 0), dtype=torch.int32,
                            device=q.device),
                torch.zeros((q.shape[0], 0), dtype=torch.float32,
                            device=q.device))
    planes = planes.to(torch.float32)
    if common.on_cuda(q, db_packed, planes):
        vals, idx = _k.asym_topk_kernel(
            q.contiguous(), planes.contiguous(), db_packed.contiguous(),
            bits, k, temperature=temperature)
    else:
        vals, idx = _ref.asym_topk_candidates_ref(
            q, db_packed, planes, bits, k, _k.topk_tile(k), temperature)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    order = order[:, :k]
    return idx.gather(1, order), vals.gather(1, order)
