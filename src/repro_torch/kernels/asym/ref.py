"""Plain PyTorch versions of the asym kernels: the same functions as
``csrc/asym.cu`` written as ordinary tensor ops (the unfused [B, M]
matrix, then a scatter-add).  CPU tensors take these; ``chip_smoke.py``
holds the kernels against them on the card."""
from __future__ import annotations

import math

import torch

from repro_torch.core import lsh as lsh_mod


def asym_exp_similarity_ref(
    query_vecs: torch.Tensor,   # [B, dim] real-valued, any norm
    db_packed: torch.Tensor,    # [M, W] int32
    planes: torch.Tensor,       # [bits, dim]
    bits: int,
    temperature: float = 1.0,
) -> torch.Tensor:
    """[B, M] float32 exp(beta * asym-cos)."""
    q = query_vecs / torch.clamp(
        torch.linalg.norm(query_vecs, dim=-1, keepdim=True), min=1e-9)
    proj = q @ planes.T                                       # [B, bits]
    signs = 2.0 * lsh_mod.unpack_bits(db_packed, bits).to(torch.float32) - 1.0
    scale = 1.0 / (bits * math.sqrt(2.0 / math.pi))
    cos = torch.clamp(proj @ signs.T * scale, -1.0, 1.0)
    return torch.exp(temperature * cos)


def asym_exp_segment_sum_ref(
    query_vecs: torch.Tensor,   # [B, dim] real-valued, any norm
    db_packed: torch.Tensor,    # [M, W] int32
    planes: torch.Tensor,       # [bits, dim]
    bits: int,
    seg_ids: torch.Tensor,      # [M] int doc -> segment slot, any order
    n_segments: int,
    temperature: float = 1.0,
) -> torch.Tensor:
    """[B, n_segments] float32 sums of the [B, M] matrix grouped by
    ``seg_ids``; slots outside [0, n_segments) add to nothing."""
    sims = asym_exp_similarity_ref(query_vecs, db_packed, planes, bits,
                                   temperature)
    seg = seg_ids.to(device=sims.device, dtype=torch.int64)
    slot = torch.where((seg >= 0) & (seg < n_segments), seg,
                       torch.full_like(seg, n_segments))
    out = sims.new_zeros((sims.shape[0], n_segments + 1))
    out.index_add_(1, slot, sims)
    return out[:, :n_segments]


def asym_exp_segment_sum_csr_ref(
    query_vecs: torch.Tensor,   # [B, dim]
    db_sorted: torch.Tensor,    # [M, W] int32, rows sorted by segment
    planes: torch.Tensor,       # [bits, dim]
    bits: int,
    seg_offsets: torch.Tensor,  # [S + 1] int32 CSR offsets
    temperature: float = 1.0,
) -> torch.Tensor:
    """The CSR form the segment-sum kernel takes: segment s owns rows
    ``seg_offsets[s]:seg_offsets[s + 1]``; rows past the last offset
    add to nothing."""
    offs = seg_offsets.to(torch.int64)
    n_segments = offs.shape[0] - 1
    counts = offs[1:] - offs[:-1]
    seg = torch.repeat_interleave(
        torch.arange(n_segments, device=offs.device), counts)
    start = int(offs[0]) if n_segments else 0
    rows = db_sorted[start:start + seg.shape[0]]
    return asym_exp_segment_sum_ref(query_vecs, rows, planes, bits,
                                    seg, n_segments, temperature)
