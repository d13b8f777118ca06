"""Plain PyTorch versions of the asym kernels: the same functions as
``csrc/asym.cu`` written as ordinary tensor ops.  CPU tensors take
these; ``chip_smoke.py`` holds the kernels against them on the card.

``asym_exp_similarity_ref`` and ``asym_exp_segment_sum_ref`` are the
unfused forms (the [B, M] matrix by a matrix product, then a
scatter-add).  The CSR segment sum — the form the fused route takes,
and the megascan's streamed schedule — instead scores with
``exp_sim_rows`` (fixed-shape row blocks) and sums with ``slot_sums``,
so that a slot's sum depends on its own rows alone: the group payload
and a single shard's payload give the same bits, as the kernels do.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import lsh as lsh_mod


def _unit(query_vecs: torch.Tensor) -> torch.Tensor:
    return query_vecs / torch.clamp(
        torch.linalg.norm(query_vecs, dim=-1, keepdim=True), min=1e-9)


def _scale(bits: int) -> float:
    return 1.0 / (bits * math.sqrt(2.0 / math.pi))


def asym_exp_similarity_ref(
    query_vecs: torch.Tensor,   # [B, dim] real-valued, any norm
    db_packed: torch.Tensor,    # [M, W] int32
    planes: torch.Tensor,       # [bits, dim]
    bits: int,
    temperature: float = 1.0,
) -> torch.Tensor:
    """[B, M] float32 exp(beta * asym-cos)."""
    proj = _unit(query_vecs) @ planes.T                       # [B, bits]
    signs = 2.0 * lsh_mod.unpack_bits(db_packed, bits).to(torch.float32) - 1.0
    cos = torch.clamp(proj @ signs.T * _scale(bits), -1.0, 1.0)
    return torch.exp(temperature * cos)


# rows per matrix product in exp_sim_rows; on the CPU, B * 512 stays
# under PyTorch's elementwise grain (32768) for B < 64, so a block's
# elementwise ops run unsplit and every element takes the same path
ROW_BLOCK = {"cpu": 512, "cuda": 1 << 16}


def exp_sim_rows(
    query_vecs: torch.Tensor,   # [B, dim] real-valued, any norm
    db_packed: torch.Tensor,    # [M, W] int32
    planes: torch.Tensor,       # [bits, dim]
    bits: int,
    temperature: float = 1.0,
) -> torch.Tensor:
    """The values of ``asym_exp_similarity_ref``, each (query, row)
    value a function of that row alone.  Rows are scored a
    ``ROW_BLOCK`` at a time, the last block zero-padded, so every matrix
    product and elementwise op has one shape whatever M is (the TPU
    kernels' argument): a product over all M rows may block differently
    when M changes, which would make a row's bits depend on the row
    count."""
    proj = _unit(query_vecs) @ planes.T                       # [B, bits]
    m, w = db_packed.shape
    rows = ROW_BLOCK[db_packed.device.type]
    out = proj.new_empty((proj.shape[0], m))
    for lo in range(0, m, rows):
        block = db_packed[lo:lo + rows]
        n = block.shape[0]
        if n < rows:
            block = torch.cat([block, block.new_zeros((rows - n, w))])
        signs = 2.0 * lsh_mod.unpack_bits(block, bits).to(torch.float32) - 1.0
        cos = torch.clamp(proj @ signs.T * _scale(bits), -1.0, 1.0)
        out[:, lo:lo + n] = torch.exp(temperature * cos)[:, :n]
    return out


def slot_sums(values: torch.Tensor, starts: torch.Tensor,
              counts: torch.Tensor) -> torch.Tensor:
    """[B, R] values -> [B, S] sums: slot s adds ``values[:, starts[s]:
    starts[s] + counts[s]]`` one column at a time, in order, from 0.
    Slots that have run out add an exact 0.0, so a slot's sum depends
    only on its own values, whatever the other slots hold."""
    starts = starts.to(torch.int64)
    counts = counts.to(torch.int64)
    out = values.new_zeros((values.shape[0], counts.shape[0]))
    if values.shape[1] == 0 or counts.shape[0] == 0:
        return out
    for r in range(int(counts.max())):
        live = counts > r
        cols = torch.where(live, starts + r, torch.zeros_like(starts))
        out = out + torch.where(live, values[:, cols], 0.0)
    return out


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
    ``seg_offsets[s]:seg_offsets[s + 1]``; rows outside the offsets add
    to nothing.  Scored with ``exp_sim_rows``, summed with
    ``slot_sums``."""
    offs = seg_offsets.to(torch.int64)
    lo, hi = int(offs[0]), int(offs[-1])
    vals = exp_sim_rows(query_vecs, db_sorted[lo:hi], planes, bits,
                        temperature)
    return slot_sums(vals, offs[:-1] - lo, offs[1:] - offs[:-1])


def asym_topk_candidates_ref(
    query_vecs: torch.Tensor,   # [B, dim] real-valued, any norm
    db_packed: torch.Tensor,    # [M, W] int32
    planes: torch.Tensor,       # [bits, dim]
    bits: int,
    k: int,
    tm: int,
    temperature: float = 1.0,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """The top-k kernel's output: per tile of ``tm`` columns, each
    query's ``k`` best (value, global doc index), value descending and
    ties by ascending index, columns >= M at -inf.  Returns ([B, J*k]
    float32 values, [B, J*k] int32 indices), J = ceil(M / tm)."""
    sims = asym_exp_similarity_ref(query_vecs, db_packed, planes, bits,
                                   temperature)
    b, m = sims.shape
    j = -(-m // tm)
    padded = sims.new_full((b, j * tm), -math.inf)
    padded[:, :m] = sims
    vals, idx = torch.sort(padded.view(b, j, tm), dim=-1, descending=True,
                           stable=True)
    idx = idx + torch.arange(j, device=idx.device)[:, None] * tm
    return (vals[..., :k].reshape(b, j * k),
            idx[..., :k].reshape(b, j * k).to(torch.int32))


def asym_exp_topk_ref(
    query_vecs: torch.Tensor,
    db_packed: torch.Tensor,
    planes: torch.Tensor,
    bits: int,
    k: int,
    temperature: float = 1.0,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """([B, k] int32 indices, [B, k] float32 values) via the unfused
    matrix and a stable descending sort: ties to the lowest index, the
    order of ``jax.lax.top_k``."""
    sims = asym_exp_similarity_ref(query_vecs, db_packed, planes, bits,
                                   temperature)
    vals, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    k = min(int(k), sims.shape[1])
    return idx[:, :k].to(torch.int32), vals[:, :k]
