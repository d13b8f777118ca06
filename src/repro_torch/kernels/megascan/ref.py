"""Plain PyTorch versions of the megascan kernels: the same functions
as ``csrc/megascan.cu`` written as ordinary tensor ops.  CPU tensors
take these; ``chip_smoke.py`` holds the kernels against them on the
card.

The asym versions score with the asym plain versions' ``exp_sim_rows``,
the sym version with the Hamming plain versions' table lookup; in both
a row's value depends on that row alone, and only real rows are read.
The sums add each slot's rows in order with ``slot_sums``, the
primitive of the CSR segment-sum plain versions (the streamed
schedule), so on the CPU too a group payload gives the bits of a
single-shard payload, and the two schedules give the same bits.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.asym.ref import exp_sim_rows, slot_sums
from repro_torch.kernels.hamming.ref import hamming_similarity_ref


def _slot_rows(row_start: torch.Tensor, row_count: torch.Tensor
               ) -> torch.Tensor:
    """Payload row index of every real row, slot by slot, in order."""
    start = row_start.to(torch.int64)
    count = row_count.to(torch.int64)
    first = torch.cumsum(count, 0) - count
    within = (torch.arange(int(count.sum()), device=start.device)
              - torch.repeat_interleave(first, count))
    return torch.repeat_interleave(start, count) + within


def asym_megascan_segsum_ref(
    query_vecs: torch.Tensor,   # [B, dim] real-valued, any norm
    sig: torch.Tensor,          # [n_rows, W] int32 block-aligned payload
    planes: torch.Tensor,       # [bits, dim]
    bits: int,
    row_start: torch.Tensor,    # [S] int32 first real row of each slot
    row_count: torch.Tensor,    # [S] int32 real rows of each slot
    temperature: float = 1.0,
) -> torch.Tensor:
    """[B, S] float32 per-slot sums of exp(beta * asym-cos) over each
    slot's real rows."""
    rows = _slot_rows(row_start, row_count)
    vals = exp_sim_rows(query_vecs, sig[rows], planes, bits, temperature)
    count = row_count.to(torch.int64)
    return slot_sums(vals, torch.cumsum(count, 0) - count, count)


def hamming_megascan_segsum_ref(
    q_packed: torch.Tensor,     # [B, W] int32 packed query signatures
    sig: torch.Tensor,          # [n_rows, W] int32 block-aligned payload
    bits: int,
    row_start: torch.Tensor,    # [S] int32 first real row of each slot
    row_count: torch.Tensor,    # [S] int32 real rows of each slot
    temperature: float = 1.0,
) -> torch.Tensor:
    """[B, S] float32 per-slot sums of exp(beta * cos(pi * m / bits))
    over each slot's real rows."""
    rows = _slot_rows(row_start, row_count)
    vals = hamming_similarity_ref(q_packed, sig[rows], bits, temperature)
    count = row_count.to(torch.int64)
    return slot_sums(vals, torch.cumsum(count, 0) - count, count)


def asym_megascan_topk_ref(
    query_vecs: torch.Tensor,   # [B, dim] real-valued, any norm
    sig: torch.Tensor,          # [n_blocks*tm, W] int32 payload
    slots: torch.Tensor,        # [n_rows] int32 row -> slot
    planes: torch.Tensor,       # [bits, dim]
    bits: int,
    k: int,
    n_valid_slots: int,
    tm: int,
    temperature: float = 1.0,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Per block of ``tm`` rows, each query's ``k`` best (value, payload
    position), value descending and ties by ascending position; rows
    whose slot is not below ``n_valid_slots`` at -inf.  Returns
    ([B, n_blocks*k] float32, [B, n_blocks*k] int32)."""
    slots = slots.reshape(-1)
    n_rows = sig.shape[0]
    n_blocks = n_rows // tm
    real = torch.nonzero(slots < n_valid_slots).reshape(-1)
    vals = exp_sim_rows(query_vecs, sig[real], planes, bits, temperature)
    b = vals.shape[0]
    full = vals.new_full((b, n_rows), -math.inf)
    full[:, real] = vals
    top, pos = torch.sort(full.view(b, n_blocks, tm), dim=-1,
                          descending=True, stable=True)
    pos = pos + torch.arange(n_blocks, device=pos.device)[:, None] * tm
    return (top[..., :k].reshape(b, n_blocks * k),
            pos[..., :k].reshape(b, n_blocks * k).to(torch.int32))
