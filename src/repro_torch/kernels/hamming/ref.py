"""Plain PyTorch versions of the Hamming kernels: the same functions as
``csrc/hamming.cu`` written as ordinary tensor ops.  CPU tensors take
these; ``chip_smoke.py`` holds the kernels against them on the card.

The distance is exact integer arithmetic (``lsh.hamming_distance``:
XOR, then a popcount of each 32-bit word by shifts and masks), computed
``ROW_BLOCK`` rows at a time so the [N, rows, W] intermediate stays
small.  The similarity reads
``value_table``, the table the kernels read too, so a (query, row)
value has the same bits on every device and in every route.  The CSR
segment sum adds each slot's values in row order (``slot_sums``, shared
with the asym plain versions), so a slot's sum depends on its own rows
alone: the group payload and a single shard's payload give the same
bits, as the kernels do.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core import lsh as lsh_mod
from repro_torch.kernels.asym.ref import slot_sums

# rows per XOR/popcount pass: bounds the [N, rows, W] int32 intermediate
ROW_BLOCK = 1 << 16


def value_table(bits: int, words: int, temperature: float,
                device: "torch.device | str") -> torch.Tensor:
    """[32 * words + 1] float32: entry m is exp(temperature * cos(pi *
    m / bits)), computed in float64 on the host and rounded once, so it
    does not depend on the device.  Cached per (bits, words,
    temperature, device): the serving path asks for it every batch.
    Callers must not write to it."""
    return _value_table(int(bits), int(words), float(temperature),
                        str(torch.device(device)))


@functools.lru_cache(maxsize=64)
def _value_table(bits: int, words: int, temperature: float,
                 device: str) -> torch.Tensor:
    m = np.arange(32 * words + 1, dtype=np.float64)
    vals = np.exp(temperature * np.cos(math.pi * m / bits))
    return torch.from_numpy(vals.astype(np.float32)).to(device)


def hamming_distance_ref(q_packed: torch.Tensor,
                         db_packed: torch.Tensor) -> torch.Tensor:
    """[N, W] x [M, W] packed int32 -> [N, M] int32 Hamming distances."""
    n, m = q_packed.shape[0], db_packed.shape[0]
    out = torch.empty((n, m), dtype=torch.int32, device=q_packed.device)
    for lo in range(0, m, ROW_BLOCK):
        out[:, lo:lo + ROW_BLOCK] = lsh_mod.hamming_distance(
            q_packed, db_packed[lo:lo + ROW_BLOCK])
    return out


def hamming_similarity_ref(q_packed: torch.Tensor, db_packed: torch.Tensor,
                           bits: int, temperature: float = 1.0
                           ) -> torch.Tensor:
    """[N, M] float32 exp(temperature * cos(pi * m / bits)), m the
    Hamming distance, read from ``value_table``."""
    table = value_table(bits, db_packed.shape[1], temperature,
                        db_packed.device)
    return table[hamming_distance_ref(q_packed, db_packed).to(torch.int64)]


def hamming_segment_similarity_ref(
    q_packed: torch.Tensor,     # [N, W] int32
    db_packed: torch.Tensor,    # [M, W] int32
    bits: int,
    seg_ids: torch.Tensor,      # [M] int doc -> segment slot, any order
    n_segments: int,
    temperature: float = 1.0,
) -> torch.Tensor:
    """[N, n_segments] float32 sums of the unfused [N, M] matrix grouped
    by ``seg_ids``; slots outside [0, n_segments) add to nothing."""
    sims = hamming_similarity_ref(q_packed, db_packed, bits, temperature)
    seg = seg_ids.to(device=sims.device, dtype=torch.int64).reshape(-1)
    slot = torch.where((seg >= 0) & (seg < n_segments), seg,
                       torch.full_like(seg, n_segments))
    out = sims.new_zeros((sims.shape[0], n_segments + 1))
    out.index_add_(1, slot, sims)
    return out[:, :n_segments]


def hamming_segment_similarity_csr_ref(
    q_packed: torch.Tensor,     # [N, W] int32
    db_sorted: torch.Tensor,    # [M, W] int32, rows sorted by segment
    bits: int,
    seg_offsets: torch.Tensor,  # [S + 1] int32 CSR offsets
    temperature: float = 1.0,
) -> torch.Tensor:
    """The CSR form the segment-sum kernel takes: segment s owns rows
    ``seg_offsets[s]:seg_offsets[s + 1]``; rows outside the offsets add
    to nothing.  Each slot adds its values in row order."""
    offs = seg_offsets.to(torch.int64)
    lo, hi = int(offs[0]), int(offs[-1])
    vals = hamming_similarity_ref(q_packed, db_sorted[lo:hi], bits,
                                  temperature)
    return slot_sums(vals, offs[:-1] - lo, offs[1:] - offs[:-1])
