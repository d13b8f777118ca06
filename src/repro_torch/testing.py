"""Checks, inputs and models shared by the port's tests and
``chip_smoke.py``."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import lsh

# The JAX package's own kernel test shapes (tests/test_kernels.py):
# row 11 (negsamp) as (B, dim, K, temperature), row 12 (k-means
# assignment) as (N, K, dim).
NEGSAMP_SHAPES = [(16, 32, 5, 1.0), (100, 64, 3, 8.0), (256, 16, 1, 4.0),
                  (7, 128, 8, 8.0)]
KMEANS_SHAPES = [(10, 3, 8), (513, 16, 32), (1000, 7, 64)]
# The top-k kernels' selection cases (rows 3, 9/10): k on both sides of
# the 32 ranks a warp holds, and valid rows per tile or payload block.
SELECT_KS = (1, 10, 31, 32, 33, 300)
SELECT_VALID = (0, 1, "k-1", "k", "k+1", 32, 33, 256)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_ids_equal_away_from_ties(got_ids, want_ids, vals,
                                    what: str = "ranked ids",
                                    rtol: float = 1e-4) -> None:
    """Assert ranked ids equal at every rank whose value is clear of its
    neighbours' in the same row: they differ by more than ``rtol``, or
    one is finite and the other not.  Takes tensors or arrays, [R, k]."""
    v = _np(vals).astype(np.float64)
    fin = np.isfinite(v)
    with np.errstate(invalid="ignore"):
        gap = ((np.abs(np.diff(v, axis=1)) > rtol * np.abs(v[:, 1:]))
               | (fin[:, 1:] != fin[:, :-1]))
    clear = np.ones_like(v, bool)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    if not np.array_equal(_np(got_ids)[clear], _np(want_ids)[clear]):
        raise AssertionError(f"{what}: ids differ away from ties")


def topk_candidates_from_scores(scores: torch.Tensor, k: int, tm: int,
                                valid: "torch.Tensor | None" = None
                                ) -> "tuple[torch.Tensor, torch.Tensor]":
    """The top-k kernels' candidates from a [B, M] score matrix: per
    tile of ``tm`` columns, a stable descending sort with the columns
    that are not ``valid`` ([M] bool; all are when None) and those past
    M at -inf, and the first ``k`` (value, column) pairs of each tile.
    Fed with the similarity kernel's scores it gives the top-k kernels'
    exact output, ids and ties included.  Returns ([B, J*k] float32,
    [B, J*k] int32), J = ceil(M / tm)."""
    b, m = scores.shape
    j = -(-m // tm)
    padded = scores.new_full((b, j * tm), -math.inf)
    padded[:, :m] = (scores if valid is None
                     else torch.where(valid, scores, -math.inf))
    vals, pos = torch.sort(padded.view(b, j, tm), dim=-1, descending=True,
                           stable=True)
    pos = pos + torch.arange(j, device=pos.device)[:, None] * tm
    return (vals[..., :k].reshape(b, j * k),
            pos[..., :k].reshape(b, j * k).to(torch.int32))


def select_counts(k: int, tm: int, lowest: int = 0) -> list:
    """``SELECT_VALID`` for this k, those in [lowest, tm], ascending."""
    named = {"k-1": k - 1, "k": k, "k+1": k + 1}
    return sorted({named.get(c, c) for c in SELECT_VALID}
                  & set(range(lowest, tm + 1)))


def block_slots(counts, tm: int, n_valid: int, scattered: bool,
                rng) -> np.ndarray:
    """[len(counts) * tm] int32 row -> slot map with ``counts[j]`` rows
    of block j in a valid slot (< ``n_valid``), the first ones of the
    block or, if ``scattered``, rows drawn at random; the other rows
    carry slots in [n_valid, 200)."""
    slots = np.empty(len(counts) * tm, np.int32)
    for j, c in enumerate(counts):
        real = np.zeros(tm, bool)
        if scattered:
            real[rng.choice(tm, c, replace=False)] = True
        else:
            real[:c] = True
        slots[j * tm:(j + 1) * tm] = np.where(
            real, rng.integers(0, n_valid, tm), rng.integers(n_valid, 200, tm))
    return slots


def ragged_segments(counts, dim: int, bits: int, seed: int, dup: bool = False,
                    n_queries: int = 5):
    """Per-shard (packed uint32 signatures, doc ids) with globally unique
    ids for shards of ``counts`` docs, ``n_queries`` query vectors and
    the planes, all numpy and made from ``seed``.  ``dup`` repeats every signature
    row in place, so ranked values tie exactly."""
    rng = np.random.default_rng(seed)
    planes = lsh.hyperplanes(lsh.LSHConfig(bits=bits), dim, "cpu")
    segs, base = [], 0
    for c in counts:
        x = rng.normal(size=(c, dim)).astype(np.float32)
        if dup:
            x[1::2] = x[0::2][:c // 2]
        sig = lsh.to_numpy_u32(lsh.pack_bits(lsh.signature_bits(
            torch.from_numpy(x), planes)))
        segs.append((sig, np.arange(base, base + c, dtype=np.int64)))
        base += c
    return (segs, rng.normal(size=(n_queries, dim)).astype(np.float32),
            planes.numpy())


def sign_clear(vecs, planes, margin: float = 1e-4) -> np.ndarray:
    """[B] bool: True for the rows of ``vecs`` whose every projection on
    a hyperplane lies farther than ``margin`` from 0, relative to the two
    norms.  Two matrix products that round differently (numpy's and
    another framework's) give such a row the same sign bits, so sym
    parity tests draw their query vectors from these rows."""
    v = np.atleast_2d(_np(vecs)).astype(np.float64)
    p = np.atleast_2d(_np(planes)).astype(np.float64)
    norms = (np.linalg.norm(v, axis=1, keepdims=True)
             * np.linalg.norm(p, axis=1)[None, :])
    cos = (v @ p.T) / np.maximum(norms, 1e-30)
    return (np.abs(cos) > margin).all(axis=1)


def top2_chunked(x: torch.Tensor, c: torch.Tensor
                 ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Each row's (at most) two largest x . c[k] and their ids, [N, 2],
    in the plain k-means assignment's row chunks, so the [N, K] scores
    are never whole."""
    from repro_torch.kernels.kmeans import ref as kref
    vals, ids = [], []
    step = kref.chunk_rows(c.shape[0])
    for lo in range(0, x.shape[0], step):
        v, i = torch.topk(x[lo:lo + step] @ c.T, min(2, c.shape[0]), dim=1)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)


def assert_assign_away_from_ties(ids: torch.Tensor, x: torch.Tensor,
                                 c: torch.Tensor, what: str) -> int:
    """Assert the assignment ``ids`` [N] of rows ``x`` to centroids ``c``
    equals the plain argmax at every row whose top two scores differ by
    more than 1e-4 relative; returns the number of rows held."""
    v, i = top2_chunked(x, c)
    if v.shape[1] == 1:
        if not torch.equal(ids.long(), i[:, 0]):
            raise AssertionError(f"{what}: assignment differs")
        return ids.shape[0]
    got = torch.stack([ids.long(), i[:, 1]], 1)
    assert_ids_equal_away_from_ties(got, i, v, what)
    vd = v.double()
    return int(((vd[:, 0] - vd[:, 1]).abs() > 1e-4 * vd[:, 1].abs()).sum())


# ----------------------------------------------------------------------
# the table-lookup segment sums of rows 2 and 7, in the kernels' order
# ----------------------------------------------------------------------
LUT_BITS = 4   # signature bits per table lookup (asym_tile.cuh)
WARP = 32


def lut_tables(proj: torch.Tensor) -> torch.Tensor:
    """[B, bits] projections -> [bits/4, B, 16] tables: entry n of chunk
    c is the sum over i < 4 of (bit i of n ? +1 : -1) * proj[:, 4c + i],
    added i = 0 first, as ``asym_tile::build_tables`` adds them."""
    b, bits = proj.shape
    p = proj.reshape(b, bits // LUT_BITS, LUT_BITS).permute(1, 0, 2)
    n = torch.arange(16, device=proj.device)
    sign = [torch.where((n >> i) & 1 == 1, 1.0, -1.0).to(proj.dtype)
            for i in range(LUT_BITS)]
    t = p[..., 0:1] * sign[0]
    for i in range(1, LUT_BITS):
        t = t + p[..., i:i + 1] * sign[i]
    return t


def lut_exp_sim_rows(q_unit: torch.Tensor, db: torch.Tensor,
                     planes: torch.Tensor, bits: int,
                     temperature: float = 1.0) -> torch.Tensor:
    """[B, M] exp(temperature * clip(dot * scale, -1, 1)) with each dot
    a sum of table entries, one per 4-bit chunk of the row's signature,
    chunks in ascending order from 0.0 (``asym_tile::lut_dots``).  The
    exp runs over fixed-shape row blocks (``ROW_BLOCK``, as the plain
    versions do), so a row's value depends on that row alone."""
    from repro_torch.kernels.asym.ref import ROW_BLOCK, _scale
    proj = q_unit @ planes.T                                 # [B, bits]
    tables = lut_tables(proj)                                # [C, B, 16]
    words = db[:, :bits // 32].to(torch.int64)
    shifts = LUT_BITS * torch.arange(32 // LUT_BITS, device=db.device)
    nib = ((words[:, :, None] >> shifts) & 15).reshape(db.shape[0],
                                                       bits // LUT_BITS)
    dot = proj.new_zeros((proj.shape[0], db.shape[0]))
    for c in range(tables.shape[0]):
        dot = dot + tables[c][:, nib[:, c]]
    cos = torch.clamp(dot * _scale(bits), -1.0, 1.0)
    rows = ROW_BLOCK[db.device.type]
    out = torch.empty_like(cos)
    for lo in range(0, cos.shape[1], rows):
        block = cos[:, lo:lo + rows]
        n = block.shape[1]
        if n < rows:
            block = torch.cat([block, block.new_zeros((block.shape[0],
                                                       rows - n))], 1)
        out[:, lo:lo + n] = torch.exp(temperature * block)[:, :n]
    return out


def warp_slot_sums(values: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor) -> torch.Tensor:
    """[B, R] values -> [B, S] per-slot sums as one warp takes them
    (``asym_tile::lut_slot_sum``): lane l adds the slot's values l,
    l + 32, ... in order from 0.0, then a fixed xor-butterfly (offsets
    16, 8, 4, 2, 1) adds the 32 partials."""
    starts = starts.to(torch.int64)
    counts = counts.to(torch.int64)
    b, s = values.shape[0], counts.shape[0]
    lanes = torch.arange(WARP, device=values.device)
    part = values.new_zeros((b, s, WARP))
    rounds = -(-int(counts.max()) // WARP) if s else 0
    for r in range(rounds):
        off = r * WARP + lanes
        live = off[None, :] < counts[:, None]                # [S, 32]
        cols = torch.where(live, starts[:, None] + off[None, :], 0)
        part = part + torch.where(live, values[:, cols], 0.0)
    for off in (16, 8, 4, 2, 1):
        part = part + part[..., lanes ^ off]
    return part[..., 0]


def lut_segment_sums(query_vecs: torch.Tensor, db: torch.Tensor,
                     planes: torch.Tensor, bits: int,
                     starts: torch.Tensor, counts: torch.Tensor,
                     temperature: float = 1.0) -> torch.Tensor:
    """The CPU model of rows 2 and 7's arithmetic: [B, S] float32 sums
    of the table-lookup exp-similarity (``lut_exp_sim_rows``) over slot
    s's rows ``db[starts[s]:starts[s] + counts[s]]``, summed per slot as
    one warp does (``warp_slot_sums``).  Query rows are unit-normalised
    as the wrappers do; only the slots' rows are read."""
    from repro_torch.kernels.asym.ref import _unit
    starts = starts.to(torch.int64)
    counts = counts.to(torch.int64)
    first = torch.cumsum(counts, 0) - counts
    within = (torch.arange(int(counts.sum()), device=db.device)
              - torch.repeat_interleave(first, counts))
    rows = torch.repeat_interleave(starts, counts) + within
    q = query_vecs.to(torch.float32)
    vals = lut_exp_sim_rows(_unit(q if q.dim() == 2 else q[None, :]),
                            db[rows], planes.to(torch.float32), bits,
                            temperature)
    return warp_slot_sums(vals, first, counts)
