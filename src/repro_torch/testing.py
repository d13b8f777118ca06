"""Checks and inputs shared by the port's tests and ``chip_smoke.py``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lsh

# The JAX package's own kernel test shapes (tests/test_kernels.py):
# row 11 (negsamp) as (B, dim, K, temperature), row 12 (k-means
# assignment) as (N, K, dim).
NEGSAMP_SHAPES = [(16, 32, 5, 1.0), (100, 64, 3, 8.0), (256, 16, 1, 4.0),
                  (7, 128, 8, 8.0)]
KMEANS_SHAPES = [(10, 3, 8), (513, 16, 32), (1000, 7, 64)]


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


def ragged_segments(counts, dim: int, bits: int, seed: int, dup: bool = False):
    """Per-shard (packed uint32 signatures, doc ids) with globally unique
    ids for shards of ``counts`` docs, 5 query vectors and the planes,
    all numpy and made from ``seed``.  ``dup`` repeats every signature
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
    return segs, rng.normal(size=(5, dim)).astype(np.float32), planes.numpy()


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
