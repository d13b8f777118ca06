"""Checks and inputs shared by the port's tests and ``chip_smoke.py``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lsh


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
