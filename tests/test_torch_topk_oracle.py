"""The exact oracle of the top-k kernels, on the CPU.

``repro_torch.testing.topk_candidates_from_scores`` turns a [B, M]
score matrix into the per-tile top-k candidates that the ranked doc
top-k (TPU row 3) and the ranked megascan (rows 9/10) emit.  Fed with
the similarity kernel's scores it is what ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold the CUDA kernels to bit for bit, ids and
ties included.  Here it is shown equal, bit for bit, to the two plain
versions (``asym_topk_candidates_ref``, ``asym_megascan_topk_ref``) fed
the same scores, at the reference's ragged shard census and at the
shapes that reach every branch of the kernels' selection: k on both
sides of the 32 a warp holds, tiles with 0, 1, k-1, k, k+1, 32, 33 and
256 valid rows, a ragged last tile, and duplicated signatures (exact
ties); and equal to a per-tile Python sort on tie-heavy scores."""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import lsh
from repro_torch.kernels.asym import kernel as tkernel
from repro_torch.kernels.asym import ref as tref
from repro_torch.kernels.megascan import ops as mops
from repro_torch.kernels.megascan import ref as mref
from repro_torch.testing import (SELECT_KS, block_slots, ragged_segments,
                                 select_counts, topk_candidates_from_scores)

RAGGED = (13, 8, 1, 0, 27, 64, 5)   # the reference's megascan shard census
BITS, DIM, TEMP = 64, 16, 4.0


def _inputs(b, m, seed, dup):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32))
    x = rng.normal(size=(m, DIM)).astype(np.float32)
    if dup:
        x[1::2] = x[0::2][:m // 2]
    planes = lsh.hyperplanes(lsh.LSHConfig(bits=BITS), DIM, "cpu")
    db = lsh.pack_bits(lsh.signature_bits(torch.from_numpy(x), planes))
    return rng, q, planes, db


def _equal(got, want, what):
    assert torch.equal(got[0], want[0]), f"{what}: values differ"
    assert torch.equal(got[1], want[1]), f"{what}: ids differ"


ROW3 = [(k, c) for k in SELECT_KS
        for c in select_counts(k, tkernel.topk_tile(k), 1)]


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("k,last", ROW3)
def test_oracle_equals_doc_topk_plain(k, last, dup):
    """Row 3: two tiles, the last with ``last`` docs (M ragged unless
    it is full)."""
    tm = tkernel.topk_tile(k)
    _, q, planes, db = _inputs(3, tm + last, k * 1000 + last, dup)
    scores = tref.asym_exp_similarity_ref(q, db, planes, BITS, TEMP)
    got = topk_candidates_from_scores(scores, k, tm)
    _equal(got, tref.asym_topk_candidates_ref(q, db, planes, BITS, k, tm,
                                              TEMP), f"k={k} last={last}")
    if dup and last >= 2:
        v = got[0].view(3, 2, k)
        assert bool((v[..., 1:] == v[..., :-1]).any()) or k == 1


@pytest.mark.parametrize("tm,k", [(8, 5), (16, 5), (16, 16), (256, 7),
                                  (256, 10), (256, 33)])
def test_oracle_equals_megascan_plain_at_the_ragged_census(tm, k):
    segs, q, planes = ragged_segments(RAGGED, DIM, BITS, tm + k)
    pay = mops.build_payload(segs, tm=tm, device="cpu")
    qt, pt = torch.from_numpy(q), torch.from_numpy(planes)
    slots = pay.slots.reshape(-1)
    scores = tref.exp_sim_rows(qt, pay.sig, pt, BITS, TEMP)
    got = topk_candidates_from_scores(scores, k, tm, slots < pay.n_slots)
    _equal(got, mref.asym_megascan_topk_ref(qt, pay.sig, slots, pt, BITS, k,
                                            pay.n_slots, tm, TEMP),
           f"ragged census tm={tm} k={k}")


MEGA = [(k, tm, layout) for k in SELECT_KS for tm in (256, 512)
        if (tm == 256) == (k <= 256) for layout in ("prefix", "scattered")]


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("k,tm,layout", MEGA)
def test_oracle_equals_megascan_plain_per_valid_count(k, tm, layout, dup):
    """Rows 9/10: one payload block per valid-row count, the valid rows
    first (the payload's layout) or scattered over the block."""
    counts = select_counts(k, tm)
    n_valid = 5
    rng, q, planes, sig = _inputs(3, len(counts) * tm, k + tm, dup)
    slots = torch.from_numpy(block_slots(counts, tm, n_valid,
                                         layout == "scattered", rng))
    scores = tref.exp_sim_rows(q, sig, planes, BITS, TEMP)
    got = topk_candidates_from_scores(scores, k, tm, slots < n_valid)
    _equal(got, mref.asym_megascan_topk_ref(q, sig, slots, planes, BITS, k,
                                            n_valid, tm, TEMP),
           f"k={k} tm={tm} {layout} counts={counts}")


@pytest.mark.parametrize("k,tm,m", [(1, 8, 21), (3, 8, 24), (10, 16, 37),
                                    (33, 64, 100)])
def test_oracle_is_a_stable_sort_per_tile(k, tm, m):
    """Against a per-tile Python sort on integer scores (mostly ties):
    valid columns by (value desc, column asc), then the lowest invalid
    ones in ascending order."""
    rng = np.random.default_rng(k + tm + m)
    scores = rng.integers(0, 4, (2, m)).astype(np.float32)
    valid = rng.random(m) < 0.6
    vals, ids = topk_candidates_from_scores(torch.from_numpy(scores), k, tm,
                                            torch.from_numpy(valid))
    for b in range(2):
        want_v, want_i = [], []
        for first in range(0, -(-m // tm) * tm, tm):
            cols = range(first, first + tm)
            key = [(-scores[b, c] if c < m and valid[c] else math.inf, c)
                   for c in cols]
            top = sorted(key)[:k]
            want_v += [-v if v != math.inf else -math.inf for v, _ in top]
            want_i += [c for _, c in top]
        assert vals[b].tolist() == want_v
        assert ids[b].tolist() == want_i
