"""The port's asym scoring functions against the JAX package's
``kernels/asym/ops`` (Pallas in interpret mode on the CPU), at the
shapes of the reference's own fused-kernel tests: ragged M, S equal to
a lane width, B not a multiple of the query tile, empty and unsorted
segments, padding slots.  On the CPU the port's wrappers take their
plain PyTorch versions; ``test_torch_cuda.py`` holds the CUDA kernels
against those same plain versions on the card.
Tolerance rtol=1e-4: the one the reference holds its own fused kernels
to; sums run in another order and beta multiplies the cosine's
absolute error into the exp's relative error."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.kernels.asym import ops as jops
from repro_torch.core import lsh as tlsh
from repro_torch.kernels.asym import kernel as tkernel
from repro_torch.kernels.asym import ops as tops
from repro_torch.kernels.asym import ref as tref


def _setup(b, m, dim, bits, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, dim)).astype(np.float32)
    x = rng.normal(size=(m, dim)).astype(np.float32)
    planes = np.array(jlsh.hyperplanes(jlsh.LSHConfig(bits=bits), dim))
    db = np.array(jlsh.pack_bits(jlsh.signature_bits(jnp.asarray(x),
                                                     jnp.asarray(planes))))
    return rng, q, planes, db


def _t(q, planes, db, device="cpu"):
    return (torch.from_numpy(q).to(device), torch.from_numpy(planes).to(device),
            tlsh.to_packed_tensor(db, device))


@pytest.mark.parametrize("b,m,dim,bits,temp", [
    (1, 7, 24, 128, 1.0),           # single query, tiny M
    (5, 613, 48, 128, 8.0),         # ragged M
    (9, 300, 32, 64, 4.0),          # B past one query tile
    (3, 1000, 64, 256, 8.0),        # the serving widths
])
def test_similarity_matches_reference(b, m, dim, bits, temp):
    _, q, planes, db = _setup(b, m, dim, bits, seed=b * 10 + m)
    want = np.asarray(jops.asym_exp_similarity(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(planes), bits,
        temperature=temp))
    tq, tp, tdb = _t(q, planes, db)
    got = tops.asym_exp_similarity(tq, tdb, tp, bits, temperature=temp)
    assert got.dtype == torch.float32 and got.shape == (b, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("b,m,s,dim,bits,temp", [
    (1, 7, 3, 24, 128, 1.0),        # single query, tiny tile
    (5, 613, 37, 48, 128, 8.0),     # ragged M, many segments
    (9, 300, 128, 32, 64, 4.0),     # S == lane width exactly
    (3, 1000, 5, 48, 256, 8.0),     # M over several tiles
])
def test_segment_sum_matches_reference(b, m, s, dim, bits, temp):
    rng, q, planes, db = _setup(b, m, dim, bits, seed=b * 100 + m)
    seg = np.sort(rng.integers(0, s, m)).astype(np.int32)
    want = np.asarray(jops.asym_exp_segment_sum(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(planes), bits,
        jnp.asarray(seg), s, temperature=temp))
    tq, tp, tdb = _t(q, planes, db)
    got = tops.asym_exp_segment_sum(tq, tdb, tp, bits, torch.from_numpy(seg),
                                    s, temperature=temp)
    assert got.shape == (b, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    direct = tref.asym_exp_segment_sum_ref(tq, tdb, tp, bits,
                                           torch.from_numpy(seg), s, temp)
    np.testing.assert_allclose(direct.numpy(), want, rtol=1e-4)


def test_segment_sum_empty_unsorted_and_padding_slots():
    rng, q, planes, db = _setup(4, 200, 32, 128, seed=0)
    tq, tp, tdb = _t(q, planes, db)
    s = 16
    # all docs in one segment: every other slot must be exactly zero
    got = tops.asym_exp_segment_sum(tq, tdb, tp, 128,
                                    torch.full((200,), 5, dtype=torch.int32), s)
    assert (got[:, 5] > 0).all()
    mask = torch.ones(s, dtype=torch.bool)
    mask[5] = False
    assert (got[:, mask] == 0).all()
    # unsorted slots, with padding slots (>= s) and a negative one mixed in
    seg = rng.integers(0, s, 200).astype(np.int32)
    seg[::7] = s + 3
    seg[3] = -1
    got = tops.asym_exp_segment_sum(tq, tdb, tp, 128, torch.from_numpy(seg), s)
    sims = np.asarray(jops.asym_exp_similarity(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(planes), 128), np.float64)
    keep = (seg >= 0) & (seg < s)
    want = np.stack([np.bincount(seg[keep], weights=row[keep], minlength=s)
                     for row in sims])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def test_segment_csr_layout():
    seg = torch.tensor([2, 0, 5, 2, -1, 0, 1], dtype=torch.int32)
    order, offsets = tops.segment_csr(seg, 4)
    assert offsets.dtype == torch.int32
    assert offsets.tolist() == [0, 2, 3, 5, 5]
    # stable: equal slots keep their row order; out-of-range rows last
    assert order.tolist()[:5] == [1, 5, 6, 0, 3]
    assert sorted(order.tolist()[5:]) == [2, 4]


def test_csr_ref_matches_direct_ref():
    rng, q, planes, db = _setup(3, 90, 16, 64, seed=4)
    tq, tp, tdb = _t(q, planes, db)
    seg = torch.from_numpy(rng.integers(0, 12, 90))
    order, offsets = tops.segment_csr(seg, 12)
    a = tref.asym_exp_segment_sum_csr_ref(tq, tdb[order], tp, 64, offsets, 2.0)
    b = tref.asym_exp_segment_sum_ref(tq, tdb, tp, 64, seg, 12, 2.0)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_zero_query_rows_stay_finite():
    _, q, planes, db = _setup(2, 40, 16, 64, seed=9)
    q[1] = 0.0                       # max(norm, 1e-9) keeps it finite
    tq, tp, tdb = _t(q, planes, db)
    got = tops.asym_exp_similarity(tq, tdb, tp, 64, temperature=8.0)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[1].numpy(), 1.0)


def test_kernel_wrappers_refuse_cpu_tensors():
    _, q, planes, db = _setup(2, 10, 16, 64, seed=1)
    tq, tp, tdb = _t(q, planes, db)
    before = tkernel.asym_similarity_kernel.launches
    with pytest.raises(ValueError):
        tkernel.asym_similarity_kernel(tq, tp, tdb, 64)
    with pytest.raises(ValueError):
        tkernel.asym_segment_sum_kernel(
            tq, tp, tdb, torch.zeros(3, dtype=torch.int32), 64)
    assert tkernel.asym_similarity_kernel.launches == before
