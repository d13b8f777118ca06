"""The CPU model of the table-lookup arithmetic of rows 2 and 7
(``repro_torch.testing.lut_segment_sums``: 4-bit tables summed i = 0
first, chunks in ascending order, exp, lane-strided partials and a
fixed xor-butterfly per slot, as ``csrc/asym_tile.cuh`` orders them)
against the JAX package's ``asym_segment_sum_kernel`` and
``asym_megascan_segsum_db_kernel`` (Pallas in interpret mode on the
CPU), on the same seeded numpy inputs: bits 64/128/256, B on both
sides of the 8-query tile, all-zero and all-one signature rows, empty
and one-row slots, beta up to 8.  Tolerance rtol=1e-4, the one the
reference holds its own fused kernels to.

Within the model the reference's bitwise properties hold bit for bit:
group payload == single-shard payload, streamed (CSR over the slot
map) == pipelined (the slots' row ranges)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.kernels.asym import ops as jaops
from repro.kernels.megascan import ops as jmops
from repro_torch.core import lsh as tlsh
from repro_torch.kernels.asym import ops as taops
from repro_torch.kernels.megascan import ops as tmops
from repro_torch.testing import (lut_exp_sim_rows, lut_segment_sums,
                                 lut_tables, warp_slot_sums)

# docs per slot: empty and one-row slots, one full warp and a lane past
# it, a slot of the serving size (26) and one of several warp rounds
COUNTS = (0, 1, 26, 33, 0, 7, 70, 1, 32)
DIM = 16


def _signatures(rng, m, bits, planes):
    """[m, W] uint32 signatures of Gaussian rows, row 0 all zero bits
    and row 1 all one bits."""
    x = rng.normal(size=(m, DIM)).astype(np.float32)
    db = np.array(jlsh.pack_bits(jlsh.signature_bits(jnp.asarray(x),
                                                     jnp.asarray(planes))))
    db[0] = 0
    db[1] = 0xFFFFFFFF
    return db


def _inputs(b, bits, seed):
    rng = np.random.default_rng(seed)
    planes = np.array(jlsh.hyperplanes(jlsh.LSHConfig(bits=bits), DIM))
    q = rng.normal(size=(b, DIM)).astype(np.float32)
    return rng, q, planes


CASES = [(bits, b, beta) for bits in (64, 128, 256)
         for b, beta in ((1, 1.0), (9, 8.0), (12, 4.0), (32, 8.0))]


@pytest.mark.parametrize("bits,b,beta", CASES)
def test_model_matches_reference_segment_sum(bits, b, beta):
    """Row 2's function: CSR-sorted rows, the model against the JAX
    package's fused segment sum."""
    rng, q, planes = _inputs(b, bits, bits + b)
    counts = np.asarray(COUNTS)
    m = int(counts.sum())
    db = _signatures(rng, m, bits, planes)
    seg = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    want = np.asarray(jaops.asym_exp_segment_sum(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(planes), bits,
        jnp.asarray(seg), len(counts), temperature=beta))
    offs = np.concatenate([[0], np.cumsum(counts)])
    got = lut_segment_sums(torch.from_numpy(q),
                           tlsh.to_packed_tensor(db, "cpu"),
                           torch.from_numpy(planes), bits,
                           torch.from_numpy(offs[:-1]),
                           torch.from_numpy(counts), beta)
    assert got.dtype == torch.float32 and got.shape == (b, len(counts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    assert (got[:, torch.from_numpy(counts == 0)] == 0).all()


@pytest.mark.parametrize("bits,b,beta", CASES)
def test_model_matches_reference_megascan(bits, b, beta):
    """Row 7's function: the block-aligned payload's real rows, the
    model against the JAX package's one-launch megascan sum."""
    rng, q, planes = _inputs(b, bits, bits * 3 + b)
    segs, base = [], 0
    for c in COUNTS:
        sig = _signatures(rng, max(c, 2), bits, planes)[:c]
        segs.append((sig, np.arange(base, base + c, dtype=np.int64)))
        base += c
    want = jmops.megascan_segment_sums(
        jmops.build_payload(segs, tm=32), jnp.asarray(q),
        jnp.asarray(planes), bits, temperature=beta, double_buffer=True)
    pay = tmops.build_payload(segs, tm=32, device="cpu")
    got = lut_segment_sums(torch.from_numpy(q), pay.sig,
                           torch.from_numpy(planes), bits, pay.row_start,
                           pay.row_count, beta)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    assert (got[:, torch.from_numpy(np.asarray(COUNTS) == 0)] == 0).all()


def test_model_tables_and_dots():
    """Each table entry is its signed sum of four projections, and the
    all-zero and all-one rows score -sum and +sum of the projection."""
    rng, q, planes = _inputs(3, 64, 5)
    proj = torch.from_numpy(q) @ torch.from_numpy(planes).T
    t = lut_tables(proj)
    assert t.shape == (16, 3, 16)
    p = proj.double().reshape(3, 16, 4)
    for n in (0, 5, 10, 15):
        sign = torch.tensor([1.0 if n >> i & 1 else -1.0 for i in range(4)],
                            dtype=torch.float64)
        torch.testing.assert_close(t[:, :, n].T.double(), p @ sign,
                                   rtol=1e-6, atol=1e-6)
    db = tlsh.to_packed_tensor(np.array([[0, 0], [0xFFFFFFFF] * 2],
                                        np.uint32), "cpu")
    unit = torch.eye(3, DIM)
    vals = lut_exp_sim_rows(unit, db, torch.from_numpy(planes), 64, 2.0)
    dots = (unit @ torch.from_numpy(planes).T).sum(dim=1).double()
    scale = 1.0 / (64 * np.sqrt(2.0 / np.pi))
    want = torch.exp(2.0 * torch.clamp(torch.stack([-dots, dots], 1) * scale,
                                       -1.0, 1.0))
    torch.testing.assert_close(vals.double(), want, rtol=1e-6, atol=0)


def test_warp_slot_sums_order():
    """Lane-strided partials and the xor-butterfly, against the same
    order written as a Python loop."""
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.random((2, 200)).astype(np.float32) * 1e3)
    starts = torch.tensor([0, 3, 3, 100])
    counts = torch.tensor([3, 0, 97, 100])
    got = warp_slot_sums(vals, starts, counts)
    for b in range(2):
        for s in range(4):
            part = [np.float32(0.0)] * 32
            for r in range(int(counts[s])):
                part[r % 32] = np.float32(part[r % 32]
                                          + vals[b, starts[s] + r].numpy())
            for off in (16, 8, 4, 2, 1):
                part = [np.float32(part[l] + part[l ^ off])
                        for l in range(32)]
            assert got[b, s].item() == part[0]


@pytest.mark.parametrize("bits,b", [(64, 5), (256, 12)])
def test_model_group_equals_per_shard_and_streamed_equals_pipelined(bits, b):
    rng, q, planes = _inputs(b, bits, 99 + bits)
    segs, base = [], 0
    for c in COUNTS:
        sig = _signatures(rng, max(c, 2), bits, planes)[:c]
        segs.append((sig, np.arange(base, base + c, dtype=np.int64)))
        base += c
    tq, tp = torch.from_numpy(q), torch.from_numpy(planes)
    pay = tmops.build_payload(segs, tm=16, device="cpu")
    group = lut_segment_sums(tq, pay.sig, tp, bits, pay.row_start,
                             pay.row_count, 8.0)
    order, offs = taops.segment_csr(pay.slots.reshape(-1), pay.n_slots)
    streamed = lut_segment_sums(tq, pay.sig[order], tp, bits, offs[:-1],
                                offs[1:] - offs[:-1], 8.0)
    assert torch.equal(group, streamed)
    for s, seg in enumerate(segs):
        one = tmops.build_payload([seg], tm=16, device="cpu")
        single = lut_segment_sums(tq, one.sig, tp, bits, one.row_start,
                                  one.row_count, 8.0)
        assert torch.equal(group[:, s], single[:, 0])
