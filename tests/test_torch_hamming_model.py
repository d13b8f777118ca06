"""The exact CPU model of the Hamming megascan sum (TPU row 8,
``csrc/megascan.cu``'s ``hamming_megascan_segsum_kernel``) against the
JAX package's two Hamming sum kernels (Pallas in interpret mode on the
CPU), and the model's add order against a warp's, lane by lane.

``testing.hamming_warp_sums`` is the plain per-row values (the
32·W+1-entry value table) of each slot summed as one warp sums them
(``testing.warp_slot_sums``); the kernel gives these bits, and
``chip_smoke.py`` and ``test_torch_cuda.py`` hold it to them on the
card.  Against the reference, which sums in another order, the model is
held to rtol=1e-4 (the tolerance the reference holds its own fused
kernels to).  ``warp_slot_sums`` must equal, bit for bit, a warp run
lane by lane in float32 (``hamming_tile::slot_sum``'s order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.kernels.megascan import ops as jops
from repro_torch.core import lsh
from repro_torch.kernels.megascan import ops as tops
from repro_torch.kernels.megascan import ref as tref
from repro_torch.testing import hamming_warp_sums, slot_ranges, warp_slot_sums

# slots of 0, 1, 26 (the served mean), 32 (a full warp), 33 and 45 rows
# (more than a warp: the kernel's per-warp path)
COUNTS = (26, 0, 1, 32, 33, 45, 26, 5, 31, 26)


def _case(counts, b, bits, seed, tm=16):
    """Per-shard signatures of random sign vectors (numpy, from the JAX
    package's planes), B query signatures, and both payloads."""
    rng = np.random.default_rng(seed)
    dim = 16
    planes = np.array(jlsh.hyperplanes(jlsh.LSHConfig(bits=bits), dim))
    segs, base = [], 0
    for c in counts:
        x = rng.normal(size=(c, dim)).astype(np.float32)
        sig = np.array(jlsh.pack_bits(jlsh.signature_bits(
            jnp.asarray(x), jnp.asarray(planes))))
        segs.append((sig.reshape(c, bits // 32),
                     np.arange(base, base + c, dtype=np.int64)))
        base += c
    q = rng.normal(size=(b, dim)).astype(np.float32)
    qsig = np.asarray(jlsh.pack_bits(jlsh.signature_bits(
        jnp.asarray(q), jnp.asarray(planes))))
    return (segs, qsig, jops.build_payload(segs, tm=tm),
            tops.build_payload(segs, tm=tm, device="cpu"))


@pytest.mark.parametrize("b,bits,beta", [
    (1, 64, 1.0), (9, 256, 8.0), (12, 256, 8.0), (16, 64, 4.0),
    (17, 256, 2.0), (12, 64, 8.0),
])
def test_model_matches_reference_kernels(b, bits, beta):
    """The model against the JAX package's
    ``hamming_megascan_segsum_db_kernel`` (double_buffer=True) and
    ``hamming_segment_similarity_kernel`` (the streamed schedule), both
    in interpret mode, on the same payload; empty slots exactly 0."""
    segs, qsig, jp, tp = _case(COUNTS, b, bits, seed=b * 7 + bits)
    q = lsh.to_packed_tensor(qsig, "cpu")
    model = hamming_warp_sums(q, tp.sig, tp.row_start, tp.row_count, bits,
                              beta)
    assert model.dtype == torch.float32 and model.shape == (b, len(COUNTS))
    for double_buffer in (True, False):
        want = jops.megascan_segment_sums(jp, jnp.asarray(qsig), None, bits,
                                          mode="hamming", temperature=beta,
                                          double_buffer=double_buffer)
        np.testing.assert_allclose(model.numpy(), want, rtol=1e-4,
                                   err_msg=f"double_buffer={double_buffer}")
    assert (model[:, np.asarray(COUNTS) == 0] == 0).all()


@pytest.mark.parametrize("b,bits", [(12, 256), (17, 64)])
def test_model_equals_plain_rowwise_values_per_slot(b, bits):
    """Each slot's model sum is ``warp_slot_sums`` of the plain
    version's per-row values of that slot alone (the values do not
    depend on the other slots), and within rtol=1e-4 of the plain
    megascan sum, which adds in row order."""
    segs, qsig, _, tp = _case(COUNTS, b, bits, seed=3)
    q = lsh.to_packed_tensor(qsig, "cpu")
    model = hamming_warp_sums(q, tp.sig, tp.row_start, tp.row_count, bits,
                              8.0)
    plain = tref.hamming_megascan_segsum_ref(q, tp.sig, bits, tp.row_start,
                                             tp.row_count, 8.0)
    torch.testing.assert_close(model, plain, rtol=1e-4, atol=1e-6)
    for s, seg in enumerate(segs):
        one = tops.build_payload([seg], tm=16, device="cpu")
        single = hamming_warp_sums(q, one.sig, one.row_start, one.row_count,
                                   bits, 8.0)
        assert torch.equal(model[:, s], single[:, 0])


def test_model_group_equals_per_shard_across_layouts():
    """Group payload == per-shard payloads bit for bit on the model, for
    two block sizes (the slot's rows sit elsewhere in the payload)."""
    segs, qsig, _, _ = _case(COUNTS, 12, 256, seed=5)
    q = lsh.to_packed_tensor(qsig, "cpu")
    sums = []
    for tm in (8, 64):
        pay = tops.build_payload(segs, tm=tm, device="cpu")
        sums.append(hamming_warp_sums(q, pay.sig, pay.row_start,
                                      pay.row_count, 256, 8.0))
        for s, seg in enumerate(segs):
            one = tops.build_payload([seg], tm=tm, device="cpu")
            assert torch.equal(sums[-1][:, s], hamming_warp_sums(
                q, one.sig, one.row_start, one.row_count, 256, 8.0)[:, 0])
    assert torch.equal(sums[0], sums[1])


def test_slot_ranges_clip_as_the_kernel_does():
    start = torch.tensor([-3, 0, 10, 95, 100], dtype=torch.int32)
    count = torch.tensor([5, 0, 7, 9, 4], dtype=torch.int32)
    lo, cnt = slot_ranges(start, count, 100)
    assert lo.tolist() == [0, 0, 10, 95, 100]
    assert cnt.tolist() == [2, 0, 7, 5, 0]


def _values(counts, b, seed):
    """Per-row values as the kernels see them (exp(beta cos) with beta
    up to 8), laid end to end per slot."""
    rng = np.random.default_rng(seed)
    total = int(np.sum(counts))
    vals = np.exp(8.0 * np.cos(np.pi * rng.integers(0, 257, (b, total))
                               / 256)).astype(np.float32)
    counts = torch.as_tensor(np.asarray(counts, np.int64))
    return torch.from_numpy(vals), torch.cumsum(counts, 0) - counts, counts


def _lane_by_lane(vals, starts, counts):
    """One warp's sum of each slot, in float32 step by step as
    ``slot_sum`` runs it: lane l adds rows l, l + 32, ... from 0.0, then
    each butterfly step adds every lane's partner (lane ^ off)."""
    v = vals.numpy()
    out = np.empty((v.shape[0], len(counts)), np.float32)
    lanes = np.arange(32)
    for s, (lo, c) in enumerate(zip(starts.tolist(), counts.tolist())):
        part = np.zeros((v.shape[0], 32), np.float32)
        for m in range(c):
            part[:, m % 32] = part[:, m % 32] + v[:, lo + m]
        for off in (16, 8, 4, 2, 1):
            part = part + part[:, lanes ^ off]
        assert (part == part[:, :1]).all()      # every lane, one total
        out[:, s] = part[:, 0]
    return torch.from_numpy(out)


@pytest.mark.parametrize("counts", [
    COUNTS, (26,) * 40, (0,) * 5, (33, 45, 70), (32,) * 33, (1,) * 70,
    tuple(np.random.default_rng(9).integers(10, 33, 300)),
    tuple(np.random.default_rng(10).choice([0, 1, 26, 32, 33, 45], 200)),
])
@pytest.mark.parametrize("b", [1, 12])
def test_warp_order_equals_a_warp_lane_by_lane(counts, b):
    """``warp_slot_sums`` gives the bits of a warp run lane by lane, on
    slots of 0 to 70 rows (one, two and three passes of the warp)."""
    vals, starts, cnt = _values(counts, b, seed=len(counts) + b)
    assert torch.equal(warp_slot_sums(vals, starts, cnt),
                       _lane_by_lane(vals, starts, cnt))


def test_bitwise_check_tells_add_orders_apart():
    """The check above can tell add orders apart: ``torch.sum`` of each
    slot's values (another order) gives other bits on slots of ≈26
    rows, within float32 rounding of the same sums."""
    counts = tuple(np.random.default_rng(4).integers(20, 33, 50))
    vals, starts, cnt = _values(counts, 12, seed=4)
    warp = warp_slot_sums(vals, starts, cnt)
    other = torch.stack([vals[:, s:s + c].sum(1) for s, c in
                         zip(starts.tolist(), cnt.tolist())], 1)
    assert not torch.equal(warp, other)
    torch.testing.assert_close(warp, other, rtol=1e-5, atol=0)
