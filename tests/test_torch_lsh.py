"""The port's LSH layer against the JAX package's: the same planes and
vectors (made with numpy from a seed) through both.  Packing, signing
and Hamming distances must match exactly; asymmetric cosines within
rtol=1e-5 (fp32 sums taken in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro_torch.core import lsh as tlsh


def _setup(n, dim, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    planes = np.array(jlsh.hyperplanes(jlsh.LSHConfig(bits=bits), dim))
    return rng, x, planes


@pytest.mark.parametrize("n,dim,bits", [(1, 8, 32), (37, 24, 64),
                                        (100, 48, 128), (65, 64, 256)])
def test_sign_and_pack_match_exactly(n, dim, bits):
    _, x, planes = _setup(n, dim, bits, seed=n + bits)
    j_bits = np.array(jlsh.signature_bits(jnp.asarray(x), jnp.asarray(planes)))
    t_bits = tlsh.signature_bits(torch.from_numpy(x), torch.from_numpy(planes))
    np.testing.assert_array_equal(t_bits.numpy(), j_bits)
    j_packed = np.asarray(jlsh.pack_bits(jnp.asarray(j_bits)))
    t_packed = tlsh.pack_bits(torch.from_numpy(j_bits))
    assert t_packed.dtype == torch.int32
    np.testing.assert_array_equal(tlsh.to_numpy_u32(t_packed), j_packed)
    np.testing.assert_array_equal(
        tlsh.unpack_bits(t_packed, bits).numpy(),
        np.asarray(jlsh.unpack_bits(jnp.asarray(j_packed), bits)))
    # the numpy signing path is the same bits again
    np.testing.assert_array_equal(tlsh.sign_vectors_np(x, planes), j_packed)


@pytest.mark.parametrize("bits", [32, 96, 256])
def test_popcount_and_hamming_match_exactly(bits):
    rng = np.random.default_rng(bits)
    w = bits // 32
    a = rng.integers(0, 2 ** 32, (7, w), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (11, w), dtype=np.uint32)
    ta, tb = tlsh.to_packed_tensor(a), tlsh.to_packed_tensor(b)
    np.testing.assert_array_equal(
        tlsh.popcount32(ta).numpy(), np.asarray(jlsh.popcount32(jnp.asarray(a))))
    want = np.asarray(jlsh.hamming_distance(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(tlsh.hamming_distance(ta, tb).numpy(), want)
    np.testing.assert_array_equal(tlsh.packed_hamming_np(a, b),
                                  jlsh.packed_hamming_np(a, b))
    np.testing.assert_allclose(
        tlsh.hamming_similarity(ta, tb, bits, temperature=4.0).numpy(),
        np.asarray(jlsh.hamming_similarity(jnp.asarray(a), jnp.asarray(b),
                                           bits, 4.0)),
        rtol=1e-6)


@pytest.mark.parametrize("m,dim,bits", [(5, 16, 64), (300, 24, 128),
                                        (129, 64, 256)])
def test_asymmetric_cosine_matches(m, dim, bits):
    rng, x, planes = _setup(m, dim, bits, seed=m)
    db = np.asarray(jlsh.pack_bits(jlsh.signature_bits(jnp.asarray(x),
                                                       jnp.asarray(planes))))
    q = (3.0 * rng.normal(size=dim)).astype(np.float32)
    want = np.asarray(jlsh.asymmetric_cosine(jnp.asarray(q), jnp.asarray(db),
                                             jnp.asarray(planes), bits))
    got = tlsh.asymmetric_cosine(torch.from_numpy(q), tlsh.to_packed_tensor(db),
                                 torch.from_numpy(planes), bits).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_packed_tensor_round_trip_keeps_bits():
    words = np.array([[0, 1, 2 ** 31, 2 ** 32 - 1]], np.uint32)
    t = tlsh.to_packed_tensor(words)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tlsh.to_numpy_u32(t), words)
    with pytest.raises(TypeError):
        tlsh.to_packed_tensor(words.astype(np.int64))


def test_hyperplanes_seeded_and_device_independent():
    cfg = tlsh.LSHConfig(bits=64, seed=3)
    a = tlsh.hyperplanes(cfg, 16)
    b = tlsh.hyperplanes(cfg, 16)
    assert a.shape == (64, 16) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, tlsh.hyperplanes(tlsh.LSHConfig(bits=64, seed=4), 16))
    with pytest.raises(ValueError):
        tlsh.LSHConfig(bits=48).words
