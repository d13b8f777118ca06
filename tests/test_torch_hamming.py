"""The port's Hamming (sym-mode) scoring against the JAX package's
``kernels/hamming`` (Pallas in interpret mode on the CPU) and its
``core/lsh``, at the reference's own test shapes
(``tests/test_kernels.py``, ``tests/test_fused_kernels.py``).

Distances and signatures must be equal; similarities and segment sums
within rtol=1e-4 (the tolerance the reference holds its fused kernels
to).  On the CPU the port's wrappers take their plain versions;
``test_torch_cuda.py`` holds the CUDA kernels against those on the
card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.kernels.hamming import ops as jops
from repro.kernels.hamming import ref as jref
from repro_torch.core import lsh as tlsh
from repro_torch.kernels.asym.ops import segment_csr
from repro_torch.kernels.hamming import kernel as tkernel
from repro_torch.kernels.hamming import ops as tops
from repro_torch.kernels.hamming import ref as tref
from repro_torch.testing import sign_clear


def _words(rng, n, w):
    return rng.integers(0, 2**32, (n, w), dtype=np.uint32)


def _t(a):
    return tlsh.to_packed_tensor(a)


@pytest.mark.parametrize("n,m,words", [
    (1, 7, 4), (3, 512, 4), (8, 513, 8), (5, 64, 2), (16, 1000, 1),
])
def test_distance_matches_reference_exactly(n, m, words):
    rng = np.random.default_rng(n * 100 + m)
    q, db = _words(rng, n, words), _words(rng, m, words)
    want = np.asarray(jops.hamming_distance(jnp.asarray(q), jnp.asarray(db)))
    np.testing.assert_array_equal(
        want, np.asarray(jref.hamming_distance_ref(jnp.asarray(q),
                                                   jnp.asarray(db))))
    got = tops.hamming_distance(_t(q), _t(db))
    assert got.dtype == torch.int32 and got.shape == (n, m)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits,temp", [(128, 1.0), (128, 8.0), (256, 4.0)])
def test_similarity_matches_reference(bits, temp):
    rng = np.random.default_rng(bits)
    w = bits // 32
    q, db = _words(rng, 4, w), _words(rng, 300, w)
    want = np.asarray(jops.hamming_similarity(jnp.asarray(q), jnp.asarray(db),
                                              bits, temperature=temp))
    got = tops.hamming_similarity(_t(q), _t(db), bits, temperature=temp)
    assert got.dtype == torch.float32 and got.shape == (4, 300)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    oracle = np.asarray(jref.hamming_similarity_ref(
        jnp.asarray(q), jnp.asarray(db), bits)) ** temp
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4)


@pytest.mark.parametrize("order", ["sorted", "unsorted+padding"])
@pytest.mark.parametrize("n,m,s,bits,temp", [
    (4, 300, 37, 128, 8.0), (1, 64, 3, 64, 1.0), (8, 1000, 121, 256, 4.0),
])
def test_segment_similarity_matches_reference(n, m, s, bits, temp, order):
    rng = np.random.default_rng(n * 10 + m)
    w = bits // 32
    q, db = _words(rng, n, w), _words(rng, m, w)
    if order == "sorted":
        seg = np.sort(rng.integers(0, s, m))
    else:                           # any order; -1 and >= s are padding
        seg = rng.integers(-1, s + 3, m)
    seg = seg.astype(np.int32)
    want = np.asarray(jops.hamming_segment_similarity(
        jnp.asarray(q), jnp.asarray(db), bits, seg, s, temperature=temp))
    got = tops.hamming_segment_similarity(_t(q), _t(db), bits,
                                          torch.from_numpy(seg), s,
                                          temperature=temp)
    assert got.dtype == torch.float32 and got.shape == (n, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    unfused = tref.hamming_segment_similarity_ref(
        _t(q), _t(db), bits, torch.from_numpy(seg), s, temp)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=1e-4)


def test_segment_similarity_empty_segments_are_exact_zeros():
    rng = np.random.default_rng(3)
    q, db = _words(rng, 3, 4), _words(rng, 50, 4)
    seg = rng.choice([0, 2, 5], 50).astype(np.int32)
    got = tops.hamming_segment_similarity(_t(q), _t(db), 128,
                                          torch.from_numpy(seg), 7,
                                          temperature=8.0)
    empty = np.setdiff1d(np.arange(7), seg)
    assert (got.numpy()[:, empty] == 0).all()
    assert (got.numpy()[:, [0, 2, 5]] > 0).all()


def test_csr_form_equals_slot_map_form():
    rng = np.random.default_rng(4)
    q, db = _words(rng, 5, 4), _words(rng, 200, 4)
    seg = torch.from_numpy(rng.integers(-2, 20, 200))
    order, offsets = segment_csr(seg, 17)
    got = tops.hamming_segment_similarity_csr(_t(q), _t(db)[order], 128,
                                              offsets, temperature=4.0)
    want = tops.hamming_segment_similarity(_t(q), _t(db), 128, seg, 17,
                                           temperature=4.0)
    assert torch.equal(got, want)


def test_values_do_not_depend_on_the_batch():
    """A (query, row) value comes from one table entry, so it has the
    same bits whatever rows and queries it is scored with."""
    rng = np.random.default_rng(5)
    q, db = _t(_words(rng, 6, 8)), _t(_words(rng, 333, 8))
    full = tops.hamming_similarity(q, db, 256, temperature=8.0)
    part = tops.hamming_similarity(q[2:3], db[100:111], 256, temperature=8.0)
    assert torch.equal(full[2:3, 100:111], part)


def test_value_table_is_the_reference_function():
    table = tref.value_table(128, 4, 8.0, "cpu")
    assert table.dtype == torch.float32 and table.shape == (129,)
    m = jnp.arange(129, dtype=jnp.float32)
    want = np.asarray(jnp.exp(8.0 * jnp.cos(jnp.pi * m / 128)))
    np.testing.assert_allclose(table.numpy(), want, rtol=1e-5)
    assert tref.value_table(128, 4, 8.0, "cpu") is table
    assert bool((table[1:] < table[:-1]).all())     # strictly decreasing


def test_popcount_of_words_with_the_high_bit():
    words = np.array([0, 1, 2**31, 2**32 - 1, 0x80000001, 0x7FFFFFFF,
                      0xAAAAAAAA, 0x55555555], np.uint32)
    got = tlsh.popcount32(_t(words.reshape(1, -1)))
    np.testing.assert_array_equal(
        got.numpy()[0], [bin(int(x)).count("1") for x in words])


def test_kernel_wrappers_refuse_cpu_tensors():
    q, db = _t(np.zeros((2, 4), np.uint32)), _t(np.zeros((3, 4), np.uint32))
    with pytest.raises(ValueError):
        tkernel.hamming_distance_kernel(q, db)
    with pytest.raises(ValueError):
        tkernel.hamming_similarity_kernel(q, db, 128)
    with pytest.raises(ValueError):
        tkernel.hamming_segment_similarity_kernel(
            q, db, torch.zeros(2, dtype=torch.int32), 128)


def test_cpu_route_launches_no_kernel():
    rng = np.random.default_rng(6)
    q, db = _t(_words(rng, 2, 4)), _t(_words(rng, 30, 4))
    before = (tkernel.hamming_distance_kernel.launches,
              tkernel.hamming_similarity_kernel.launches,
              tkernel.hamming_segment_similarity_kernel.launches)
    tops.hamming_distance(q, db)
    tops.hamming_similarity(q, db, 128)
    tops.hamming_segment_similarity(q, db, 128, torch.zeros(30), 1)
    assert (tkernel.hamming_distance_kernel.launches,
            tkernel.hamming_similarity_kernel.launches,
            tkernel.hamming_segment_similarity_kernel.launches) == before


def _clear_vectors(rng, n, dim, planes):
    """``n`` Gaussian vectors whose signs no rounding can flip."""
    x = rng.normal(size=(4 * n, dim)).astype(np.float32)
    x = x[sign_clear(x, planes)][:n]
    assert x.shape[0] == n
    return x


@pytest.mark.parametrize("dim,bits", [(24, 128), (64, 256), (16, 64)])
def test_host_signing_matches_reference_signing(dim, bits):
    """Sym queries are signed on the host (``sign_vectors_np``); their
    bits equal the reference's jax signing for inputs clear of 0."""
    rng = np.random.default_rng(dim + bits)
    planes = np.array(jlsh.hyperplanes(jlsh.LSHConfig(bits=bits), dim))
    x = _clear_vectors(rng, 40, dim, planes)
    want = np.asarray(jlsh.pack_bits(jlsh.signature_bits(
        jnp.asarray(x), jnp.asarray(planes))))
    got = tlsh.sign_tensor(x, torch.from_numpy(planes))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tlsh.sign_vectors_np(x, planes), want)


def test_sign_clear_flags_rows_near_a_hyperplane():
    planes = np.eye(3, dtype=np.float32)
    vecs = np.array([[1, 1, 1], [1, 1e-6, 1], [0, 0, 0]], np.float32)
    np.testing.assert_array_equal(sign_clear(vecs, planes), [True, False,
                                                             False])


@pytest.mark.parametrize("temp", [1.0, 8.0])
def test_lsh_index_matches_reference(temp):
    rng = np.random.default_rng(9)
    dim, bits = 24, 128
    planes = np.array(jlsh.hyperplanes(jlsh.LSHConfig(bits=bits), dim))
    x = _clear_vectors(rng, 60, dim, planes)
    q = _clear_vectors(rng, 1, dim, planes)[0]
    packed = np.asarray(jlsh.pack_bits(jlsh.signature_bits(
        jnp.asarray(x), jnp.asarray(planes))))
    ref = jlsh.LSHIndex(jnp.asarray(packed), jnp.asarray(planes), bits)
    port = tlsh.LSHIndex(_t(packed), torch.from_numpy(planes), bits)
    np.testing.assert_array_equal(port.sign(q).numpy().view(np.uint32),
                                  np.asarray(ref.sign(jnp.asarray(q))))
    want = np.asarray(ref.similarities(jnp.asarray(q), use_kernel=True,
                                       temperature=temp))
    got = port.similarities(q, temperature=temp)
    assert got.shape == (60,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.similarities(jnp.asarray(q),
                                                 temperature=temp)),
        rtol=1e-4)
    built = tlsh.LSHIndex.build(x, tlsh.LSHConfig(bits=bits, seed=3),
                                device="cpu")
    assert built.packed.device.type == "cpu"
    assert built.bits == bits and built.packed.shape == (60, 4)
    assert torch.equal(built.packed, built.sign(x))


def test_lsh_index_build_defaults_to_cuda():
    """``LSHIndex.build`` computes on CUDA unless asked for the CPU, as
    every entry point of the port does: without a GPU the default
    raises instead of carrying on on the CPU."""
    x = np.random.default_rng(4).standard_normal((5, 8)).astype(np.float32)
    cfg = tlsh.LSHConfig(bits=32, seed=1)
    if torch.cuda.is_available():
        assert tlsh.LSHIndex.build(x, cfg).packed.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tlsh.LSHIndex.build(x, cfg)
