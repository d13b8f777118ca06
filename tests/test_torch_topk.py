"""The port's ranked top-k over documents against the JAX package's
``kernels/asym/ops.asym_exp_topk`` (Pallas in interpret mode on the
CPU) and ``ApproxIndex.topk_doc_similarities_batch``, on the same
inputs made with numpy, at the shapes of the reference's own fused
top-k tests.  On the CPU the port's wrapper takes the kernel's plain
version (per-tile candidates, then the same final stable sort);
``test_torch_cuda.py`` holds the CUDA kernel against it on the card.

Values are held to rtol=1e-4, the reference's tolerance; ids must be
equal wherever neighbouring values differ by more than that, and on
exact ties (duplicated signature rows) the lowest index comes first,
the order of ``jax.lax.top_k``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.kernels.asym import ops as jops
from repro_torch.core import index as tindex
from repro_torch.core import lsh as tlsh
from repro_torch.kernels.asym import kernel as tkernel
from repro_torch.kernels.asym import ops as tops
from repro_torch.kernels.asym import ref as tref
from repro_torch.testing import assert_ids_equal_away_from_ties

QUERIES = [[3, 5, 9], [2], [10, 11], [7, 4, 5, 6]]
SHAPES = [  # (B, M, k, dim, bits, beta): tests/test_fused_kernels.py
    (3, 257, 10, 48, 128, 8.0),     # k << tile, ragged M
    (5, 100, 100, 32, 64, 4.0),     # k == M (full sort)
    (2, 700, 300, 24, 128, 1.0),    # k > the default tile
    (2, 50, 7, 24, 64, 2.0),        # tiny M
]


def _setup(b, m, dim, bits, seed, dup=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, dim)).astype(np.float32)
    x = rng.normal(size=(m, dim)).astype(np.float32)
    if dup:
        x[1::2] = x[0::2][:m // 2]
    planes = np.array(jlsh.hyperplanes(jlsh.LSHConfig(bits=bits), dim))
    db = np.array(jlsh.pack_bits(jlsh.signature_bits(jnp.asarray(x),
                                                     jnp.asarray(planes))))
    return q, planes, db


def _port(q, planes, db, bits, k, temp):
    return tops.asym_exp_topk(torch.from_numpy(q), tlsh.to_packed_tensor(db),
                              torch.from_numpy(planes), bits, k,
                              temperature=temp)


@pytest.mark.parametrize("b,m,k,dim,bits,temp", SHAPES)
def test_topk_matches_reference(b, m, k, dim, bits, temp):
    q, planes, db = _setup(b, m, dim, bits, seed=b + m + k)
    want_idx, want_vals = jops.asym_exp_topk(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(planes), bits, k,
        temperature=temp)
    idx, vals = _port(q, planes, db, bits, k, temp)
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    assert idx.shape == vals.shape == (b, min(k, m))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals),
                               rtol=1e-4)
    assert_ids_equal_away_from_ties(idx.numpy(), want_idx, vals.numpy())
    # rows descending, and the picks carry their own values
    assert (np.diff(vals.numpy(), axis=1) <= 0).all()
    sims = tops.asym_exp_similarity(
        torch.from_numpy(q), tlsh.to_packed_tensor(db),
        torch.from_numpy(planes), bits, temperature=temp)
    assert torch.equal(sims.gather(1, idx.long()), vals)


@pytest.mark.parametrize("b,m,k,dim,bits,temp", SHAPES)
def test_topk_equals_the_unfused_plain_version(b, m, k, dim, bits, temp):
    """Per-tile candidates then the final stable sort give exactly the
    stable sort of the whole matrix (ties to the lowest index)."""
    q, planes, db = _setup(b, m, dim, bits, seed=7 * b + m)
    idx, vals = _port(q, planes, db, bits, k, temp)
    ridx, rvals = tref.asym_exp_topk_ref(
        tops._prep_queries(torch.from_numpy(q)), tlsh.to_packed_tensor(db),
        torch.from_numpy(planes), bits, k, temp)
    assert torch.equal(idx, ridx) and torch.equal(vals, rvals)


@pytest.mark.parametrize("m,k", [(600, 10), (257, 40), (50, 50)])
def test_topk_ties_go_to_the_lowest_index(m, k):
    q, planes, db = _setup(3, m, 32, 64, seed=m, dup=True)
    idx, vals = _port(q, planes, db, 64, k, 4.0)
    want_idx, want_vals = jops.asym_exp_topk(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(planes), 64, k,
        temperature=4.0)
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals),
                               rtol=1e-4)
    idx, vals = idx.numpy(), vals.numpy()
    tie = vals[:, 1:] == vals[:, :-1]
    assert tie.any()
    assert (idx[:, 1:][tie] > idx[:, :-1][tie]).all()
    assert_ids_equal_away_from_ties(idx, want_idx, vals)


def test_topk_candidates_layout():
    """The kernel's output layout: per tile, the k best (value, global
    index) of that tile's columns, columns past M at -inf."""
    q, planes, db = _setup(2, 300, 16, 64, seed=3)
    tq, tp, tdb = (torch.from_numpy(q), torch.from_numpy(planes),
                   tlsh.to_packed_tensor(db))
    vals, idx = tref.asym_topk_candidates_ref(tq, tdb, tp, 64, 5, 256, 2.0)
    assert vals.shape == idx.shape == (2, 10) and idx.dtype == torch.int32
    sims = tref.asym_exp_similarity_ref(tq, tdb, tp, 64, 2.0)
    for t, (lo, hi) in enumerate([(0, 256), (256, 300)]):
        order = torch.sort(sims[:, lo:hi], dim=1, descending=True,
                           stable=True).indices[:, :5] + lo
        assert torch.equal(idx[:, 5 * t:5 * t + 5], order.to(torch.int32))
    assert tkernel.topk_tile(5) == 256 and tkernel.topk_tile(300) == 512


def test_topk_clamps_k():
    q, planes, db = _setup(2, 20, 16, 64, seed=4)
    idx, vals = _port(q, planes, db, 64, 50, 1.0)
    assert idx.shape == (2, 20)
    idx, vals = _port(q, planes, db, 64, 0, 1.0)
    assert idx.shape == vals.shape == (2, 0)


# ----------------------------------------------------------------------
# index level
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair(small_corpus, built_index, tmp_path_factory):
    """(the reference's doc-granular kernel index, the port's load)."""
    ref = dataclasses.replace(built_index, granularity="doc",
                              use_kernel=True).attach_corpus(small_corpus)
    path = str(tmp_path_factory.mktemp("idx") / "index.npz")
    ref.save(path)
    return ref, tindex.ApproxIndex.load(path, device="cpu")


@pytest.mark.parametrize("k", [1, 9, 40])
def test_index_topk_fused_matches_unfused_and_reference(pair, k):
    ref, port = pair
    ids_f, vals_f = port.topk_doc_similarities_batch(QUERIES, k=k)
    ids_u, vals_u = port.topk_doc_similarities_batch(QUERIES, k=k,
                                                     fused=False)
    assert ids_f.dtype == np.int64 and vals_f.dtype == np.float64
    assert ids_f.shape == vals_f.shape == (len(QUERIES), k)
    np.testing.assert_array_equal(ids_f, ids_u)
    np.testing.assert_array_equal(vals_f, vals_u)
    for fused in (True, False):
        want_ids, want_vals = ref.topk_doc_similarities_batch(
            QUERIES, k=k, fused=fused)
        np.testing.assert_allclose(vals_f, want_vals, rtol=1e-4)
        assert_ids_equal_away_from_ties(ids_f, want_ids, vals_f)


def test_index_topk_requires_doc_vectors(pair):
    _, port = pair
    bare = dataclasses.replace(port, doc_sig=None, doc_vecs=None)
    with pytest.raises(ValueError):
        bare.topk_doc_similarities_batch(QUERIES, k=3)
    # sym mode, refused before the Hamming kernels were ported, takes
    # the reference's unfused route (``tests/test_torch_sym.py``)
    sym = dataclasses.replace(port, lsh_mode="sym")
    ids, vals = sym.topk_doc_similarities_batch(QUERIES, k=3)
    assert ids.shape == vals.shape == (len(QUERIES), 3)
    uids, uvals = sym.topk_doc_similarities_batch(QUERIES, k=3, fused=False)
    np.testing.assert_array_equal(ids, uids)
    np.testing.assert_array_equal(vals, uvals)
