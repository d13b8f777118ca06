"""The port's distributed side (slice 8) against the JAX package's.

Rule parity: ``logical_to_mesh_spec`` of every rule key and of every
logical-axes tuple the models and trees use, on three meshes and under
two overrides, with the reference's four mapping tests as direct
counterparts.  Tree parity, with no device: the legalized parameter,
optimizer-state, batch and decode-state shardings of all ten archs at
full width on the (16, 16) and (2, 16, 16) meshes, leaf for leaf, and
the per-device bytes they imply.  The shape cells and their arithmetic.
Multi-process (gloo over a ``FileStore``, ``_torch_dist.py``): the int8
compressed all-reduce against the reference's under ``jax.vmap``, bit
for bit in its residual; ``shard_constraint`` on a DTensor; the sharded
train step on 8 ranks against the single-process step.  JAX spec
entries naming one axis come back as the axis name (jax 0.9 normalises
``("data",)`` to ``"data"``), so specs are compared through ``norm``."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh

import _torch_dist as D
from _torch_lm import ARCHS, bound
from repro.configs import get_config as jget
from repro.distributed import sharding as JS
from repro.launch import specs as JSP
from repro.launch import steps as JST
from repro.optimizer.adamw import AdamWConfig as JCfg
from repro_torch.configs import get_config as tget
from repro_torch.distributed import sharding as TS
from repro_torch.launch import specs as TSP
from repro_torch.launch import steps as TST
from repro_torch.launch.mesh import make_placement_mesh
from repro_torch.optimizer.adamw import AdamWConfig as TCfg
from repro_torch.utils.trees import tree_leaves


class _FakeMesh:
    def __init__(self, names):
        self.axis_names = tuple(names)


def norm(spec) -> tuple:
    """A spec's entries with a one-axis tuple written as the axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 (tuple(e) if isinstance(e, tuple) else e) for e in spec)


# ----------------------------------------------------------------------
# rules: the reference's four mapping tests, then every key and tuple
# ----------------------------------------------------------------------
def test_logical_mapping_drops_missing_axes():
    spec = TS.logical_to_mesh_spec(("batch", None, "d_ff"),
                                   _FakeMesh(["data", "model"]))
    assert spec == TS.P(("data",), None, "model")
    assert norm(spec) == tuple(JS.logical_to_mesh_spec(
        ("batch", None, "d_ff"), _FakeMesh(["data", "model"])))


def test_logical_mapping_multi_axis_batch():
    spec = TS.logical_to_mesh_spec(("batch", "d_ff"),
                                   _FakeMesh(["pod", "data", "model"]))
    assert spec[0] == ("pod", "data")
    assert spec[1] == "model"


def test_rules_override_scoped():
    mesh = _FakeMesh(["data", "model"])
    with TS.set_rules({"seq": "model"}):
        assert TS.logical_to_mesh_spec(("batch", "seq"), mesh)[1] == "model"
    assert TS.logical_to_mesh_spec(("batch", "seq"), mesh)[1] is None


def test_no_duplicate_mesh_axes():
    mesh = _FakeMesh(["data", "model"])
    with TS.set_rules({"seq": "data"}):   # batch also wants data
        spec = TS.logical_to_mesh_spec(("batch", "seq"), mesh)
    used = [a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)]
    assert len(used) == len(set(used))
    assert spec == TS.P(("data",), None)


# the tuples the models' shard_constraint calls and the trees use
_MODEL_TUPLES = [
    ("batch", "seq", "d_model"), ("batch", "seq", "vocab"), ("batch", "vocab"),
    ("batch", "seq", "d_ff"), ("experts", None, None, "d_model"),
    ("experts", None, None, "d_ff"), ("batch", "seq", "d_inner"),
    ("batch", "kv_heads", None, "attn_q_seq"),
    ("batch", "kv_heads", None, "attn_q_seq", None),
    ("batch", "seq", "heads", None), ("batch", "seq", "kv_heads", None),
    ("batch", "attn_q_seq", None, None),
]


@functools.lru_cache(maxsize=None)
def _param_tuples():
    from repro.models import model as JM
    out = set()
    for a in ARCHS:
        jax.tree_util.tree_map(out.add, JM.logical_axes(jget(a)),
                               is_leaf=lambda x: isinstance(x, tuple))
    return sorted(out, key=repr)


@pytest.mark.parametrize("override", [None, {"seq": "model"},
                                      {"fsdp": None}])
@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model"), ("data",)])
def test_every_rule_and_tuple_maps_as_the_reference(names, override):
    mesh = _FakeMesh(names)
    cases = ([(k,) for k in JS.LOGICAL_RULES] + _MODEL_TUPLES
             + _param_tuples() + [("layers", "fsdp", "heads", None)])
    assert dict(TS.LOGICAL_RULES) == dict(JS.LOGICAL_RULES)
    ov = override or {}
    with JS.set_rules(ov), TS.set_rules(ov):
        for axes in cases:
            got = TS.logical_to_mesh_spec(axes, mesh)
            assert norm(got) == tuple(JS.logical_to_mesh_spec(axes, mesh)), axes
            assert TS.get_rules() == JS.get_rules()
    assert TS.get_rules() is TS.LOGICAL_RULES


# ----------------------------------------------------------------------
# trees on the production meshes, no device
# ----------------------------------------------------------------------
_MESHES = {"single": ((16, 16), ("data", "model")),
           "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(which):
    sizes, names = _MESHES[which]
    return JMesh(sizes, names), TS.AbstractMesh(sizes, names)


def _jspecs(tree):
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]


def _tspecs(tree):
    return [norm(s.spec) for s in tree_leaves(tree)]


def _jbytes(shardings, abstract) -> int:
    return sum(math.prod(sh.shard_shape(a.shape)) * a.dtype.itemsize
               for sh, a in zip(jax.tree_util.tree_leaves(
                   shardings, is_leaf=lambda x: isinstance(
                       x, jax.sharding.NamedSharding)),
                   jax.tree_util.tree_leaves(abstract)))


@pytest.mark.parametrize("which", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_trees_match_the_reference(arch, which):
    from repro_torch.launch.dryrun import tree_shard_bytes
    jc, tc = jget(arch), tget(arch)
    jm, tm = _meshes(which)
    for serve in (False, True):
        assert _tspecs(TST.params_shardings(tc, tm, serve=serve)) == \
            _jspecs(JST.params_shardings(jc, jm, serve=serve))
    tp_sh = TST.params_shardings(tc, tm)
    assert _tspecs(TST.opt_state_shardings(tc, tm)) == \
        _jspecs(JST.opt_state_shardings(jc, jm))
    # per-device bytes: the reference's shard_shape over its abstract leaves
    assert tree_shard_bytes(tp_sh, TST.abstract_params(tc)) == \
        _jbytes(JST.params_shardings(jc, jm), JST.abstract_params(jc))
    o_sh = TST.opt_state_shardings(tc, tm)
    ab_o = TST.abstract_opt_state(tc, TCfg(state_dtype=tc.dtypes.opt_state))
    jab_o = JST.abstract_opt_state(jc, JCfg(state_dtype=jc.dtypes.opt_state))
    assert tree_shard_bytes(o_sh, ab_o) == \
        _jbytes(JST.opt_state_shardings(jc, jm), jab_o)
    with_enc = jc.is_encdec or jc.family == "vlm"
    for shape in TSP.SHAPES.values():
        assert _tspecs(TST.batch_shardings(tc, tm, shape.global_batch,
                                           with_enc)) == \
            _jspecs(JST.batch_shardings(jc, jm, shape.global_batch, with_enc))
    cell = TSP.SHAPES["decode_32k"]
    tstate = TST.abstract_decode_state(tc, cell.global_batch, cell.seq_len,
                                       with_enc)
    jstate = JST.abstract_decode_state(jc, cell.global_batch, cell.seq_len,
                                       with_enc)
    t_st = TST.decode_state_shardings(tc, tm, tstate, cell.global_batch)
    j_st = JST.decode_state_shardings(jc, jm, jstate, cell.global_batch)
    assert _tspecs(t_st) == _jspecs(j_st)
    assert [tuple(x.shape) for x in tree_leaves(tstate)
            if isinstance(x, torch.Tensor)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jstate)
         if x.ndim > 0]


def test_placement_meshes_give_the_same_trees():
    """``make_placement_mesh(16, model=16)`` is the (16, 16) mesh."""
    tc = tget("smollm_360m")
    a = TST.params_shardings(tc, make_placement_mesh(16, model=16))
    b = TST.params_shardings(tc, _meshes("single")[1])
    assert _tspecs(a) == _tspecs(b)


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_cells_match_the_reference(arch):
    jc, tc = jget(arch), tget(arch)
    assert {k: tuple(vars(v).values()) for k, v in TSP.SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in JSP.SHAPES.items()}
    for shape in TSP.SHAPES:
        assert TSP.cell_is_supported(tc, shape) == \
            JSP.cell_is_supported(jc, shape)
        assert TSP.microbatches_for(tc, shape) == \
            JSP.microbatches_for(jc, shape)
        jt = JSP.train_input_specs(jc, shape)
        tt = TSP.train_input_specs(tc, shape)
        assert {k: tuple(v.shape) for k, v in tt.items()} == \
            {k: tuple(v.shape) for k, v in jt.items()}
        assert tt["tokens"].dtype == torch.int64
        assert tuple(TSP.serve_token_spec(tc, shape).shape) == \
            tuple(JSP.serve_token_spec(jc, shape).shape)


def test_named_sharding_placements_and_shard_shape():
    from torch.distributed.tensor import Replicate, Shard
    mesh = TS.AbstractMesh((2, 4, 8), ("pod", "data", "model"))
    sh = TS.NamedSharding(mesh, TS.P(("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert sh.shard_shape((16, 3, 64)) == (2, 3, 8)
    assert TS.NamedSharding(mesh, TS.P()).placements == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        TS.NamedSharding(mesh, TS.P(("data", "pod"))).placements
    with pytest.raises(ValueError):
        sh.shard_shape((6, 3, 64))
    assert TS.data_host_count(mesh) == 8
    assert TS.mesh_axis_size("model") is None
    with TS.use_mesh(mesh):
        assert TS.mesh_axis_size("model") == 8
    assert TS.shard_constraint(torch.ones(2), "batch") is not None


# ----------------------------------------------------------------------
# fault 3: a batch that does not divide into micro-batches
# ----------------------------------------------------------------------
def test_indivisible_microbatches_refused_by_both():
    from _torch_lm import FP32, configs, jbatch, stacked_params, tbatch, train_batch
    from repro.optimizer.adamw import adamw_init as jinit
    from repro_torch.optimizer.adamw import adamw_init as tinit
    jc, tc = configs("smollm_360m", FP32)
    jp, tp = stacked_params(jc, tc, seed=0)
    batch = train_batch(jc, b=10, s=16, seed=2)
    with pytest.raises(TypeError, match="reshape"):
        JST.make_train_step(jc, JCfg(), microbatches=4)(
            jp, jinit(jp, JCfg()), jbatch(batch))
    with pytest.raises(ValueError, match="10 rows .* 4 micro-batches"):
        TST.make_train_step(tc, TCfg(), microbatches=4)(
            tp, tinit(tp, TCfg()), tbatch(batch))


# ----------------------------------------------------------------------
# multi-process: compression, shard_constraint, the sharded step
# ----------------------------------------------------------------------
def test_compressed_psum_and_shard_constraint_on_gloo(tmp_path):
    from repro.distributed.compression import compressed_psum as jpsum
    ranks = D.spawn("compress", 4, tmp_path)
    xs, errs = zip(*(D.compress_inputs(r) for r in range(4)))
    jsum, jerr = jax.vmap(lambda x, e: jpsum(x, "i", e), axis_name="i")(
        jnp.asarray(np.stack(xs)), jnp.asarray(np.stack(errs)))
    # gloo adds in another order than XLA, so a sum that cancels is held
    # relative to its four addends' magnitudes (rtol 1e-6), not to
    # itself (10 of 900 entries cancel to 7e-4 relative, 1.2e-7 apart)
    scale = sum(np.abs(x + e) for x, e in zip(xs, errs))
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["new_error"].numpy(),
                                      np.asarray(jerr[r]))
        assert (np.abs(out["sum"].numpy() - np.asarray(jsum[r]))
                <= 1e-6 * scale).all()
        # batch -> data does not divide 3 rows: dropped; d_ff -> model
        assert out["placements"] == ["Replicate()", "Shard(dim=1)"]
        assert out["plain_is_same"]
    assert [tuple(o["local"].shape) for o in ranks] == [(3, 2)] * 4


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """One spawn of 8 ranks for every case of ``D.STEP_CASES``."""
    return D.spawn("step", 8, tmp_path_factory.mktemp("step"))[0]


@pytest.mark.parametrize("case", D.STEP_CASES, ids=D.case_id)
def test_sharded_step_matches_single_process(sharded_runs, case):
    """Loss and every parameter after 3 steps within ``bound(1e-5,
    move)`` of the single-process step, ``move`` its own one-ulp move
    (readings, smollm: parameters 3.0e-7 to 5.3e-7 against moves of
    1.2e-4 to 1.6e-4, losses within 8.2e-8).  The MoE cases run
    expert-parallel: each rank keeps E / model experts, and the step
    launched the expert region's collectives.  Where a rank's rows, or
    a micro-batch's, are masked whole, the aux loss still counts once
    (a rank's weight is 0 only where it holds no unmasked row).  Every
    case is tensor-parallel over ``model`` where a sublayer's dim
    divides: no leaf the split reads by its chunk is gathered over
    ``model``, and in the dense cases each layer's split sublayers run
    their collectives the expected number of times.  For the archs of
    ``D.GRADS_ONLY`` the first step's loss (rtol 1e-5) and gradients
    (``bound(1e-5, move)`` of the gradients' own one-ulp move) are held
    instead of the parameters after the steps."""
    arch, (sizes, names), mb = case[:3]
    got = sharded_runs[case]
    if arch in D.GRADS_ONLY:
        loss, grads, gmove = D.single_process_grads(arch)
        gtol = bound(1e-5, gmove)
        assert abs(got["loss0"] - loss) <= 1e-5 * abs(loss)
        for a, b in zip(got["grads"], grads):
            assert a.shape == b.shape and D.rel(a, b) < gtol
    else:
        p, losses, move, lmove = D.single_process(arch, mb, *case[3:])
        tol, ltol = bound(1e-5, move), bound(1e-5, lmove)
        for a, b in zip(tree_leaves(got["params"]), tree_leaves(p)):
            assert a.shape == b.shape and D.rel(a, b) < tol
        for a, b in zip(got["losses"], losses):
            assert abs(a - b) <= ltol * abs(b)
    p = got["params"]
    # the state lay as shards: tok_emb [vocab, d] over (model, data)
    size = dict(zip(names, sizes))
    full = tuple(p["tok_emb"].shape)
    assert got["local_tok_emb"] == (full[0] // size["model"],
                                    full[1] // size["data"])
    kinds = got["collectives"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(kinds)
    if "drops" in got:
        moe = p["groups"]["moe"] if "groups" in p else p["layers"]
        n_layers, n_exp = moe["moe"]["w_gate"].shape[:2]
        assert got["local_w_gate"][:2] == (n_layers, n_exp // size["model"])
        assert {"region-in", "region-out", "stat-all-reduce",
                "count-all-gather"} <= set(kinds)
    if len(case) > 3 and case[3] is not None:
        # drops fall on a batch rank after the first
        assert any(n > 0 for coord, n in got["drops"] if coord["data"] > 0)
    # tensor parallelism over model: no leaf that the split reads by its
    # chunk is gathered over model
    from repro_torch.models import model as TM
    from repro_torch.models.attention import attention_split
    from repro_torch.models.layers import tree_paths
    cfg = D.step_setup(arch, *case[3:])[0]
    m, s = size["model"], D.STEP_SEQ
    reads = TM.tp_reads(cfg, m, s, cfg.encoder_seq if cfg.is_encdec else 0)
    split = {"/".join(path) for path, r in tree_paths(reads)
             if isinstance(r, int)}
    assert split and not split & set(got["gathered"].get("model", ()))
    if cfg.family == "dense":
        # a micro-batch sums the input gradient of each layer's
        # attention and MLP and of the head once (region-in), their
        # outputs and the embedding's at least once (region-out; the
        # remat's recompute may run the attention's again), or gathers
        # the attention's query rows (seq-all-gather)
        per, n = D.STEP_COUNT * mb, cfg.n_layers
        heads = attention_split(cfg, m, s) == "heads"
        assert kinds["region-in"]["count"] == per * (2 * n + 1)
        once = per * ((2 if heads else 1) * n + 1)
        assert once <= kinds["region-out"]["count"] <= once + per * n
        if not heads:
            assert per * n <= kinds["seq-all-gather"]["count"] <= 2 * per * n


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """One spawn of ``D.SERVE_WORLD`` ranks for every case of
    ``D.SERVE_CASES``."""
    return D.spawn("serve", D.SERVE_WORLD,
                   tmp_path_factory.mktemp("serve"))[0]


@pytest.mark.parametrize("case", D.SERVE_CASES, ids=D.serve_id)
def test_sharded_serving_matches_single_process(serve_runs, case):
    """The sharded prefill and decode steps on 4 gloo ranks: every
    call's logits [B, vocab] (whole on every rank) and the state after
    them (its leaves joined) within ``bound(1e-5, move)`` of the
    unsharded ``prefill`` / ``decode_step``, ``move`` the logits' own
    one-ulp move (readings: 3.3e-7 to 8.3e-6 against moves of 4.6e-6
    to 4.9e-5), ``pos`` and ``length`` exactly; each
    rank held its slots of the caches (the sequence split over
    ``model``) and its rows of the batch; a decode step joined the
    attention over the slots by log-sum-exp, the logits' columns were
    gathered; no leaf the step reads by its chunk (``tp_reads(...,
    serve=True)``) was gathered over ``model``; where the SSM computes
    whole over split state leaves, their chunks were gathered."""
    from repro_torch.models import model as TM
    from repro_torch.models.layers import tree_paths
    from repro_torch.models.ssm import ssm_split
    arch, (sizes, names), changes = case
    got = serve_runs[case]
    logits, state, move = D.single_process_serve(arch, changes)
    tol = bound(1e-5, move)
    assert len(got["logits"]) == len(logits)
    for a, b in zip(got["logits"], logits):
        assert a.shape == b.shape and D.rel(a, b) < tol
    st = got["state"]
    assert st.length == state.length
    if state.pos is not None:
        assert torch.equal(st.pos, state.pos)
    want = tree_leaves((state.kv, state.ssm))
    for a, b, local in zip(tree_leaves((st.kv, st.ssm)), want,
                           got["local_shapes"]):
        assert a.shape == b.shape and D.rel(a, b) < tol
    size = dict(zip(names, sizes))
    m = size["model"]
    cfg = D.serve_setup(arch, changes)[0]
    if state.kv is not None:
        k = tree_leaves(state.kv)[0]
        seq_dim = k.ndim - 3
        assert got["local_shapes"][0][seq_dim] == k.shape[seq_dim] // m
        assert got["local_shapes"][0][seq_dim - 1] == \
            k.shape[seq_dim - 1] // size["data"]
        assert {"decode-max", "decode-sum", "decode-out"} <= \
            set(got["collectives"]["decode"])
    if cfg.vocab_size % m == 0:
        assert "logits-all-gather" in got["collectives"]["decode"]
    if state.ssm is not None:
        gathers = "state-all-gather" in got["collectives"]["decode"]
        assert gathers == (ssm_split(cfg, m) is None)
    for step, s in (("prefill", D.SERVE_PROMPT), ("decode", 1)):
        reads = TM.tp_reads(cfg, m, s, serve=True)
        split = {"/".join(path) for path, r in tree_paths(reads)
                 if isinstance(r, int)}
        assert split and not split & set(got["gathered"][step]
                                         .get("model", ()))


def test_meshes():
    """``make_placement_mesh`` is shape only; ``make_host_mesh`` makes a
    one-rank group when there is none; ``make_production_mesh`` needs a
    world of its size (a fake 512-rank one here)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    m = make_placement_mesh(6, model=2)
    assert (m.shape, m.size) == ({"data": 6, "model": 2}, 12)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="256 ranks, found 0"):
        make_production_mesh(device="cpu")
    host = make_host_mesh("cpu")
    try:
        assert TS.mesh_shape(host) == {"data": 1, "model": 1}
        with pytest.raises(RuntimeError, match="512 ranks, found 1"):
            make_production_mesh(multi_pod=True, device="cpu")
    finally:
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        prod = make_production_mesh(multi_pod=True, device="cpu")
        assert TS.mesh_shape(prod) == {"pod": 2, "data": 16, "model": 16}
        assert TS.data_host_count(prod) == 32
    finally:
        dist.destroy_process_group()
