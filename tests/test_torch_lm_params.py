"""The port's LM configs and parameter trees against the JAX package's.

At full size for all ten architectures, with nothing materialised: the
same config fields, the same ``param_defs`` paths, shapes, logical axes
and initialisers, the same parameter count, ``param_count_estimate``,
``active_param_count_estimate`` and ``supports_long_context``.  At smoke
size: the init-scale rule (a stacked definition's fan-in is its layer
axis, as in the reference), the carried tree's per-layer layout, and the
tree helpers against ``repro.utils.trees``."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import ARCHS, carried_params, configs
from repro.configs import ALIASES as JALIASES
from repro.configs import get_config as jget
from repro.configs import list_archs as jlist
from repro.models import model as JM
from repro.models.layers import ParamDef as JParamDef
from repro.utils import trees as jtrees
from repro_torch.configs import ALIASES as TALIASES
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs as tlist
from repro_torch.models import model as TM
from repro_torch.models.layers import tree_paths
from repro_torch.utils import trees as ttrees


def _jdefs(cfg):
    leaves = jax.tree_util.tree_flatten_with_path(
        JM.param_defs(cfg), is_leaf=lambda x: isinstance(x, JParamDef))[0]
    return {tuple(k.key for k in path): d for path, d in leaves}


def _plain(cfg):
    out = dataclasses.asdict(cfg)
    out["dtypes"] = dataclasses.asdict(cfg.dtypes)
    return out


def test_registry_matches():
    assert tlist() == jlist() == ARCHS
    assert TALIASES == JALIASES
    for alias in JALIASES:
        assert tget(alias).name == jget(alias).name


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_param_tree_and_counts(arch):
    jc, tc = jget(arch), tget(arch)
    assert _plain(tc) == _plain(jc)
    assert _plain(tget(arch, smoke=True)) == _plain(jget(arch, smoke=True))
    jd = _jdefs(jc)
    td = dict(tree_paths(TM.param_defs(tc)))
    assert set(td) == set(jd)
    for path, d in jd.items():
        t = td[path]
        assert (t.shape, t.logical_axes, t.init, t.scale) == \
            (d.shape, d.logical_axes, d.init, d.scale), path
    count = sum(math.prod(d.shape) for d in td.values())
    assert count == sum(math.prod(d.shape) for d in jd.values())
    assert tc.param_count_estimate() == jc.param_count_estimate()
    assert tc.active_param_count_estimate() == jc.active_param_count_estimate()
    assert tc.supports_long_context == jc.supports_long_context
    assert (tc.d_inner, tc.ssm_heads, tc.q_dim, tc.kv_dim, tc.is_encdec) == \
        (jc.d_inner, jc.ssm_heads, jc.q_dim, jc.kv_dim, jc.is_encdec)
    assert TM.logical_axes(tc) == jax.tree_util.tree_map(
        lambda d: d.logical_axes, JM.param_defs(jc),
        is_leaf=lambda x: isinstance(x, JParamDef))


def test_dtype_names_map_to_torch():
    d = tget("smollm_360m").dtypes
    assert (d.params_dtype, d.compute_dtype, d.kv_cache_dtype,
            d.opt_state_dtype) == (torch.float32, torch.bfloat16,
                                   torch.bfloat16, torch.float32)
    assert tget("llama4_maverick_400b_a17b").dtypes.opt_state_dtype == \
        torch.bfloat16


def test_init_scale_is_the_reference_rule():
    """A stacked weight's fan-in is its leading (layer) axis: smollm smoke
    ``w_gate`` [2, 64, 128] is drawn with std 1/sqrt(2), as the
    reference's is; zeros and ones stay exact."""
    jc, tc = configs("smollm_360m")
    tp = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    w = torch.stack([lp["mlp"]["w_gate"] for lp in tp["layers"]])
    assert abs(float(w.std()) - 1 / math.sqrt(2)) < 0.02
    assert abs(float(np.std(np.asarray(jp["layers"]["mlp"]["w_gate"])))
               - 1 / math.sqrt(2)) < 0.02
    assert abs(float(tp["tok_emb"].std()) - 1 / math.sqrt(256)) < 0.003
    assert all(torch.equal(lp["norm1"], torch.ones(64)) for lp in tp["layers"])
    again = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"][1]["attn"]["wq"],
                       tp["layers"][1]["attn"]["wq"])
    assert tp["layers"][0]["attn"]["wq"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["smollm_360m", "whisper_small",
                                  "llama4_maverick_400b_a17b",
                                  "llama_3_2_vision_11b"])
def test_carried_tree_is_unstacked_per_layer(arch):
    jc, tc = configs(arch)
    jp, tp = carried_params(jc, tc, 0)
    if "layers" in jp:
        assert len(tp["layers"]) == jc.n_layers
        np.testing.assert_array_equal(
            tp["layers"][1]["attn"]["wq"].numpy(),
            np.asarray(jp["layers"]["attn"]["wq"][1]))
    else:
        g = jp["groups"]
        per = g["plain"]["norm1"].shape[1]
        assert len(tp["groups"]) == g["plain"]["norm1"].shape[0]
        assert all(len(gp["plain"]) == per for gp in tp["groups"])
        second = "cross" if "cross" in g else "moe"
        key = "gate" if second == "cross" else "router"
        np.testing.assert_array_equal(
            tp["groups"][-1][second][second][key].numpy(),
            np.asarray(g[second][second][key][-1]))
        np.testing.assert_array_equal(
            tp["groups"][0]["plain"][per - 1]["mlp"]["w_up"].numpy(),
            np.asarray(g["plain"]["mlp"]["w_up"][0, per - 1]))
    if jc.is_encdec:
        assert len(tp["encoder"]) == jc.encoder_layers
    assert ttrees.tree_param_count(tp) == jtrees.tree_param_count(jp)
    assert ttrees.tree_bytes(tp) == jtrees.tree_bytes(jp)


def test_model_from_arrays_refuses_another_tree():
    jc, tc = configs("smollm_360m")
    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(
        jc, jax.random.PRNGKey(0)))
    del tree["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        TM.model_from_arrays(tc, tree, device="cpu")


def test_tree_helpers_match_the_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32),
                  "i": np.arange(6, dtype=np.int32)}}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = {"a": torch.from_numpy(tree["a"]),
          "b": {"c": torch.from_numpy(tree["b"]["c"]),
                "i": torch.from_numpy(tree["b"]["i"])}}
    assert ttrees.tree_param_count(tt) == jtrees.tree_param_count(jt) == 23
    assert ttrees.tree_bytes(tt) == jtrees.tree_bytes(jt)
    np.testing.assert_allclose(float(ttrees.tree_global_norm(tt)),
                               float(jtrees.tree_global_norm(jt)), rtol=1e-6)
    cast = ttrees.tree_cast(tt, torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16
    assert cast["b"]["i"].dtype == torch.int32
    np.testing.assert_array_equal(
        cast["b"]["c"].float().numpy(),
        np.asarray(jtrees.tree_cast(jt, jnp.bfloat16)["b"]["c"], np.float32))
    z = ttrees.tree_zeros_like(tt)
    assert z["b"]["i"].dtype == torch.int32 and not z["a"].any()
    assert ttrees.tree_zeros_like(tt, torch.float16)["a"].dtype == torch.float16
