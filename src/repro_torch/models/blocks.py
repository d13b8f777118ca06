"""Per-family transformer blocks: ParamDefs + apply functions.

Every block comes in one apply function usable for the full-sequence
forward (no cache) and serving (with KV/SSM state).  Blocks take the
*per-layer* param dict; model.py stacks the definitions along a leading
"layers" axis (the reference's tree) and runs the layers in a loop.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.collectives import NO_TP, TPShard
from repro_torch.distributed.sharding import shard_constraint
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import ParamDef, gelu_mlp, rms_norm, swiglu
from repro_torch.utils.tracing import span


# ----------------------------------------------------------------------
# ParamDefs
# ----------------------------------------------------------------------
def attn_defs(cfg) -> dict:
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    out = {
        "wq": ParamDef((d, q), ("fsdp", "q_dim")),
        "wk": ParamDef((d, kv), ("fsdp", "kv_dim")),
        "wv": ParamDef((d, kv), ("fsdp", "kv_dim")),
        "wo": ParamDef((q, d), ("q_dim", "fsdp")),
    }
    if cfg.qkv_bias:
        out.update({
            "bq": ParamDef((q,), ("q_dim",), init="zeros"),
            "bk": ParamDef((kv,), ("kv_dim",), init="zeros"),
            "bv": ParamDef((kv,), ("kv_dim",), init="zeros"),
        })
    return out


def mlp_defs(cfg, gelu: bool = False) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if gelu:
        return {
            "w_in": ParamDef((d, ff), ("fsdp", "d_ff")),
            "b_in": ParamDef((ff,), ("d_ff",), init="zeros"),
            "w_out": ParamDef((ff, d), ("d_ff", "fsdp")),
            "b_out": ParamDef((d,), ("d_model",), init="zeros"),
        }
    return {
        "w_gate": ParamDef((d, ff), ("fsdp", "d_ff")),
        "w_up": ParamDef((d, ff), ("fsdp", "d_ff")),
        "w_down": ParamDef((ff, d), ("d_ff", "fsdp")),
    }


def moe_defs(cfg) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamDef((d, e), ("d_model", None)),
        "w_gate": ParamDef((e, d, ff), ("experts", "fsdp", None)),
        "w_up": ParamDef((e, d, ff), ("experts", "fsdp", None)),
        "w_down": ParamDef((e, ff, d), ("experts", None, "fsdp")),
    }


def ssm_defs(cfg) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * di + 2 * n + h
    return {
        "in_proj": ParamDef((d, proj_out), ("fsdp", "d_inner")),
        "conv_w": ParamDef((cfg.conv_dim, di), (None, "d_inner"), scale=0.5),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "a_log": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamDef((h,), ("ssm_heads",), init="ones"),
        "out_proj": ParamDef((di, d), ("d_inner", "fsdp")),
    }


def mamba2_defs(cfg) -> dict:
    """The published Mamba2 mixer's leaves (``ssm.mamba2_apply``)."""
    d, di, h, w = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.conv_width
    return {
        "in_proj": ParamDef((d, di + w + h), ("fsdp", "d_inner")),
        "conv_w": ParamDef((cfg.conv_dim, w), (None, "d_inner"), scale=0.5),
        "conv_b": ParamDef((w,), ("d_inner",), init="zeros"),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "a_log": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamDef((h,), ("ssm_heads",), init="ones"),
        "norm": ParamDef((di,), ("d_inner",), init="ones"),
        "out_proj": ParamDef((di, d), ("d_inner", "fsdp")),
    }


def cross_defs(cfg) -> dict:
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {
        "wq": ParamDef((d, q), ("fsdp", "q_dim")),
        "wk": ParamDef((d, kv), ("fsdp", "kv_dim")),
        "wv": ParamDef((d, kv), ("fsdp", "kv_dim")),
        "wo": ParamDef((q, d), ("q_dim", "fsdp")),
        "gate": ParamDef((), (), init="zeros"),
    }


def block_defs(cfg, kind: str) -> dict:
    """kind: dense | moe | ssm | hybrid | cross | encoder | dec_cross |
    interleaved (the leaves every layer of an interleaved stack has: its
    norms and MLP; its mixer is stacked with those of its kind)."""
    def norm():
        return ParamDef((cfg.d_model,), ("d_model",), init="ones")
    if kind == "interleaved":
        return {"norm1": norm(), "norm2": norm(), "mlp": mlp_defs(cfg)}
    if kind == "ssm":
        return {"norm": norm(), "ssm": ssm_defs(cfg)}
    if kind == "cross":
        return {"norm1": norm(), "cross": cross_defs(cfg),
                "norm2": norm(), "mlp": mlp_defs(cfg)}
    if kind == "encoder":
        return {"norm1": norm(), "attn": attn_defs(cfg),
                "norm2": norm(), "mlp": mlp_defs(cfg, gelu=True)}
    if kind == "dec_cross":   # whisper decoder layer: self + cross + mlp
        return {"norm1": norm(), "attn": attn_defs(cfg),
                "norm2": norm(), "cross": cross_defs(cfg),
                "norm3": norm(), "mlp": mlp_defs(cfg, gelu=True)}
    out = {"norm1": norm(), "attn": attn_defs(cfg), "norm2": norm()}
    if kind == "moe":
        out["moe"] = moe_defs(cfg)
    elif kind == "hybrid":
        out["ssm"] = ssm_defs(cfg)
        out["mlp"] = mlp_defs(cfg)
        out["mix"] = ParamDef((2,), (None,), init="ones")
    elif kind == "dense":
        out["mlp"] = mlp_defs(cfg)
    else:
        raise ValueError(kind)
    return out


# ----------------------------------------------------------------------
# apply
# ----------------------------------------------------------------------
def _gelu_mlp(h: torch.Tensor, p: dict, cfg, tp) -> torch.Tensor:
    return gelu_mlp(h, p["w_in"], p["b_in"], p["w_out"], p["b_out"], tp,
                    cfg.d_ff)


def _swiglu(h: torch.Tensor, p: dict, cfg, tp) -> torch.Tensor:
    return swiglu(h, p["w_gate"], p["w_up"], p["w_down"], tp, cfg.d_ff)


def _residual(x: torch.Tensor, y: torch.Tensor):
    """The residual sum x + y, rounded to x's dtype for the stream, and
    unrounded in float32 for the norm that reads it.  The reference's
    XLA evaluates ``rms_norm(x + y)``'s ``convert(x + y, f32)`` as a
    float32 add, so its norms see the unrounded sum (under a bf16
    compute dtype; under float32 the two are one tensor)."""
    s32 = x.float() + y.float()
    return s32.to(x.dtype), s32


def _norm32(s32: torch.Tensor, w: torch.Tensor, cfg, dtype) -> torch.Tensor:
    return rms_norm(s32, w, cfg.norm_eps).to(dtype)


def hybrid_mixer(p: dict, h: torch.Tensor, cfg, *, positions: torch.Tensor,
                 cache: Optional[attn_mod.KVCache] = None,
                 ssm_state: Optional[ssm_mod.SSMState] = None,
                 causal: bool = True, tp: TPShard = NO_TP):
    """Hymba's token mixer on the normed ``h``: the sliding-window
    attention and the SSM branch, each split by ``tp`` and joined (its
    own ``region_out`` or row gather), mixed in float32 by
    ``softmax(mix)`` and rounded to ``h``'s dtype.  Returns (y,
    new_cache, new_ssm_state)."""
    y, new_cache = attn_mod.attention_apply(
        p["attn"], h, cfg=cfg, positions=positions, cache=cache,
        causal=causal, window=cfg.sliding_window, tp=tp)
    ys, new_state = ssm_mod.ssm_apply(p["ssm"], h, cfg, ssm_state, tp)
    mix = torch.softmax(p["mix"].float(), dim=-1)
    return (mix[0] * y.float() + mix[1] * ys.float()).to(h.dtype), \
        new_cache, new_state


def apply_block(
    p: dict,
    x: torch.Tensor,
    cfg,
    kind: str,
    *,
    positions: torch.Tensor,
    cache: Optional[attn_mod.KVCache] = None,
    ssm_state: Optional[ssm_mod.SSMState] = None,
    enc: Optional[torch.Tensor] = None,
    causal: bool = True,
    want_aux: bool = False,
    moe_shard=None,
    tp: TPShard = NO_TP,
):
    """Returns (x_out, new_cache, new_ssm_state, aux_loss); aux_loss is
    the MoE router's load-balancing loss where ``want_aux`` (a training
    loss reads it; serving does not), else the float 0.0 (no launch).
    ``moe_shard``: the sharded step's ``moe.MoEShard`` (the MoE block's
    expert parallelism), or None.  ``tp``: the tensor-parallel split
    over ``model`` of every sublayer whose dim divides it: the
    self-attention (by heads or query rows; with a cache, by the
    cache's slots), the cross-attention (by heads or decoder rows), the
    SSM (by heads, hymba's branch too) and the MLPs (over ``d_ff``).
    The norms, the residual stream and the MoE router (replicated in
    the reference too) are computed whole on every rank."""
    new_cache, new_state = None, None
    zero = 0.0
    dtype = x.dtype
    if kind == "ssm":
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        y, new_state = ssm_mod.ssm_apply(p["ssm"], h, cfg, ssm_state, tp)
        return x + y, None, new_state, zero

    if kind == "cross":
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        y = attn_mod.cross_attention_apply(p["cross"], h, enc, cfg=cfg,
                                           tp=tp)
        x, s32 = _residual(x, torch.tanh(p["cross"]["gate"]) * y)
        h = _norm32(s32, p["norm2"], cfg, dtype)
        return x + _swiglu(h, p["mlp"], cfg, tp), None, None, zero

    if kind == "encoder":
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        with span("layer.attention"):
            y, _ = attn_mod.attention_apply(
                p["attn"], h, cfg=cfg, positions=positions, causal=False,
                use_rope=False, tp=tp)
        x, s32 = _residual(x, y)
        h = _norm32(s32, p["norm2"], cfg, dtype)
        return x + _gelu_mlp(h, p["mlp"], cfg, tp), None, None, zero

    if kind == "dec_cross":
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        with span("layer.attention"):
            y, new_cache = attn_mod.attention_apply(
                p["attn"], h, cfg=cfg, positions=positions, cache=cache,
                causal=causal, use_rope=False, tp=tp)
        x, s32 = _residual(x, y)
        h = _norm32(s32, p["norm2"], cfg, dtype)
        x, s32 = _residual(
            x, attn_mod.cross_attention_apply(p["cross"], h, enc, cfg=cfg,
                                              tp=tp))
        h = _norm32(s32, p["norm3"], cfg, dtype)
        return x + _gelu_mlp(h, p["mlp"], cfg, tp), new_cache, None, zero

    # dense / moe / hybrid share the attention sublayer
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    with span("layer.attention"):
        if kind == "hybrid":
            y, new_cache, new_state = hybrid_mixer(
                p, h, cfg, positions=positions, cache=cache,
                ssm_state=ssm_state, causal=causal, tp=tp)
        else:
            y, new_cache = attn_mod.attention_apply(
                p["attn"], h, cfg=cfg, positions=positions, cache=cache,
                causal=causal, tp=tp)
    x, s32 = _residual(x, y)
    x = shard_constraint(x, "batch", "seq", "d_model")
    h = _norm32(s32, p["norm2"], cfg, dtype)
    aux = zero
    if kind == "moe":
        x = x + moe_mod.moe_apply(p["moe"], h, cfg, moe_shard)
        if want_aux:
            aux = moe_mod.moe_aux_loss(p["moe"], h, cfg, moe_shard)
    else:
        x = x + _swiglu(h, p["mlp"], cfg, tp)
    return x, new_cache, new_state, aux


def apply_interleaved(
    p: dict,
    x: torch.Tensor,
    cfg,
    *,
    positions: torch.Tensor,
    cache: Optional[attn_mod.KVCache] = None,
    ssm_state: Optional[ssm_mod.SSMState] = None,
):
    """One layer of an interleaved stack (``config.InterleavedConfig``):
    ``x + r * mixer(rms(x))``, then ``x + r * mlp(rms(x))``, r the
    residual multiplier, each branch scaled and summed in float32 (the
    norm reads the unrounded sum, as ``_residual``).  ``p`` holds the
    layer's norms and MLP and its mixer: ``attn`` (self-attention at the
    configuration's score scale, rotary positions where ``use_rope``;
    ``layer.attention`` span) or ``mamba`` (``ssm.mamba2_apply``;
    ``layer.ssm`` span).  Returns (x_out, new_cache, new_ssm_state)."""
    r = cfg.residual_multiplier
    new_cache, new_state = None, None
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if "attn" in p:
        with span("layer.attention"):
            y, new_cache = attn_mod.attention_apply(
                p["attn"], h, cfg=cfg, positions=positions, cache=cache,
                use_rope=cfg.use_rope, scale=cfg.score_scale)
    else:
        with span("layer.ssm"):
            y, new_state = ssm_mod.mamba2_apply(p["mamba"], h, cfg,
                                                ssm_state)
    x, s32 = _residual(x, y.float() * r)
    h = _norm32(s32, p["norm2"], cfg, x.dtype)
    x, _ = _residual(x, _swiglu(h, p["mlp"], cfg, NO_TP).float() * r)
    return x, new_cache, new_state
