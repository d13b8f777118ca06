"""Granite 4.0-H Micro as the benchmark runs it: the sizes of
``granite-4.0-h-micro.json`` (the published keys at its top level, with
the sizes it assumes), the port's configuration built from them, the
weights the benchmark makes (names as ``bench/reference/granite_4_0_h_micro``
reads them, and where each sits in the port's parameter tree: what every
layer has under ``layers``, each kind's mixers stacked apart under
``attn`` and ``mamba``), the state prefill leaves, and the model flops
that ``mfu`` counts.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

NAME = "granite-4.0-h-micro"
SPEC = json.loads(Path(__file__).with_name(NAME + ".json").read_text())

_ATTN = ("wq", "wk", "wv", "wo")
_MAMBA = ("in_proj", "conv_w", "conv_b", "dt_bias", "a_log", "d_skip",
          "norm", "out_proj")
# neutral weight name -> path in the port's stacked parameter tree
PORT_PATHS = {
    "embed": ("tok_emb",), "final_norm": ("final_norm",),
    "layers.norm1": ("layers", "norm1"),
    "layers.norm2": ("layers", "norm2"),
    "layers.w_gate": ("layers", "mlp", "w_gate"),
    "layers.w_up": ("layers", "mlp", "w_up"),
    "layers.w_down": ("layers", "mlp", "w_down"),
    **{f"attn.{w}": ("attn", w) for w in _ATTN},
    **{f"mamba.{w}": ("mamba", w) for w in _MAMBA},
}
# the prefill state's parts, by the check's number that reads them
STATE_CHECKS = {"kv_err": ("k", "v"), "ssm_err": ("ssm", "conv")}


# the file's own keys; every other top-level key is the published config's
_OWN = ("name", "source", "assumed_sizes", "reduced", "port", "smoke",
        "dtypes", "init", "assumed", "departures")


def sizes(smoke: bool = False) -> dict:
    if smoke:
        return SPEC["smoke"]["sizes"]
    published = {k: v for k, v in SPEC.items() if k not in _OWN}
    return {**published, **SPEC["assumed_sizes"]}


def token_vocab(s: dict) -> int:
    """Token ids are drawn below this."""
    return s["vocab_size"]


def port_config(smoke: bool = False):
    """The port's ``InterleavedConfig``, checked against the sizes."""
    from repro_torch.configs import get_config
    cfg = get_config(SPEC["port"]["arch"], smoke=smoke)
    s = sizes(smoke)
    want = {"n_layers": s["num_hidden_layers"], "d_model": s["hidden_size"],
            "n_heads": s["num_attention_heads"],
            "n_kv_heads": s["num_key_value_heads"], "head_dim": s["head_dim"],
            "d_ff": s["shared_intermediate_size"],
            "vocab_size": s["vocab_size"], "norm_eps": s["rms_norm_eps"],
            "tie_embeddings": s["tie_word_embeddings"],
            "layer_types": tuple(s["layer_types"]),
            "embedding_multiplier": s["embedding_multiplier"],
            "residual_multiplier": s["residual_multiplier"],
            "logits_scaling": s["logits_scaling"],
            "attn_scale": s["attention_multiplier"],
            "use_rope": s["position_embedding_type"] == "rope",
            "ssm_state": s["mamba_d_state"],
            "ssm_head_dim": s["mamba_d_head"],
            "ssm_heads": s["mamba_n_heads"],
            "d_inner": s["mamba_expand"] * s["hidden_size"],
            "ssm_chunk": s["mamba_chunk_size"], "conv_dim": s["mamba_d_conv"],
            "ssm_groups": s["mamba_n_groups"], "family": "interleaved",
            "qkv_bias": s["attention_bias"]}
    got = {k: getattr(cfg, k) for k in want}
    if got != want or not s["mamba_conv_bias"] or s["mamba_proj_bias"] \
            or s["num_local_experts"]:
        raise ValueError(f"the port's {NAME} is not the configuration: "
                         f"{got} != {want}")
    return cfg


def _counts(s: dict):
    kinds = s["layer_types"]
    return kinds.count("attention"), kinds.count("mamba")


def leaves(s: dict) -> list:
    L, d, v = s["num_hidden_layers"], s["hidden_size"], s["vocab_size"]
    la, lm = _counts(s)
    q = s["num_attention_heads"] * s["head_dim"]
    kv = s["num_key_value_heads"] * s["head_dim"]
    ff = s["shared_intermediate_size"]
    di = s["mamba_expand"] * d
    h, k = s["mamba_n_heads"], s["mamba_d_conv"]
    cw = di + 2 * s["mamba_n_groups"] * s["mamba_d_state"]
    std = ("normal", s["initializer_range"])
    one = ("const", 1.0)
    return [("embed", (v, d), std), ("final_norm", (d,), one),
            ("layers.norm1", (L, d), one), ("layers.norm2", (L, d), one),
            ("layers.w_gate", (L, d, ff), std),
            ("layers.w_up", (L, d, ff), std),
            ("layers.w_down", (L, ff, d), std),
            ("attn.wq", (la, d, q), std), ("attn.wk", (la, d, kv), std),
            ("attn.wv", (la, d, kv), std), ("attn.wo", (la, q, d), std),
            ("mamba.in_proj", (lm, d, di + cw + h), std),
            ("mamba.conv_w", (lm, k, cw), std),
            ("mamba.conv_b", (lm, cw), std),
            ("mamba.dt_bias", (lm, h),
             ("uniform", math.log(1e-3), math.log(1e-1))),
            ("mamba.a_log", (lm, h), ("uniform", 0.0, math.log(64.0))),
            ("mamba.d_skip", (lm, h), one), ("mamba.norm", (lm, di), one),
            ("mamba.out_proj", (lm, di, d), std)]


def port_state(state, row: int) -> dict:
    """One prompt's part of the port's ``DecodeState``, as the
    reference's prefill names it: the attention layers' keys and values
    [La, S, KH, hd], the Mamba2 layers' SSD state [Lm, H, P, N] and conv
    tail [Lm, k - 1, cw]."""
    return {"k": state.kv[0][:, row], "v": state.kv[1][:, row],
            "ssm": state.ssm[0][:, row], "conv": state.ssm[1][:, row]}


def _matmul_weights(s: dict):
    """(weights a token reads in the layers' matrix products, in the
    head's)."""
    d = s["hidden_size"]
    la, lm = _counts(s)
    q = s["num_attention_heads"] * s["head_dim"]
    kv = s["num_key_value_heads"] * s["head_dim"]
    di = s["mamba_expand"] * d
    cw = di + 2 * s["mamba_n_groups"] * s["mamba_d_state"]
    mlp = s["num_hidden_layers"] * 3 * d * s["shared_intermediate_size"]
    attn = la * (2 * d * q + 2 * d * kv)
    mamba = lm * (d * (di + cw + s["mamba_n_heads"]) + di * d)
    return mlp + attn + mamba, d * s["vocab_size"]


def prefill_flops(s: dict, length: int) -> float:
    """One prompt's forward, from the shapes alone:

      * 2 N a token, N the weights of every matrix product of the
        layers (the MLPs, the attention projections, ``in_proj`` and
        ``out_proj``), and the head at the last position only (prefill
        returns the last logits): 2 d V;
      * causal self-attention in the 4 attention layers, 2 La (H hd) T^2
        (Q K^T and P V, 2 H hd T^2 each, halved by the mask);
      * each Mamba2 layer's scan in its recurrent form, 6 d_inner N a
        token: the state's decay (d_inner N), the update dt x B^T
        (2 d_inner N) and the read-out C h (2 d_inner N), rounded up by
        the D term, the conv and the gated norm.  The chunked form the
        port runs does more (the intra-chunk term is quadratic in the
        chunk), which the count leaves out, as it leaves out masked
        attention scores."""
    body, head = _matmul_weights(s)
    la, lm = _counts(s)
    q = s["num_attention_heads"] * s["head_dim"]
    di = s["mamba_expand"] * s["hidden_size"]
    return (2.0 * body * length + 2.0 * head
            + 2.0 * la * q * length * length
            + 6.0 * lm * di * s["mamba_d_state"] * length)
