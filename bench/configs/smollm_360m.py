"""SmolLM-360M as the benchmark runs it: the sizes of
``smollm-360m.json``, the port's configuration built from them, the
weights the benchmark makes (names as ``bench/reference/smollm_360m``
reads them, and where each sits in the port's parameter tree), the
state prefill leaves, and the model flops that ``mfu`` counts.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

NAME = "smollm-360m"
SPEC = json.loads(Path(__file__).with_name(NAME + ".json").read_text())

# neutral weight name -> path in the port's stacked parameter tree
PORT_PATHS = {
    "embed": ("tok_emb",), "final_norm": ("final_norm",),
    "layers.norm1": ("layers", "norm1"),
    "layers.norm2": ("layers", "norm2"),
    **{f"layers.{w}": ("layers", "attn", w) for w in ("wq", "wk", "wv", "wo")},
    "layers.w_gate": ("layers", "mlp", "w_gate"),
    "layers.w_up": ("layers", "mlp", "w_up"),
    "layers.w_down": ("layers", "mlp", "w_down"),
}
# the prefill state's parts, by the check's number that reads them
STATE_CHECKS = {"kv_err": ("k", "v")}


def sizes(smoke: bool = False) -> dict:
    return SPEC["smoke"]["sizes"] if smoke else SPEC["published"]


def token_vocab(s: dict) -> int:
    """Token ids are drawn below this."""
    return s["vocab_size"]


def port_config(smoke: bool = False):
    """The port's ``ModelConfig``, checked against the sizes."""
    from repro_torch.configs import get_config
    cfg = get_config(SPEC["port"]["arch"], smoke=smoke)
    rep = SPEC["smoke"]["port_replace"] if smoke else SPEC["port"]["replace"]
    cfg = dataclasses.replace(cfg, **rep)
    s = sizes(smoke)
    want = {"n_layers": s["num_hidden_layers"], "d_model": s["hidden_size"],
            "n_heads": s["num_attention_heads"],
            "n_kv_heads": s["num_key_value_heads"], "head_dim": s["head_dim"],
            "d_ff": s["intermediate_size"], "vocab_size": s["vocab_size"],
            "norm_eps": s["rms_norm_eps"], "rope_theta": s["rope_theta"],
            "tie_embeddings": True, "family": "dense", "qkv_bias": False}
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise ValueError(f"the port's {NAME} is not the configuration: "
                         f"{got} != {want}")
    return cfg


def leaves(s: dict) -> list:
    L, d, v = s["num_hidden_layers"], s["hidden_size"], s["vocab_size"]
    q = s["num_attention_heads"] * s["head_dim"]
    kv = s["num_key_value_heads"] * s["head_dim"]
    ff = s["intermediate_size"]
    std = ("normal", s["initializer_range"])
    return [("embed", (v, d), std), ("final_norm", (d,), ("const", 1.0)),
            ("layers.norm1", (L, d), ("const", 1.0)),
            ("layers.norm2", (L, d), ("const", 1.0)),
            ("layers.wq", (L, d, q), std), ("layers.wk", (L, d, kv), std),
            ("layers.wv", (L, d, kv), std), ("layers.wo", (L, q, d), std),
            ("layers.w_gate", (L, d, ff), std),
            ("layers.w_up", (L, d, ff), std),
            ("layers.w_down", (L, ff, d), std)]


def port_state(state, row: int) -> dict:
    """One prompt's part of the port's ``DecodeState``, as the
    reference's prefill names it (each [L, S, KH, hd])."""
    return {"k": state.kv[0][:, row], "v": state.kv[1][:, row]}


def _matmul_weights(s: dict):
    """(weights a token reads in the layers' matrix products, in the
    head's)."""
    d, hd = s["hidden_size"], s["head_dim"]
    q, kv = s["num_attention_heads"] * hd, s["num_key_value_heads"] * hd
    per = 2 * d * q + 2 * d * kv + 3 * d * s["intermediate_size"]
    return s["num_hidden_layers"] * per, d * s["vocab_size"]


def train_flops_per_token(s: dict, seq: int) -> float:
    """PaLM's appendix B: 6 N (N the weights of every matrix product,
    the head's included, the embedding's gather not) plus causal
    attention, half of PaLM's 12 L H Q T: 6 L (H hd) T."""
    body, head = _matmul_weights(s)
    q = s["num_attention_heads"] * s["head_dim"]
    return 6.0 * (body + head) + 6.0 * s["num_hidden_layers"] * q * seq


def prefill_flops(s: dict, length: int) -> float:
    """One prompt's forward: 2 N a token with the head at the last
    position only (prefill returns the last logits), and causal
    attention, 2 L (H hd) T^2."""
    body, head = _matmul_weights(s)
    q = s["num_attention_heads"] * s["head_dim"]
    return (2.0 * body * length + 2.0 * head
            + 2.0 * s["num_hidden_layers"] * q * length * length)
