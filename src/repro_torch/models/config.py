"""Unified model configuration for the 10 LM architectures.

The same fields, defaults and properties as the JAX package's
``ModelConfig``; the dtype names map to ``torch`` dtypes.  ``remat``
is the training loss's activation-checkpoint policy
(``torch.utils.checkpoint`` around each layer body, see
``models/model.py``); ``scan_layers`` is a compile knob of the JAX
package, read and ignored (the port runs its layers in a Python loop);
``attn_impl`` is honoured.  ``InterleavedConfig`` is the port's own
subclass for a stack of layers of different kinds (Granite 4.0-H).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Per-tensor-class dtypes."""
    params: str = "float32"
    compute: str = "bfloat16"
    kv_cache: str = "bfloat16"
    # optimizer second/first moments (used by training)
    opt_state: str = "float32"

    @property
    def params_dtype(self) -> torch.dtype:
        return _DTYPES[self.params]

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute]

    @property
    def kv_cache_dtype(self) -> torch.dtype:
        return _DTYPES[self.kv_cache]

    @property
    def opt_state_dtype(self) -> torch.dtype:
        return _DTYPES[self.opt_state]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                  # query heads (0 for pure ssm)
    n_kv_heads: int               # GQA kv heads
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False        # qwen2.5 uses bias on QKV
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    # 1 = every layer is MoE; 2 = alternating dense/MoE (maverick)
    moe_every: int = 1

    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2           # d_inner = expand * d_model
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_dim: int = 4

    # --- hybrid (Hymba): per-layer parallel attn + ssm heads ---
    sliding_window: int = 0       # 0 = full attention

    # --- enc-dec (Whisper backbone) ---
    encoder_layers: int = 0       # >0 means enc-dec; frontend is a stub
    encoder_seq: int = 1500       # whisper 30s @ 50Hz after conv stub

    # --- VLM (Llama-3.2-vision backbone) ---
    cross_attn_every: int = 0     # insert a cross-attn layer every N layers
    vision_tokens: int = 1601     # stub patch-embedding count (1 tile)

    # --- training / serving behavior ---
    max_seq_len: int = 8192
    dtypes: DTypePolicy = dataclasses.field(default_factory=DTypePolicy)
    # activation checkpointing of the training loss: none | full |
    # selective (save the weight matmuls); scan_layers is read and
    # ignored (see the module docstring)
    remat: str = "selective"
    scan_layers: bool = True
    # attention implementation: "dense" (materialized scores) or
    # "chunked" (flash-style lazy softmax over KV chunks)
    attn_impl: str = "dense"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """True if decode state is O(1)-ish in sequence length: SSM and
        sliding-window hybrids."""
        return self.family == "ssm" or (
            self.family == "hybrid" and self.sliding_window > 0)

    def param_count_estimate(self) -> int:
        """Analytic parameter count (memory napkin math; the exact count
        comes from the parameter tree)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "audio", "vlm", "hybrid"):
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            per_layer += attn
        if self.family == "moe":
            moe_frac = 1.0 / self.moe_every
            per_layer += moe_frac * self.n_experts * 3 * d * ff
            per_layer += (1 - moe_frac) * 3 * d * ff
        elif self.family in ("dense", "audio", "vlm"):
            per_layer += 3 * d * ff
        elif self.family == "hybrid":
            per_layer += 3 * d * ff
        if self.family in ("ssm", "hybrid"):
            di = self.d_inner
            per_layer += d * 2 * di + di * d + di * self.ssm_state * 2 // max(self.ssm_heads, 1)
        total = emb + self.n_layers * per_layer
        if self.is_encdec:
            total += self.encoder_layers * (4 * d * d + 3 * d * ff)
        if self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (4 * d * d)
        return int(total)

    def active_param_count_estimate(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.param_count_estimate()
        d, ff = self.d_model, self.d_ff
        total = self.param_count_estimate()
        n_moe_layers = self.n_layers // self.moe_every
        moe_all = n_moe_layers * self.n_experts * 3 * d * ff
        moe_active = n_moe_layers * self.top_k * 3 * d * ff
        return int(total - moe_all + moe_active)


LAYER_TYPES = ("mamba", "attention")


@dataclasses.dataclass(frozen=True)
class InterleavedConfig(ModelConfig):
    """A stack whose layers differ in their token mixer, one kind a
    layer, each followed by the SwiGLU MLP (IBM's Granite 4.0-H, the
    ``granitemoehybrid`` modeling code with no experts).  The port's
    own family, ``interleaved``: the JAX package has no such model, and
    ``ModelConfig`` gains no field for it.

    ``layer_types``: "mamba" (the published Mamba2 mixer:
    ``models/ssm.mamba2_apply``) or "attention" (GQA self-attention, its
    scores times ``attn_scale``, rotary positions only where
    ``use_rope``), one a layer.  The token embeddings are multiplied by
    ``embedding_multiplier``, each sublayer's output by
    ``residual_multiplier`` before the residual sum, and the logits
    divided by ``logits_scaling``.  ``ssm_groups`` is the mixer's number
    of B / C groups (the scan takes one)."""
    layer_types: Tuple[str, ...] = ()
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attn_scale: float = 0.0          # 0: 1 / sqrt(head_dim)
    use_rope: bool = True
    ssm_groups: int = 1

    def __post_init__(self):
        if self.family != "interleaved":
            raise ValueError(f"{self.name}: an InterleavedConfig's family "
                             f"is 'interleaved', got {self.family!r}")
        if len(self.layer_types) != self.n_layers or \
                set(self.layer_types) - set(LAYER_TYPES):
            raise ValueError(f"{self.name}: layer_types must name one of "
                             f"{LAYER_TYPES} for each of the {self.n_layers} "
                             f"layers, got {self.layer_types}")
        if self.ssm_groups != 1:
            raise ValueError(f"{self.name}: the SSD scan takes one B / C "
                             f"group, got ssm_groups={self.ssm_groups}")

    def count(self, kind: str) -> int:
        """The number of layers of ``kind``."""
        return self.layer_types.count(kind)

    @property
    def conv_width(self) -> int:
        """The Mamba2 mixer's convolved channels: x, B and C."""
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def score_scale(self) -> Optional[float]:
        """The attention's score scale, None for 1 / sqrt(head_dim)."""
        return self.attn_scale or None

    def param_count_estimate(self) -> int:
        """Exact: the embedding (the head tied or not), the norms and
        MLP of every layer, and each kind's mixers."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2) + d
        per_layer = 2 * d + 3 * d * self.d_ff
        attn = 2 * d * self.q_dim + 2 * d * self.kv_dim
        di, h, w = self.d_inner, self.ssm_heads, self.conv_width
        mamba = (d * (di + w + h) + (self.conv_dim + 1) * w + 3 * h + di
                 + di * d)
        return int(emb + self.n_layers * per_layer
                   + self.count("attention") * attn
                   + self.count("mamba") * mamba)
