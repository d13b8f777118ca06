"""Input shape cells + abstract input specs for the dry-run.

Every (architecture x shape) cell maps here to a step kind and its
inputs as ``meta`` tensors (shape and dtype, no storage: the full
configs are only ever exercised abstractly; tests use the smoke
configs).  Token ids are int64, as the training driver feeds them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def cell_is_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """The skip policy: a 500k decode cell only for the sub-quadratic
    archs."""
    cell = SHAPES[shape]
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention decode state would be a 500k KV "
                       "cache; sub-quadratic archs only (DESIGN.md Sec 6)")
    return True, ""


def enc_input_spec(cfg: ModelConfig, batch: int,
                   dtype) -> Optional[torch.Tensor]:
    if cfg.is_encdec:
        return _meta((batch, cfg.encoder_seq, cfg.d_model), dtype)
    if cfg.family == "vlm":
        return _meta((batch, cfg.vision_tokens, cfg.d_model), dtype)
    return None


def train_input_specs(cfg: ModelConfig, shape: str) -> Dict[str, torch.Tensor]:
    cell = SHAPES[shape]
    b, s = cell.global_batch, cell.seq_len
    specs = {
        "tokens": _meta((b, s), torch.int64),
        "labels": _meta((b, s), torch.int64),
        "mask": _meta((b, s), torch.float32),
    }
    enc = enc_input_spec(cfg, b, cfg.dtypes.compute_dtype)
    if enc is not None:
        specs["enc_inputs"] = enc
    return specs


def serve_token_spec(cfg: ModelConfig, shape: str) -> torch.Tensor:
    cell = SHAPES[shape]
    if cell.kind == "prefill":
        return _meta((cell.global_batch, cell.seq_len), torch.int64)
    return _meta((cell.global_batch, 1), torch.int64)


def effective_max_len(cfg: ModelConfig, shape: str) -> int:
    return SHAPES[shape].seq_len


def microbatches_for(cfg: ModelConfig, shape: str) -> int:
    """Gradient-accumulation depth for train cells: keeps live
    activations per microbatch bounded.  Wider models get smaller
    microbatches (live bytes ~ tokens_mb * d_model * c; holding
    tokens_mb * d_model ~ 2^26 keeps the per-device residual and
    attention temporaries under a few GB at 256-way sharding)."""
    if SHAPES[shape].kind != "train":
        return 1
    cell = SHAPES[shape]
    tokens = cell.global_batch * cell.seq_len
    if cfg.family == "moe" and cfg.n_experts >= 64:
        target = 1 << 14   # maverick: dispatch + expert-grad temps
    elif cfg.d_model >= 4096:
        target = 1 << 15
    elif cfg.d_model >= 2048:
        target = 1 << 16
    else:
        target = 1 << 17
    per_mb = max(1, tokens // target)
    mb = min(cell.global_batch, per_mb)
    # per-microbatch batch must stay >= 32 (pod x data = 2 x 16) or the
    # batch dim stops dividing the mesh and activations replicate
    mb = min(mb, max(1, cell.global_batch // 32))
    # choose a divisor of global_batch
    while cell.global_batch % mb:
        mb -= 1
    return max(1, mb)
