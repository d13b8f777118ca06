"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256 — cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision].  Vision frontend is a stub:
input_specs provides precomputed patch embeddings [B, 1601, d_model]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    cross_attn_every=5, vision_tokens=1601,
    remat="full",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16, cross_attn_every=2,
        vision_tokens=16, max_seq_len=128)
