"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads
[arXiv:2411.13676].  Sliding-window attention (1024) in every layer +
parallel SSM heads is what bounds the decode state for long_500k."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    sliding_window=1024,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16, ssm_state=8,
        ssm_head_dim=16, ssm_chunk=32, sliding_window=32, max_seq_len=128)
