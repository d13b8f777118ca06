"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49152, head_dim=64,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16, max_seq_len=128)
