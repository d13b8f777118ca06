"""whisper-small [audio]: 12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865 — enc-dec, conv frontend (stub) [arXiv:2212.04356].
The 12L spec maps to whisper-small's 12 encoder + 12 decoder layers;
the modality frontend is a stub per the assignment (input_specs
provides precomputed frame embeddings [B, 1500, d_model])."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    encoder_layers=12, encoder_seq=1500, max_seq_len=32768 + 8,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
        encoder_seq=32, max_seq_len=128)
