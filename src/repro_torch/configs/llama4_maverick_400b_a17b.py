"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1
[hf:meta-llama/Llama-4-Scout-17B-16E].  Fitting 512x16GB requires
FSDP + EP + bf16 optimizer moments (DTypePolicy)."""
import dataclasses
from repro_torch.models.config import ModelConfig, DTypePolicy

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    n_experts=128, top_k=1, capacity_factor=1.25, moe_every=2,
    remat="full",
    dtypes=DTypePolicy(params="float32", compute="bfloat16",
                       kv_cache="bfloat16", opt_state="bfloat16"),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16, n_experts=8,
        max_seq_len=128)
