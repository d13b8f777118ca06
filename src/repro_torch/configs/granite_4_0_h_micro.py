"""granite-4.0-h-micro [interleaved]: 40L d_model=2048, 36 Mamba2 layers
(64 heads of 64, d_state 128, one B/C group, conv 4 with a bias) and 4
NoPE GQA attention layers (32H, kv=8, head 64, score scale 1/64) at
layers 5, 15, 25, 35; a SwiGLU MLP of 8192 in every layer; vocab=100352,
tied; embeddings x12, residual branches x0.22, logits /8
[hf:ibm-granite/granite-4.0-h-micro].  The port's own: the JAX package
has no such architecture."""
import dataclasses

from repro_torch.models.config import InterleavedConfig

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = InterleavedConfig(
    name="granite-4.0-h-micro", family="interleaved",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=100352, head_dim=64, norm_eps=1e-5,
    tie_embeddings=True, max_seq_len=131072,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    conv_dim=4, layer_types=_PERIOD * 4,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    logits_scaling=8.0, attn_scale=0.015625, use_rope=False,
)


def smoke_config() -> InterleavedConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=8, max_seq_len=128,
        layer_types=("mamba", "attention", "mamba"))
