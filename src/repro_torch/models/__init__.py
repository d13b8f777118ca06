"""Model zoo: the 10 LM architectures as one composable family, on
PyTorch.

All models share a single ModelConfig surface and the entry points
``init_params`` / ``model_from_arrays`` (parameters drawn from a
``torch.Generator``, or carried over from the JAX package),
``forward`` and ``prefill`` / ``decode_step`` (KV/SSM-cache serving),
and the training loss ``loss_fn`` over the stacked tree
(``init_stacked_params``, ``train_state_from_arrays``).

Families: dense transformer (GQA/RoPE/QKV-bias), MoE (top-k capacity
dispatch), SSM (Mamba2 SSD), hybrid (Hymba parallel attn+SSM), enc-dec
audio backbone (Whisper, stub frontend), VLM (Llama-3.2-vision backbone,
stub patch embeddings, interleaved cross-attention); and the port's
own interleaved stack (Granite 4.0-H: published Mamba2 layers between
NoPE GQA attention layers, ``config.InterleavedConfig``).
"""
from repro_torch.models.config import ModelConfig, DTypePolicy  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    init_params,
    init_stacked_params,
    forward_train,
    loss_fn,
    init_decode_state,
    prefill,
    decode_step,
)
