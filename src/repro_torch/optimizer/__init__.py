"""Optimizers: AdamW with dtype-policy moments, 8-bit blockwise state,
schedules, and global-norm clipping."""
from repro_torch.optimizer.adamw import (  # noqa: F401
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
)
from repro_torch.optimizer.schedules import cosine_warmup_schedule  # noqa: F401
from repro_torch.optimizer.quantized import (  # noqa: F401
    Q8State,
    q8_quantize,
    q8_dequantize,
)
