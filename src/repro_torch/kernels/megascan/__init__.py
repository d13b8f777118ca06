"""One-launch scan over a shard group (see ``csrc/megascan.cu``).

``ops`` holds the payload builder, the wrappers and the executor-facing
``MegascanSpec``; ``kernel`` the CUDA launch wrappers; ``ref`` their
plain PyTorch versions.
"""
from repro_torch.kernels.megascan.ops import (  # noqa: F401
    MegascanPayload,
    MegascanSpec,
    build_payload,
    megascan_segment_sums,
    megascan_topk,
)
