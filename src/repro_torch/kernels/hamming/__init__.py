"""Packed-signature Hamming scoring (sym mode): distance, similarity
and segment sum."""
from repro_torch.kernels.hamming.ops import (  # noqa: F401
    hamming_distance,
    hamming_segment_similarity,
    hamming_segment_similarity_csr,
    hamming_similarity,
)
