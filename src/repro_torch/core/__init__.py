"""Index, LSH and sampling: the paper's core, on torch.

  pv_dbow     - PV-DBOW embedding model + negative-sampling training
  lsh         - random-hyperplane signatures, packed Hamming similarity
  sampling    - pps / SRCS cluster sampling + Horvitz-Thompson estimators
  index       - the approximation index: vectors + LSH + corpus stats
  allocation  - spherical k-means document allocation
  queries/    - aggregation, Boolean/ranked retrieval, recommendation

``lsh`` is imported before ``index``, which reaches it through the
package.
"""
from repro_torch.core.lsh import LSHConfig, LSHIndex, pack_bits, hamming_similarity  # noqa: F401
from repro_torch.core.pv_dbow import PVDBOWConfig, PVDBOWModel, train_pv_dbow  # noqa: F401
from repro_torch.core.sampling import (  # noqa: F401
    SampleResult,
    pps_sample,
    pps_sample_distinct,
    srcs_sample,
    ht_estimate,
)
from repro_torch.core.index import ApproxIndex, build_index  # noqa: F401
