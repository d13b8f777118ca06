"""Plain PyTorch version of the k-means assignment kernel: the same
function as ``csrc/kmeans.cu`` written as ordinary tensor ops (the JAX
package's ``kernels/kmeans/ref.py``).  CPU tensors take it;
``chip_smoke.py`` holds the kernel against it on the card.

The [N, K] score matrix is formed ``ROW_BYTES`` bytes of it at a time,
in row chunks: at the allocation shape (2^20 documents, 39983 shards)
it would be 168 GB whole.  A row's scores, max and argmax depend on its
own row alone, so chunking changes no row's result."""
from __future__ import annotations

import torch

# bytes of [rows, K] float32 scores formed at once
ROW_BYTES = 1 << 30


def chunk_rows(k: int) -> int:
    """Rows of x scored at once against K centroids."""
    return max(1, ROW_BYTES // (4 * max(k, 1)))


def assign_ref(x: torch.Tensor, c: torch.Tensor):
    """x [N, dim], c [K, dim] float32 -> (assignment int32 [N], best
    score float32 [N]): each row's first maximal x . c[k] and its
    value."""
    ids, vals = [], []
    step = chunk_rows(c.shape[0])
    for lo in range(0, x.shape[0], step):
        scores = x[lo:lo + step] @ c.T
        ids.append(torch.argmax(scores, dim=1).to(torch.int32))
        vals.append(torch.amax(scores, dim=1))
    if not ids:
        return (torch.zeros(0, dtype=torch.int32, device=x.device),
                torch.zeros(0, dtype=torch.float32, device=x.device))
    return torch.cat(ids), torch.cat(vals).to(torch.float32)
