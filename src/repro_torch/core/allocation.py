"""Document allocation via spherical k-means (paper Sec. IV-D), the
port of the JAX package's ``core/allocation.py``.

Clusters documents by the cosine of their PV-DBOW vectors so that
semantically similar documents land in the same shard, which skews the
shard-level p(w|s) the way retrieval-style queries need.

The assignment step (documents x centroids, then the row argmax) runs
through ``kernels/kmeans``: the hand-written CUDA kernel on a CUDA
device, its plain version on the CPU; the config has no ``use_kernel``
flag, the device picks the route.  The centroid update sums each
cluster's rows in a fixed order, with no float atomics (``_update``),
so two runs on the card give the same centroid bits, and the same bits
as the CPU route's sums.  The initial centroids are a random
choice of documents from a ``torch.Generator`` (the reference draws
them with threefry, which torch cannot reproduce); ``init_ids`` injects
them for parity.

``_rebalance`` is the reference's numpy, unchanged.  It forms the whole
[n, k] score matrix and its int64 argsort, so it fits only where n x k
does: at 2^20 documents and 39983 shards that would be 168 GB + 335 GB,
in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.kmeans import ops as kmeans_ops


@dataclasses.dataclass(frozen=True)
class KMeansConfig:
    n_clusters: int
    iters: int = 25
    seed: int = 3
    balanced: bool = True   # cap cluster sizes so shards stay rectangular-ish


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-8)


def cluster_sums(x: torch.Tensor, assign: torch.Tensor, k: int
                 ) -> "tuple[torch.Tensor, torch.Tensor]":
    """([k, dim] sums, [k] int64 counts) of each cluster's rows.  The rows
    are sorted stably by cluster and each cluster's rows are added one
    after another, in row order, from 0 (``torch.segment_reduce`` over
    the clusters' lengths): no float atomics, so the sums are the same
    bits on every run and on every device.  The counts are an integer
    ``bincount``, exact."""
    idx = assign.long()
    counts = torch.bincount(idx, minlength=k)
    rows = x[torch.argsort(idx, stable=True)]
    sums = torch.segment_reduce(rows, "sum", lengths=counts, axis=0,
                                unsafe=True)
    return sums, counts


def _update(x: torch.Tensor, assign: torch.Tensor, k: int) -> torch.Tensor:
    """New unit centroids: the mean of each cluster's rows
    (``cluster_sums``); a dead centroid (no rows) becomes the unit vector
    along (1, ..., 1), as in the reference."""
    sums, counts = cluster_sums(x, assign, k)
    counts = counts.to(x.dtype)
    alive = counts[:, None] > 0
    new_c = sums / torch.clamp(counts[:, None], min=1.0)
    return _unit(torch.where(alive, new_c, 0.0)
                 + torch.where(alive, 0.0, 1e-4))


def spherical_kmeans(
    doc_vecs,
    cfg: KMeansConfig,
    *,
    device: "torch.device | str | None" = None,
    init_ids=None,
    callback: Optional[Callable[[int], None]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (assignment [n_docs] int64, centroids [k, dim] float32),
    numpy, computed on ``device`` (CUDA unless named).  ``doc_vecs`` is
    an array or a tensor.  ``init_ids`` [k] (parity only) replaces the
    drawn initial centroid rows.  ``callback(i)`` is called after each
    assignment: i = 0 for the initial one, i = t after iteration t."""
    dev = resolve_device(device)
    x = _unit(torch.as_tensor(doc_vecs, dtype=torch.float32, device=dev))
    n = x.shape[0]
    k = cfg.n_clusters
    if init_ids is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        init_ids = torch.randperm(n, generator=gen, device=dev)[:k]
    centroids = x[torch.as_tensor(init_ids, device=dev).long()]

    assign = kmeans_ops.assign(x, centroids)
    if callback is not None:
        callback(0)
    for it in range(1, cfg.iters + 1):
        centroids = _update(x, assign, k)
        new_assign = kmeans_ops.assign(x, centroids)
        if callback is not None:
            callback(it)
        if torch.equal(new_assign, assign):
            assign = new_assign
            break
        assign = new_assign

    assign = assign.cpu().numpy().astype(np.int64)
    centroids = centroids.cpu().numpy().astype(np.float32)
    if cfg.balanced:
        assign = _rebalance(x.cpu().numpy(), centroids, assign, k)
    return assign, centroids


def _rebalance(x: np.ndarray, centroids: np.ndarray, assign: np.ndarray, k: int) -> np.ndarray:
    """Greedy capacity rebalancing: clusters above ceil(n/k)*slack spill
    their worst-fitting members to the nearest under-capacity cluster.
    Keeps shard sizes within ~25% of uniform so no shard becomes a
    straggler (runtime concern the paper's HDFS blocks got for free)."""
    n = x.shape[0]
    cap = int(np.ceil(n / k * 1.25))
    scores = x @ centroids.T
    order = np.argsort(-scores.max(axis=1))  # strongest members keep seats
    counts = np.zeros(k, np.int64)
    out = np.empty(n, np.int64)
    pref = np.argsort(-scores, axis=1)
    for i in order:
        for c in pref[i]:
            if counts[c] < cap:
                out[i] = c
                counts[c] += 1
                break
        else:  # all full (can't happen with slack>1, but be safe)
            c = int(np.argmin(counts))
            out[i] = c
            counts[c] += 1
    return out


def allocate_corpus(corpus, index_doc_vecs, n_shards: Optional[int] = None,
                    cfg: Optional[KMeansConfig] = None, *,
                    device: "torch.device | str | None" = None,
                    init_ids=None):
    """Cluster + reallocate, returning the new corpus.  Paper Sec. VII-A
    sets n_clusters = number of HDFS blocks; the default is the current
    shard count.  ``device`` and ``init_ids`` go to
    ``spherical_kmeans``."""
    n_shards = n_shards or corpus.n_shards
    cfg = cfg or KMeansConfig(n_clusters=n_shards)
    if cfg.n_clusters != n_shards:
        cfg = dataclasses.replace(cfg, n_clusters=n_shards)
    assign, _ = spherical_kmeans(index_doc_vecs, cfg, device=device,
                                 init_ids=init_ids)
    return corpus.reallocate(assign, n_shards)
