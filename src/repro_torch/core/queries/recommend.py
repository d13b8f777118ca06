"""Recommendation queries: approximate user-centric collaborative
filtering (paper Sec. IV-C, VII-D).

Setup (matches the paper): a "document" is the concatenation of all
reviews by one user, so PV-DBOW doc vectors are *user* vectors encoding
preference.  For a target user u:

  1. sample shards of users with probability proportional to
     exp(u . s)   (Eq 10 with the user vector as the query),
  2. neighbors = users in the sampled shards,
  3. predicted rating r(u, i) = sum_v sim(u,v) r(v,i) / sum_v sim(u,v)
     over neighbors v who rated i, with sim(u,v) = exp(u . v)
     (the paper's softmax-weighted average),
  4. rank unpurchased items by predicted rating for the top-k list.
"""
from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core.index import ApproxIndex
from repro_torch.core.sampling import (
    SampleResult,
    pps_sample,
    similarity_probabilities,
    srcs_sample,
    unique_shards,
)
from repro_torch.data.corpus import ReviewData
from repro_torch.data.store import ShardedCorpus


class RecommendResult(NamedTuple):
    predictions: Dict[int, float]   # item_id -> predicted rating
    top_k: np.ndarray               # item ids, best first
    sample: SampleResult
    shards_read: int
    n_shards: int
    elapsed_s: float

    @property
    def data_fraction(self) -> float:
        return self.shards_read / self.n_shards


def recommend_query(
    corpus: ShardedCorpus,          # shards of user-documents
    index: Optional[ApproxIndex],
    reviews: ReviewData,
    target_user: int,
    rate: float,
    k: int = 10,
    *,
    method: str = "emapprox",
    rng: Optional[np.random.Generator] = None,
    target_vector: Optional[np.ndarray] = None,
    exclude_items: Optional[Sequence[int]] = None,
    candidate_items: Optional[Sequence[int]] = None,
) -> RecommendResult:
    """Predict ratings for ``target_user`` from a sampled neighborhood.

    ``target_vector`` overrides the index's stored user vector (used when
    the target user was held out / is new — paper Sec. V inference)."""
    rng = rng or np.random.default_rng(0)
    t0 = time.perf_counter()

    if target_vector is None:
        if index is None or index.doc_vecs is None:
            raise ValueError("need a target_vector or an index with doc vectors")
        target_vector = index.doc_vecs[target_user]

    if rate >= 1.0:
        distinct = np.arange(corpus.n_shards)
        sample = SampleResult(distinct.astype(np.int64),
                              np.full(corpus.n_shards, 1.0 / corpus.n_shards), 1.0)
    elif method == "emapprox":
        sims = index.vector_shard_similarities(target_vector)
        sample = pps_sample(similarity_probabilities(sims), rate, rng)
        distinct = unique_shards(sample)
    elif method == "srcs":
        sample = srcs_sample(corpus.n_shards, rate, rng)
        distinct = unique_shards(sample)
    else:
        raise ValueError(f"unknown method {method!r}")

    # neighbor set = users co-located in sampled shards (minus target)
    neighbor_ids = np.concatenate(
        [corpus.shards[int(s)].doc_ids for s in distinct]
    ) if len(distinct) else np.zeros(0, np.int64)
    neighbor_ids = neighbor_ids[neighbor_ids != target_user]

    # similarity weights sim(u, v) = exp(u . v) over neighbor user vectors
    if index is not None and index.doc_vecs is not None:
        nvecs = index.doc_vecs[neighbor_ids].astype(np.float64)
        u = np.asarray(target_vector, np.float64)
        u = u / max(np.linalg.norm(u), 1e-9)
        sims = np.exp(nvecs @ u)
    else:
        sims = np.ones(len(neighbor_ids), np.float64)
    sim_of = dict(zip(neighbor_ids.tolist(), sims.tolist()))

    # gather neighbor ratings per item (single pass over interactions)
    neighbor_mask = np.isin(reviews.user_of, neighbor_ids)
    u_of = reviews.user_of[neighbor_mask]
    i_of = reviews.item_of[neighbor_mask]
    r_of = reviews.ratings[neighbor_mask]

    num: Dict[int, float] = {}
    den: Dict[int, float] = {}
    for v, i, r in zip(u_of.tolist(), i_of.tolist(), r_of.tolist()):
        w = sim_of[v]
        num[i] = num.get(i, 0.0) + w * r
        den[i] = den.get(i, 0.0) + w
    predictions = {i: num[i] / den[i] for i in num if den[i] > 0}

    exclude = (set(int(x) for x in exclude_items)
               if exclude_items is not None else set())
    if candidate_items is not None:
        cand = [i for i in candidate_items if i in predictions and i not in exclude]
    else:
        cand = [i for i in predictions if i not in exclude]
    cand.sort(key=lambda i: -predictions[i])
    top_k = np.asarray(cand[:k], np.int64)
    return RecommendResult(predictions, top_k, sample, len(distinct),
                           corpus.n_shards, time.perf_counter() - t0)


def mse(predictions: Dict[int, float], truth_items: np.ndarray,
        truth_ratings: np.ndarray) -> float:
    """MSE over held-out (item, rating) pairs that received a prediction;
    items with no neighbor rating fall back to the global midpoint 3.0
    (so missing coverage is penalized, not silently dropped)."""
    errs = []
    for i, r in zip(truth_items.tolist(), truth_ratings.tolist()):
        pred = predictions.get(int(i), 3.0)
        errs.append((pred - r) ** 2)
    return float(np.mean(errs)) if errs else float("nan")


def precision_at_k(top_k: np.ndarray, purchased: np.ndarray, k: int = 10) -> float:
    if len(top_k) == 0:
        return 0.0
    return float(np.isin(top_k[:k], purchased).mean())
