"""Aggregation queries: phrase-occurrence estimation with error bounds
(paper Sec. III, evaluated in Sec. VII-B).

Pipeline (paper Fig. 2 a1-a5):
  1. q = sum of query word vectors; phi_s = softmax over exp(q . s)
     (or uniform for SRCS).
  2. pps-sample ceil(rate * n_shards) shards with replacement.
  3. Count the phrase exactly inside each distinct sampled shard
     (the "Spark job" — here the shard executor, which can run local
     threads or shard_map over devices).
  4. Hansen-Hurwitz estimate + t-based error bound (Eq 1, 2).
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core.index import ApproxIndex
from repro_torch.core.sampling import (
    Estimate,
    SampleResult,
    ht_estimate,
    pps_sample,
    srcs_sample,
    unique_shards,
)
from repro_torch.data.store import ShardedCorpus, count_phrase_in_shard


class PhraseCountResult(NamedTuple):
    estimate: Estimate
    sample: SampleResult
    shards_read: int
    n_shards: int
    elapsed_s: float
    # planned-but-unreachable shards (every replica dead): the reduce
    # ran over the surviving sample with a widened CI (batch engine
    # with allow_partial executors; always 0 on the healthy path)
    lost_shards: int = 0

    @property
    def data_fraction(self) -> float:
        return self.shards_read / self.n_shards

    @property
    def achieved_rate(self) -> float:
        """The rate actually served (after budget planning and any
        degradation): the fraction of shards physically read."""
        return self.data_fraction


def phrase_count_query(
    corpus: ShardedCorpus,
    index: Optional[ApproxIndex],
    phrase: Sequence[int],
    rate: float,
    *,
    method: str = "emapprox",       # "emapprox" | "srcs"
    rng: Optional[np.random.Generator] = None,
    confidence: float = 0.95,
    executor=None,
) -> PhraseCountResult:
    rng = rng or np.random.default_rng(0)
    t0 = time.perf_counter()
    if rate >= 1.0:
        # precise execution: scan everything, zero error bound
        total = precise_phrase_count(corpus, phrase, executor=executor)
        sample = SampleResult(
            np.arange(corpus.n_shards, dtype=np.int64),
            np.full(corpus.n_shards, 1.0 / corpus.n_shards), 1.0)
        return PhraseCountResult(
            estimate=Estimate(float(total), 0.0, confidence,
                              corpus.n_shards),
            sample=sample, shards_read=corpus.n_shards,
            n_shards=corpus.n_shards,
            elapsed_s=time.perf_counter() - t0)
    if method == "emapprox":
        if index is None:
            raise ValueError("emapprox method requires an index")
        probs = index.shard_probabilities(phrase)
        sample = pps_sample(probs, rate, rng)
    elif method == "srcs":
        sample = srcs_sample(corpus.n_shards, rate, rng)
    else:
        raise ValueError(f"unknown method {method!r}")

    distinct = unique_shards(sample)
    if executor is not None:
        counts_by_shard = executor.map_shards(
            corpus, distinct, lambda shard: count_phrase_in_shard(shard, phrase)
        )
    else:
        counts_by_shard = {
            int(sid): count_phrase_in_shard(corpus.shards[int(sid)], phrase)
            for sid in distinct
        }
    local = np.asarray([counts_by_shard[int(s)] for s in sample.shard_ids], np.float64)
    est = ht_estimate(local, sample, confidence)
    return PhraseCountResult(
        estimate=est,
        sample=sample,
        shards_read=len(distinct),
        n_shards=corpus.n_shards,
        elapsed_s=time.perf_counter() - t0,
    )


def precise_phrase_count(corpus: ShardedCorpus, phrase: Sequence[int],
                         executor=None) -> int:
    """The exact baseline ('pure Spark program')."""
    if executor is not None:
        all_ids = np.arange(corpus.n_shards)
        counts = executor.map_shards(
            corpus, all_ids, lambda shard: count_phrase_in_shard(shard, phrase)
        )
        return int(sum(counts.values()))
    return corpus.count_phrase(phrase)
