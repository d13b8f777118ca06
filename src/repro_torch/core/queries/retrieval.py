"""Distributed information retrieval queries (paper Sec. IV-B, VII-C).

Boolean retrieval: query is an AND/OR tree over words.  Shard
similarity follows the paper's generative-probability algebra:
    p(wi AND wj | s) = p(wi|s) * p(wj|s)
    p(wi OR  wj | s) = p(wi|s) + p(wj|s)
with each p(w|s) proportional to exp(w . s) (Eq 10).  Shards are then
pps-sampled and only their documents are evaluated against the query.

Ranked retrieval: query is a bag of words; shards are sampled via the
standard query-vector similarity (Eq 11); documents in the sample are
scored with BM25 (the paper's choice) using *offline* global df stats
from the index.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.index import ApproxIndex
from repro_torch.core.sampling import (
    Estimate,
    SampleResult,
    pps_sample_distinct,
    similarity_probabilities,
    unique_shards,
)
from repro_torch.data.store import DocShard, ShardedCorpus


# ----------------------------------------------------------------------
# Boolean expression AST
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BoolExpr:
    op: str                                  # "word" | "and" | "or"
    word: Optional[int] = None
    left: Optional["BoolExpr"] = None
    right: Optional["BoolExpr"] = None

    @staticmethod
    def w(word: int) -> "BoolExpr":
        return BoolExpr("word", word=word)

    def __and__(self, other: "BoolExpr") -> "BoolExpr":
        return BoolExpr("and", left=self, right=other)

    def __or__(self, other: "BoolExpr") -> "BoolExpr":
        return BoolExpr("or", left=self, right=other)

    def words(self) -> List[int]:
        if self.op == "word":
            return [self.word]
        return self.left.words() + self.right.words()


def parse_boolean(tokens: Sequence[Union[int, str]]) -> BoolExpr:
    """Tiny recursive-descent parser: ints are words, 'and'/'or'/'('/')'
    are operators.  AND binds tighter than OR (paper Sec. IV-B)."""
    pos = 0

    def peek():
        return tokens[pos] if pos < len(tokens) else None

    def eat():
        nonlocal pos
        t = tokens[pos]
        pos += 1
        return t

    def atom() -> BoolExpr:
        t = eat()
        if t == "(":
            e = expr()
            if eat() != ")":
                raise ValueError("unbalanced parens")
            return e
        if isinstance(t, (int, np.integer)):
            return BoolExpr.w(int(t))
        raise ValueError(f"unexpected token {t!r}")

    def conj() -> BoolExpr:
        e = atom()
        while peek() == "and":
            eat()
            e = e & atom()
        return e

    def expr() -> BoolExpr:
        e = conj()
        while peek() == "or":
            eat()
            e = e | conj()
        return e

    out = expr()
    if pos != len(tokens):
        raise ValueError("trailing tokens")
    return out


def _expr_shard_similarity(expr: BoolExpr, index: ApproxIndex) -> np.ndarray:
    """p(q_b | s) for every shard via the paper's AND->product OR->sum
    algebra over per-word exp-similarities."""
    if expr.op == "word":
        return index.word_shard_similarity(expr.word)
    l = _expr_shard_similarity(expr.left, index)
    r = _expr_shard_similarity(expr.right, index)
    return l * r if expr.op == "and" else l + r


def _expr_eval_docs(expr: BoolExpr, shard: DocShard) -> np.ndarray:
    """Boolean [n_docs] mask of documents in ``shard`` satisfying expr.

    Word leaves walk the shard's CSR postings — O(docs containing the
    word) — instead of rescanning the flat token array per word."""
    if expr.op == "word":
        from repro_torch.data.store import shard_postings
        mask = np.zeros(shard.n_docs, bool)
        mask[shard_postings(shard).lookup(expr.word)[0]] = True
        return mask
    l = _expr_eval_docs(expr.left, shard)
    r = _expr_eval_docs(expr.right, shard)
    return (l & r) if expr.op == "and" else (l | r)


class RetrievalResult(NamedTuple):
    doc_ids: np.ndarray
    sample: SampleResult
    shards_read: int
    n_shards: int
    elapsed_s: float
    # result-size estimate with bootstrap CI (batch engine with CIs
    # enabled; None from the single-query path / with CIs off)
    estimate: Optional["Estimate"] = None
    # planned-but-unreachable shards (every replica dead) — the union
    # ran over survivors only; always 0 on the healthy path
    lost_shards: int = 0

    @property
    def data_fraction(self) -> float:
        return self.shards_read / self.n_shards

    @property
    def achieved_rate(self) -> float:
        """The rate actually served (after budget planning and any
        degradation): the fraction of shards physically read."""
        return self.data_fraction


def boolean_query(
    corpus: ShardedCorpus,
    index: Optional[ApproxIndex],
    expr: BoolExpr,
    rate: float,
    *,
    method: str = "emapprox",
    rng: Optional[np.random.Generator] = None,
    executor=None,
) -> RetrievalResult:
    rng = rng or np.random.default_rng(0)
    t0 = time.perf_counter()
    if rate >= 1.0:
        distinct = np.arange(corpus.n_shards)
        sample = SampleResult(distinct.astype(np.int64),
                              np.full(corpus.n_shards, 1.0 / corpus.n_shards), 1.0)
    elif method == "emapprox":
        sims = _expr_shard_similarity(expr, index)
        sample = pps_sample_distinct(
            similarity_probabilities(sims), rate, rng)
        distinct = unique_shards(sample)
    elif method == "srcs":
        # NOTE: retrieval SRCS is uniform *without* replacement (the
        # paper's with-replacement SRCS only matters for the HH
        # aggregation estimator) so both methods read the same number
        # of distinct shards at a given rate — the comparison stays a
        # comparison of *which* shards, not how many
        uniform = np.full(corpus.n_shards, 1.0 / corpus.n_shards)
        sample = pps_sample_distinct(uniform, rate, rng)
        distinct = unique_shards(sample)
    else:
        raise ValueError(f"unknown method {method!r}")

    def work(shard: DocShard) -> np.ndarray:
        return shard.doc_ids[_expr_eval_docs(expr, shard)]

    if executor is not None:
        by_shard = executor.map_shards(corpus, distinct, work)
        hits = [by_shard[int(s)] for s in distinct]
    else:
        hits = [work(corpus.shards[int(s)]) for s in distinct]
    doc_ids = np.concatenate(hits) if hits else np.zeros(0, np.int64)
    return RetrievalResult(np.unique(doc_ids), sample, len(distinct),
                           corpus.n_shards, time.perf_counter() - t0)


# ----------------------------------------------------------------------
# Ranked retrieval (BM25)
# ----------------------------------------------------------------------
def bm25_scores_for_shard(
    shard: DocShard,
    query_words: Sequence[int],
    doc_freq: np.ndarray,
    n_docs: int,
    avg_doc_len: float,
    k1: float = 1.2,
    b: float = 0.75,
) -> np.ndarray:
    """BM25 (Robertson) over every document in the shard; [n_docs].

    Walks the shard's CSR postings of the query words, touching only
    documents that actually contain them (documents with tf=0
    contribute 0 to the sum, exactly as in the dense formula).
    """
    from repro_torch.data.store import shard_postings
    lens = np.diff(shard.offsets).astype(np.float64)
    scores = np.zeros(shard.n_docs, np.float64)
    norm = k1 * (1.0 - b + b * lens / max(avg_doc_len, 1e-9))
    post = shard_postings(shard)
    for w in query_words:
        docs, tf = post.lookup(w)
        if docs.size == 0:
            continue
        tf = tf.astype(np.float64)
        df = float(doc_freq[w])
        idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
        scores[docs] += idf * tf * (k1 + 1.0) / np.maximum(
            tf + norm[docs], 1e-9)
    return scores


class RankedResult(NamedTuple):
    doc_ids: np.ndarray      # top-k, best first
    scores: np.ndarray
    sample: SampleResult
    shards_read: int
    n_shards: int
    elapsed_s: float
    # top-k stability score with bootstrap CI: 1.0 = every resample of
    # the sampled shards reproduces this top-k (batch engine with CIs
    # enabled; None from the single-query path / with CIs off)
    estimate: Optional["Estimate"] = None
    # planned-but-unreachable shards (every replica dead) — the top-k
    # merged survivors only; always 0 on the healthy path
    lost_shards: int = 0

    @property
    def data_fraction(self) -> float:
        return self.shards_read / self.n_shards

    @property
    def achieved_rate(self) -> float:
        """The rate actually served (after budget planning and any
        degradation): the fraction of shards physically read."""
        return self.data_fraction


def ranked_query(
    corpus: ShardedCorpus,
    index: Optional[ApproxIndex],
    query_words: Sequence[int],
    rate: float,
    k: int = 10,
    *,
    method: str = "emapprox",
    rng: Optional[np.random.Generator] = None,
    doc_freq: Optional[np.ndarray] = None,
    executor=None,
) -> RankedResult:
    """Top-k BM25 over a similarity-selected sample of shards."""
    rng = rng or np.random.default_rng(0)
    t0 = time.perf_counter()
    if doc_freq is None:
        if index is None:
            raise ValueError("need doc_freq or an index")
        doc_freq = index.doc_freq
    n_docs = index.n_docs if index is not None else corpus.n_docs
    avg_len = index.avg_doc_len if index is not None else corpus.n_tokens / max(n_docs, 1)

    if rate >= 1.0:
        distinct = np.arange(corpus.n_shards)
        sample = SampleResult(distinct.astype(np.int64),
                              np.full(corpus.n_shards, 1.0 / corpus.n_shards), 1.0)
    elif method == "emapprox":
        probs = index.shard_probabilities(query_words)
        sample = pps_sample_distinct(probs, rate, rng)
        distinct = unique_shards(sample)
    elif method == "srcs":
        # same note as boolean_query: uniform without replacement so
        # the srcs/emapprox comparison holds read budget fixed
        uniform = np.full(corpus.n_shards, 1.0 / corpus.n_shards)
        sample = pps_sample_distinct(uniform, rate, rng)
        distinct = unique_shards(sample)
    else:
        raise ValueError(f"unknown method {method!r}")

    def work(shard: DocShard) -> Tuple[np.ndarray, np.ndarray]:
        s = bm25_scores_for_shard(shard, query_words, doc_freq, n_docs, avg_len)
        return shard.doc_ids, s

    if executor is not None:
        by_shard = executor.map_shards(corpus, distinct, work)
        parts = [by_shard[int(s)] for s in distinct]
    else:
        parts = [work(corpus.shards[int(s)]) for s in distinct]
    if parts:
        ids = np.concatenate([p[0] for p in parts])
        sc = np.concatenate([p[1] for p in parts])
    else:
        ids, sc = np.zeros(0, np.int64), np.zeros(0, np.float64)
    order = np.argsort(-sc, kind="stable")[:k]
    return RankedResult(ids[order], sc[order], sample, len(distinct),
                        corpus.n_shards, time.perf_counter() - t0)


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------
def recall(approx_ids: np.ndarray, precise_ids: np.ndarray) -> float:
    if precise_ids.size == 0:
        return 1.0
    return float(np.isin(precise_ids, approx_ids).mean())


def precision_at_k(approx_ids: np.ndarray, precise_ids: np.ndarray, k: int) -> float:
    """Fraction of approx top-k that appear in the precise top-k (paper
    Sec. VII-A definition of P@k)."""
    a = approx_ids[:k]
    p = precise_ids[:k]
    if len(a) == 0:
        return 0.0
    return float(np.isin(a, p).mean())
