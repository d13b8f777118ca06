"""Synthetic corpora with controlled skew.

The paper evaluates on Wikipedia / CCNews / Amazon reviews.  Offline we
reproduce their *statistical shape* rather than their bytes: a topic
mixture model with Zipfian within-topic word distributions.  Documents
drawn from few topics + Zipf word laws give exactly the skewed
phrase-occurrence distributions that make similarity-driven sampling
beat random sampling (paper Sec. I: "random sampling can lead to large
errors ... when sampling from a skewed distribution").

Two generators, each draw for draw the JAX package's (same numpy RNG
stream, same outputs):
  * ``generate_text_corpus``   -> Wikipedia/CCNews analogue.
  * ``generate_review_corpus`` -> Amazon analogue (users x items x
    ratings, review text correlated with user preference vectors) for
    the recommendation queries.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.data.store import Document

# tokens per chunk of the per-word topic assignment (bounds memory)
_TOPIC_CHUNK = 1 << 22


@dataclasses.dataclass(frozen=True)
class SyntheticCorpusConfig:
    vocab_size: int = 8192
    n_topics: int = 24
    n_docs: int = 4096
    mean_doc_len: int = 160
    std_doc_len: int = 60
    min_doc_len: int = 16
    zipf_exponent: float = 1.07
    # concentration of a document's topic mixture; smaller = more skew
    doc_topic_alpha: float = 0.08
    # Order documents by dominant topic (with noise). Real corpora have
    # strong arrival locality — Wikipedia dumps are category-clustered,
    # Common Crawl visits sites consecutively — which is what gives HDFS
    # blocks their natural skew (paper Sec. I).  0.0 = random order,
    # 1.0 = perfectly topic-sorted.
    topic_locality: float = 0.85
    seed: int = 0


def _topic_word_dists(cfg: SyntheticCorpusConfig, rng: np.random.Generator) -> np.ndarray:
    """[n_topics, vocab] rows: 30% of each topic's mass is a shared
    Zipf law over the whole vocabulary (stopword-like words common to
    every topic) and 70% is a Zipf law over a topic-EXCLUSIVE slice of
    the vocabulary.  Topic-exclusive heads are what give real corpora
    their per-block skew ("Yankees" lives in sports pages); a plain
    per-topic permutation spreads every mid-frequency word across many
    topics and kills the skew the paper's sampling exploits."""
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    shared = ranks ** (-cfg.zipf_exponent)
    shared /= shared.sum()
    shared = shared[rng.permutation(cfg.vocab_size)]

    block = cfg.vocab_size // (cfg.n_topics + 1)   # last block: shared-only
    dists = np.empty((cfg.n_topics, cfg.vocab_size), np.float64)
    for t in range(cfg.n_topics):
        own = np.zeros(cfg.vocab_size, np.float64)
        lo, hi = t * block, (t + 1) * block
        local_ranks = np.arange(1, hi - lo + 1, dtype=np.float64)
        own_p = local_ranks ** (-cfg.zipf_exponent)
        own[lo + rng.permutation(hi - lo)] = own_p / own_p.sum()
        dists[t] = 0.3 * shared + 0.7 * own
    return dists


def generate_text_corpus(
    cfg: SyntheticCorpusConfig,
) -> Tuple[List[Document], np.ndarray]:
    """Returns (documents, doc_topic_weights[n_docs, n_topics])."""
    rng = np.random.default_rng(cfg.seed)
    topic_dists = _topic_word_dists(cfg, rng)
    doc_topics = rng.dirichlet(
        np.full(cfg.n_topics, cfg.doc_topic_alpha), size=cfg.n_docs
    )
    lengths = np.clip(
        rng.normal(cfg.mean_doc_len, cfg.std_doc_len, cfg.n_docs).astype(np.int64),
        cfg.min_doc_len,
        None,
    )
    # Pre-draw word pools per topic (vectorized): each topic gets a large
    # reservoir sampled from its Zipf law; documents then slice from the
    # reservoirs according to their per-word topic assignments.
    total = int(lengths.sum())
    # per-word topic assignment: one uniform per token against its
    # document's cumulative topic weights.  The comparison runs in
    # token chunks so the [chunk, n_topics] float64 intermediate stays
    # bounded (the whole corpus at once is [total, n_topics]); chunking
    # changes no value.
    doc_index = np.repeat(np.arange(cfg.n_docs), lengths)
    u = rng.random(total)
    cum = np.cumsum(doc_topics, axis=1)
    word_topic = np.empty(total, np.int64)
    step = _TOPIC_CHUNK
    for lo in range(0, total, step):
        hi = min(total, lo + step)
        word_topic[lo:hi] = (u[lo:hi, None] > cum[doc_index[lo:hi]]).sum(axis=1)
    del doc_index, u
    tokens = np.empty(total, np.int32)
    for t in range(cfg.n_topics):
        mask = word_topic == t
        n = int(mask.sum())
        if n:
            tokens[mask] = rng.choice(cfg.vocab_size, size=n, p=topic_dists[t]).astype(np.int32)
    offsets = np.zeros(cfg.n_docs + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])

    # arrival-order locality: sort by dominant topic + noise
    if cfg.topic_locality > 0:
        dominant = doc_topics.argmax(axis=1).astype(np.float64)
        noise = rng.normal(0, (1.0 - cfg.topic_locality) * cfg.n_topics + 1e-9,
                           cfg.n_docs)
        order = np.argsort(dominant + noise, kind="stable")
    else:
        order = np.arange(cfg.n_docs)

    docs: List[Document] = []
    for new_id, i in enumerate(order):
        docs.append(Document(new_id, tokens[offsets[i]: offsets[i + 1]]))
    return docs, doc_topics[order]


@dataclasses.dataclass(frozen=True)
class ReviewCorpusConfig:
    vocab_size: int = 8192
    n_topics: int = 16
    n_users: int = 512
    n_items: int = 256
    reviews_per_user_mean: int = 20
    review_len_mean: int = 40
    zipf_exponent: float = 1.07
    rating_noise: float = 0.35
    seed: int = 1


@dataclasses.dataclass
class ReviewData:
    """Amazon-analogue interaction data.

    ``user_docs[u]`` concatenates all reviews written by user ``u`` — the
    paper's definition of a document for the recommendation workload
    (Table II: 'all reviews written by the same user').
    """
    user_docs: List[Document]
    ratings: np.ndarray          # float32 [n_interactions]
    user_of: np.ndarray          # int64   [n_interactions]
    item_of: np.ndarray          # int64   [n_interactions]
    user_topics: np.ndarray      # [n_users, n_topics] preference vectors
    item_topics: np.ndarray      # [n_items, n_topics]
    vocab_size: int = 0

    def ratings_matrix(self) -> np.ndarray:
        """Dense [n_users, n_items] matrix with NaN for missing."""
        n_u = self.user_topics.shape[0]
        n_i = self.item_topics.shape[0]
        m = np.full((n_u, n_i), np.nan, np.float32)
        m[self.user_of, self.item_of] = self.ratings
        return m


def _choice_cdf(p: np.ndarray) -> np.ndarray:
    """The cdf numpy's ``Generator.choice(a, size, p=p)`` draws through:
    ``cumsum`` normalised by its last entry.  ``cdf.searchsorted(
    rng.random(size), side="right")`` is then the same draw from the
    same stream, without rebuilding and re-checking ``p`` each call."""
    cdf = p.cumsum()
    cdf /= cdf[-1]
    return cdf


def generate_review_corpus(cfg: ReviewCorpusConfig) -> ReviewData:
    """The JAX package's generator, draw for draw.  The per-review word
    draws take each topic's cdf once (``_choice_cdf``) instead of one
    ``rng.choice(..., p=...)`` a (review, topic), which rebuilds the
    vocabulary-wide cdf every call; the draws and the data are the
    same."""
    rng = np.random.default_rng(cfg.seed)
    word_cfg = SyntheticCorpusConfig(
        vocab_size=cfg.vocab_size, n_topics=cfg.n_topics,
        zipf_exponent=cfg.zipf_exponent, seed=cfg.seed,
    )
    topic_dists = _topic_word_dists(word_cfg, rng)
    topic_cdfs = [_choice_cdf(d) for d in topic_dists]
    user_topics = rng.dirichlet(np.full(cfg.n_topics, 0.15), size=cfg.n_users)
    item_topics = rng.dirichlet(np.full(cfg.n_topics, 0.15), size=cfg.n_items)

    # affinity -> rating on a 1..5 scale
    affinity = user_topics @ item_topics.T            # [U, I]
    a_min, a_max = affinity.min(), affinity.max()
    scaled = 1.0 + 4.0 * (affinity - a_min) / max(a_max - a_min, 1e-9)

    users, items, ratings = [], [], []
    user_tokens: List[List[np.ndarray]] = [[] for _ in range(cfg.n_users)]
    for u in range(cfg.n_users):
        k = max(2, int(rng.poisson(cfg.reviews_per_user_mean)))
        k = min(k, cfg.n_items)
        # users review items they're predisposed to encounter
        p = affinity[u] / affinity[u].sum()
        chosen = rng.choice(cfg.n_items, size=k, replace=False, p=p)
        for i in chosen:
            r = np.clip(scaled[u, i] + rng.normal(0, cfg.rating_noise), 1.0, 5.0)
            users.append(u)
            items.append(int(i))
            ratings.append(float(r))
            # review text: mixture of user and item topics
            mix = 0.5 * user_topics[u] + 0.5 * item_topics[i]
            length = max(8, int(rng.normal(cfg.review_len_mean, cfg.review_len_mean / 3)))
            wt = _choice_cdf(mix).searchsorted(rng.random(length),
                                               side="right")
            toks = np.empty(length, np.int32)
            for t in np.unique(wt):
                m = wt == t
                toks[m] = topic_cdfs[t].searchsorted(
                    rng.random(int(m.sum())), side="right").astype(np.int32)
            user_tokens[u].append(toks)

    user_docs = [
        Document(u, np.concatenate(user_tokens[u]) if user_tokens[u] else np.zeros(0, np.int32))
        for u in range(cfg.n_users)
    ]
    return ReviewData(
        user_docs=user_docs,
        ratings=np.asarray(ratings, np.float32),
        user_of=np.asarray(users, np.int64),
        item_of=np.asarray(items, np.int64),
        user_topics=user_topics,
        item_topics=item_topics,
        vocab_size=cfg.vocab_size,
    )
