"""PV-DBOW (Paragraph Vector, distributed bag of words) on torch.

The port of the JAX package's ``core/pv_dbow.py``.  The paper (Sec.
II-C) uses PV-DBOW with window = document length: every (document,
word) occurrence is a training pair.  Negative sampling with k noise
words factorizes the shifted PMI matrix (Levy-Goldberg, Eq 4), which is
what makes ``exp(q . d)`` proportional to ``p(q|d)`` (Eq 5), the basis
of the whole index.  Vectors are re-normalized to unit length at each
step so dot product == cosine (paper Sec. III-B).

Where it differs from the reference:

  * Random draws come from ``torch.Generator``s (the initial tables,
    the negatives, inference's noise words) where the reference draws
    from threefry keys, which torch cannot reproduce.  The pair indices
    come from ``np.random.default_rng(cfg.seed)`` as in the reference,
    so the batches are the same.  For parity, ``train_pv_dbow`` and
    ``infer_doc_vector(s)`` take the initial state and the negative ids
    injected (keyword-only; ``model_from_arrays`` carries weights
    across).
  * ``train_pv_dbow`` always steps through ``kernels/negsamp``'s
    ``negsamp_step``, which takes the hand-written CUDA kernel on a
    CUDA device and its plain version on the CPU.  The config has no
    ``use_kernel`` flag: the device picks the route.  ``sgns_step``
    (autograd) stays public as the counterpart of the reference's
    default step.
  * On CUDA the steps' scatter-adds use float atomics, so training is
    repeatable there within rounding, not bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.store import ShardedCorpus
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.negsamp import ops as negsamp_ops
from repro_torch.kernels.negsamp.ref import softplus


@dataclasses.dataclass(frozen=True)
class PVDBOWConfig:
    dim: int = 64                 # lambda_1 in the paper (default 100 there)
    negatives: int = 5            # k in Eq 4
    lr: float = 0.05
    steps: int = 1500
    batch_pairs: int = 8192
    noise_power: float = 0.75     # unigram^0.75 noise distribution
    unit_norm: bool = True        # paper's modification for LSH-cosine
    subsample_t: float = 1e-3     # word2vec frequent-word subsampling threshold
    # Temperature inside the SGNS sigmoid: sigma(beta * cos).  With the
    # per-step unit-norm projection dots are capped at [-1, 1], and
    # without beta the tables collapse (the reference measured it);
    # scoring exponentiates with the same beta.
    temperature: float = 8.0
    seed: int = 0


class PVDBOWModel(NamedTuple):
    word_vecs: torch.Tensor   # [V, dim] float32
    doc_vecs: torch.Tensor    # [n_docs, dim] float32

    @property
    def dim(self) -> int:
        return self.word_vecs.shape[1]


class CorpusPairs(NamedTuple):
    """Flat (doc, word) training pairs + the negative-sampling noise law
    (``noise_cdf``: the cumulative unigram^power distribution; negatives
    are drawn by inverse CDF)."""
    doc_of_token: np.ndarray   # int32 [total_tokens]
    word_of_token: np.ndarray  # int32 [total_tokens]
    noise_cdf: np.ndarray      # float32 [V] cumulative noise distribution


def model_from_arrays(word_vecs, doc_vecs,
                      device: "torch.device | str | None" = None
                      ) -> PVDBOWModel:
    """A ``PVDBOWModel`` on ``device`` (CUDA unless named) from any two
    arrays or tensors, e.g. the JAX package's model as numpy."""
    dev = resolve_device(device)

    def table(x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.detach().to(dev, torch.float32)
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return PVDBOWModel(table(word_vecs), table(doc_vecs))


def corpus_pairs(
    corpus: ShardedCorpus,
    noise_power: float = 0.75,
    subsample_t: float = 1e-3,
    seed: int = 0,
) -> CorpusPairs:
    """Extract (doc, word) pairs with word2vec frequent-word subsampling
    (keep prob = sqrt(t / f) for frequency f), bit for bit the
    reference's numpy."""
    docs, words = [], []
    for shard in corpus.shards:
        lens = np.diff(shard.offsets)
        docs.append(np.repeat(shard.doc_ids.astype(np.int32), lens))
        words.append(shard.tokens)
    word_of_token = np.concatenate(words)
    doc_of_token = np.concatenate(docs)

    counts = np.bincount(word_of_token, minlength=corpus.vocab_size).astype(np.float64)
    if subsample_t > 0:
        freq = counts / counts.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            keep_p = np.sqrt(subsample_t / np.maximum(freq, 1e-12))
        keep_p = np.clip(keep_p, 0.0, 1.0)
        rng = np.random.default_rng(seed)
        keep = rng.random(word_of_token.shape[0]) < keep_p[word_of_token]
        if keep.sum() > 1024:  # don't subsample tiny corpora into nothing
            word_of_token = word_of_token[keep]
            doc_of_token = doc_of_token[keep]

    p = counts ** noise_power
    p /= p.sum()
    return CorpusPairs(doc_of_token, word_of_token,
                       np.cumsum(p).astype(np.float32))


def sample_negatives(gen: torch.Generator, noise_cdf: torch.Tensor,
                     shape) -> torch.Tensor:
    """Inverse-CDF negative sampling: int64 ids with the unigram^power
    law, drawn on the generator's device (``noise_cdf`` lies there)."""
    u = torch.rand(shape, generator=gen, device=noise_cdf.device)
    ids = torch.searchsorted(noise_cdf, u)
    return ids.clamp_(0, noise_cdf.shape[0] - 1)


def init_model(gen: torch.Generator, vocab_size: int, n_docs: int,
               dim: int) -> PVDBOWModel:
    """Unit rows of N(0, 1/dim) tables, drawn on the generator's device."""
    scale = 1.0 / np.sqrt(dim)
    w = torch.randn((vocab_size, dim), generator=gen, device=gen.device) * scale
    d = torch.randn((n_docs, dim), generator=gen, device=gen.device) * scale
    return PVDBOWModel(_unit_rows(w), _unit_rows(d))


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-8)


def sgns_loss(
    model: PVDBOWModel,
    doc_ids: torch.Tensor,     # int [B]
    word_ids: torch.Tensor,    # int [B]
    neg_ids: torch.Tensor,     # int [B, k]
    temperature: float = 1.0,
) -> torch.Tensor:
    """Skip-gram-with-negative-sampling loss, document as context,
    L = -log sigma(w.d) - sum_neg log sigma(-w'.d), SUM-reduced over the
    batch (each pair gives its embedding rows an O(1) gradient whatever
    the batch size)."""
    d = model.doc_vecs[doc_ids]
    w = model.word_vecs[word_ids]
    wn = model.word_vecs[neg_ids]
    pos = torch.einsum("bd,bd->b", w, d) * temperature
    neg = torch.einsum("bkd,bd->bk", wn, d) * temperature
    return softplus(-pos).sum() + softplus(neg).sum()


def sgns_step(
    model: PVDBOWModel,
    neg_ids: torch.Tensor,
    doc_ids: torch.Tensor,
    word_ids: torch.Tensor,
    *,
    lr: float,
    unit_norm: bool,
    temperature: float = 1.0,
) -> Tuple[PVDBOWModel, torch.Tensor]:
    """One SGD step of ``sgns_loss`` with gradients by autograd (the
    counterpart of ``jax.value_and_grad``); the negatives come drawn.
    Returns (new model, per-pair mean loss)."""
    leaf = PVDBOWModel(model.word_vecs.detach().requires_grad_(True),
                       model.doc_vecs.detach().requires_grad_(True))
    loss = sgns_loss(leaf, doc_ids, word_ids, neg_ids, temperature)
    g_w, g_d = torch.autograd.grad(loss, (leaf.word_vecs, leaf.doc_vecs))
    with torch.no_grad():
        new_w = model.word_vecs - lr * g_w
        new_d = model.doc_vecs - lr * g_d
        if unit_norm:
            new_w = _unit_rows(new_w)
            new_d = _unit_rows(new_d)
    return PVDBOWModel(new_w, new_d), loss.detach() / doc_ids.shape[0]


def train_pv_dbow(
    corpus: ShardedCorpus,
    cfg: PVDBOWConfig,
    *,
    callback=None,
    log_every: int = 100,
    device: "torch.device | str | None" = None,
    init: Optional[PVDBOWModel] = None,
    negatives: Optional[Callable[[int], torch.Tensor]] = None,
) -> PVDBOWModel:
    """Offline index-model training (paper Fig. 2 step p1) on ``device``
    (CUDA unless named).  ``callback(step, loss)`` is called every
    ``log_every`` steps and after the last; each call reads the loss
    back from the device.  For parity only: ``init`` replaces the drawn
    initial tables and ``negatives(step)`` the drawn [B, k] negative
    ids of each step."""
    dev = resolve_device(device)
    pairs = corpus_pairs(corpus, cfg.noise_power, cfg.subsample_t, cfg.seed)
    n_pairs = pairs.doc_of_token.shape[0]
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    if init is None:
        model = init_model(gen, corpus.vocab_size, corpus.n_docs, cfg.dim)
    else:
        model = PVDBOWModel(init.word_vecs.to(dev), init.doc_vecs.to(dev))
    noise_cdf = torch.as_tensor(pairs.noise_cdf, device=dev)
    rng = np.random.default_rng(cfg.seed)

    for step in range(cfg.steps):
        idx = rng.integers(0, n_pairs, size=cfg.batch_pairs)
        doc_ids = torch.as_tensor(pairs.doc_of_token[idx].astype(np.int64),
                                  device=dev)
        word_ids = torch.as_tensor(pairs.word_of_token[idx].astype(np.int64),
                                   device=dev)
        if negatives is None:
            neg_ids = sample_negatives(gen, noise_cdf,
                                       (cfg.batch_pairs, cfg.negatives))
        else:
            neg_ids = torch.as_tensor(negatives(step), device=dev).long()
        model, loss = negsamp_ops.negsamp_step(
            model, neg_ids, doc_ids, word_ids, lr=cfg.lr,
            unit_norm=cfg.unit_norm, temperature=cfg.temperature)
        if callback is not None and (step % log_every == 0
                                     or step == cfg.steps - 1):
            callback(step, float(loss))
    return model


def _infer_step(word_vecs: torch.Tensor, tokens: torch.Tensor,
                vec: torch.Tensor, kneg: torch.Tensor, *, lr: float,
                temperature: float) -> torch.Tensor:
    """One frozen-model inference step (word matrix fixed, one doc
    vector [1, dim] trained) on the [T, k] noise-word ids ``kneg``."""
    v = vec.detach().requires_grad_(True)
    w = word_vecs[tokens]
    pos = w @ v[0] * temperature
    neg = torch.einsum("bkd,d->bk", word_vecs[kneg], v[0]) * temperature
    loss = softplus(-pos).mean() + softplus(neg).sum(-1).mean()
    (g,) = torch.autograd.grad(loss, (v,))
    with torch.no_grad():
        return _unit_rows(vec - lr * g)


def infer_doc_vector(
    model: PVDBOWModel,
    tokens: np.ndarray,
    cfg: PVDBOWConfig,
    steps: int = 50,
    *,
    pause_s: float = 0.0,
    init_vec: Optional[torch.Tensor] = None,
    negatives: Optional[Callable[[int], torch.Tensor]] = None,
) -> torch.Tensor:
    """Infer a vector [dim] for an unseen document with the word vectors
    frozen (paper Sec. V, model-drift mitigation), on the model's
    device.  Deterministic in (cfg.seed, tokens): the generator restarts
    from ``cfg.seed + 1`` for every document.  ``pause_s`` sleeps
    between steps (a cooperative yield for a concurrent reader) and
    never changes the result.  For parity only: ``init_vec`` replaces
    the drawn initial vector (the [1, dim] normal / sqrt(dim) draw, made
    unit here) and ``negatives(step)`` the drawn [T, k]
    noise-word ids of each step."""
    word_vecs = model.word_vecs
    dev = word_vecs.device
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    if init_vec is None:
        init_vec = torch.randn((1, cfg.dim), generator=gen,
                               device=dev) / np.sqrt(cfg.dim)
    vec = _unit_rows(torch.as_tensor(init_vec, dtype=torch.float32,
                                     device=dev).reshape(1, cfg.dim))
    tokens = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
    n_words = word_vecs.shape[0]
    for i in range(steps):
        if negatives is None:
            kneg = torch.randint(0, n_words, (tokens.shape[0], cfg.negatives),
                                 generator=gen, device=dev)
        else:
            kneg = torch.as_tensor(negatives(i), device=dev).long()
        vec = _infer_step(word_vecs, tokens, vec, kneg, lr=cfg.lr,
                          temperature=cfg.temperature)
        if pause_s > 0.0:
            time.sleep(pause_s)
    return vec[0]


def infer_doc_vectors(
    model: PVDBOWModel,
    docs: Sequence[np.ndarray],
    cfg: PVDBOWConfig,
    steps: int = 50,
    *,
    pause_s: float = 0.0,
    init_vec: Optional[torch.Tensor] = None,
    negatives: Optional[Callable[[int, int], torch.Tensor]] = None,
) -> np.ndarray:
    """Frozen-model inference for a batch of documents: [len(docs), dim]
    float32, row ``i`` bit for bit ``infer_doc_vector(model, docs[i],
    cfg, steps)``.  Documents are ragged and each one's noise draws are
    shaped by its token count, so they run one after another, never
    padded into a rectangle.  ``negatives(i, step)`` injects document
    i's draws (parity only)."""
    if not len(docs):
        return np.zeros((0, cfg.dim), np.float32)
    out = []
    for i, d in enumerate(docs):
        neg_i = None if negatives is None else (
            lambda step, i=i: negatives(i, step))
        out.append(infer_doc_vector(model, d, cfg, steps, pause_s=pause_s,
                                    init_vec=init_vec, negatives=neg_i)
                   .cpu().numpy().astype(np.float32))
    return np.stack(out)


def query_vector(model_or_words, word_ids: Sequence[int]) -> torch.Tensor:
    """Paper Sec. III: q = elementwise sum of the query's word vectors."""
    w = model_or_words.word_vecs if isinstance(model_or_words, PVDBOWModel) \
        else torch.as_tensor(model_or_words)
    return w[torch.as_tensor(list(word_ids), dtype=torch.int64,
                             device=w.device)].sum(dim=0)
