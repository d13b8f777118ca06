"""Sharded document store — the HDFS-block analogue.

Documents are stored CSR-style per shard: a flat int32 token array plus
an int64 offsets array.  A shard is the cluster-sampling unit (paper
Sec. II-B) and the unit of placement on the ``data`` mesh axis.

Postings (query-side acceleration): each shard lazily builds a CSR
postings cache ``word -> (local doc index, term frequency)`` on first
use (``shard_postings``).  Word-driven operators — BM25 scoring,
Boolean document matching — then walk only the postings of the query
words, O(matching tokens), instead of rescanning the full flat token
array once per (query, word) pair, O(shard_tokens x query_words).  The
trade-off: the one-time build costs one sort of the shard's tokens and
~8 bytes per distinct (word, doc) pair, which pays for itself after a
couple of queries touching the shard; the flat-scan implementations are
kept (``*_scan``) as parity references and for one-shot scans where
building the cache would be wasted work.

Persistence: ``ShardedCorpus.save``/``load`` round-trip the per-shard
CSR payload *and* the postings next to it, so a cold serving process
opens the corpus with every shard's inverted index already attached —
no one-time rebuild on the first query to touch each shard.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Iterator, List, Sequence

import numpy as np


def atomic_savez(path: str, **payload: np.ndarray) -> None:
    """Write a compressed npz atomically: savez into a tempfile in the
    target directory, then ``os.replace`` over ``path`` — readers never
    see a half-written file.  (np.savez appends ``.npz`` to suffixless
    names, hence the existence probe.)  Shared by every on-disk artifact
    (corpus + postings here, the index in core/index.py)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    os.close(fd)
    try:
        np.savez_compressed(tmp, **payload)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp,
                   path)
    finally:
        for leftover in (tmp, tmp + ".npz"):
            if os.path.exists(leftover):
                os.unlink(leftover)


@dataclasses.dataclass(frozen=True)
class Document:
    """A single document: token ids plus a stable global id."""
    doc_id: int
    tokens: np.ndarray  # int32 [len]

    def __len__(self) -> int:
        return int(self.tokens.shape[0])


@dataclasses.dataclass
class DocShard:
    """One subcollection of documents (CSR layout)."""
    shard_id: int
    tokens: np.ndarray       # int32 [total_tokens_in_shard]
    offsets: np.ndarray      # int64 [n_docs + 1]
    doc_ids: np.ndarray      # int64 [n_docs] global document ids

    @property
    def n_docs(self) -> int:
        return int(self.doc_ids.shape[0])

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])

    def document(self, i: int) -> Document:
        lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
        return Document(int(self.doc_ids[i]), self.tokens[lo:hi])

    def iter_documents(self) -> Iterator[Document]:
        for i in range(self.n_docs):
            yield self.document(i)

    @staticmethod
    def from_documents(shard_id: int, docs: Sequence[Document]) -> "DocShard":
        if docs:
            tokens = np.concatenate([d.tokens for d in docs]).astype(np.int32)
            offsets = np.zeros(len(docs) + 1, np.int64)
            np.cumsum([len(d) for d in docs], out=offsets[1:])
            doc_ids = np.asarray([d.doc_id for d in docs], np.int64)
        else:
            tokens = np.zeros((0,), np.int32)
            offsets = np.zeros((1,), np.int64)
            doc_ids = np.zeros((0,), np.int64)
        return DocShard(shard_id, tokens, offsets, doc_ids)


class ShardedCorpus:
    """A corpus partitioned into shards (subcollections).

    ``shard_tokens`` is the target token budget per shard — the analogue
    of the paper's 32 MB HDFS block size.
    """

    def __init__(self, shards: List[DocShard], vocab_size: int):
        self.shards = shards
        self.vocab_size = int(vocab_size)
        self._doc_to_shard = None

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def from_documents(
        docs: Sequence[Document],
        vocab_size: int,
        shard_tokens: int = 1 << 18,
    ) -> "ShardedCorpus":
        """Sequential allocation: fill shards to the token budget in doc
        order (the 'as-ingested' layout, before k-means reallocation)."""
        shards: List[DocShard] = []
        cur: List[Document] = []
        cur_tokens = 0
        for d in docs:
            cur.append(d)
            cur_tokens += len(d)
            if cur_tokens >= shard_tokens:
                shards.append(DocShard.from_documents(len(shards), cur))
                cur, cur_tokens = [], 0
        if cur:
            shards.append(DocShard.from_documents(len(shards), cur))
        return ShardedCorpus(shards, vocab_size)

    def reallocate(self, assignment: np.ndarray, n_shards: int) -> "ShardedCorpus":
        """Rebuild shards from a document→shard assignment vector indexed
        by global doc_id (paper Sec. IV-D: cluster-based allocation)."""
        buckets: List[List[Document]] = [[] for _ in range(n_shards)]
        for shard in self.shards:
            for doc in shard.iter_documents():
                buckets[int(assignment[doc.doc_id])].append(doc)
        shards = [DocShard.from_documents(i, b) for i, b in enumerate(buckets)]
        return ShardedCorpus(shards, self.vocab_size)

    # ------------------------------------------------------------------
    # inspection
    # ------------------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_docs(self) -> int:
        return sum(s.n_docs for s in self.shards)

    @property
    def n_tokens(self) -> int:
        return sum(s.n_tokens for s in self.shards)

    def iter_documents(self) -> Iterator[Document]:
        for s in self.shards:
            yield from s.iter_documents()

    def doc_shard_map(self) -> np.ndarray:
        """Global doc_id → shard_id (cached)."""
        if self._doc_to_shard is None:
            out = np.full(self.n_docs, -1, np.int64)
            for s in self.shards:
                out[s.doc_ids] = s.shard_id
            self._doc_to_shard = out
        return self._doc_to_shard

    def shard_doc_counts(self) -> np.ndarray:
        return np.asarray([s.n_docs for s in self.shards], np.int64)

    def shard_token_counts(self) -> np.ndarray:
        return np.asarray([s.n_tokens for s in self.shards], np.int64)

    # ------------------------------------------------------------------
    # exact counting oracles (used by tests and precise execution)
    # ------------------------------------------------------------------
    def count_phrase(self, phrase: Sequence[int]) -> int:
        """Exact number of occurrences of ``phrase`` in the corpus."""
        return sum(count_phrase_in_shard(s, phrase) for s in self.shards)

    # ------------------------------------------------------------------
    # persistence (atomic; shard payload + CSR postings side by side)
    # ------------------------------------------------------------------
    def save(self, path: str, *, include_postings: bool = True) -> None:
        """Write the corpus to one compressed npz.

        ``include_postings=True`` (default) persists each shard's CSR
        postings next to its token payload — building any that were not
        built yet — so a process that ``load``s the file serves its
        first queries without paying the one-time postings rebuild.
        Set False to store the raw payload only (smaller file, lazy
        rebuild on first use as before)."""
        payload = dict(meta=np.asarray(json.dumps(dict(
            vocab_size=self.vocab_size, n_shards=self.n_shards,
            postings=bool(include_postings)))))
        for i, shard in enumerate(self.shards):
            payload[f"s{i}_tokens"] = shard.tokens
            payload[f"s{i}_offsets"] = shard.offsets
            payload[f"s{i}_doc_ids"] = shard.doc_ids
            if include_postings:
                post = shard_postings(shard)
                payload[f"s{i}_indptr"] = post.indptr
                payload[f"s{i}_doc_idx"] = post.doc_idx
                payload[f"s{i}_tf"] = post.tf
        atomic_savez(path, **payload)

    @staticmethod
    def load(path: str) -> "ShardedCorpus":
        """Open a saved corpus; persisted postings are re-attached to
        their shards, so ``shard_postings`` is a cache hit from the
        first query onward (cold processes skip the rebuild)."""
        z = np.load(path, allow_pickle=False)
        meta = json.loads(str(z["meta"]))
        shards: List[DocShard] = []
        for i in range(int(meta["n_shards"])):
            shard = DocShard(i, z[f"s{i}_tokens"], z[f"s{i}_offsets"],
                             z[f"s{i}_doc_ids"])
            if meta.get("postings"):
                shard._postings = ShardPostings(
                    z[f"s{i}_indptr"], z[f"s{i}_doc_idx"], z[f"s{i}_tf"])
            shards.append(shard)
        return ShardedCorpus(shards, int(meta["vocab_size"]))


def count_phrase_in_shard(shard: DocShard, phrase: Sequence[int]) -> int:
    """Occurrences of a token n-gram within a shard, never crossing
    document boundaries."""
    phrase = np.asarray(phrase, np.int32)
    k = len(phrase)
    if k == 0 or shard.n_tokens < k:
        return 0
    tokens = shard.tokens
    if k == 1:
        return int(np.count_nonzero(tokens == phrase[0]))
    # vectorized n-gram match over the flat array
    match = tokens[: len(tokens) - k + 1] == phrase[0]
    for j in range(1, k):
        match &= tokens[j: len(tokens) - k + 1 + j] == phrase[j]
    if not match.any():
        return 0
    # kill matches that straddle a document boundary
    pos = np.nonzero(match)[0]
    doc_of_start = np.searchsorted(shard.offsets, pos, side="right") - 1
    doc_of_end = np.searchsorted(shard.offsets, pos + k - 1, side="right") - 1
    return int(np.count_nonzero(doc_of_start == doc_of_end))


def segment_sum_by_offsets(values: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Per-document sums over a CSR layout.  Handles empty documents
    anywhere: np.add.reduceat alone mis-handles empty segments (and
    raises on out-of-bounds starts), so it runs only at the starts of
    non-empty documents — strictly increasing, in-bounds slices — and
    the empty documents stay zero.  (Clamping empty starts into range
    instead would split the last tokens of the preceding document into
    the wrong slice whenever an empty doc sits at the end.)"""
    n_docs = len(offsets) - 1
    out = np.zeros(n_docs, values.dtype)
    if n_docs == 0 or values.shape[0] == 0:
        return out
    lens = np.diff(offsets)
    nonempty = lens > 0
    if nonempty.any():
        out[nonempty] = np.add.reduceat(values, offsets[:-1][nonempty])
    return out


def plan_blocked_layout(counts: Sequence[int], block: int
                        ) -> "tuple[np.ndarray, np.ndarray, int]":
    """Row layout for a block-aligned packed multi-segment payload
    (the megascan's input contract, kernels/megascan): each segment's
    rows are padded *independently* up to a multiple of ``block`` before
    concatenation, so every ``block``-row slab belongs to exactly one
    segment.  Returns ``(row_starts, blocks, total_rows)``: segment
    ``i``'s real rows occupy ``[row_starts[i], row_starts[i] +
    counts[i])``, it owns ``blocks[i]`` slabs, and the packed array has
    ``total_rows`` rows in all.  Empty segments get zero slabs (they
    occupy no rows at all, not an empty padded slab)."""
    counts = np.asarray(counts, np.int64)
    if block <= 0:
        raise ValueError(f"block size must be positive, got {block}")
    if (counts < 0).any():
        raise ValueError("segment counts must be non-negative")
    blocks = -(-counts // block)
    row_starts = np.zeros(counts.shape[0], np.int64)
    if counts.shape[0] > 1:
        np.cumsum(blocks[:-1] * block, out=row_starts[1:])
    return row_starts, blocks, int(blocks.sum() * block)


# ----------------------------------------------------------------------
# per-shard CSR postings (lazily built, cached on the shard)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardPostings:
    """CSR inverted index for one shard: row = word id, entries =
    (local document index, term frequency).

    ``indptr`` is [vocab_local + 1] with vocab_local = max token + 1 —
    lookups of words the shard never saw fall off the end and return
    empty slices, so callers never need the global vocab size.
    """
    indptr: np.ndarray    # int64 [vocab_local + 1]
    doc_idx: np.ndarray   # int32 [nnz] local doc index within the shard
    tf: np.ndarray        # int32 [nnz] term frequency

    def lookup(self, word: int) -> "tuple[np.ndarray, np.ndarray]":
        """(local doc indices, term frequencies) for ``word``."""
        w = int(word)
        if w < 0 or w >= self.indptr.shape[0] - 1:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        lo, hi = int(self.indptr[w]), int(self.indptr[w + 1])
        return (self.doc_idx[lo:hi], self.tf[lo:hi])

    def word_count(self, word: int) -> int:
        """Total occurrences of ``word`` in the shard (sum of tf)."""
        return int(self.lookup(word)[1].sum())

    @property
    def nbytes(self) -> int:
        return self.indptr.nbytes + self.doc_idx.nbytes + self.tf.nbytes


def build_postings(shard: DocShard) -> ShardPostings:
    """One pass over the shard's CSR token array: key each token by
    (word, doc), count distinct keys, and lay the pairs out word-major
    (np.unique returns keys sorted, and word is the high digit)."""
    n_docs = shard.n_docs
    if n_docs == 0 or shard.n_tokens == 0:
        z32 = np.zeros(0, np.int32)
        return ShardPostings(np.zeros(1, np.int64), z32, z32)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64),
                       np.diff(shard.offsets))
    key = shard.tokens.astype(np.int64) * n_docs + doc_of
    uniq, tf = np.unique(key, return_counts=True)
    words = uniq // n_docs
    vocab_local = int(shard.tokens.max()) + 1
    indptr = np.zeros(vocab_local + 1, np.int64)
    np.cumsum(np.bincount(words, minlength=vocab_local), out=indptr[1:])
    return ShardPostings(indptr, (uniq % n_docs).astype(np.int32),
                         tf.astype(np.int32))


def shard_postings(shard: DocShard) -> ShardPostings:
    """Postings for ``shard``, built lazily and cached on the shard
    object.  Concurrent first calls may both build (benign — identical
    results, last write wins); afterwards every query touching the
    shard reuses the cache, which is what makes the batched engine's
    shared scans cheap."""
    post = getattr(shard, "_postings", None)
    if post is None:
        post = build_postings(shard)
        shard._postings = post
    return post
