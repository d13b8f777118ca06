"""LM batch pipeline + similarity-driven training-data sampler.

``LMBatchPipeline`` packs a ShardedCorpus into (batch, seq_len) token
blocks with next-token labels — the input format for every architecture
in the zoo.  Shards are the unit of shuffling and of similarity-driven
selection, mirroring the query path.

``SimilaritySampler`` is the beyond-paper integration of EmApprox into
*training*: given an approximation index and a "domain prompt", shards
are drawn with pps probabilities so gradient steps concentrate on
query-relevant data.

A copy of the JAX package's module (numpy and a thread): the same
batches and the same draws from the same seed.
"""
from __future__ import annotations

import dataclasses
import threading
import queue as queue_mod
import time
from typing import Iterator, Optional, Sequence

import numpy as np

from repro_torch.data.store import ShardedCorpus
from repro_torch.utils.tracing import span


@dataclasses.dataclass
class LMBatchPipeline:
    corpus: ShardedCorpus
    batch_size: int
    seq_len: int
    pad_id: int = 0
    seed: int = 0
    shard_order: Optional[Sequence[int]] = None  # None = shuffled each epoch

    def _shard_sequence(self, epoch: int) -> np.ndarray:
        if self.shard_order is not None:
            return np.asarray(self.shard_order, np.int64)
        rng = np.random.default_rng(self.seed + epoch)
        return rng.permutation(self.corpus.n_shards)

    def iter_epoch(self, epoch: int = 0) -> Iterator[dict]:
        """Yields {'tokens': int32 [B, S], 'labels': int32 [B, S],
        'mask': float32 [B, S]} — labels are next-token shifted."""
        need = self.batch_size * (self.seq_len + 1)
        buf = np.zeros(0, np.int32)
        for sid in self._shard_sequence(epoch):
            shard = self.corpus.shards[int(sid)]
            buf = np.concatenate([buf, shard.tokens])
            while buf.shape[0] >= need:
                block = buf[:need].reshape(self.batch_size, self.seq_len + 1)
                buf = buf[need:]
                yield {
                    "tokens": block[:, :-1].copy(),
                    "labels": block[:, 1:].copy(),
                    "mask": np.ones((self.batch_size, self.seq_len), np.float32),
                }
        if buf.shape[0] > self.batch_size:  # final ragged batch, padded
            per = buf.shape[0] // self.batch_size
            if per >= 2:
                block = buf[: per * self.batch_size].reshape(self.batch_size, per)
                tokens = np.full((self.batch_size, self.seq_len), self.pad_id, np.int32)
                labels = np.full((self.batch_size, self.seq_len), self.pad_id, np.int32)
                mask = np.zeros((self.batch_size, self.seq_len), np.float32)
                n = min(per - 1, self.seq_len)
                tokens[:, :n] = block[:, :n]
                labels[:, :n] = block[:, 1: n + 1]
                mask[:, :n] = 1.0
                yield {"tokens": tokens, "labels": labels, "mask": mask}


class SimilaritySampler:
    """Draw shard ids with probabilities proportional to similarity to a
    target prompt (EmApprox index reused for training-data curriculum)."""

    def __init__(self, probabilities: np.ndarray, seed: int = 0):
        p = np.asarray(probabilities, np.float64)
        if p.ndim != 1 or (p < 0).any():
            raise ValueError("probabilities must be a non-negative 1-D array")
        self.p = p / p.sum()
        self.rng = np.random.default_rng(seed)

    def draw_epoch_order(self, n_draws: Optional[int] = None) -> np.ndarray:
        n = n_draws or self.p.shape[0]
        return self.rng.choice(self.p.shape[0], size=n, replace=True, p=self.p)


class PrefetchIterator:
    """Background-thread prefetch so host batch assembly overlaps device
    compute (the CPU-side piece of compute/comm overlap).  ``close``
    stops the thread (the JAX package's has none: its thread blocks on
    a full queue until the process exits).  ``wait_s`` counts the host
    seconds the consumer spent blocked for a batch, ``gets`` its calls
    of ``__next__``; the wait runs in a ``data.wait`` span."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.wait_s = 0.0
        self.gets = 0
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def worker():
            try:
                for item in it:
                    if not self._put(item):
                        return
            except BaseException as e:  # propagate into consumer
                self._err = e
            finally:
                self._put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless ``close`` was called first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue_mod.Full:
                pass
        return False

    def __iter__(self):
        return self

    def __next__(self):
        self.gets += 1
        t0 = time.perf_counter()
        with span("data.wait"):
            item = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker thread and wait for it (up to ``timeout``)."""
        self._stop.set()
        self._thread.join(timeout)
