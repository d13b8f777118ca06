"""The approximation index (paper Fig. 1 / Fig. 2 steps p1-p2), on torch.

Contents, as in the JAX package's ``core/index.py`` and in its npz
format:
  * word vectors           [V, dim]        (unit rows)
  * shard vectors          [n_shards, dim] (mean of member doc vectors)
  * optional doc vectors   [n_docs, dim]
  * LSH packed signatures for words, shards and docs + the hyperplanes
  * document-frequency table for BM25 scoring (ranked retrieval)

Query-time API (paper Fig. 2 step a1): compose a query vector from word
vectors, score it against signatures, normalise into sampling
probabilities.  The index keeps its arrays on the host as numpy (the
reference's types, and what ``save``/``load`` exchange) and computes on
``device``: CUDA unless the caller asks for the CPU.  Asking for CUDA
without a GPU raises.

LSH scoring always goes through the kernels of its mode, and the
device alone picks the route: on CUDA the hand-written kernels, on the
CPU their plain PyTorch versions.  asym mode (stored side quantized,
query side real) scores through ``kernels/asym``; sym mode, the
paper's two-sided Hamming scoring (Sec. III-B), signs the queries
through ``lsh.sign_tensor`` (on the host, so their bits do not depend
on the device) and scores through ``kernels/hamming``.  The JAX package's
``use_kernel`` flag has no counterpart: ``load``/``from_arrays`` read
past it and ``save`` writes it True.  ``_exp_sim_batch`` scores a
[B, dim] block against every target signature (Boolean word x shard
rows, shard-granular planning), and doc-granular planning takes the
fused segment sum, which reduces the [B, n_docs] similarities straight
to [B, n_shards] without writing the intermediate.  Only the
real-valued ablation (``use_lsh=False``) scores in numpy on the host.
The device-resident operands (planes, the shard-sorted doc signatures
and slots, the CSR segment offsets) are uploaded once and cached;
``attach_corpus`` drops them.  Results come back as numpy float64, as
in the reference.

Ranked retrieval over documents (``topk_doc_similarities_batch``) runs
the fused per-tile top-k (``kernels/asym``) on the cached doc
signatures in asym mode; in sym mode it scores every doc and sorts on
the device, the reference's unfused route.  ``megascan_payload`` packs
a shard group's doc signatures into the block-aligned payload of the
one-launch megascan (``kernels/megascan``), cached per (shards, tile,
content generation).

Not in this module yet: the live-ingest refresh.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import lsh as lsh_mod
from repro_torch.core.sampling import similarity_probabilities
from repro_torch.data.store import ShardedCorpus, atomic_savez
from repro_torch.kernels.common import resolve_device
from repro_torch.runtime.generation import GenerationClock


# guards the megascan payload cache's check-then-build
_PAYLOAD_LOCK = threading.Lock()


@dataclasses.dataclass
class ApproxIndex:
    word_vecs: np.ndarray          # [V, dim] float32 (unit rows)
    shard_vecs: np.ndarray         # [n_shards, dim] float32
    doc_vecs: Optional[np.ndarray]  # [n_docs, dim] or None
    planes: np.ndarray             # [bits, dim] LSH hyperplanes
    word_sig: np.ndarray           # [V, bits//32] uint32
    shard_sig: np.ndarray          # [n_shards, bits//32] uint32
    doc_sig: Optional[np.ndarray]  # [n_docs, bits//32] uint32 or None
    bits: int
    doc_freq: np.ndarray           # [V] int64 document frequency (BM25)
    n_docs: int
    avg_doc_len: float
    use_lsh: bool = True           # False = score with real-valued vectors
    # "asym": stored side quantized, query side real; "sym": two-sided
    # Hamming (the paper's mode)
    lsh_mode: str = "asym"
    # "shard": paper Eq 10 (one vector per shard);  "doc": doc-granular
    # scoring (see shard_similarities)
    granularity: str = "shard"
    _doc_shard_ids: Optional[np.ndarray] = None  # doc_id -> shard_id
    # similarities are exp(beta * cos); must match the temperature the
    # embedding model was trained with
    temperature: float = 1.0
    # the joint word/doc mean subtracted by build_index(center=True)
    center_mean: Optional[np.ndarray] = None
    # where scoring runs: CUDA unless the caller asks for the CPU
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------
    # content generation
    # ------------------------------------------------------------------
    @property
    def clock(self) -> GenerationClock:
        """The generation authority this index bumps its *content* axis
        through.  Lazily a private clock so a standalone index works
        un-wired.  Kept off the dataclass fields: it is identity state,
        not index content — ``dataclasses.replace`` and save/load must
        not carry it."""
        c = getattr(self, "_gen_clock", None)
        if c is None:
            c = GenerationClock()
            object.__setattr__(self, "_gen_clock", c)
        return c

    # ------------------------------------------------------------------
    # device-resident operands
    # ------------------------------------------------------------------
    def _device_cache(self) -> Dict[str, torch.Tensor]:
        dev = getattr(self, "_dev", None)
        if dev is None:
            dev = {}
            object.__setattr__(self, "_dev", dev)
        return dev

    def _device_planes(self) -> torch.Tensor:
        dev = self._device_cache()
        if "planes" not in dev:
            dev["planes"] = torch.as_tensor(
                np.asarray(self.planes, np.float32), device=self.device)
        return dev["planes"]

    def _device_sig(self, target_sig: np.ndarray, role: str) -> torch.Tensor:
        """``target_sig`` on the device, uploaded once per role ("shard"
        | "doc" | "word") — re-uploading a signature set per batch would
        push it host->device every serving window."""
        dev = self._device_cache()
        key = f"{role}_sig"
        if key not in dev:
            dev[key] = lsh_mod.to_packed_tensor(target_sig, self.device)
        return dev[key]

    def _fused_device_arrays(self) -> Dict[str, torch.Tensor]:
        """Operands of the fused segment sum, uploaded once and cached:
        the planes, the shard-sorted doc signatures ``sig``, their int32
        shard slots ``seg`` and the int32 CSR offsets [n_shards + 1]
        delimiting each shard's rows."""
        dev = self._device_cache()
        if "sig" not in dev:
            _, _, counts, seg_sorted, sig_sorted = self._shard_sorted_docs()
            offsets = np.zeros(counts.shape[0] + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            if offsets[-1] > np.iinfo(np.int32).max:
                raise ValueError(f"too many docs for int32 offsets: "
                                 f"{offsets[-1]}")
            dev["sig"] = lsh_mod.to_packed_tensor(sig_sorted, self.device)
            dev["seg"] = torch.as_tensor(seg_sorted, device=self.device)
            dev["offsets"] = torch.as_tensor(offsets.astype(np.int32),
                                             device=self.device)
        self._device_planes()
        return dev

    # ------------------------------------------------------------------
    # query-time scoring
    # ------------------------------------------------------------------
    def query_vector(self, word_ids: Sequence[int]) -> np.ndarray:
        """q = sum of word vectors (paper Sec. III)."""
        q = self.word_vecs[np.asarray(list(word_ids), np.int64)].sum(axis=0)
        return q

    def _exp_sim(self, vec: np.ndarray, target_sig: np.ndarray,
                 target_vecs: np.ndarray, role: str) -> np.ndarray:
        """exp(beta * cos) similarity of one vector against a signed set."""
        return self._exp_sim_batch(np.asarray(vec)[None, :], target_sig,
                                   target_vecs, role)[0]

    def _exp_sim_batch(self, vecs: np.ndarray, target_sig: np.ndarray,
                       target_vecs: np.ndarray, role: str) -> np.ndarray:
        """exp(beta * cos) of a [B, dim] query block against a signed
        set; returns [B, M] float64.  On CUDA the block is scored in one
        launch of the similarity kernel of the LSH mode."""
        vecs = np.atleast_2d(np.asarray(vecs))
        if self.use_lsh:
            return self._lsh_sims(vecs, target_sig, role).cpu().numpy(
            ).astype(np.float64)
        q = np.asarray(vecs, np.float64)
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)
        return np.exp(self.temperature * (q @ target_vecs.astype(np.float64).T))

    def _lsh_sims(self, vecs: np.ndarray, target_sig: np.ndarray,
                  role: str) -> torch.Tensor:
        """[B, M] float32 LSH exp-similarities on the device: asym
        through ``kernels/asym``, sym through ``kernels/hamming`` on the
        host-signed query signatures."""
        if self.lsh_mode == "asym":
            from repro_torch.kernels.asym import ops as asym_ops
            return asym_ops.asym_exp_similarity(
                torch.as_tensor(np.asarray(vecs, np.float32),
                                device=self.device),
                self._device_sig(target_sig, role),
                self._device_planes(), self.bits,
                temperature=self.temperature)
        from repro_torch.kernels.hamming import ops as hamming_ops
        return hamming_ops.hamming_similarity(
            self.query_sig_tensor(vecs), self._device_sig(target_sig, role),
            self.bits, temperature=self.temperature)

    def query_sig_tensor(self, vecs: np.ndarray) -> torch.Tensor:
        """Sym mode: [B, bits//32] packed query signatures on the device,
        signed by ``lsh.sign_tensor`` so the CUDA and the CPU index see
        the same bits."""
        return lsh_mod.sign_tensor(vecs, self._device_planes())

    def _doc_granular(self) -> bool:
        return self.granularity == "doc" and (
            self.doc_sig is not None or self.doc_vecs is not None)

    def shard_similarities(self, query_word_ids: Sequence[int]) -> np.ndarray:
        """Similarity of the query to every shard.

        ``granularity='shard'`` is the paper's Eq 10: exp(q . s_bar) with
        s_bar the mean doc vector.  ``granularity='doc'`` sums
        exp(beta cos(q, d)) over member documents — proportional to the
        expected count sum_d |d| p(q|d) the pps sampler wants."""
        if self._doc_granular():
            doc_sims = self._exp_sim(self.query_vector(query_word_ids),
                                     self.doc_sig, self.doc_vecs, "doc")
            return self._sum_docs_to_shards(doc_sims)
        return self._exp_sim(self.query_vector(query_word_ids),
                             self.shard_sig, self.shard_vecs, "shard")

    def query_vectors(self, queries: Sequence[Sequence[int]]) -> np.ndarray:
        """[B, dim] stack of query vectors (sum of word vectors each)."""
        return np.stack([self.query_vector(q) for q in queries])

    def query_signatures(self, vecs: np.ndarray) -> np.ndarray:
        """[B, bits//32] packed uint32 LSH signatures for query vectors
        under the index's own hyperplanes, on the numpy path — the key
        material for the semantic query cache (``runtime/qcache``)."""
        return lsh_mod.sign_vectors_np(vecs, self.planes)

    def shard_similarities_batch(
            self, queries: Sequence[Sequence[int]], *,
            fused: bool = True) -> np.ndarray:
        """[B, n_shards] similarity of every query to every shard in one
        scoring pass.  ``fused=True`` (default) routes doc-granular LSH
        scoring through the fused segment sum, so the [B, n_docs]
        intermediate never reaches device memory; ``fused=False`` keeps
        the unfused ``_exp_sim_batch`` + numpy reduce route (the parity
        reference)."""
        return self._shard_sims_from_vectors(self.query_vectors(queries),
                                             fused=fused)

    def _shard_sims_from_vectors(self, vecs: np.ndarray, *,
                                 fused: bool = True) -> np.ndarray:
        if not self._doc_granular():
            return self._exp_sim_batch(vecs, self.shard_sig,
                                       self.shard_vecs, "shard")
        if (fused and self.use_lsh and self.doc_sig is not None
                and self._doc_shard_ids is not None):
            return self._fused_doc_shard_sims_batch(vecs)
        doc_sims = self._exp_sim_batch(vecs, self.doc_sig,
                                       self.doc_vecs, "doc")
        return self._sum_docs_to_shards_batch(doc_sims)

    def _fused_doc_shard_sims_batch(self, vecs: np.ndarray) -> np.ndarray:
        """[B, n_shards] via the fused segment sum of the LSH mode over
        the cached shard-sorted doc signatures and CSR offsets."""
        vecs = np.atleast_2d(np.asarray(vecs))
        dev = self._fused_device_arrays()
        if self.lsh_mode == "asym":
            from repro_torch.kernels.asym import ops as asym_ops
            out = asym_ops.asym_exp_segment_sum_csr(
                torch.as_tensor(np.asarray(vecs, np.float32),
                                device=self.device),
                dev["sig"], dev["planes"], self.bits, dev["offsets"],
                temperature=self.temperature)
        else:
            from repro_torch.kernels.hamming import ops as hamming_ops
            out = hamming_ops.hamming_segment_similarity_csr(
                self.query_sig_tensor(vecs), dev["sig"], self.bits,
                dev["offsets"], temperature=self.temperature)
        return out.cpu().numpy().astype(np.float64)

    def topk_doc_similarities_batch(
            self, queries: Sequence[Sequence[int]], k: int = 10, *,
            fused: bool = True) -> "tuple[np.ndarray, np.ndarray]":
        """Ranked retrieval over *documents*: ([B, k] int64 doc indices,
        [B, k] float64 exp-similarities), rows descending, ties to the
        lowest doc index, k = min(k, n_docs).

        ``fused=True`` on an asym LSH index runs the fused top-k (only
        per-tile candidates leave the kernel).  Otherwise — sym mode,
        as in the reference, or ``fused=False`` — the [B, n_docs]
        matrix is scored unfused and stably sorted, on the device for
        an LSH index: the parity reference."""
        if self.doc_sig is None and self.doc_vecs is None:
            raise ValueError("index was built without document vectors")
        vecs = np.atleast_2d(self.query_vectors(queries))
        if not (self.use_lsh and self.doc_sig is not None):
            sims = self._exp_sim_batch(vecs, self.doc_sig, self.doc_vecs,
                                       "doc")
            k = min(int(k), sims.shape[1])
            idx = np.argsort(-sims, axis=1, kind="stable")[:, :k]
            return idx.astype(np.int64), np.take_along_axis(sims, idx, axis=1)
        if fused and self.lsh_mode == "asym":
            from repro_torch.kernels.asym import ops as asym_ops
            idx, vals = asym_ops.asym_exp_topk(
                torch.as_tensor(np.asarray(vecs, np.float32),
                                device=self.device),
                self._device_sig(self.doc_sig, "doc"),
                self._device_planes(), self.bits, k,
                temperature=self.temperature)
        else:
            sims = self._lsh_sims(vecs, self.doc_sig, "doc")
            k = min(int(k), sims.shape[1])
            vals, idx = torch.sort(sims, dim=1, descending=True, stable=True)
            idx, vals = idx[:, :k], vals[:, :k]
        return (idx.cpu().numpy().astype(np.int64),
                vals.cpu().numpy().astype(np.float64))

    def word_shard_similarities_batch(
            self, word_ids: Sequence[int]) -> np.ndarray:
        """[n_words, n_shards] per-word p(w|s) rows in one pass — lets a
        batch of Boolean queries score all their distinct words at once
        before applying the AND->product / OR->sum algebra."""
        ids = np.asarray(list(word_ids), np.int64)
        return self._exp_sim_batch(self.word_vecs[ids], self.shard_sig,
                                   self.shard_vecs, "shard")

    def _sum_docs_to_shards(self, doc_values: np.ndarray) -> np.ndarray:
        if self._doc_shard_ids is None:
            raise ValueError("doc-granular scoring requires attach_corpus()")
        out = np.zeros(self.shard_vecs.shape[0], np.float64)
        np.add.at(out, self._doc_shard_ids, doc_values)
        return out

    def _shard_sorted_docs(self):
        """Cached shard-sort structures for doc->shard reductions:
        (order, starts, counts, seg_sorted, sig_sorted) where ``order``
        permutes docs into shard-contiguous position, ``starts``/
        ``counts`` delimit each shard's segment in that order,
        ``seg_sorted`` is the int32 shard slot per sorted doc, and
        ``sig_sorted`` the doc signatures in sorted order (None when
        the index carries no doc signatures)."""
        if self._doc_shard_ids is None:
            raise ValueError("doc-granular scoring requires attach_corpus()")
        cache = getattr(self, "_shard_sort", None)
        if cache is None:
            ids = np.asarray(self._doc_shard_ids, np.int64)
            n_shards = self.shard_vecs.shape[0]
            order = np.argsort(ids, kind="stable")
            counts = np.bincount(ids, minlength=n_shards)
            starts = np.zeros(n_shards, np.int64)
            np.cumsum(counts[:-1], out=starts[1:])
            seg_sorted = ids[order].astype(np.int32)
            sig_sorted = (self.doc_sig[order]
                          if self.doc_sig is not None else None)
            cache = (order, starts, counts, seg_sorted, sig_sorted)
            object.__setattr__(self, "_shard_sort", cache)
        return cache

    def _sum_docs_to_shards_batch(self, doc_values: np.ndarray) -> np.ndarray:
        """[B, n_docs] -> [B, n_shards] row-wise scatter-add as one
        ``np.add.reduceat`` over shard-sorted doc order.  reduceat
        mis-handles empty segments, so it runs only at the starts of
        non-empty shards and the empty shards stay zero."""
        order, starts, counts, _, _ = self._shard_sorted_docs()
        doc_values = np.atleast_2d(doc_values)
        n_docs = doc_values.shape[1]
        out = np.zeros((doc_values.shape[0], counts.shape[0]), np.float64)
        nonempty = counts > 0
        if n_docs == 0 or doc_values.shape[0] == 0 or not nonempty.any():
            return out
        vals = np.ascontiguousarray(doc_values[:, order])
        out[:, nonempty] = np.add.reduceat(vals, starts[nonempty], axis=1)
        return out

    def megascan_payload(self, shard_ids, *, tm: int = 256):
        """Block-aligned packed signature payload for the one-launch
        megascan (``kernels/megascan``) on this index's device: the
        named shards' shard-sorted doc signatures, each padded
        independently to TM-row blocks and concatenated, with row ->
        shard-slot and row -> doc-id maps.  Cached per ``(shard_ids, tm,
        content generation)``: the serving path re-scans the same shard
        groups every window, and the payload must not be re-uploaded
        per batch; ``attach_corpus`` bumps the content generation and
        drops the cache."""
        if self.doc_sig is None:
            raise ValueError("megascan requires doc signatures")
        from repro_torch.kernels.megascan import ops as mega_ops
        ids = tuple(int(s) for s in shard_ids)
        key = (ids, int(tm), self.clock.current().content)
        with _PAYLOAD_LOCK:      # the executor's workers call in parallel
            cache = getattr(self, "_megascan_pay", None)
            if cache is None:
                cache = {}
                object.__setattr__(self, "_megascan_pay", cache)
            payload = cache.get(key)
            if payload is None:
                order, starts, counts, _, sig = self._shard_sorted_docs()
                segments = [(sig[starts[s]:starts[s] + counts[s]],
                             order[starts[s]:starts[s] + counts[s]])
                            for s in ids]
                payload = mega_ops.build_payload(
                    segments, tm=tm, shard_ids=ids, device=self.device)
                cache[key] = payload
            return payload

    def attach_corpus(self, corpus) -> "ApproxIndex":
        """Record the doc->shard map (needed for doc-granular scoring).
        Drops the shard-sort, device-operand and megascan-payload caches
        — all derive from the map — and bumps the *content* generation:
        anything keyed on what this index answers from is stale the
        moment a new corpus attaches."""
        self._doc_shard_ids = corpus.doc_shard_map()
        for cached in ("_shard_sort", "_dev", "_megascan_pay"):
            if hasattr(self, cached):
                object.__delattr__(self, cached)
        self.clock.bump_content()
        return self

    def shard_probabilities(self, query_word_ids: Sequence[int]) -> np.ndarray:
        """phi_s(q) (paper Eq 11)."""
        return similarity_probabilities(self.shard_similarities(query_word_ids))

    def word_shard_similarity(self, word_id: int) -> np.ndarray:
        """p(w|s) up to constant for a single word (Boolean retrieval)."""
        return self._exp_sim(self.word_vecs[word_id], self.shard_sig,
                             self.shard_vecs, "shard")

    # ------------------------------------------------------------------
    # persistence: the JAX package's npz format, both ways
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = dict(
            word_vecs=self.word_vecs, shard_vecs=self.shard_vecs,
            planes=self.planes, word_sig=self.word_sig, shard_sig=self.shard_sig,
            doc_freq=self.doc_freq,
            meta=np.asarray(json.dumps(dict(
                bits=self.bits, n_docs=self.n_docs, avg_doc_len=self.avg_doc_len,
                use_lsh=self.use_lsh, has_docs=self.doc_vecs is not None,
                temperature=self.temperature, lsh_mode=self.lsh_mode,
                # the JAX package's routing flag: this index always
                # scores through its kernels
                use_kernel=True, granularity=self.granularity,
                has_doc_shard_ids=self._doc_shard_ids is not None,
                has_center_mean=self.center_mean is not None,
            ))),
        )
        if self.doc_vecs is not None:
            payload["doc_vecs"] = self.doc_vecs
            payload["doc_sig"] = self.doc_sig
        if self._doc_shard_ids is not None:
            payload["doc_shard_ids"] = np.asarray(self._doc_shard_ids, np.int64)
        if self.center_mean is not None:
            payload["center_mean"] = np.asarray(self.center_mean, np.float32)
        atomic_savez(path, **payload)

    @staticmethod
    def from_arrays(arrays: Dict[str, np.ndarray], meta: Dict[str, Any], *,
                    device: Any = "cuda") -> "ApproxIndex":
        """An index from the npz payload's arrays and its ``meta`` dict
        (the fields ``ApproxIndex.save`` writes, in either package).
        ``meta["use_kernel"]`` is not read: ``device`` picks the route."""
        return ApproxIndex(
            word_vecs=arrays["word_vecs"], shard_vecs=arrays["shard_vecs"],
            doc_vecs=arrays["doc_vecs"] if meta["has_docs"] else None,
            planes=arrays["planes"], word_sig=arrays["word_sig"],
            shard_sig=arrays["shard_sig"],
            doc_sig=arrays["doc_sig"] if meta["has_docs"] else None,
            bits=meta["bits"], doc_freq=arrays["doc_freq"],
            n_docs=meta["n_docs"], avg_doc_len=meta["avg_doc_len"],
            use_lsh=meta["use_lsh"],
            temperature=meta.get("temperature", 1.0),
            lsh_mode=meta.get("lsh_mode", "sym"),
            granularity=meta.get("granularity", "shard"),
            _doc_shard_ids=(arrays["doc_shard_ids"]
                            if meta.get("has_doc_shard_ids") else None),
            center_mean=(arrays["center_mean"]
                         if meta.get("has_center_mean") else None),
            device=device,
        )

    @staticmethod
    def load(path: str, *, device: Any = "cuda") -> "ApproxIndex":
        """Read a file written by ``save`` (this package's or the JAX
        package's)."""
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files if k != "meta"}
            meta = json.loads(str(z["meta"]))
        return ApproxIndex.from_arrays(arrays, meta, device=device)

# ----------------------------------------------------------------------
# index build (paper Fig. 2 step p2)
# ----------------------------------------------------------------------
_SIGN_CHUNK = 1 << 18      # rows signed per device pass


def _doc_frequency(corpus: ShardedCorpus) -> np.ndarray:
    """Documents containing each word: per shard, the distinct
    (local doc, word) pairs, counted per word."""
    v = corpus.vocab_size
    df = np.zeros(v, np.int64)
    for shard in corpus.shards:
        if shard.n_tokens == 0:
            continue
        doc_of = np.repeat(np.arange(shard.n_docs, dtype=np.int64),
                           np.diff(shard.offsets))
        pairs = np.unique(doc_of * v + shard.tokens.astype(np.int64))
        df += np.bincount(pairs % v, minlength=v)
    return df


def _center_and_unit(x: np.ndarray, mean: np.ndarray) -> np.ndarray:
    y = x - mean
    n = np.linalg.norm(y, axis=-1, keepdims=True)
    return (y / np.maximum(n, 1e-8)).astype(np.float32)


def shard_vectors(doc_vecs: np.ndarray, corpus: ShardedCorpus) -> np.ndarray:
    """Paper Sec. III-A: subcollection vector = arithmetic mean of member
    document vectors (zero for an empty shard)."""
    dv = np.asarray(doc_vecs)
    out = [dv[s.doc_ids].mean(axis=0) if s.n_docs
           else np.zeros(dv.shape[1], dv.dtype) for s in corpus.shards]
    return np.stack(out).astype(np.float32)


def _host_f32(x) -> np.ndarray:
    """A float32 numpy copy of an array or of a tensor on any device."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _sign_rows(x: np.ndarray, planes: torch.Tensor) -> np.ndarray:
    """[N, dim] vectors -> [N, bits//32] uint32 packed signatures under
    ``planes``, computed on the planes' device in row chunks."""
    out = []
    for lo in range(0, x.shape[0], _SIGN_CHUNK):
        xs = torch.as_tensor(np.asarray(x[lo:lo + _SIGN_CHUNK], np.float32),
                             device=planes.device)
        out.append(lsh_mod.to_numpy_u32(
            lsh_mod.pack_bits(lsh_mod.signature_bits(xs, planes))))
    if not out:
        return np.zeros((0, planes.shape[0] // 32), np.uint32)
    return np.concatenate(out)


def build_index(
    corpus: ShardedCorpus,
    model,
    lsh_cfg: Optional[lsh_mod.LSHConfig] = None,
    *,
    keep_doc_vectors: bool = True,
    use_lsh: bool = True,
    center: bool = True,
    temperature: float = 8.0,   # must match the model's training temperature
    lsh_mode: str = "asym",
    granularity: str = "shard",
    planes: Optional[np.ndarray] = None,
    device: Any = "cuda",
) -> ApproxIndex:
    """Paper Fig. 2 step p2: compose shard vectors, hash everything.

    ``model`` is any object with ``word_vecs`` [V, dim] and ``doc_vecs``
    [n_docs, dim] arrays or tensors on any device (a trained
    ``core.pv_dbow.PVDBOWModel`` on the card, the JAX package's model).
    ``center`` subtracts the joint word/doc mean before re-normalizing
    (the all-but-the-top style post-process the JAX package applies);
    False is the strictly paper-faithful ablation.  ``planes`` [bits, dim] overrides the hyperplanes drawn
    from ``lsh_cfg.seed`` (see ``core/lsh.py`` on why the two packages
    draw different planes from one seed)."""
    dev = resolve_device(device)
    lsh_cfg = lsh_cfg or lsh_mod.LSHConfig()
    word_vecs = _host_f32(model.word_vecs)
    doc_vecs = _host_f32(model.doc_vecs)
    mean = None
    if center:
        mean = 0.5 * (word_vecs.mean(axis=0) + doc_vecs.mean(axis=0))
        word_vecs = _center_and_unit(word_vecs, mean)
        doc_vecs = _center_and_unit(doc_vecs, mean)
    shards = shard_vectors(doc_vecs, corpus)

    if planes is None:
        planes_t = lsh_mod.hyperplanes(lsh_cfg, word_vecs.shape[1], dev)
    else:
        planes_t = torch.tensor(np.asarray(planes, np.float32), device=dev)
    if planes_t.shape != (lsh_cfg.bits, word_vecs.shape[1]):
        raise ValueError(f"planes must be [{lsh_cfg.bits}, "
                         f"{word_vecs.shape[1]}], got {tuple(planes_t.shape)}")

    total_tokens = corpus.n_tokens
    return ApproxIndex(
        word_vecs=word_vecs,
        shard_vecs=shards,
        doc_vecs=doc_vecs if keep_doc_vectors else None,
        planes=planes_t.cpu().numpy(),
        word_sig=_sign_rows(word_vecs, planes_t),
        shard_sig=_sign_rows(shards, planes_t),
        doc_sig=_sign_rows(doc_vecs, planes_t) if keep_doc_vectors else None,
        bits=lsh_cfg.bits,
        doc_freq=_doc_frequency(corpus),
        n_docs=corpus.n_docs,
        avg_doc_len=total_tokens / max(corpus.n_docs, 1),
        use_lsh=use_lsh,
        temperature=temperature,
        lsh_mode=lsh_mode,
        granularity=granularity,
        _doc_shard_ids=corpus.doc_shard_map() if granularity == "doc" else None,
        center_mean=mean,
        device=dev,
    )
