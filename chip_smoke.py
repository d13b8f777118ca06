#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--n-docs 1048576]

Phases, each of which raises (exit code not 0) on any failure:

  1. device   — the card's name and power limit (nvidia-smi); no GPU
                means exit code 2 and no result.
  2. build    — every CUDA source under src/repro_torch/csrc, one nvcc
                each, all started together.
  3. kernels  — each kernel against its plain PyTorch version at the
                reference's test shapes (ragged M, B past a query tile,
                empty, unsorted and padding segments), rtol=1e-4, and
                bitwise equal from run to run.
  4. small    — a small corpus served through the CUDA index and
                through the same index on the CPU (plain versions):
                probability rows agree (rtol=1e-4), census counts are
                the exact counts.
  5. serving  — the main path at full width (the EmApprox config: dim
                64, bits 256, beta 8, vocab 4096, 16 topics, 4096-token
                shards) over n_docs documents: a synthetic corpus from
                --seed, a stand-in model with no training (doc vectors
                = topic weights @ a Gaussian [16, 64] + noise; word
                vectors = count-weighted mean of their documents'
                vectors), ``build_index(granularity="doc")`` with the
                kernels on, and ``QueryBatch`` over a
                ``ShardTaskExecutor`` serving 3 batches of 48 mixed
                count / Boolean / ranked queries at rate 0.05.  The
                launch counters are zeroed just before and read just
                after; both kernels must have launched.  Every batch's
                probability rows are held against the plain path on the
                same vectors (rtol=1e-4).
  6. timing   — each kernel at the shapes the main path gave it,
                CUDA-event median of 25, beside its plain version and
                its bound (the larger of bytes / 3.35 TB/s and fp32
                operations / 67 TFLOP/s, the H100 SXM peaks; operations
                are those of the least-work, table-lookup algorithm,
                see ``least_ops``).

The last three lines of standard output are the card line, the
``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_FP32_FLOPS = 67e12        # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
RTOL = 1e-4
TEST_SHAPES = [  # (B, M, S, dim, bits, beta), the reference's kernel tests
    (1, 7, 3, 24, 128, 1.0), (5, 613, 37, 48, 128, 8.0),
    (9, 300, 128, 32, 64, 4.0), (3, 1000, 5, 48, 256, 8.0),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Assert got ~= want (rtol=1e-4); returns the max abs error."""
    torch.testing.assert_close(got, want.to(got.dtype), rtol=RTOL,
                               atol=1e-6, msg=lambda m: f"{what}: {m}")
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def same(got: torch.Tensor, again: torch.Tensor, what: str) -> None:
    """Assert two launches on the same inputs gave bitwise equal output."""
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: not bitwise repeatable run to run")


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def least_ops(b: int, m: int, bits: int, dim: int, per_row: int, *,
              bit_serial: bool = False) -> float:
    """fp32 operations of the least-work way to compute the asym scores
    of B queries against M packed rows.  A ±1 dot product with the
    projection p is a sum of table entries: per query, each 8-bit chunk
    of the signature indexes a table of the 256 signed sums of its 8
    projections.  That is the projection (2·B·bits·dim), the tables
    (B·bits/8·256 adds) and, per (query, row), bits/8 table adds plus
    ``per_row`` more (clip, exp and, for the segment sum, its add).
    ``bit_serial`` counts the bit-by-bit FMA instead (2·B·M·bits)."""
    if bit_serial:
        return 2.0 * b * m * bits + 2.0 * b * bits * dim
    return (2.0 * b * bits * dim + b * (bits // 8) * 256.0
            + b * m * (bits / 8 + per_row))


def bound(ops: float, nbytes: float) -> "tuple[float, str]":
    """(bound_ms, bound_by): the larger of ``ops`` over the fp32 peak
    and ``nbytes`` over the HBM rate."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                        else "bytes")


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions at the test shapes
# ----------------------------------------------------------------------
def kernel_phase(dev: torch.device) -> None:
    from repro_torch.core import lsh
    from repro_torch.kernels.asym import ops, ref

    for b, m, s, dim, bits, beta in TEST_SHAPES:
        rng = np.random.default_rng(b * 100 + m)
        q = torch.from_numpy(rng.normal(size=(b, dim)).astype(np.float32)).to(dev)
        x = torch.from_numpy(rng.normal(size=(m, dim)).astype(np.float32)).to(dev)
        planes = lsh.hyperplanes(lsh.LSHConfig(bits=bits), dim, dev)
        db = lsh.pack_bits(lsh.signature_bits(x, planes))
        sim = ops.asym_exp_similarity(q, db, planes, bits, temperature=beta)
        same(sim, ops.asym_exp_similarity(q, db, planes, bits,
                                          temperature=beta),
             f"similarity {b}x{m}")
        close(sim, ref.asym_exp_similarity_ref(q, db, planes, bits, beta),
              f"similarity {b}x{m}")
        for name, seg in (
                ("sorted", np.sort(rng.integers(0, s, m))),
                ("unsorted+padding", rng.integers(-1, s + 3, m)),
                ("one segment", np.full(m, s // 2))):
            seg_t = torch.from_numpy(seg.astype(np.int32)).to(dev)
            got = ops.asym_exp_segment_sum(q, db, planes, bits, seg_t, s,
                                           temperature=beta)
            same(got, ops.asym_exp_segment_sum(q, db, planes, bits, seg_t,
                                               s, temperature=beta),
                 f"segment sum {b}x{m} {name}")
            want = ref.asym_exp_segment_sum_ref(q, db, planes, bits, seg_t,
                                                s, beta)
            close(got, want, f"segment sum {b}x{m}x{s} {name}")
            occupied = np.zeros(s, bool)
            occupied[seg[(seg >= 0) & (seg < s)]] = True
            if bool((got[:, torch.from_numpy(~occupied).to(dev)] != 0).any()):
                raise AssertionError("an empty segment is not exactly zero")
        log(f"   kernels ok at B={b} M={m} S={s} dim={dim} bits={bits}")


# ----------------------------------------------------------------------
# the stand-in model and the corpus
# ----------------------------------------------------------------------
@dataclasses.dataclass
class StandInModel:
    word_vecs: np.ndarray
    doc_vecs: np.ndarray


def stand_in_model(corpus, doc_topics: np.ndarray, dim: int, seed: int,
                   dev: torch.device, chunk: int = 1 << 22) -> StandInModel:
    """Doc vectors = topic weights @ E + small noise (E [n_topics, dim]
    Gaussian); word vectors = each word's count-weighted mean of the
    vectors of the documents it occurs in.  No training."""
    rng = np.random.default_rng(seed + 1)
    e = rng.normal(size=(doc_topics.shape[1], dim))
    doc_vecs = (doc_topics @ e
                + 0.05 * rng.normal(size=(doc_topics.shape[0], dim)))
    tokens = torch.from_numpy(np.concatenate([s.tokens for s in corpus.shards]))
    doc_of = torch.repeat_interleave(
        torch.from_numpy(np.concatenate([s.doc_ids for s in corpus.shards])),
        torch.from_numpy(np.concatenate([np.diff(s.offsets)
                                         for s in corpus.shards])))
    dv = torch.from_numpy(doc_vecs).to(dev)
    acc = torch.zeros((corpus.vocab_size, dim), dtype=torch.float64, device=dev)
    cnt = torch.zeros(corpus.vocab_size, dtype=torch.float64, device=dev)
    for lo in range(0, tokens.shape[0], chunk):
        tok = tokens[lo:lo + chunk].to(dev, torch.int64)
        acc.index_add_(0, tok, dv[doc_of[lo:lo + chunk].to(dev)])
        cnt.index_add_(0, tok, torch.ones_like(tok, dtype=torch.float64))
    word_vecs = (acc / cnt.clamp(min=1.0)[:, None]).cpu().numpy()
    return StandInModel(word_vecs.astype(np.float32), doc_vecs.astype(np.float32))


def make_queries(tokens_per_word: np.ndarray, n: int, rng, scale: float):
    """Mixed count / Boolean / ranked queries, 1:1:1, drawn as the JAX
    package's examples/serve_queries.py draws them: three distinct
    mid-frequency words each (its count window, scaled to the corpus)."""
    from repro_torch.core.queries import BatchQuery, parse_boolean
    cand = np.nonzero((tokens_per_word > 50 * scale)
                      & (tokens_per_word < 1200 * scale))[0]
    if cand.shape[0] < 3:
        raise AssertionError(f"only {cand.shape[0]} candidate query words")
    out = []
    for i in range(n):
        words = rng.choice(cand, 3, replace=False).astype(int)
        if i % 3 == 0:
            out.append(BatchQuery.count([int(words[0])]))
        elif i % 3 == 1:
            out.append(BatchQuery.boolean(parse_boolean(
                [int(words[0]), "or", int(words[1]), "and", int(words[2])])))
        else:
            out.append(BatchQuery.ranked(words.tolist(), k=10))
    return out


def build_served_index(n_docs: int, seed: int, dev: torch.device,
                       timings: dict):
    from repro_torch.core.index import build_index
    from repro_torch.core.lsh import LSHConfig
    from repro_torch.data.corpus import SyntheticCorpusConfig, generate_text_corpus
    from repro_torch.data.store import ShardedCorpus

    t = time.perf_counter()
    ccfg = SyntheticCorpusConfig(n_docs=n_docs, vocab_size=4096, n_topics=16,
                                 seed=seed)
    docs, doc_topics = generate_text_corpus(ccfg)
    timings["corpus_s"] = time.perf_counter() - t
    t = time.perf_counter()
    corpus = ShardedCorpus.from_documents(docs, ccfg.vocab_size,
                                          shard_tokens=4096)
    del docs
    timings["shard_s"] = time.perf_counter() - t
    t = time.perf_counter()
    model = stand_in_model(corpus, doc_topics, 64, seed, dev)
    timings["model_s"] = time.perf_counter() - t
    t = time.perf_counter()
    index = build_index(corpus, model, LSHConfig(bits=256), temperature=8.0,
                        granularity="doc", device=dev)
    index.attach_corpus(corpus)
    index._fused_device_arrays()
    torch.cuda.synchronize()
    timings["index_s"] = time.perf_counter() - t
    return ccfg, corpus, index


# ----------------------------------------------------------------------
# the plain path on the same vectors
# ----------------------------------------------------------------------
def plain_rows(index, queries):
    """Probability rows of ``queries`` computed with the plain PyTorch
    versions on the card (the unfused [B, n_docs] matrix, then a
    scatter-add), following the engine's planning algebra."""
    from repro_torch.core.sampling import similarity_probabilities
    from repro_torch.kernels.asym import ref

    dev = index._fused_device_arrays()
    n_shards = index.shard_vecs.shape[0]
    rows = [None] * len(queries)
    vec_pos = [i for i, q in enumerate(queries) if q.kind != "bool"]
    if vec_pos:
        vecs = torch.as_tensor(index.query_vectors(
            [queries[i].word_ids() for i in vec_pos]), device=index.device)
        sims = ref.asym_exp_segment_sum_ref(
            vecs, dev["sig"], dev["planes"], index.bits, dev["seg"],
            n_shards, index.temperature).cpu().numpy().astype(np.float64)
        for row, i in zip(sims, vec_pos):
            rows[i] = similarity_probabilities(row)
    bool_pos = [i for i, q in enumerate(queries) if q.kind == "bool"]
    if bool_pos:
        words = sorted({w for i in bool_pos for w in queries[i].expr.words()})
        wv = torch.as_tensor(index.word_vecs[np.asarray(words)],
                             device=index.device)
        sig = index._device_sig(index.shard_sig, "shard")
        w_rows = ref.asym_exp_similarity_ref(
            wv, sig, dev["planes"], index.bits,
            index.temperature).cpu().numpy().astype(np.float64)
        by_word = dict(zip(words, w_rows))

        def algebra(e):
            if e.op == "word":
                return by_word[e.word]
            a, b = algebra(e.left), algebra(e.right)
            return a * b if e.op == "and" else a + b

        for i in bool_pos:
            rows[i] = similarity_probabilities(algebra(queries[i].expr))
    return rows


def check_rows(got, want, what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not np.all(np.isfinite(g)):
            raise AssertionError(f"{what}: row {i} malformed")
        np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=f"{what} row {i}")
        if abs(float(g.sum()) - 1.0) > 1e-9:
            raise AssertionError(f"{what}: row {i} does not sum to 1")


# ----------------------------------------------------------------------
# phase 4: a small input through the CUDA and the CPU index
# ----------------------------------------------------------------------
def small_phase(dev: torch.device, seed: int) -> None:
    from repro_torch.core.queries import QueryBatch

    timings: dict = {}
    _, corpus, index = build_served_index(3000, seed, dev, timings)
    cpu_index = dataclasses.replace(index, device="cpu").attach_corpus(corpus)
    counts = np.bincount(np.concatenate([s.tokens for s in corpus.shards]),
                         minlength=corpus.vocab_size)
    queries = make_queries(counts, 24, np.random.default_rng(seed), 1.0)
    cuda_engine = QueryBatch(corpus, index)
    cpu_engine = QueryBatch(corpus, cpu_index)
    check_rows(cuda_engine._probability_rows(queries, corpus, index),
               cpu_engine._probability_rows(queries, corpus, cpu_index),
               "small input, CUDA vs CPU index")
    census = cuda_engine.execute(queries, 1.0)
    plain = cpu_engine.execute(queries, 1.0)
    for q, a, b in zip(queries, census, plain):
        if q.kind == "count":
            truth = float(corpus.count_phrase(q.phrase))
            if a.estimate.value != truth or b.estimate.value != truth:
                raise AssertionError("census count is not the exact count")
        else:
            np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
    log(f"   small input ok: {corpus.n_docs} docs, {corpus.n_shards} shards")


# ----------------------------------------------------------------------
# phase 5 + 6: the main path, then the kernels at its shapes
# ----------------------------------------------------------------------
def serve_phase(dev: torch.device, args) -> list:
    from repro_torch.core.queries import QueryBatch
    from repro_torch.kernels.asym import kernel as k
    from repro_torch.kernels.asym import ref
    from repro_torch.runtime.executor import ShardTaskExecutor

    timings: dict = {}
    ccfg, corpus, index = build_served_index(args.n_docs, args.seed, dev,
                                             timings)
    n_tokens = corpus.n_tokens
    log(f"   corpus: {corpus.n_docs} docs, {n_tokens} tokens, "
        f"{corpus.n_shards} shards; set-up s: "
        + ", ".join(f"{k_}={v:.2f}" for k_, v in timings.items()))
    counts = np.bincount(np.concatenate([s.tokens for s in corpus.shards]),
                         minlength=ccfg.vocab_size)
    # serve_queries.py's count window was set for its 3200-doc corpus
    queries = make_queries(counts, args.batches * args.batch,
                           np.random.default_rng(args.seed),
                           corpus.n_docs / 3200)

    seen = []
    with ShardTaskExecutor(workers=4, adaptive_workers=True) as ex:
        engine = QueryBatch(corpus, index, executor=ex)
        inner = engine._probability_rows

        def recording_rows(qs, c, i):
            t = time.perf_counter()
            rows = inner(qs, c, i)
            seen.append((list(qs), rows, time.perf_counter() - t))
            return rows

        engine._probability_rows = recording_rows
        k.asym_similarity_kernel.launches = 0
        k.asym_segment_sum_kernel.launches = 0
        walls, results = [], []
        for bi in range(args.batches):
            batch = queries[bi * args.batch:(bi + 1) * args.batch]
            t = time.perf_counter()
            res = engine.execute(batch, args.rate,
                                 rng=np.random.default_rng(args.seed + bi))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t, ex.last_job["wall_s"]))
            results.append((batch, res))
        launches = {"asym_exp_similarity": k.asym_similarity_kernel.launches,
                    "asym_exp_segment_sum": k.asym_segment_sum_kernel.launches}
    log(f"   launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")

    for bi, ((batch, res), (wall, scan_s)) in enumerate(zip(results, walls)):
        qs, rows, plan_s = seen[bi]
        check_rows(rows, plain_rows(index, qs), f"batch {bi}")
        est = []
        for q, r in zip(batch, res):
            if q.kind == "count":
                truth = float(counts[q.phrase[0]])
                e = r.estimate
                if not (math.isfinite(e.value) and e.value >= 0):
                    raise AssertionError(f"count estimate {e.value}")
                est.append(f"count w{q.phrase[0]}={e.value:.0f}"
                           f"±{e.error_bound:.0f} (true {truth:.0f})")
            elif q.kind == "bool":
                est.append(f"bool {len(r.doc_ids)} docs")
            else:
                if not np.all(np.isfinite(r.scores)) or len(r.doc_ids) > q.k:
                    raise AssertionError("malformed ranked result")
                est.append(f"ranked top {r.doc_ids[:3].tolist()}")
        log(f"   batch {bi}: {len(batch)} queries at rate {args.rate}, "
            f"wall {wall:.3f} s (planning {plan_s:.3f} s, shared scan "
            f"{scan_s:.3f} s), shards read "
            f"{sum(r.shards_read for r in res)}; rows match the plain path")
        log("      " + "; ".join(est[:6]))

    # ---- the kernels at the shapes the main path gave them ----
    batch, _ = results[0]
    dev_ops = index._fused_device_arrays()
    planes, bits, beta = dev_ops["planes"], index.bits, index.temperature
    dim = planes.shape[1]
    vec_q = [q for q in batch if q.kind != "bool"]
    vecs = torch.as_tensor(index.query_vectors([q.word_ids() for q in vec_q]),
                           device=dev)
    words = sorted({w for q in batch if q.kind == "bool"
                    for w in q.expr.words()})
    wvecs = torch.as_tensor(index.word_vecs[np.asarray(words)], device=dev)
    norm = lambda v: v / v.norm(dim=-1, keepdim=True).clamp(min=1e-9)  # noqa: E731
    sig, seg, offs = dev_ops["sig"], dev_ops["seg"], dev_ops["offsets"]
    shard_sig = index._device_sig(index.shard_sig, "shard")
    n_shards = index.shard_vecs.shape[0]
    w = sig.shape[1]
    kernels = []

    b, m = vecs.shape[0], sig.shape[0]
    got = k.asym_segment_sum_kernel(norm(vecs), planes, sig, offs, bits,
                                    temperature=beta)
    want = ref.asym_exp_segment_sum_ref(vecs, sig, planes, bits, seg,
                                        n_shards, beta)
    err = close(got, want, "segment sum at the serving shapes")
    same(got, k.asym_segment_sum_kernel(norm(vecs), planes, sig, offs, bits,
                                        temperature=beta),
         "segment sum at the serving shapes")
    qn = norm(vecs)
    nbytes = 4.0 * (m * w + (n_shards + 1) + b * dim + bits * dim
                    + b * n_shards)
    bound_ms, bound_by = bound(least_ops(b, m, bits, dim, 4), nbytes)
    serial_ms, _ = bound(least_ops(b, m, bits, dim, 0, bit_serial=True),
                         nbytes)
    log(f"   segment sum bound if bit-serial on CUDA cores: {serial_ms} ms")
    kernels.append(dict(
        name="asym_exp_segment_sum", route="cuda",
        source="src/repro_torch/csrc/asym.cu",
        replaces="src/repro/kernels/asym/kernel.py:191",
        launches=launches["asym_exp_segment_sum"], max_abs_err=err,
        ms=time_ms(lambda: k.asym_segment_sum_kernel(
            qn, planes, sig, offs, bits, temperature=beta)),
        plain_ms=time_ms(lambda: ref.asym_exp_segment_sum_ref(
            vecs, sig, planes, bits, seg, n_shards, beta)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    shapes = [dict(B=b, M=m, S=n_shards, dim=dim, bits=bits)]

    b, m = wvecs.shape[0], shard_sig.shape[0]
    wq = norm(wvecs)
    got = k.asym_similarity_kernel(wq, planes, shard_sig, bits,
                                   temperature=beta)
    want = ref.asym_exp_similarity_ref(wvecs, shard_sig, planes, bits, beta)
    err = close(got, want, "similarity at the serving shapes")
    same(got, k.asym_similarity_kernel(wq, planes, shard_sig, bits,
                                       temperature=beta),
         "similarity at the serving shapes")
    nbytes = 4.0 * (m * w + b * dim + bits * dim + b * m)
    bound_ms, bound_by = bound(least_ops(b, m, bits, dim, 3), nbytes)
    kernels.insert(0, dict(
        name="asym_exp_similarity", route="cuda",
        source="src/repro_torch/csrc/asym.cu",
        replaces="src/repro/kernels/asym/kernel.py:151",
        launches=launches["asym_exp_similarity"], max_abs_err=err,
        ms=time_ms(lambda: k.asym_similarity_kernel(
            wq, planes, shard_sig, bits, temperature=beta)),
        plain_ms=time_ms(lambda: ref.asym_exp_similarity_ref(
            wvecs, shard_sig, planes, bits, beta)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    shapes.insert(0, dict(B=b, M=m, dim=dim, bits=bits))
    for kr, shape in zip(kernels, shapes):
        log(f"   {kr['name']}: {kr['ms']:.4f} ms (plain {kr['plain_ms']:.4f} "
            f"ms, bound {kr['bound_ms']:.4f} ms by {kr['bound_by']}, max abs "
            f"err {kr['max_abs_err']:.3g}) at {shape}")
    return kernels


def main(argv=None) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-docs", type=int, default=1 << 20)
    p.add_argument("--batches", type=int, default=3)
    p.add_argument("--batch", type=int, default=48)
    p.add_argument("--rate", type=float, default=0.05)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import common

    t_all = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda")
    log(f"== device: {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    t = time.perf_counter()
    common.build_all()
    log(f"== build: {time.perf_counter() - t:.1f} s")
    log("== kernels vs plain versions at the reference's test shapes")
    kernel_phase(dev)
    log("== small input: CUDA index vs CPU index")
    small_phase(dev, args.seed)
    log(f"== serving: n_docs={args.n_docs}, {args.batches} batches of "
        f"{args.batch} at rate {args.rate}")
    kernels = serve_phase(dev, args)
    log(f"== done in {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
