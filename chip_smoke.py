#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--n-docs 1048576] [--build-docs 65536]

Phases, each of which raises (exit code not 0) on any failure:

  1. device   — the card's name and power limit (nvidia-smi); no GPU
                means exit code 2 and no result.
  2. build    — every CUDA source under src/repro_torch/csrc, one nvcc
                each, all started together.
  3. kernels  — each kernel against its plain PyTorch version at the
                reference's test shapes (ragged M, B past a query tile,
                empty, unsorted and padding segments), rtol=1e-4, and
                bitwise equal from run to run; the Hamming distance
                (row 4, which no engine path runs) exactly and the
                Hamming similarity bit for bit (one value table); the
                negative-sampling gradients (row 11) within rtol=1e-5,
                atol=1e-5 * t^2 (float32 dot products summed in another
                order, amplified by the temperature t), the k-means
                assignment (row 12) exactly, the first index on
                duplicated centroids; the top-k kernels' candidates (rows
                3, 9/10) also bit for bit equal to the oracle over the
                similarity kernel's scores, ties included.
  4. small    — a small corpus served through the CUDA index and
                through the same index on the CPU (plain versions), in
                asym and in sym mode: probability rows agree
                (rtol=1e-4), census counts are the exact counts.
  5. serving  — the main path at full width (the EmApprox config: dim
                64, bits 256, beta 8, vocab 4096, 16 topics, 4096-token
                shards) over n_docs documents: a synthetic corpus from
                --seed, a stand-in model with no training (doc vectors
                = topic weights @ a Gaussian [16, 64] + noise; word
                vectors = count-weighted mean of their documents'
                vectors), ``build_index(granularity="doc")`` with the
                kernels on, and ``QueryBatch`` over a
                ``ShardTaskExecutor`` serving a batch of 48 mixed
                count / Boolean / ranked queries at rate 0.05 on cold
                postings, then one of 12 on warm postings (cut from 3
                batches of 48: the host shard scan takes 15–380 s a full
                batch, and the run must stay well inside its 1200 s
                limit).  The launch counters are zeroed just before and
                read just after; both kernels must have launched.  Every batch's
                probability rows are held against the plain path on the
                same vectors (rtol=1e-4).
  6. timing   — each kernel at the shapes the main path gave it:
                ``ms``, the CUDA-event median of 25 calls from the host
                (dispatch included), and ``device_ms``, its device time
                (up to 100 launches replayed from one CUDA graph), beside
                its plain version and its bound (the larger of bytes /
                3.35 TB/s and fp32 operations / 67 TFLOP/s, the H100 SXM
                peaks; operations are those of the least-work,
                table-lookup algorithm, see ``least_ops``, plus one
                compare per candidate for the top-k kernels; the figure
                with the top-k kernels' own selection work, counted on
                this run's scores by ``selection_work``, is printed
                beside it).  Rows 2 and 7 (table-lookup scoring) also
                print their shared memory per block, their grid and the
                largest gap to ``testing.lut_segment_sums``, the same
                arithmetic in PyTorch on the card.  The Hamming
                kernels' bound takes their popcounts over the card's
                popcount rate instead (``popc_rate``: SMs x 16 per
                clock, compute capability 9.0, x the max SM clock).
  7. megascan — on the serving index: 12 query vectors from 3-word
                triples with ragged plans (every 4th query one shard,
                the next half the fleet, the rest the whole fleet)
                through ``ShardTaskExecutor.map_shard_batch(...,
                megakernel=True)`` with a sum ``MegascanSpec`` and a
                ranked one (k=10): one group launch per call, held
                against the plain versions on the same payload, bitwise
                equal to the per-shard route on a seeded sample of 1024
                shards and to the streamed schedule; the top-k
                kernel's candidates over the full fleet equal, bit for
                bit, the oracle over row 1's scores of every payload row
                (``testing.topk_candidates_from_scores``); both kernels timed,
                and both routes on the sample, 20 host-clock runs each,
                alternating (median, min, max).
  8. top-k    — ``topk_doc_similarities_batch`` of the serving phase's
                48 queries, k=10 over every doc, fused (the kernel)
                against unfused; the kernel's candidates equal, bit for
                bit, the oracle over row 1's [48, n_docs] scores; the
                kernel timed.
  9. sym serving — the paper's two-sided Hamming mode on the same
                corpus and signatures (``lsh_mode="sym"``): one batch
                of the serving phase's first 48 queries through
                ``QueryBatch.execute`` (the postings built before are
                reused), rows 5 and 6 launched in it, rows held against
                the plain path on the same query signatures; then, with
                row 5's counter zeroed again, a shard-granular sym
                planning of the same queries (exactly one row 5 launch)
                against plain.
 10. sym megascan — a Hamming sum ``MegascanSpec`` over the full fleet
                with phase 7's plans: one group launch, against plain,
                bitwise equal to the per-shard route on phase 7's
                sample and to the streamed schedule; both routes timed
                over 5 alternating runs.
 11. sym top-k — ``topk_doc_similarities_batch`` on the sym index, k=10,
                48 queries, every doc: ids and values equal the plain
                path's exactly, ties included; rows 4 and 5 timed at
                this shape.

 12. train    — ``train_pv_dbow`` on the serving phase's corpus (2^20
                docs) at the EmApprox PV settings (dim 64, 5 negatives,
                4096 pairs a step, 2000 steps, lr 0.01, t 8): row 11
                launches exactly once a step; the loss read every step
                through the trainer's callback and printed every 100; the
                wall of ``corpus_pairs`` (a call of its own) and of the
                step loop; every row of both tables finite and of unit
                norm (atol 1e-4); the mean loss of the last 100 steps
                below the first 100's; row 11 at the step shape on unit
                rows against its plain version (rtol 1e-5, atol 1e-6),
                timed as device time (100 launches in a CUDA graph)
                beside one host call's time, its plain version and bound.
 13. k-means  — ``spherical_kmeans`` of the trained doc vectors into
                n_shards (39983) clusters, unbalanced (the reference's
                ``_rebalance`` forms [n, k] and its argsort, 168 + 335 GB
                here): row 12 launches once per iteration plus once; the
                final assignment against the plain version on the card,
                ids away from near-ties (top two within 1e-4), scores
                within rtol 1e-4; iterations and the wall of each (from
                ``spherical_kmeans``' callback), cluster sizes; a second
                run from the same seed gives the same assignment and
                centroid bits (the update sums clusters in a fixed
                order); row 12 timed (median of 5) beside its plain
                version, the chunked ``torch.matmul`` + ``max`` (two
                calls a chunk, TF32 off) and its bound.
 14. offline build and serve — the JAX package's pipeline in the order
                of examples/serve_queries.py on a fresh corpus of
                --build-docs documents from --seed: shard, train (as in
                12), a real-valued pre-index, ``allocate_corpus``
                (balanced: ``_rebalance`` fits at this size), the
                doc-granular index (bits 256), and one
                ``QueryBatch.execute`` of 48 mixed queries at rate 0.05.
                Rows 11, 12, 1 and 2 must launch; the loss falls; the
                reallocated corpus keeps every document and token and no
                shard exceeds ``_rebalance``'s cap; the batch's rows agree
                with the plain path (rtol 1e-4); the wall of each step
                and the count-estimate errors are printed.

Each of the main paths (serving, megascan, top-k, their sym
counterparts, training, k-means and the offline build) is driven with
the launch counters set to 0 just before it and read just after; each
of its kernels must have launched.  Row 5 runs on three paths (the sym
batch, the shard-granular planning, the sym top-k): its record's
``launches`` is the sym batch's count and ``launches_by_path`` has
each path's own; so do rows 1, 2, 11 and 12 (their first path and the
offline build).  The last three lines of standard
output are the card line, the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
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
# batches the serving phase serves: the first of --batch queries on cold
# postings, each later one of WARM_BATCH queries on warm postings.  Cut
# from 3 full batches: the host shard scan takes 15-380 s a full batch
# and the run must stay well inside 1200 s
SERVE_BATCHES = 2
WARM_BATCH = 12
ROUTE_RUNS = 20  # host-clock runs of each megascan route on the sample
TEST_SHAPES = [  # (B, M, S, dim, bits, beta), the reference's kernel tests
    (1, 7, 3, 24, 128, 1.0), (5, 613, 37, 48, 128, 8.0),
    (9, 300, 128, 32, 64, 4.0), (3, 1000, 5, 48, 256, 8.0),
]
TOPK_SHAPES = [  # (B, M, k, dim, bits, beta, duplicated rows)
    (3, 257, 10, 48, 128, 8.0, False), (5, 100, 100, 32, 64, 4.0, False),
    (2, 700, 300, 24, 128, 1.0, False), (2, 50, 7, 24, 64, 2.0, False),
    (4, 600, 10, 32, 64, 4.0, True),
]
HAMMING_SHAPES = [  # (N, M, words), the reference's distance tests
    (1, 7, 4), (3, 512, 4), (8, 513, 8), (5, 64, 2), (16, 1000, 1),
]
HAMMING_SEG_SHAPES = [  # (N, M, S, bits, beta), the reference's fused tests
    (4, 300, 37, 128, 8.0), (1, 64, 3, 64, 1.0), (8, 1000, 121, 256, 4.0),
]
BUILD_BATCH = 48   # queries served by the offline-build phase
# __popc results per clock per SM at compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput table)
POPC_PER_CLOCK_PER_SM = 16
SYM_ROUTE_RUNS = 5  # host-clock runs of each Hamming megascan route
RAGGED = (13, 8, 1, 0, 27, 64, 5)   # the reference's megascan shard census
MEGA_SHAPES = [  # (shard doc counts, tm, k, duplicated rows); dim 16, bits 64
    (RAGGED, 8, 5, False), (RAGGED, 16, 5, False), ((300, 40, 9), 256, 7, False),
    (RAGGED, 16, 5, True),
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


def graph_ms(fn, launches: int = 100, reps: int = 25) -> float:
    """Median device time of one call of ``fn``: ``launches`` calls
    captured in one CUDA graph, the graph replayed ``reps`` times
    between CUDA events, each replay's time divided by ``launches``.
    The replay launches the kernels back to back, so the host's dispatch
    of each call (the wrapper's checks, its allocations and the ctypes
    call) is not in it.  Capturing adds ``launches`` to the wrapper's
    counter; call it after the counts were read."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay, reps=reps, warmup=1) / launches


def timed(fn, reps: int = 25, warmup: int = 3) -> dict:
    """A kernel record's two times of one call of ``fn``: ``ms``, from
    the host (``time_ms``, its dispatch included), and ``device_ms``,
    its device time (``graph_ms``) over as many launches in the graph as
    take about 20 ms (1 to 100)."""
    ms = time_ms(fn, reps=reps, warmup=warmup)
    launches = max(1, min(100, int(20.0 / max(ms, 1e-3))))
    return dict(ms=ms, device_ms=graph_ms(fn, launches=launches, reps=reps))


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


def selection_work(scores: torch.Tensor, tm: int, k: int,
                   valid: "torch.Tensor | None" = None
                   ) -> "tuple[int, int, int]":
    """(ballots, sorts, insertions) of the top-k kernels' warp selection
    (``asym_tile.cuh``, ``warp_topk``) on these [B, M] scores, per query
    and tile of ``tm`` rows: one ballot for each 32-row chunk that holds
    a valid row, one 32-lane sort of the first such chunk, and one
    insertion for each valid row of a later chunk that beats the k-th
    best (value, row) of the valid rows before its chunk (a later row
    loses a tie)."""
    b, m = scores.shape
    j = -(-m // tm)
    real = torch.zeros(j * tm, dtype=torch.bool, device=scores.device)
    real[:m] = True if valid is None else valid
    v = scores.new_full((b, j * tm), -math.inf)
    v[:, :m] = scores
    v = torch.where(real, v, -math.inf).view(b, j, tm)
    real = real.view(j, tm)
    ballots = sorts = insertions = 0
    for lo in range(0, tm, 32):
        hi = min(tm, lo + 32)
        here = real[:, lo:hi].any(dim=1)
        seen = real[:, :lo].any(dim=1)
        ballots += b * int(here.sum())
        sorts += b * int((here & ~seen).sum())
        if lo >= k:
            kth = torch.topk(v[:, :, :lo], k, dim=-1).values[..., -1:]
        else:
            kth = torch.full_like(v[:, :, :1], -math.inf)
        insertions += int(((v[:, :, lo:hi] > kth) & real[:, lo:hi]
                           & seen[:, None]).sum())
    return ballots, sorts, insertions


def popc_rate() -> "tuple[float, str]":
    """(popcounts per second, how it was reckoned): the SMs times
    POPC_PER_CLOCK_PER_SM times the card's max SM clock (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * POPC_PER_CLOCK_PER_SM * mhz * 1e6
    return rate, (f"{sms} SMs x {POPC_PER_CLOCK_PER_SM} popc/clock/SM x "
                  f"{mhz:.0f} MHz max SM clock = {rate:.4g} popc/s")


def popc_bound(popcs: float, nbytes: float, rate: float
               ) -> "tuple[float, str]":
    """(bound_ms, bound_by) of a Hamming kernel: the larger of its
    popcounts over the card's popcount rate and ``nbytes`` over the HBM
    rate."""
    t_ops, t_bytes = popcs / rate, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                        else "bytes")


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


def ties_by_index(vals: torch.Tensor, idx: torch.Tensor, width: int,
                  what: str) -> int:
    """Assert that within each run of ``width`` ranked candidates exact
    ties come lowest index first; returns the number of ties seen."""
    v = vals.cpu().reshape(-1, width)
    i = idx.cpu().reshape(-1, width)
    tie = (v[:, 1:] == v[:, :-1]) & torch.isfinite(v[:, 1:])
    if not bool((i[:, 1:][tie] > i[:, :-1][tie]).all()):
        raise AssertionError(f"{what}: a tie is not lowest index first")
    return int(tie.sum())


def kernel_phase_ranked(dev: torch.device) -> None:
    """The top-k and megascan kernels against their plain versions at
    the reference's test shapes: twice bitwise, group == single shard
    and streamed == pipelined bitwise, exact ties lowest index first."""
    from repro_torch.core import lsh
    from repro_torch.kernels.asym import kernel as k
    from repro_torch.kernels.asym import ops, ref
    from repro_torch.kernels.megascan import kernel as mk
    from repro_torch.kernels.megascan import ops as mops
    from repro_torch.kernels.megascan import ref as mref
    from repro_torch.testing import (assert_ids_equal_away_from_ties,
                                     ragged_segments,
                                     topk_candidates_from_scores)

    def exact(got, scores, kk, tm, valid, what):
        want = topk_candidates_from_scores(scores, kk, tm, valid)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{what}: candidates differ from the oracle "
                                 f"over the similarity kernel's scores")

    for b, m, kk, dim, bits, beta, dup in TOPK_SHAPES:
        rng = np.random.default_rng(b * 1000 + m + kk)
        q = torch.from_numpy(rng.normal(size=(b, dim)).astype(np.float32)).to(dev)
        x = rng.normal(size=(m, dim)).astype(np.float32)
        if dup:
            x[1::2] = x[0::2][:m // 2]
        planes = lsh.hyperplanes(lsh.LSHConfig(bits=bits), dim, dev)
        db = lsh.pack_bits(lsh.signature_bits(torch.from_numpy(x).to(dev),
                                              planes))
        qn = ops._prep_queries(q)
        kc = min(kk, m)
        cv, ci = k.asym_topk_kernel(qn, planes, db, bits, kc, temperature=beta)
        cv2, ci2 = k.asym_topk_kernel(qn, planes, db, bits, kc,
                                      temperature=beta)
        same(cv, cv2, f"top-k {b}x{m} k={kk}")
        same(ci, ci2, f"top-k {b}x{m} k={kk}")
        rv, ri = ref.asym_topk_candidates_ref(qn, db, planes, bits, kc,
                                              k.topk_tile(kc), beta)
        close(cv, rv, f"top-k candidates {b}x{m} k={kk}")
        exact((cv, ci), k.asym_similarity_kernel(qn, planes, db, bits,
                                                 temperature=beta),
              kc, k.topk_tile(kc), None, f"top-k candidates {b}x{m} k={kk}")
        assert_ids_equal_away_from_ties(ci, ri, rv,
                                        f"top-k candidates {b}x{m} k={kk}")
        idx, vals = ops.asym_exp_topk(q, db, planes, bits, kk,
                                      temperature=beta)
        ridx, rvals = ref.asym_exp_topk_ref(qn, db, planes, bits, kk, beta)
        close(vals, rvals, f"top-k {b}x{m} k={kk}")
        assert_ids_equal_away_from_ties(idx, ridx, rvals,
                                        f"top-k {b}x{m} k={kk}")
        ties = ties_by_index(vals, idx, vals.shape[1], f"top-k {b}x{m}")
        if dup and ties == 0:
            raise AssertionError("duplicated rows gave no exact tie")
        log(f"   top-k ok at B={b} M={m} k={kk} dim={dim} bits={bits}, "
            f"{k.topk_selection(kc)} selection, candidates == oracle"
            + (f" ({ties} exact ties, lowest index first)" if dup else ""))

    for counts, tm, kk, dup in MEGA_SHAPES:
        segs, q, planes_np = ragged_segments(counts, 16, 64,
                                             tm + len(counts), dup)
        pay = mops.build_payload(segs, tm=tm, device=dev)
        planes = torch.from_numpy(planes_np).to(dev)
        qt = torch.from_numpy(q).to(dev)
        qn = ops._prep_queries(qt)
        what = f"megascan {counts} tm={tm}"
        got = mk.asym_megascan_segsum_kernel(qn, planes, pay.sig, pay.row_start,
                                             pay.row_count, 64, temperature=4.0)
        same(got, mk.asym_megascan_segsum_kernel(
            qn, planes, pay.sig, pay.row_start, pay.row_count, 64,
            temperature=4.0), what)
        close(got, mref.asym_megascan_segsum_ref(
            qn, pay.sig, planes, 64, pay.row_start, pay.row_count, 4.0), what)
        if bool((got[:, torch.from_numpy(pay.counts == 0).to(dev)] != 0).any()):
            raise AssertionError(f"{what}: an empty slot is not exactly zero")
        sums = mops.megascan_segment_sums(pay, qt, planes, 64, temperature=4.0)
        streamed = mops.megascan_segment_sums(pay, qt, planes, 64,
                                              temperature=4.0,
                                              double_buffer=False)
        if not np.array_equal(sums, streamed):
            raise AssertionError(f"{what}: streamed != pipelined")
        slots = pay.slots.reshape(-1)
        cv, cp = mk.asym_megascan_topk_kernel(qn, planes, pay.sig, slots, 64, kk,
                                              pay.n_slots, tm, temperature=4.0)
        cv2, cp2 = mk.asym_megascan_topk_kernel(qn, planes, pay.sig, slots, 64,
                                                kk, pay.n_slots, tm,
                                                temperature=4.0)
        same(cv, cv2, what + " top-k")
        same(cp, cp2, what + " top-k")
        rv, rp = mref.asym_megascan_topk_ref(qn, pay.sig, slots, planes, 64, kk,
                                             pay.n_slots, tm, 4.0)
        close(cv, rv, what + " top-k")
        exact((cv, cp), k.asym_similarity_kernel(qn, planes, pay.sig, 64,
                                                 temperature=4.0),
              kk, tm, slots < pay.n_slots, what + " top-k")
        for j in range(pay.n_blocks):
            sl = slice(j * kk, (j + 1) * kk)
            assert_ids_equal_away_from_ties(cp[:, sl], rp[:, sl], rv[:, sl],
                                            what + " top-k")
        ties = ties_by_index(cv, cp, kk, what + " top-k")
        if dup and ties == 0:
            raise AssertionError("duplicated rows gave no exact tie")
        ids, vals = mops.megascan_topk(pay, qt, planes, 64, kk,
                                       temperature=4.0)
        for s, seg in enumerate(segs):
            one = mops.build_payload([seg], tm=tm, device=dev)
            single = mops.megascan_segment_sums(one, qt, planes, 64,
                                                temperature=4.0)
            i1, v1 = mops.megascan_topk(one, qt, planes, 64, kk,
                                        temperature=4.0)
            if not (np.array_equal(sums[:, s], single[:, 0])
                    and np.array_equal(ids[:, s], i1[:, 0])
                    and np.array_equal(vals[:, s], v1[:, 0])):
                raise AssertionError(f"{what}: group != single shard {s}")
        log(f"   megascan ok at {counts} tm={tm} k={kk}, "
            f"{k.topk_selection(kk)} selection, top-k candidates == oracle"
            + (f" ({ties} exact ties, lowest position first)" if dup else ""))


def kernel_phase_hamming(dev: torch.device) -> int:
    """The Hamming kernels (rows 4, 5, 6 and 8) against their plain
    versions at the reference's test shapes: the distance exactly, the
    similarity bit for bit (both read one value table), the sums within
    rtol=1e-4; every kernel bitwise run to run; for the megascan, group
    == single shard and streamed == pipelined bit for bit.  Returns the
    distance kernel's launches (its only path)."""
    from repro_torch.core import lsh
    from repro_torch.kernels.hamming import kernel as hk
    from repro_torch.kernels.hamming import ops, ref
    from repro_torch.kernels.megascan import kernel as mk
    from repro_torch.kernels.megascan import ops as mops
    from repro_torch.kernels.megascan import ref as mref
    from repro_torch.testing import ragged_segments

    def words(rng, n, w):
        return lsh.to_packed_tensor(
            rng.integers(0, 2**32, (n, w), dtype=np.uint32), dev)

    hk.hamming_distance_kernel.launches = 0
    for n, m, w in HAMMING_SHAPES:
        rng = np.random.default_rng(n * 100 + m)
        q, db = words(rng, n, w), words(rng, m, w)
        dist = ops.hamming_distance(q, db)
        same(dist, ops.hamming_distance(q, db), f"distance {n}x{m}")
        if not torch.equal(dist, ref.hamming_distance_ref(q, db)):
            raise AssertionError(f"distance {n}x{m}: not exact")
        for bits, beta in ((32 * w, 1.0), (32 * w, 8.0)):
            sim = ops.hamming_similarity(q, db, bits, temperature=beta)
            same(sim, ops.hamming_similarity(q, db, bits, temperature=beta),
                 f"similarity {n}x{m}")
            if not torch.equal(sim, ref.hamming_similarity_ref(q, db, bits,
                                                               beta)):
                raise AssertionError(f"similarity {n}x{m}: not bitwise plain")
        log(f"   hamming ok at N={n} M={m} W={w}")
    for n, m, s, bits, beta in HAMMING_SEG_SHAPES:
        rng = np.random.default_rng(n * 10 + m)
        q, db = words(rng, n, bits // 32), words(rng, m, bits // 32)
        for name, seg in (
                ("sorted", np.sort(rng.integers(0, s, m))),
                ("unsorted+padding", rng.integers(-1, s + 3, m)),
                ("one segment", np.full(m, s // 2))):
            seg_t = torch.from_numpy(seg.astype(np.int32)).to(dev)
            got = ops.hamming_segment_similarity(q, db, bits, seg_t, s,
                                                 temperature=beta)
            same(got, ops.hamming_segment_similarity(
                q, db, bits, seg_t, s, temperature=beta),
                f"hamming segment sum {n}x{m} {name}")
            close(got, ref.hamming_segment_similarity_ref(
                q, db, bits, seg_t, s, beta),
                f"hamming segment sum {n}x{m}x{s} {name}")
            occupied = np.zeros(s, bool)
            occupied[seg[(seg >= 0) & (seg < s)]] = True
            if bool((got[:, torch.from_numpy(~occupied).to(dev)] != 0).any()):
                raise AssertionError("an empty segment is not exactly zero")
        log(f"   hamming segment sum ok at N={n} M={m} S={s} bits={bits}")
    distance_launches = hk.hamming_distance_kernel.launches

    for counts, tm, _, _ in MEGA_SHAPES[:3]:
        segs, qv, planes = ragged_segments(counts, 16, 64, tm + len(counts))
        qsig = lsh.sign_tensor(qv, torch.as_tensor(planes, device=dev))
        pay = mops.build_payload(segs, tm=tm, device=dev)
        what = f"hamming megascan {counts} tm={tm}"
        got = mk.hamming_megascan_segsum_kernel(
            qsig, pay.sig, pay.row_start, pay.row_count, 64, temperature=4.0)
        same(got, mk.hamming_megascan_segsum_kernel(
            qsig, pay.sig, pay.row_start, pay.row_count, 64,
            temperature=4.0), what)
        close(got, mref.hamming_megascan_segsum_ref(
            qsig, pay.sig, 64, pay.row_start, pay.row_count, 4.0), what)
        if bool((got[:, torch.from_numpy(pay.counts == 0).to(dev)] != 0).any()):
            raise AssertionError(f"{what}: an empty slot is not exactly zero")
        sums = mops.megascan_segment_sums(pay, qsig, None, 64, mode="hamming",
                                          temperature=4.0)
        streamed = mops.megascan_segment_sums(pay, qsig, None, 64,
                                              mode="hamming", temperature=4.0,
                                              double_buffer=False)
        if not np.array_equal(sums, streamed):
            raise AssertionError(f"{what}: streamed != pipelined")
        for s, seg in enumerate(segs):
            one = mops.build_payload([seg], tm=tm, device=dev)
            single = mops.megascan_segment_sums(one, qsig, None, 64,
                                                mode="hamming",
                                                temperature=4.0)
            if not np.array_equal(sums[:, s], single[:, 0]):
                raise AssertionError(f"{what}: group != single shard {s}")
        log(f"   {what} ok")
    return distance_launches


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
def plain_segment_sums(index, vecs: np.ndarray) -> np.ndarray:
    """[B, n_shards] doc-granular planning sums by the plain versions of
    the index's LSH mode on the card: the unfused [B, n_docs] matrix,
    then a scatter-add.  Sym queries take the index's own host-side
    signatures."""
    from repro_torch.kernels.asym import ref
    from repro_torch.kernels.hamming import ref as href

    dev = index._fused_device_arrays()
    n_shards = index.shard_vecs.shape[0]
    if index.lsh_mode == "asym":
        out = ref.asym_exp_segment_sum_ref(
            torch.as_tensor(vecs, device=index.device), dev["sig"],
            dev["planes"], index.bits, dev["seg"], n_shards,
            index.temperature)
    else:
        qsig = index.query_sig_tensor(vecs)
        out = href.hamming_segment_similarity_ref(
            qsig, dev["sig"], index.bits, dev["seg"], n_shards,
            index.temperature)
    return out.cpu().numpy().astype(np.float64)


def plain_similarities(index, vecs: np.ndarray, sig: torch.Tensor
                       ) -> torch.Tensor:
    """[B, M] exp-similarities of ``vecs`` against the packed rows
    ``sig`` by the plain version of the index's LSH mode on the card."""
    from repro_torch.kernels.asym import ref
    from repro_torch.kernels.hamming import ref as href

    if index.lsh_mode == "asym":
        return ref.asym_exp_similarity_ref(
            torch.as_tensor(vecs, device=index.device), sig,
            index._device_planes(), index.bits, index.temperature)
    qsig = index.query_sig_tensor(vecs)
    return href.hamming_similarity_ref(qsig, sig, index.bits,
                                       index.temperature)


def plain_rows(index, queries):
    """Probability rows of ``queries`` computed with the plain PyTorch
    versions on the card, following the engine's planning algebra."""
    from repro_torch.core.sampling import similarity_probabilities

    rows = [None] * len(queries)
    vec_pos = [i for i, q in enumerate(queries) if q.kind != "bool"]
    if vec_pos:
        sims = plain_segment_sums(index, index.query_vectors(
            [queries[i].word_ids() for i in vec_pos]))
        for row, i in zip(sims, vec_pos):
            rows[i] = similarity_probabilities(row)
    bool_pos = [i for i, q in enumerate(queries) if q.kind == "bool"]
    if bool_pos:
        words = sorted({w for i in bool_pos for w in queries[i].expr.words()})
        sig = index._device_sig(index.shard_sig, "shard")
        w_rows = plain_similarities(
            index, index.word_vecs[np.asarray(words)],
            sig).cpu().numpy().astype(np.float64)
        by_word = dict(zip(words, w_rows))

        def algebra(e):
            if e.op == "word":
                return by_word[e.word]
            a, b = algebra(e.left), algebra(e.right)
            return a * b if e.op == "and" else a + b

        for i in bool_pos:
            rows[i] = similarity_probabilities(algebra(queries[i].expr))
    return rows


def record_planning(engine, seen: list) -> None:
    """Wrap ``engine._probability_rows`` so that every call appends
    (queries, rows, seconds) to ``seen``."""
    inner = engine._probability_rows

    def recording_rows(qs, c, i):
        t = time.perf_counter()
        rows = inner(qs, c, i)
        seen.append((list(qs), rows, time.perf_counter() - t))
        return rows

    engine._probability_rows = recording_rows


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
    _, corpus, asym_index = build_served_index(3000, seed, dev, timings)
    counts = np.bincount(np.concatenate([s.tokens for s in corpus.shards]),
                         minlength=corpus.vocab_size)
    queries = make_queries(counts, 24, np.random.default_rng(seed), 1.0)
    for mode in ("asym", "sym"):
        index = dataclasses.replace(asym_index,
                                    lsh_mode=mode).attach_corpus(corpus)
        cpu_index = dataclasses.replace(index,
                                        device="cpu").attach_corpus(corpus)
        cuda_engine = QueryBatch(corpus, index)
        cpu_engine = QueryBatch(corpus, cpu_index)
        check_rows(cuda_engine._probability_rows(queries, corpus, index),
                   cpu_engine._probability_rows(queries, corpus, cpu_index),
                   f"small input ({mode}), CUDA vs CPU index")
        census = cuda_engine.execute(queries, 1.0)
        plain = cpu_engine.execute(queries, 1.0)
        for q, a, b in zip(queries, census, plain):
            if q.kind == "count":
                truth = float(corpus.count_phrase(q.phrase))
                if a.estimate.value != truth or b.estimate.value != truth:
                    raise AssertionError("census count is not the exact count")
            else:
                np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        log(f"   small input ok ({mode}): {corpus.n_docs} docs, "
            f"{corpus.n_shards} shards")


# ----------------------------------------------------------------------
# phase 5 + 6: the main path, then the kernels at its shapes
# ----------------------------------------------------------------------
def serve_phase(dev: torch.device, args) -> "tuple[list, dict]":
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
    sizes = [args.batch] + [args.warm_batch] * (args.batches - 1)
    queries = make_queries(counts, sum(sizes),
                           np.random.default_rng(args.seed),
                           corpus.n_docs / 3200)
    starts = np.cumsum([0] + sizes)

    seen = []
    with ShardTaskExecutor(workers=4, adaptive_workers=True) as ex:
        engine = QueryBatch(corpus, index, executor=ex)
        record_planning(engine, seen)
        k.asym_similarity_kernel.launches = 0
        k.asym_segment_sum_kernel.launches = 0
        walls, results = [], []
        for bi in range(args.batches):
            batch = queries[starts[bi]:starts[bi + 1]]
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
    launch = k.segsum_launch_shape(bits, dim, n_shards, b)
    log(f"   segment sum launch (table lookup): {launch}, 256 threads a "
        f"block")
    log_model_gap(got, vecs, sig, planes, bits, offs[:-1],
                  offs[1:] - offs[:-1], beta, "segment sum")
    kernels.append(dict(
        name="asym_exp_segment_sum", route="cuda",
        source="src/repro_torch/csrc/asym.cu",
        replaces="src/repro/kernels/asym/kernel.py:191",
        launches=launches["asym_exp_segment_sum"], max_abs_err=err,
        launch=launch,
        **timed(lambda: k.asym_segment_sum_kernel(
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
        **timed(lambda: k.asym_similarity_kernel(
            wq, planes, shard_sig, bits, temperature=beta)),
        plain_ms=time_ms(lambda: ref.asym_exp_similarity_ref(
            wvecs, shard_sig, planes, bits, beta)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    shapes.insert(0, dict(B=b, M=m, dim=dim, bits=bits))
    for kr, shape in zip(kernels, shapes):
        log_kernel(kr, shape)
    return kernels, dict(corpus=corpus, index=index, counts=counts,
                         batch=batch)


def log_kernel(kr: dict, shape: dict) -> None:
    log(f"   {kr['name']}: {kr['ms']:.4f} ms, device {kr['device_ms']:.4f} "
        f"ms (plain {kr['plain_ms']:.4f} "
        f"ms, bound {kr['bound_ms']:.4f} ms by {kr['bound_by']}, max abs "
        f"err {kr['max_abs_err']:.3g}, "
        f"{kr.get('launches_by_path', kr['launches'])} launches) at {shape}")


def log_model_gap(got, vecs, db, planes, bits, starts, counts, beta,
                  what: str) -> None:
    """Print the largest relative gap between a segment-sum kernel's
    output and ``testing.lut_segment_sums``, the same table-lookup
    arithmetic in PyTorch, on the same device (their projections differ
    in summation order)."""
    from repro_torch.testing import lut_segment_sums
    model = lut_segment_sums(vecs, db, planes, bits, starts, counts, beta)
    gap = ((got.double() - model.double()).abs()
           / model.double().abs().clamp(min=1e-30)).max()
    log(f"   {what}: largest relative gap to the table-lookup model "
        f"{float(gap):.3g}")


def finite_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error over the entries both hold finite (-inf marks
    padding in the top-k candidates)."""
    ok = torch.isfinite(got) & torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        raise AssertionError("finite entries differ from the plain version")
    return float((got[ok].double() - want[ok].double()).abs().max()) if bool(ok.any()) else 0.0


# ----------------------------------------------------------------------
# phase 7: the megascan over the serving index
# ----------------------------------------------------------------------
def ragged_plans(n_queries: int, n_shards: int, rng) -> list:
    """serve_bench's megascan plans: every 4th query one shard, the next
    half the fleet, the rest the whole fleet."""
    plans = []
    for i in range(n_queries):
        if i % 4 == 0:
            plans.append([int(rng.integers(n_shards))])
        elif i % 4 == 1:
            sub = rng.choice(n_shards, size=max(2, n_shards // 2),
                             replace=False)
            plans.append(sorted(int(s) for s in sub))
        else:
            plans.append(list(range(n_shards)))
    return plans


def dense_of(results: list, n_shards: int, ranked: bool):
    """Group results (one {shard: result} dict per query) as dense
    arrays: sums [B, S] (nan where a query did not plan a shard), or
    ranked ids and values [B, S, k] (-1 / -inf)."""
    b = len(results)
    if not ranked:
        out = np.full((b, n_shards), np.nan)
        for qi, per in enumerate(results):
            out[qi, list(per)] = list(per.values())
        return out
    k = max(len(r["doc_ids"]) for per in results for r in per.values())
    ids = np.full((b, n_shards, k), -1, np.int64)
    vals = np.full((b, n_shards, k), -np.inf)
    for qi, per in enumerate(results):
        for sid, r in per.items():
            ids[qi, sid, :len(r["doc_ids"])] = r["doc_ids"]
            vals[qi, sid, :len(r["values"])] = r["values"]
    return ids, vals


def results_equal(a: list, b: list, what: str) -> int:
    """Assert two routes' results are bitwise equal where both have
    them; returns the (query, shard) pairs compared."""
    n = 0
    for qa, qb in zip(a, b):
        for sid, rb in qb.items():
            ra = qa[sid]
            ok = (np.array_equal(ra["doc_ids"], rb["doc_ids"])
                  and np.array_equal(ra["values"], rb["values"])
                  if isinstance(ra, dict) else ra == rb)
            if not ok:
                raise AssertionError(f"{what}: shard {sid} differs")
            n += 1
    return n


def megascan_phase(dev: torch.device, args, ctx: dict) -> list:
    from repro_torch.kernels.asym import kernel as ak
    from repro_torch.kernels.asym import ops
    from repro_torch.kernels.megascan import MegascanSpec
    from repro_torch.kernels.megascan import kernel as mk
    from repro_torch.kernels.megascan import ops as mops
    from repro_torch.kernels.megascan import ref as mref
    from repro_torch.runtime.executor import ShardTaskExecutor
    from repro_torch.testing import (assert_ids_equal_away_from_ties,
                                     topk_candidates_from_scores)

    corpus, index, counts = ctx["corpus"], ctx["index"], ctx["counts"]
    n_shards = corpus.n_shards
    rng = np.random.default_rng(args.seed + 23)
    cand = np.nonzero((counts > 50 * corpus.n_docs / 3200)
                      & (counts < 1200 * corpus.n_docs / 3200))[0]
    triples = [rng.choice(cand, 3, replace=False).tolist() for _ in range(12)]
    vecs = index.query_vectors(triples)
    plans = ragged_plans(12, n_shards, rng)
    ctx["mega_vecs"], ctx["mega_plans"] = vecs, plans
    sum_spec = MegascanSpec(index, vecs)
    ranked_spec = MegascanSpec(index, vecs, ranked_k=10)
    with ShardTaskExecutor(workers=4) as ex:
        t = time.perf_counter()
        index.megascan_payload(tuple(range(n_shards)))
        torch.cuda.synchronize()
        log(f"   full-fleet payload built and uploaded in "
            f"{time.perf_counter() - t:.2f} s")
        # ---- the main path: both specs through the group route ----
        mk.asym_megascan_segsum_kernel.launches = 0
        mk.asym_megascan_topk_kernel.launches = 0
        jobs = ex.stats["megascan_jobs"]
        mega = {}
        for label, spec in (("sum", sum_spec), ("ranked", ranked_spec)):
            t = time.perf_counter()
            mega[label] = ex.map_shard_batch(corpus, plans, spec.scan_fns(),
                                             megakernel=True)
            wall = time.perf_counter() - t
            if spec.stats["group_launches"] != 1:
                raise AssertionError(f"{label}: {spec.stats} is not one "
                                     f"group launch")
            if "megascan" not in ex.last_job:
                raise AssertionError(f"{label}: no megascan job record")
            rec = ex.last_job["megascan"]
            log(f"   {label} megascan: 1 launch over {rec['shards']} shards, "
                f"{rec['real_rows']} real of {rec['rows']} payload rows, "
                f"route wall {wall:.3f} s (scan {rec['wall_s']:.4f} s)")
        launches = {"megascan_segsum": mk.asym_megascan_segsum_kernel.launches,
                    "megascan_topk": mk.asym_megascan_topk_kernel.launches}
        if ex.stats["megascan_jobs"] != jobs + 2:
            raise AssertionError(f"megascan_jobs {ex.stats['megascan_jobs']}")
        log(f"   launches on the megascan path: {launches}")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{name} never launched on its path")

        # ---- against the plain versions on the same payload ----
        pay = index.megascan_payload(tuple(range(n_shards)))
        planes, bits, beta = index._device_planes(), index.bits, index.temperature
        q = torch.as_tensor(vecs, device=dev)
        qn = ops._prep_queries(q)
        plain_sum = mref.asym_megascan_segsum_ref(
            qn, pay.sig, planes, bits, pay.row_start, pay.row_count,
            beta).cpu().numpy()
        got = dense_of(mega["sum"], n_shards, False)
        seen = ~np.isnan(got)
        np.testing.assert_allclose(got[seen], plain_sum[seen], rtol=RTOL,
                                   err_msg="megascan sums vs plain")
        slots = pay.slots.reshape(-1)
        pv, pp = mref.asym_megascan_topk_ref(qn, pay.sig, slots, planes, bits,
                                             10, pay.n_slots, pay.tm, beta)
        tv, tp = mops.per_slot_topk(pv, pp, pay.block_slot, pay.n_slots, 10)
        tv, tp = tv.cpu().numpy(), tp.cpu().numpy()
        plain_ids = np.where(np.isfinite(tv),
                             pay.doc_idx[np.maximum(tp, 0)], -1)
        ids, vals = dense_of(mega["ranked"], n_shards, True)
        kk = ids.shape[2]
        for qi, plan in enumerate(plans):
            assert_ids_equal_away_from_ties(ids[qi, plan],
                                            plain_ids[qi, plan, :kk],
                                            tv[qi, plan, :kk],
                      f"ranked megascan query {qi}")
            fin = np.isfinite(vals[qi, plan])
            np.testing.assert_allclose(vals[qi, plan][fin],
                                       tv[qi, plan, :kk][fin], rtol=RTOL)
        log("   group results match the plain versions (sums rtol 1e-4, "
            "ranked ids away from near-ties)")

        # ---- group == per-shard, bitwise, on a sample of 1024 shards ----
        sample = set(rng.choice(n_shards, min(1024, n_shards),
                                replace=False).tolist())
        sub = [[s for s in plan if s in sample] for plan in plans]
        ctx["mega_sub"] = sub
        walls = {}
        for label, spec in (("sum", sum_spec), ("ranked", ranked_spec)):
            fns = spec.scan_fns()
            per = ex.map_shard_batch(corpus, sub, fns, megakernel=False)
            n = results_equal(mega[label], per, f"{label} group vs per-shard")
            grp = ex.map_shard_batch(corpus, sub, fns, megakernel=True)
            results_equal(grp, per, f"{label} sample group vs per-shard")
            log(f"   {label}: group == per-shard bitwise on {n} (query, "
                f"shard) pairs over {len(sample)} sampled shards")
        fns = sum_spec.scan_fns()
        for megakernel in (True, False) * ROUTE_RUNS:   # alternating
            t = time.perf_counter()
            ex.map_shard_batch(corpus, sub, fns, megakernel=megakernel)
            walls.setdefault(megakernel, []).append(time.perf_counter() - t)
        for label, key, n in (("group", True, "1 launch"),
                              ("per-shard", False, f"{len(sample)} launches")):
            w_ = walls[key]
            log(f"   1024-shard sample, {label} route ({n}), host wall over "
                f"{len(w_)} runs: median {np.median(w_)} s, min {min(w_)} s, "
                f"max {max(w_)} s")
        log(f"   per-shard / group median: "
            f"{np.median(walls[False]) / np.median(walls[True])}")

    # ---- streamed == pipelined on the full-fleet payload ----
    pipelined = mops.megascan_segment_sums(pay, q, planes, bits,
                                           temperature=beta)
    streamed = mops.megascan_segment_sums(pay, q, planes, bits,
                                          temperature=beta,
                                          double_buffer=False)
    if not np.array_equal(pipelined, streamed):
        raise AssertionError("full-fleet streamed != pipelined")
    log("   full fleet: streamed == pipelined, bitwise")

    # ---- both kernels at the full-fleet shapes ----
    b, dim, w = qn.shape[0], planes.shape[1], pay.sig.shape[1]
    real, n_slots = pay.real_rows, pay.n_slots
    got = mk.asym_megascan_segsum_kernel(qn, planes, pay.sig, pay.row_start,
                                         pay.row_count, bits, temperature=beta)
    same(got, mk.asym_megascan_segsum_kernel(
        qn, planes, pay.sig, pay.row_start, pay.row_count, bits,
        temperature=beta), "megascan sum, full fleet")
    err = close(got, torch.from_numpy(plain_sum).to(dev),
                "megascan sum, full fleet")
    launch = mk.segsum_launch_shape(bits, dim, n_slots, b)
    log(f"   megascan sum launch (table lookup): {launch}, 256 threads a "
        f"block")
    log_model_gap(got, q, pay.sig, planes, bits, pay.row_start,
                  pay.row_count, beta, "megascan sum")
    nbytes = 4.0 * (real * w + 2 * n_slots + b * dim + bits * dim
                    + b * n_slots)
    bound_ms, bound_by = bound(least_ops(b, real, bits, dim, 4), nbytes)
    shape = dict(B=b, real_rows=real, payload_rows=pay.n_rows, S=n_slots,
                 dim=dim, bits=bits)
    kernels = [dict(
        name="asym_megascan_segsum", route="cuda",
        source="src/repro_torch/csrc/megascan.cu",
        replaces="src/repro/kernels/megascan/kernel.py:182",
        launches=launches["megascan_segsum"], max_abs_err=err,
        launch=launch,
        **timed(lambda: mk.asym_megascan_segsum_kernel(
            qn, planes, pay.sig, pay.row_start, pay.row_count, bits,
            temperature=beta)),
        plain_ms=time_ms(lambda: mref.asym_megascan_segsum_ref(
            qn, pay.sig, planes, bits, pay.row_start, pay.row_count, beta)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)]
    log_kernel(kernels[-1], shape)

    cv, cp = mk.asym_megascan_topk_kernel(qn, planes, pay.sig, slots, bits, 10,
                                          n_slots, pay.tm, temperature=beta)
    cv2, cp2 = mk.asym_megascan_topk_kernel(qn, planes, pay.sig, slots, bits,
                                            10, n_slots, pay.tm,
                                            temperature=beta)
    same(cv, cv2, "megascan top-k, full fleet")
    same(cp, cp2, "megascan top-k, full fleet")
    err = finite_err(cv, pv)
    close(cv, pv, "megascan top-k candidates, full fleet")
    # exact: the oracle over row 1's scores of every payload row
    scores = ak.asym_similarity_kernel(qn, planes, pay.sig, bits,
                                       temperature=beta)
    valid = slots < n_slots
    ev, ep = topk_candidates_from_scores(scores, 10, pay.tm, valid)
    if not (torch.equal(cv, ev) and torch.equal(cp, ep)):
        raise AssertionError("megascan top-k, full fleet: candidates differ "
                             "from the oracle over the similarity kernel's "
                             "scores")
    ties = ties_by_index(cv, cp, 10, "megascan top-k, full fleet")
    log(f"   megascan top-k candidates == the oracle over row 1's "
        f"{list(scores.shape)} scores, values and positions bit for bit "
        f"({ties} exact ties, lowest position first)")
    ballots, sorts, inserts = selection_work(scores, pay.tm, 10, valid)
    del scores, valid, ev, ep
    # the function reads the real rows' signatures and the per-slot
    # ranges (not the padded payload's row -> slot map) and writes the
    # candidates; a top-k selection takes about one compare per
    # (query, real row)
    nbytes = 4.0 * (real * w + 2 * n_slots + b * dim + bits * dim
                    + 2 * b * pay.n_blocks * 10)
    bound_ms, bound_by = bound(least_ops(b, real, bits, dim, 3) + b * real,
                               nbytes)
    sel_ms, _ = bound(least_ops(b, real, bits, dim, 3)
                      + 32.0 * (ballots + 15 * sorts + inserts),
                      nbytes + 4.0 * pay.n_rows)
    selection = ak.topk_selection(10)
    log(f"   megascan top-k selection ({selection}): {ballots} chunk "
        f"ballots, {sorts} warp sorts and {inserts} insertions over {b} x "
        f"{pay.n_blocks} (query, block) pairs ({inserts / (b * pay.n_blocks)}"
        f" insertions a pair); bound with them (32 lanes a ballot or an "
        f"insertion, 15 x 32 a sort) and the row -> slot map: {sel_ms} ms")
    kernels.append(dict(
        name="asym_megascan_topk", route="cuda",
        source="src/repro_torch/csrc/megascan.cu",
        replaces="src/repro/kernels/megascan/kernel.py:363",
        also_replaces="src/repro/kernels/megascan/kernel.py:411",
        selection=selection,
        launches=launches["megascan_topk"], max_abs_err=err,
        **timed(lambda: mk.asym_megascan_topk_kernel(
            qn, planes, pay.sig, slots, bits, 10, n_slots, pay.tm,
            temperature=beta)),
        plain_ms=time_ms(lambda: mref.asym_megascan_topk_ref(
            qn, pay.sig, slots, planes, bits, 10, n_slots, pay.tm, beta)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    log_kernel(kernels[-1], dict(shape, k=10, tm=pay.tm, blocks=pay.n_blocks))
    return kernels


# ----------------------------------------------------------------------
# phases 9-11: sym mode (two-sided Hamming) on the same corpus and index
# ----------------------------------------------------------------------
def sym_serve_phase(dev: torch.device, args, ctx: dict,
                    rate: float) -> list:
    """One batch of the serving phase's 48 queries through
    ``QueryBatch.execute`` on the sym index, then a shard-granular sym
    planning of the same queries; rows 5 and 6 must launch, and every
    probability row equals the plain path's on the same query
    signatures (rtol=1e-4).  Times row 6 at the shape the batch gave
    it."""
    from repro_torch.core.queries import QueryBatch
    from repro_torch.kernels.hamming import kernel as hk
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.runtime.executor import ShardTaskExecutor

    corpus, batch = ctx["corpus"], ctx["batch"]
    t = time.perf_counter()
    index = dataclasses.replace(ctx["index"], lsh_mode="sym")
    index._fused_device_arrays()
    torch.cuda.synchronize()
    log(f"   sym index: shard sort and upload {time.perf_counter() - t:.2f} s")
    seen = []
    with ShardTaskExecutor(workers=4, adaptive_workers=True) as ex:
        engine = QueryBatch(corpus, index, executor=ex)
        record_planning(engine, seen)
        hk.hamming_similarity_kernel.launches = 0
        hk.hamming_segment_similarity_kernel.launches = 0
        t = time.perf_counter()
        res = engine.execute(batch, rate,
                             rng=np.random.default_rng(args.seed + 101))
        torch.cuda.synchronize()
        wall, scan_s = time.perf_counter() - t, ex.last_job["wall_s"]
        launches = {
            "hamming_similarity": hk.hamming_similarity_kernel.launches,
            "hamming_segment_similarity":
                hk.hamming_segment_similarity_kernel.launches}
    log(f"   launches on the sym serving path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the sym path")
    shard_index = dataclasses.replace(index, granularity="shard")
    words = [sorted(q.expr.words()) if q.kind == "bool" else q.word_ids()
             for q in batch]
    hk.hamming_similarity_kernel.launches = 0
    t = time.perf_counter()
    shard_rows = shard_index.shard_similarities_batch(words)
    shard_s = time.perf_counter() - t
    shard_launches = hk.hamming_similarity_kernel.launches
    log(f"   hamming_similarity launches on the shard-granular planning: "
        f"{shard_launches}")
    if shard_launches != 1:
        raise AssertionError(f"shard-granular sym planning launched "
                             f"hamming_similarity {shard_launches} times, "
                             f"not once")
    qs, rows, plan_s = seen[0]
    check_rows(rows, plain_rows(index, qs), "sym batch")
    for q, r in zip(batch, res):
        if q.kind == "count" and not (math.isfinite(r.estimate.value)
                                      and r.estimate.value >= 0):
            raise AssertionError(f"sym count estimate {r.estimate.value}")
        if q.kind == "ranked" and not np.all(np.isfinite(r.scores)):
            raise AssertionError("malformed sym ranked result")
    log(f"   sym batch: {len(batch)} queries at rate {rate}, wall "
        f"{wall:.3f} s (planning {plan_s:.3f} s, shared scan {scan_s:.3f} "
        f"s), shards read {sum(r.shards_read for r in res)}; rows match "
        f"the plain path")
    shard_sig = index._device_sig(index.shard_sig, "shard")
    want = plain_similarities(index, index.query_vectors(words), shard_sig)
    np.testing.assert_allclose(shard_rows, want.cpu().numpy(), rtol=RTOL,
                               err_msg="sym shard-granular planning")
    log(f"   sym shard-granular planning of {len(words)} queries: "
        f"{shard_s:.3f} s, matches the plain path")

    # ---- row 6 at the shape the batch gave it ----
    dev_ops = index._fused_device_arrays()
    sig, seg, offs = dev_ops["sig"], dev_ops["seg"], dev_ops["offsets"]
    vec_q = [q for q in batch if q.kind != "bool"]
    qsig = index.query_sig_tensor(
        index.query_vectors([q.word_ids() for q in vec_q]))
    bits, beta = index.bits, index.temperature
    b, m, w = qsig.shape[0], sig.shape[0], sig.shape[1]
    n_shards = offs.shape[0] - 1
    got = hk.hamming_segment_similarity_kernel(qsig, sig, offs, bits,
                                               temperature=beta)
    same(got, hk.hamming_segment_similarity_kernel(
        qsig, sig, offs, bits, temperature=beta), "sym segment sum")
    err = close(got, href.hamming_segment_similarity_ref(
        qsig, sig, bits, seg, n_shards, beta), "sym segment sum")
    nbytes = 4.0 * (b * w + m * w + (n_shards + 1) + (32 * w + 1)
                    + b * n_shards)
    bound_ms, bound_by = popc_bound(b * m * w, nbytes, ctx["popc_rate"])
    kr = dict(
        name="hamming_segment_similarity", route="cuda",
        source="src/repro_torch/csrc/hamming.cu",
        replaces="src/repro/kernels/hamming/kernel.py:160",
        launches=launches["hamming_segment_similarity"], max_abs_err=err,
        **timed(lambda: hk.hamming_segment_similarity_kernel(
            qsig, sig, offs, bits, temperature=beta)),
        plain_ms=time_ms(lambda: href.hamming_segment_similarity_csr_ref(
            qsig, sig, bits, offs, beta)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    log_kernel(kr, dict(B=b, M=m, S=n_shards, W=w, bits=bits))
    ctx["sym_index"] = index
    ctx["sym_launches"] = launches
    ctx["sym_shard_launches"] = shard_launches
    return [kr]


def sym_megascan_phase(dev: torch.device, ctx: dict) -> list:
    """A Hamming sum ``MegascanSpec`` over the full fleet with the
    megascan phase's ragged plans: one group launch, the plain version,
    group == per-shard on the 1024-shard sample and streamed ==
    pipelined bit for bit, both routes timed."""
    from repro_torch.kernels.megascan import MegascanSpec
    from repro_torch.kernels.megascan import kernel as mk
    from repro_torch.kernels.megascan import ops as mops
    from repro_torch.kernels.megascan import ref as mref
    from repro_torch.runtime.executor import ShardTaskExecutor

    corpus, index = ctx["corpus"], ctx["sym_index"]
    n_shards = corpus.n_shards
    plans, sub = ctx["mega_plans"], ctx["mega_sub"]
    spec = MegascanSpec(index, ctx["mega_vecs"])
    if spec.mode != "hamming":
        raise AssertionError(f"sym spec runs in {spec.mode} mode")
    with ShardTaskExecutor(workers=4) as ex:
        t = time.perf_counter()
        pay = index.megascan_payload(tuple(range(n_shards)))
        torch.cuda.synchronize()
        log(f"   full-fleet payload built and uploaded in "
            f"{time.perf_counter() - t:.2f} s")
        mk.hamming_megascan_segsum_kernel.launches = 0
        t = time.perf_counter()
        group = ex.map_shard_batch(corpus, plans, spec.scan_fns(),
                                   megakernel=True)
        wall = time.perf_counter() - t
        launches = mk.hamming_megascan_segsum_kernel.launches
        if spec.stats["group_launches"] != 1 or launches <= 0:
            raise AssertionError(f"hamming megascan: {spec.stats}, "
                                 f"{launches} kernel launches")
        rec = ex.last_job["megascan"]
        log(f"   hamming megascan: 1 launch over {rec['shards']} shards, "
            f"{rec['real_rows']} real rows, route wall {wall:.3f} s (scan "
            f"{rec['wall_s']:.4f} s); {launches} kernel launches")
        qsig, bits, beta = spec.queries, index.bits, index.temperature
        plain = mref.hamming_megascan_segsum_ref(
            qsig, pay.sig, bits, pay.row_start, pay.row_count,
            beta).cpu().numpy()
        got = dense_of(group, n_shards, False)
        seen = ~np.isnan(got)
        np.testing.assert_allclose(got[seen], plain[seen], rtol=RTOL,
                                   err_msg="hamming megascan vs plain")
        fns = spec.scan_fns()
        per = ex.map_shard_batch(corpus, sub, fns, megakernel=False)
        n = results_equal(group, per, "hamming group vs per-shard")
        log(f"   hamming: group == per-shard bitwise on {n} (query, shard) "
            f"pairs of the 1024-shard sample")
        walls = {}
        for megakernel in (True, False) * SYM_ROUTE_RUNS:   # alternating
            t = time.perf_counter()
            ex.map_shard_batch(corpus, sub, fns, megakernel=megakernel)
            walls.setdefault(megakernel, []).append(time.perf_counter() - t)
        for label, key in (("group", True), ("per-shard", False)):
            w_ = walls[key]
            log(f"   hamming 1024-shard sample, {label} route, host wall over "
                f"{len(w_)} runs: median {np.median(w_)} s, min {min(w_)} s, "
                f"max {max(w_)} s")
    pipelined = mops.megascan_segment_sums(pay, qsig, None, bits,
                                           mode="hamming", temperature=beta)
    streamed = mops.megascan_segment_sums(pay, qsig, None, bits,
                                          mode="hamming", temperature=beta,
                                          double_buffer=False)
    if not np.array_equal(pipelined, streamed):
        raise AssertionError("hamming full-fleet streamed != pipelined")
    log("   hamming full fleet: streamed == pipelined, bitwise")

    b, w = qsig.shape[0], pay.sig.shape[1]
    real, n_slots = pay.real_rows, pay.n_slots
    got = mk.hamming_megascan_segsum_kernel(qsig, pay.sig, pay.row_start,
                                            pay.row_count, bits,
                                            temperature=beta)
    same(got, mk.hamming_megascan_segsum_kernel(
        qsig, pay.sig, pay.row_start, pay.row_count, bits,
        temperature=beta), "hamming megascan, full fleet")
    err = close(got, torch.from_numpy(plain).to(dev),
                "hamming megascan, full fleet")
    nbytes = 4.0 * (b * w + real * w + 2 * n_slots + (32 * w + 1) + b * n_slots)
    bound_ms, bound_by = popc_bound(b * real * w, nbytes, ctx["popc_rate"])
    kr = dict(
        name="hamming_megascan_segsum", route="cuda",
        source="src/repro_torch/csrc/megascan.cu",
        replaces="src/repro/kernels/megascan/kernel.py:222",
        launches=launches, max_abs_err=err,
        **timed(lambda: mk.hamming_megascan_segsum_kernel(
            qsig, pay.sig, pay.row_start, pay.row_count, bits,
            temperature=beta)),
        plain_ms=time_ms(lambda: mref.hamming_megascan_segsum_ref(
            qsig, pay.sig, bits, pay.row_start, pay.row_count, beta)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    log_kernel(kr, dict(B=b, real_rows=real, payload_rows=pay.n_rows,
                        S=n_slots, W=w, bits=bits))
    return [kr]


def sym_topk_phase(dev: torch.device, ctx: dict,
                   distance_launches: int) -> list:
    """``topk_doc_similarities_batch`` on the sym index (row 5 over
    every doc, then a stable sort): ids equal the plain path's exactly,
    ties included.  Times rows 4 and 5 at this shape."""
    from repro_torch.kernels.hamming import kernel as hk
    from repro_torch.kernels.hamming import ref as href

    index, batch = ctx["sym_index"], ctx["batch"]
    words = [sorted(q.expr.words()) if q.kind == "bool" else q.word_ids()
             for q in batch]
    hk.hamming_similarity_kernel.launches = 0
    t = time.perf_counter()
    ids, vals = index.topk_doc_similarities_batch(words, k=10)
    wall = time.perf_counter() - t
    launches = hk.hamming_similarity_kernel.launches
    log(f"   sym top-10 over {index.n_docs} docs for {len(words)} queries: "
        f"{wall:.3f} s host wall, {launches} similarity launches")
    if launches <= 0:
        raise AssertionError("hamming_similarity never launched on top-k")
    db = index._device_sig(index.doc_sig, "doc")
    qsig = index.query_sig_tensor(index.query_vectors(words))
    bits, beta = index.bits, index.temperature
    want = href.hamming_similarity_ref(qsig, db, bits, beta)
    wv, wi = torch.sort(want, dim=1, descending=True, stable=True)
    if not (np.array_equal(ids, wi[:, :10].cpu().numpy())
            and np.array_equal(vals, wv[:, :10].cpu().numpy())):
        raise AssertionError("sym top-k differs from the plain path")
    ties = int((np.diff(vals, axis=1) == 0).sum())
    log(f"   sym top-k ids and values equal the plain path exactly "
        f"({ties} exact ties in the top 10, lowest index first)")

    b, m, w = qsig.shape[0], db.shape[0], db.shape[1]
    sim = hk.hamming_similarity_kernel(qsig, db, bits, temperature=beta)
    same(sim, hk.hamming_similarity_kernel(qsig, db, bits, temperature=beta),
         "sym similarity at the top-k shape")
    if not torch.equal(sim, want):
        raise AssertionError("sym similarity is not bitwise its plain version")
    sim_err = float((sim.double() - want.double()).abs().max())
    del sim
    rate = ctx["popc_rate"]
    nbytes = 4.0 * (b * w + m * w + (32 * w + 1) + b * m)
    bound_ms, bound_by = popc_bound(b * m * w, nbytes, rate)
    kernels = [dict(
        name="hamming_similarity", route="cuda",
        source="src/repro_torch/csrc/hamming.cu",
        replaces="src/repro/kernels/hamming/kernel.py:89",
        launches=ctx["sym_launches"]["hamming_similarity"],
        launches_by_path={
            "sym_batch": ctx["sym_launches"]["hamming_similarity"],
            "sym_shard_planning": ctx["sym_shard_launches"],
            "sym_topk": launches},
        max_abs_err=sim_err,
        **timed(lambda: hk.hamming_similarity_kernel(
            qsig, db, bits, temperature=beta)),
        plain_ms=time_ms(lambda: href.hamming_similarity_ref(
            qsig, db, bits, beta)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)]
    log_kernel(kernels[-1], dict(B=b, M=m, W=w, bits=bits))
    dist = hk.hamming_distance_kernel(qsig, db)
    plain_dist = href.hamming_distance_ref(qsig, db)
    if not torch.equal(dist, plain_dist):
        raise AssertionError("distance at the top-k shape is not exact")
    dist_err = float((dist - plain_dist).abs().max())
    del dist, plain_dist
    nbytes = 4.0 * (b * w + m * w + b * m)
    bound_ms, bound_by = popc_bound(b * m * w, nbytes, rate)
    kernels.insert(0, dict(
        name="hamming_distance", route="cuda",
        source="src/repro_torch/csrc/hamming.cu",
        replaces="src/repro/kernels/hamming/kernel.py:89",
        launches=distance_launches, max_abs_err=dist_err,
        **timed(lambda: hk.hamming_distance_kernel(qsig, db)),
        plain_ms=time_ms(lambda: href.hamming_distance_ref(qsig, db)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    log_kernel(kernels[0], dict(B=b, M=m, W=w, bits=bits))
    return kernels


# ----------------------------------------------------------------------
# phase 8: ranked top-k over every document
# ----------------------------------------------------------------------
def topk_phase(dev: torch.device, ctx: dict) -> list:
    from repro_torch.kernels.asym import kernel as k
    from repro_torch.kernels.asym import ops, ref
    from repro_torch.testing import (assert_ids_equal_away_from_ties,
                                     topk_candidates_from_scores)

    index, batch = ctx["index"], ctx["batch"]
    words = [sorted(q.expr.words()) if q.kind == "bool" else q.word_ids()
             for q in batch]
    k.asym_topk_kernel.launches = 0
    t = time.perf_counter()
    ids, vals = index.topk_doc_similarities_batch(words, k=10)
    wall = time.perf_counter() - t
    launches = k.asym_topk_kernel.launches
    log(f"   fused top-10 over {index.n_docs} docs for {len(words)} queries: "
        f"{wall:.3f} s host wall, {launches} launches")
    if launches <= 0:
        raise AssertionError("asym_exp_topk never launched on its path")
    if ids.shape != (len(words), 10) or not np.all(np.isfinite(vals)):
        raise AssertionError("malformed top-k result")
    uids, uvals = index.topk_doc_similarities_batch(words, k=10, fused=False)
    np.testing.assert_allclose(vals, uvals, rtol=RTOL,
                               err_msg="fused vs unfused top-k")
    assert_ids_equal_away_from_ties(ids, uids, uvals, "fused vs unfused top-k")
    log("   fused == unfused (values rtol 1e-4, ids away from near-ties)")

    planes, bits, beta = index._device_planes(), index.bits, index.temperature
    db = index._device_sig(index.doc_sig, "doc")
    qn = ops._prep_queries(torch.as_tensor(index.query_vectors(words),
                                           device=dev))
    b, dim, m, w = qn.shape[0], planes.shape[1], db.shape[0], db.shape[1]
    tm = k.topk_tile(10)
    cv, ci = k.asym_topk_kernel(qn, planes, db, bits, 10, temperature=beta)
    cv2, ci2 = k.asym_topk_kernel(qn, planes, db, bits, 10, temperature=beta)
    same(cv, cv2, "top-k at the serving shapes")
    same(ci, ci2, "top-k at the serving shapes")
    rv, ri = ref.asym_topk_candidates_ref(qn, db, planes, bits, 10, tm, beta)
    err = finite_err(cv, rv)
    close(cv, rv, "top-k candidates at the serving shapes")
    assert_ids_equal_away_from_ties(ci, ri, rv,
                                    "top-k candidates at the serving shapes")
    # exact: the oracle over row 1's scores of every doc
    scores = k.asym_similarity_kernel(qn, planes, db, bits, temperature=beta)
    ev, ei = topk_candidates_from_scores(scores, 10, tm)
    if not (torch.equal(cv, ev) and torch.equal(ci, ei)):
        raise AssertionError("top-k candidates at the serving shapes differ "
                             "from the oracle over the similarity kernel's "
                             "scores")
    ties = ties_by_index(cv, ci, 10, "top-k candidates at the serving shapes")
    log(f"   top-k candidates == the oracle over row 1's "
        f"{list(scores.shape)} scores, values and ids bit for bit ({ties} "
        f"exact ties, lowest index first)")
    ballots, sorts, inserts = selection_work(scores, tm, 10)
    del scores, ev, ei
    n_tiles = -(-m // tm)
    # a per-tile top-k selection takes about one compare per candidate
    nbytes = 4.0 * (m * w + b * dim + bits * dim + 2 * b * n_tiles * 10)
    bound_ms, bound_by = bound(least_ops(b, m, bits, dim, 3) + b * m, nbytes)
    sel_ms, _ = bound(least_ops(b, m, bits, dim, 3)
                      + 32.0 * (ballots + 15 * sorts + inserts), nbytes)
    selection = k.topk_selection(10)
    log(f"   top-k selection ({selection}): {ballots} chunk ballots, {sorts} "
        f"warp sorts and {inserts} insertions over {b} x {n_tiles} (query, "
        f"tile) pairs ({inserts / (b * n_tiles)} insertions a pair); bound "
        f"with them (32 lanes a ballot or an insertion, 15 x 32 a sort): "
        f"{sel_ms} ms")
    kr = dict(
        name="asym_exp_topk", route="cuda",
        source="src/repro_torch/csrc/asym.cu",
        replaces="src/repro/kernels/asym/kernel.py:240",
        selection=selection, launches=launches, max_abs_err=err,
        **timed(lambda: k.asym_topk_kernel(qn, planes, db, bits, 10,
                                              temperature=beta)),
        plain_ms=time_ms(lambda: ref.asym_topk_candidates_ref(
            qn, db, planes, bits, 10, tm, beta)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    log_kernel(kr, dict(B=b, M=m, k=10, tm=tm, dim=dim, bits=bits))
    return [kr]


# ----------------------------------------------------------------------
# phase 3 (cont.): the offline-build kernels at the reference's shapes
# ----------------------------------------------------------------------
def negsamp_close(got, want, atol: float, what: str) -> float:
    """Assert each of row 11's four outputs within rtol=1e-5 and ``atol``
    of the plain version's; returns the max abs error."""
    err = 0.0
    for name, g, w in zip(("loss", "grad_d", "grad_w", "grad_wn"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=atol,
                                   msg=lambda m: f"{what} {name}: {m}")
        err = max(err, float((g.double() - w.double()).abs().max())
                  if g.numel() else 0.0)
    return err


def kernel_phase_build(dev: torch.device) -> None:
    """Rows 11 and 12 against their plain versions at the reference's
    test shapes, each twice (bitwise run to run); row 12 also on
    duplicated centroids, where the first index must win.  Row 11's
    inputs here are N(0, 1), as the reference's are: two programs that
    sum a float32 dot product in different orders differ by its
    rounding, which the temperature amplifies once in the logit and
    again in the gradient, so the gradients are held at atol 1e-5 * t^2
    (tests/test_torch_negsamp.py measures it); on unit rows (the step
    shape, phase 12) the reference's atol 1e-6 holds."""
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.kernels.kmeans import ref as kref
    from repro_torch.kernels.negsamp import kernel as nk
    from repro_torch.kernels.negsamp import ref as nref
    from repro_torch.testing import (KMEANS_SHAPES, NEGSAMP_SHAPES,
                                     assert_assign_away_from_ties)

    for b, dim, k, t in NEGSAMP_SHAPES:
        rng = np.random.default_rng(b)
        d, w, wn = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                    .to(dev) for s in ((b, dim), (b, dim), (b, k, dim)))
        got = nk.negsamp_grads_kernel(d, w, wn, temperature=t)
        again = nk.negsamp_grads_kernel(d, w, wn, temperature=t)
        for g, a in zip(got, again):
            same(g, a, f"negsamp B={b} dim={dim} K={k}")
        err = negsamp_close(got, nref.negsamp_grads_ref(d, w, wn, t),
                            1e-5 * t * t, f"negsamp B={b} dim={dim} K={k} t={t}")
        log(f"   negsamp ok at B={b} dim={dim} K={k} t={t} (max abs err "
            f"{err:.3g})")

    def unit(rng, n, dim):
        x = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32))
        return (x / x.norm(dim=1, keepdim=True)).to(dev)

    for n, k, dim in KMEANS_SHAPES:
        rng = np.random.default_rng(n)
        x, c = unit(rng, n, dim), unit(rng, k, dim)
        ids, best = kk.assign_kernel(x, c)
        ids2, best2 = kk.assign_kernel(x, c)
        same(ids, ids2, f"kmeans N={n} K={k}")
        same(best, best2, f"kmeans N={n} K={k}")
        want_ids, want_best = kref.assign_ref(x, c)
        if not torch.equal(ids, want_ids):
            raise AssertionError(f"kmeans N={n} K={k} dim={dim}: "
                                 f"assignment differs from plain")
        err = close(best, want_best, f"kmeans N={n} K={k} best score")
        log(f"   kmeans assign ok at N={n} K={k} dim={dim} (exact ids, "
            f"scores max abs err {err:.3g})")
    rng = np.random.default_rng(7)
    x, c = unit(rng, 4000, 64), unit(rng, 300, 64)
    c[200:] = c[:100]                      # c[j] copies c[j - 200]
    ids, _ = kk.assign_kernel(x, c)
    held = assert_assign_away_from_ties(ids, x, c, "kmeans duplicated")
    if bool((ids >= 200).any()):
        raise AssertionError("a duplicated centroid did not give the first "
                             "index")
    log(f"   kmeans assign on duplicated centroids: first index always, "
        f"{held} clear rows equal plain")


# ----------------------------------------------------------------------
# phases 12-14: the offline index build
# ----------------------------------------------------------------------
def train(corpus, dev: torch.device, what: str):
    """``train_pv_dbow`` at the EmApprox PV settings with row 11's counter
    zeroed first, its callback reading the loss at every step; checks
    the launches, the loss and the tables.  ``corpus_pairs`` is timed by
    a call of its own before training.  Returns (model, launches, walls:
    ``corpus_pairs``, the steps after the first, the whole training)."""
    from repro_torch.configs.emapprox import CONFIG
    from repro_torch.core import pv_dbow
    from repro_torch.kernels.negsamp import kernel as nk

    pv = CONFIG.pv
    t = time.perf_counter()
    n_pairs = pv_dbow.corpus_pairs(corpus, pv.noise_power, pv.subsample_t,
                                   pv.seed).doc_of_token.shape[0]
    pairs_s = time.perf_counter() - t
    losses, first_step_at = [], []

    def every_step(step, loss):
        if step == 0:
            first_step_at.append(time.perf_counter())
        losses.append(loss)
        if step % 100 == 0 or step == pv.steps - 1:
            log(f"      {what} step {step}: loss {loss:.5f}")

    nk.negsamp_grads_kernel.launches = 0
    t = time.perf_counter()
    model = pv_dbow.train_pv_dbow(corpus, pv, device=dev, callback=every_step,
                                  log_every=1)
    torch.cuda.synchronize()
    end = time.perf_counter()
    launches = nk.negsamp_grads_kernel.launches
    loop_s = end - first_step_at[0]
    walls = dict(corpus_pairs_s=pairs_s, step_loop_s=loop_s,
                 train_s=end - t)
    log(f"   {what}: {corpus.n_docs} docs, {n_pairs} pairs after "
        f"subsampling, {pv.steps} steps of {pv.batch_pairs}; corpus_pairs "
        f"{pairs_s:.3f} s (own call), training {end - t:.3f} s, steps 1.."
        f"{pv.steps - 1} {loop_s:.3f} s ({1e3 * loop_s / (pv.steps - 1):.3f}"
        f" ms a step, the loss read back each step)")
    if launches != pv.steps or len(losses) != pv.steps:
        raise AssertionError(f"{what}: negsamp_grads launched {launches} "
                             f"times, {len(losses)} losses, in {pv.steps} "
                             f"steps")
    first, last = float(np.mean(losses[:100])), float(np.mean(losses[-100:]))
    log(f"   {what}: mean loss of the first 100 steps {first:.5f}, of the "
        f"last 100 {last:.5f}")
    if not last < first:
        raise AssertionError(f"{what}: the loss did not fall")
    for name, tab in (("word", model.word_vecs), ("doc", model.doc_vecs)):
        norms = torch.linalg.norm(tab, dim=1)
        if not (bool(torch.isfinite(tab).all())
                and float((norms - 1.0).abs().max()) <= 1e-4):
            raise AssertionError(f"{what}: a {name} row is not finite and "
                                 f"of unit norm")
    return model, launches, walls


def train_phase(dev: torch.device, ctx: dict) -> list:
    """Phase 12: training on the serving corpus, then row 11 at the step
    shape."""
    from repro_torch.configs.emapprox import CONFIG
    from repro_torch.kernels.negsamp import kernel as nk
    from repro_torch.kernels.negsamp import ref as nref

    corpus = ctx["corpus"]
    model, launches, walls = train(corpus, dev, "train")
    ctx["model"], ctx["train_launches"] = model, launches
    pv = CONFIG.pv
    b, k, dim, t = pv.batch_pairs, pv.negatives, pv.dim, pv.temperature
    gen = torch.Generator(device=dev).manual_seed(11)
    doc_ids = torch.randint(0, corpus.n_docs, (b,), generator=gen, device=dev)
    word_ids = torch.randint(0, corpus.vocab_size, (b,), generator=gen,
                             device=dev)
    neg_ids = torch.randint(0, corpus.vocab_size, (b, k), generator=gen,
                            device=dev)
    d = model.doc_vecs[doc_ids]
    w = model.word_vecs[word_ids]
    wn = model.word_vecs[neg_ids]
    got = nk.negsamp_grads_kernel(d, w, wn, temperature=t)
    for g, a in zip(got, nk.negsamp_grads_kernel(d, w, wn, temperature=t)):
        same(g, a, "negsamp at the step shape")
    # unit rows: every dot is at most 1, so the reference's atol holds
    err = negsamp_close(got, nref.negsamp_grads_ref(d, w, wn, t), 1e-6,
                        "negsamp at the step shape")
    nbytes = 4.0 * (2 * b * dim + b * k * dim) + 4.0 * (b + 2 * b * dim
                                                         + b * k * dim)
    # per row: 1 + K dots (2 dim each), g_d (2 dim each), g_w and g_wn
    # (dim each), and the softplus / sigmoid of each logit (~8 each)
    ops = b * ((1 + k) * 4.0 * dim + (1 + k) * dim + (1 + k) * 8.0)
    bound_ms, bound_by = bound(ops, nbytes)
    device = graph_ms(lambda: nk.negsamp_grads_kernel(d, w, wn, temperature=t))
    kr = dict(
        name="negsamp_grads", route="cuda",
        source="src/repro_torch/csrc/negsamp.cu",
        replaces="src/repro/kernels/negsamp/kernel.py:68",
        launches=launches, launches_by_path={"train": launches},
        max_abs_err=err, ms=device, device_ms=device,
        plain_ms=time_ms(lambda: nref.negsamp_grads_ref(d, w, wn, t)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        dispatch_ms=time_ms(
            lambda: nk.negsamp_grads_kernel(d, w, wn, temperature=t)))
    log_kernel(kr, dict(B=b, K=k, dim=dim, t=t, **walls))
    log(f"   negsamp ms is device time (100 launches in one CUDA graph); "
        f"one call from the host, dispatch included: "
        f"{kr['dispatch_ms']:.4f} ms")
    return [kr]


def kmeans_phase(dev: torch.device, ctx: dict) -> list:
    """Phase 13: spherical k-means of the trained doc vectors into
    n_shards clusters, unbalanced; then row 12 at that shape."""
    from repro_torch.core import allocation
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.kernels.kmeans import ref as kref
    from repro_torch.testing import assert_assign_away_from_ties

    corpus, model = ctx["corpus"], ctx["model"]
    k = corpus.n_shards
    cfg = allocation.KMeansConfig(n_clusters=k, balanced=False)
    stamps = []

    def after_assign(it):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    kk.assign_kernel.launches = 0
    t = time.perf_counter()
    assign, centroids = allocation.spherical_kmeans(
        model.doc_vecs, cfg, device=dev, callback=after_assign)
    wall = time.perf_counter() - t
    launches = kk.assign_kernel.launches
    iterations = len(stamps) - 1
    steps = np.diff([t] + stamps)
    log(f"   k-means of {corpus.n_docs} docs into {k} clusters: "
        f"{iterations} iterations, {launches} assign launches, wall "
        f"{wall:.3f} s; wall of the first assignment and of each iteration "
        f"(update + assign) (s): " + ", ".join(f"{x:.4f}" for x in steps))
    if launches != iterations + 1:
        raise AssertionError(f"kmeans_assign launched {launches} times in "
                             f"{iterations} iterations")
    sizes = np.bincount(assign, minlength=k)
    log(f"   cluster sizes: max {sizes.max()}, empty {int((sizes == 0).sum())}"
        f", median {np.median(sizes)}")
    ctx["kmeans_launches"] = launches
    t = time.perf_counter()
    assign2, centroids2 = allocation.spherical_kmeans(model.doc_vecs, cfg,
                                                      device=dev)
    if not (np.array_equal(assign, assign2)
            and np.array_equal(centroids.view(np.uint32),
                               centroids2.view(np.uint32))):
        raise AssertionError("a second spherical_kmeans from the same seed "
                             "gave another assignment or other centroid "
                             "bits")
    log(f"   a second k-means from the same seed: the same assignment and "
        f"centroid bits ({time.perf_counter() - t:.3f} s)")

    x = allocation._unit(model.doc_vecs.float())
    c = torch.as_tensor(centroids, device=dev)
    ids, best = kk.assign_kernel(x, c)
    ids2, best2 = kk.assign_kernel(x, c)
    same(ids, ids2, "kmeans at the allocation shape")
    same(best, best2, "kmeans at the allocation shape")
    if not np.array_equal(ids.cpu().numpy(), assign):
        raise AssertionError("the kernel on the final centroids does not "
                             "give spherical_kmeans' assignment")
    held = assert_assign_away_from_ties(ids, x, c, "final assignment")
    want_ids, want_best = kref.assign_ref(x, c)
    err = close(best, want_best, "kmeans best scores")
    log(f"   final assignment equals the plain version on {held} of "
        f"{x.shape[0]} rows (the rest within 1e-4 of a tie; "
        f"{int((ids != want_ids).sum())} differ there)")

    n, dim = x.shape

    def library():
        step = kref.chunk_rows(k)
        for lo in range(0, n, step):
            torch.max(torch.matmul(x[lo:lo + step], c.T), dim=1)

    nbytes = 4.0 * (n * dim + k * dim) + 8.0 * n
    bound_ms, bound_by = bound(2.0 * n * k * dim + 1.0 * n * k, nbytes)
    kr = dict(
        name="kmeans_assign", route="cuda",
        source="src/repro_torch/csrc/kmeans.cu",
        replaces="src/repro/kernels/kmeans/kernel.py:42",
        launches=launches, launches_by_path={"kmeans": launches},
        max_abs_err=err,
        **timed(lambda: kk.assign_kernel(x, c), reps=5, warmup=1),
        plain_ms=time_ms(lambda: kref.assign_ref(x, c), reps=5, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(library, reps=5, warmup=1),
        library_call="torch.matmul + torch.max(dim=1), per chunk of "
                     f"{kref.chunk_rows(k)} rows (two calls a chunk)")
    log_kernel(kr, dict(N=n, K=k, dim=dim, iterations=iterations))
    log(f"   library (chunked matmul + max): {kr['library_ms']:.4f} ms")
    return [kr]


def build_serve_phase(dev: torch.device, args, kernels: list) -> None:
    """Phase 14: the JAX package's offline build and one served batch, in
    the order of examples/serve_queries.py, on a fresh corpus; adds this
    path's launches to the records of rows 1, 2, 11 and 12."""
    from repro_torch.configs.emapprox import CONFIG
    from repro_torch.core.allocation import allocate_corpus
    from repro_torch.core.index import build_index
    from repro_torch.core.lsh import LSHConfig
    from repro_torch.core.queries import QueryBatch
    from repro_torch.data.corpus import generate_text_corpus
    from repro_torch.data.store import ShardedCorpus
    from repro_torch.kernels.asym import kernel as ak
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.runtime.executor import ShardTaskExecutor

    walls = {}
    t = time.perf_counter()
    ccfg = dataclasses.replace(CONFIG.corpus, n_docs=args.build_docs,
                               seed=args.seed)
    docs, _ = generate_text_corpus(ccfg)
    corpus = ShardedCorpus.from_documents(docs, ccfg.vocab_size,
                                          shard_tokens=CONFIG.shard_tokens)
    del docs
    walls["corpus_and_shard_s"] = time.perf_counter() - t
    log(f"   corpus: {corpus.n_docs} docs, {corpus.n_tokens} tokens, "
        f"{corpus.n_shards} shards")
    ak.asym_similarity_kernel.launches = 0
    ak.asym_segment_sum_kernel.launches = 0
    kk.assign_kernel.launches = 0
    model, n_train, tw = train(corpus, dev, "build train")
    walls["train_s"] = tw["train_s"]
    t = time.perf_counter()
    pre = build_index(corpus, model, LSHConfig(bits=128), use_lsh=False,
                      temperature=CONFIG.pv.temperature, device=dev)
    walls["pre_index_s"] = time.perf_counter() - t
    t = time.perf_counter()
    allocated = allocate_corpus(corpus, pre.doc_vecs, device=dev)
    walls["allocate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    index = build_index(allocated, model, CONFIG.lsh,
                        temperature=CONFIG.pv.temperature, granularity="doc",
                        device=dev).attach_corpus(allocated)
    index._fused_device_arrays()
    torch.cuda.synchronize()
    walls["index_s"] = time.perf_counter() - t

    n, k = corpus.n_docs, corpus.n_shards
    cap = int(np.ceil(n / k * 1.25))
    lens = np.zeros(n, np.int64)
    for s in allocated.shards:
        lens[s.doc_ids] = np.diff(s.offsets)
    want_lens = np.zeros(n, np.int64)
    for s in corpus.shards:
        want_lens[s.doc_ids] = np.diff(s.offsets)
    ids = np.sort(np.concatenate([s.doc_ids for s in allocated.shards]))
    per_shard = allocated.shard_doc_counts()
    if not (allocated.n_shards == k and np.array_equal(ids, np.arange(n))
            and allocated.n_tokens == corpus.n_tokens
            and np.array_equal(lens, want_lens)):
        raise AssertionError("the reallocated corpus lost or changed a "
                             "document")
    if per_shard.max() > cap:
        raise AssertionError(f"a shard holds {per_shard.max()} docs, over "
                             f"_rebalance's cap {cap}")
    log(f"   allocated: {allocated.n_shards} shards, every doc and token "
        f"kept, docs per shard max {per_shard.max()} (cap {cap}), min "
        f"{per_shard.min()}")

    counts = np.bincount(np.concatenate([s.tokens for s in allocated.shards]),
                         minlength=ccfg.vocab_size)
    queries = make_queries(counts, BUILD_BATCH,
                           np.random.default_rng(args.seed + 7),
                           n / 3200)
    seen = []
    with ShardTaskExecutor(workers=4, adaptive_workers=True) as ex:
        engine = QueryBatch(allocated, index, executor=ex)
        record_planning(engine, seen)
        t = time.perf_counter()
        res = engine.execute(queries, args.rate,
                             rng=np.random.default_rng(args.seed + 5))
        torch.cuda.synchronize()
        walls["batch_s"] = time.perf_counter() - t
    launches = {"asym_exp_similarity": ak.asym_similarity_kernel.launches,
                "asym_exp_segment_sum": ak.asym_segment_sum_kernel.launches,
                "kmeans_assign": kk.assign_kernel.launches,
                "negsamp_grads": n_train}
    log(f"   launches on the offline-build path: {launches}")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} never launched on the offline "
                                 f"build")
    qs, rows, plan_s = seen[0]
    check_rows(rows, plain_rows(index, qs), "offline-build batch")
    errs = []
    for q, r in zip(queries, res):
        if q.kind == "count":
            truth = float(counts[q.phrase[0]])
            if not (math.isfinite(r.estimate.value) and r.estimate.value >= 0):
                raise AssertionError(f"count estimate {r.estimate.value}")
            errs.append(abs(r.estimate.value - truth) / truth)
        elif q.kind == "ranked" and not np.all(np.isfinite(r.scores)):
            raise AssertionError("malformed ranked result")
    log(f"   batch: {len(queries)} queries at rate {args.rate}, planning "
        f"{plan_s:.3f} s, shards read {sum(r.shards_read for r in res)}; "
        f"rows match the plain path")
    log(f"   count-estimate relative errors ({len(errs)} count queries): "
        f"median {np.median(errs):.4f}, mean {np.mean(errs):.4f}, max "
        f"{np.max(errs):.4f}")
    log("   walls (s): " + ", ".join(f"{k_}={v:.3f}"
                                     for k_, v in walls.items()))
    for kr in kernels:
        if kr["name"] in launches:
            kr.setdefault("launches_by_path",
                          {"serving": kr["launches"]})["offline_build"] = \
                launches[kr["name"]]


def main(argv=None) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-docs", type=int, default=1 << 20)
    p.add_argument("--batches", type=int, default=SERVE_BATCHES)
    p.add_argument("--batch", type=int, default=48)
    p.add_argument("--warm-batch", type=int, default=WARM_BATCH)
    p.add_argument("--rate", type=float, default=0.05)
    p.add_argument("--build-docs", type=int, default=1 << 16)
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
    rate, rate_note = popc_rate()
    log(f"== popcount rate for the Hamming bounds: {rate_note}")
    log("== kernels vs plain versions at the reference's test shapes")
    kernel_phase(dev)
    kernel_phase_ranked(dev)
    distance_launches = kernel_phase_hamming(dev)
    kernel_phase_build(dev)
    log("== small input: CUDA index vs CPU index, asym and sym")
    small_phase(dev, args.seed)
    log(f"== serving: n_docs={args.n_docs}, a batch of {args.batch} then "
        f"{args.batches - 1} of {args.warm_batch} at rate {args.rate}")
    kernels, ctx = serve_phase(dev, args)
    ctx["popc_rate"] = rate
    log("== megascan: sum and ranked specs through the group route")
    mega = megascan_phase(dev, args, ctx)
    log("== ranked top-k over every document")
    kernels += topk_phase(dev, ctx) + mega
    log(f"== sym serving: 1 batch of {args.batch} at rate {args.rate} on the "
        f"same corpus, lsh_mode='sym'")
    sym = sym_serve_phase(dev, args, ctx, args.rate)
    log("== sym megascan: a Hamming sum spec through the group route")
    sym += sym_megascan_phase(dev, ctx)
    log("== sym top-k over every document")
    kernels += sym_topk_phase(dev, ctx, distance_launches) + sym
    log("== train: PV-DBOW at the EmApprox settings on the serving corpus")
    kernels += train_phase(dev, ctx)
    log(f"== k-means: the trained doc vectors into {ctx['corpus'].n_shards} "
        f"clusters, unbalanced")
    kernels += kmeans_phase(dev, ctx)
    log(f"== offline build and serve: {args.build_docs} docs, train, "
        f"pre-index, allocate, index, a batch of {BUILD_BATCH}")
    build_serve_phase(dev, args, kernels)
    log(f"== done in {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
