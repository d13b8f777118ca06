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
                arithmetic in PyTorch on the card; row 1 prints its
                launch too.  The Hamming
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
                over 5 alternating runs.  Row 8 on the full fleet equals
                ``testing.hamming_warp_sums`` (its exact model) bit for
                bit, prints its launch (grid, blocks per SM, shared
                memory a block) and is timed once more with the L2
                cache flushed before each launch (``cold_device_ms``).
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

 15. ingest   — live ingest at 2^20 docs: a doc-granular, centred index
                over the serving corpus from phase 12's trained model;
                1024 new documents (``generate_text_corpus``, another
                seed) appended at 4096-token shards (the open shard grows,
                new shards spill); ``refresh_appended`` at 50 inference
                steps, each document timed; then the checks: old doc rows
                and untouched shard rows byte-identical, touched shard
                rows the build ops over the new membership (mean, then
                ``_sign_rows``) bit for bit, doc frequencies exact, the
                refreshed index's row-2 planning of a batch within rtol
                1e-4 of the plain version over arrays rebuilt from the new
                corpus, a megascan sum over the touched and new shards bit
                for bit the per-shard route, and a semantic-cache entry
                from before the swap not served after the content bump;
                then a batch of 12 on the new generation.  Prints the
                inference ms a document (median, p90), the refresh wall
                by step (inference, signing, centroids, doc frequencies,
                the first device upload) and the batch wall.
 16. stack    — ``build_serving_stack`` on phase 14's build: 4 simulated
                hosts, 2 replicas, balanced, cache, planner, window, fleet
                and ingest, the megakernel route on.  96 mixed queries
                stream through the window while the ingestor appends 4 x
                256 documents (spilling new shards, so the placement
                extends) and a fault plan crashes host 2 at the second
                host-group job; every future resolves.  Then a megascan
                sum through the host group: row 7 launches once a host
                group with work, bitwise the per-shard route; and a census
                through the stack equals the exact counts of the final
                corpus under the last generation minted.  Prints the
                window's batch sizes, the controller's plan, each ingest
                step's wall, the host-group walls and the balance and
                budget audits.
 17. recommend — a review corpus of 8192 users and 2048 items
                (``generate_review_corpus``, vocab 8192, 16 topics; the
                generation time is printed), user documents sharded at
                4096 tokens, PV-DBOW at the EmApprox settings (row 11), an
                asym and a sym index, and benchmarks/recsys_bench.py's
                protocol (40 test users, 20 % of each one's ratings held
                out, rates 0.10 / 0.25 / 0.50 / 1.0, ``emapprox`` against
                ``srcs``; the sym index at 0.25): MSE and P@10 printed,
                not gated.  Gate: ``vector_shard_similarities_batch`` of
                the 40 user vectors against its plain version, row 1
                within rtol 1e-4, row 5 exactly.
 18. LM serving — the LM model zoo's serving path, which launches no
                kernel of rows 1-12 (their counts are zeroed before it
                and must read 0 after); its self-attention takes row 13,
                the fused attention forward, whose launches are counted
                (path ``lm_serve``, at least one).  (a) smollm-360m and mamba2-780m at
                full width through ``launch/serve.serve``: parameters
                drawn on the card from a seeded ``torch.Generator``, the
                default policy (fp32 parameters, bf16 compute and KV
                cache), batch 4, prompt 64 (mamba2: 320, across a
                256-token SSD chunk), 32 greedy tokens after one short
                warm-up call; prints the parameter count and bytes, the
                prefill ms, decode ms a token (median, p90), tokens/s,
                ``torch.cuda.max_memory_allocated`` (and its rise over
                what was live before the call) and, from
                ``torch.profiler`` over 3 decode steps, device ops and
                device-busy ms a step and the idle share.  (b) The same
                parameters under the fp32 policy: prefill + one
                ``decode_step`` against the teacher-forced ``forward``
                within 5e-3 of max |logit|, and the card's ``forward``
                against the CPU's at b=1, s=16 within ``LM_CPU_TOL``
                (1e-3; mamba2 5e-3, fixed from the readings in PERF.md:
                at full width it amplifies float32 rounding past 1e-3);
                every logit finite; the same two checks read again with
                the card at the default (bf16) policy, which must fail
                the card-vs-CPU bound.  (d) All ten architectures at
                smoke width, fp32 policy: forward and prefill + decode
                on the card against the same parameters on the CPU,
                within 1e-4.
 19. LM training — ``launch/train`` (``main``, in process) for
                smollm-360m at full width: 65536 docs (~40 shards of
                2^18 tokens), ``--similarity-prompt`` over four frequent
                word ids (PV-DBOW training, row 11, and the prompt's shard
                probabilities, row 1, on the card), batch 8 x 256, 10
                steps, a checkpoint every 10 in a temporary directory;
                the counts of rows 1 and 11 zeroed before and read after
                (path ``lm_train``), every logged loss finite.  (b) The
                committed step restores bit for bit equal to the state in
                memory; a second call to 15 steps resumes from step 10.
                (c) 10 steps of ``make_train_step`` (warmup_steps=1) on one
                fixed batch at full width: the loss falls for smollm-360m
                (lr 5e-3) and mamba2-780m (lr 1e-3, the reference's for
                SSM).  (d) fp32 policy, b=1, s=16, the same stacked
                parameters: the loss within rtol 1e-4 and every
                gradient leaf within twice the run's own largest move of
                the CPU's gradients under one ulp of the parameters
                (printed beside each reading), at most ``TRAIN_CPU_TOL``
                (3e-3; mamba2 3e-2, fixed from the readings in PERF.md),
                of its max |CPU gradient|.  (e) Every architecture at
                smoke width, fp32 policy, two steps (the first has lr 0)
                on the card against the CPU: loss and grad_norm within
                twice the CPU's largest move under 8 one-ulp draws, at
                most rtol 1e-4 (Whisper 3e-3, Maverick 1e-3, the VLM
                4e-4, fixed the same way), the parameters
                within 2 lr at worst and 1e-3 lr at the median (q8
                moments for smollm, bf16 for maverick).  (f)
                Step walls (CUDA events; median, p90), tokens/s, a
                ``torch.profiler`` count of 3 steps (device ops and
                device-busy ms a step, idle share), peak memory, the
                checkpoint snapshot, write and restore walls, and whether
                one step from one state repeats bit for bit.  Rows 1 and
                11 are also held against their plain versions at the
                training path's shapes.
 20. distributed — the sharded side on one card: (a) a one-rank NCCL
                process group made through a ``HashStore`` and
                ``make_host_mesh("cuda")``'s (1, 1) (data, model) mesh;
                (b) ``launch/train`` for smollm-360m at full width through
                that mesh, phase 19's arguments cut to 6 steps with a
                checkpoint every 3 (the state placed as DTensors by
                ``params_shardings`` / ``opt_state_shardings``, the
                sharded step), rows 1 and 11 counted on path
                ``lm_train_mesh``; (c) the sharded step against the
                unsharded step from (b)'s state on one batch with part of
                a row masked, micro-batches 1 and 2: parameters, moments
                and loss equal bit for bit; (d) ``compressed_tree_psum``
                on the NCCL group equal bit for bit to
                ``quantize_roundtrip`` of the same tree; (e) a note that
                one card cannot time a multi-GPU step (none is
                modelled); (f) the process group destroyed.
 21. MoE      — the MoE family through the sharded step on one card, on
                its own one-rank NCCL group: (a) llama4-scout at full
                width (d 5120, 16 experts, top-1, vocab 202048) cut to 1
                layer, batch 8 x 256 (one dispatch group of 2048 tokens,
                capacity 160): ``make_sharded_grads`` (the sharded
                step's loss and gradients, before AdamW, through the
                expert-parallel MoE block with every collective the
                identity) equal to the unsharded ``_value_and_grad`` bit
                for bit, no collective launched, walls and peak memory (the AdamW state of 4.1e9
                parameters does not fit 80 GB); (b) at that width with no
                process group, what each rank would compute: the places
                and kept flags of 4 contiguous token ranges, each routed
                on its own rows from the earlier ranges' counts, equal to
                a plain whole-batch cumsum's at capacity factors 1.25 and
                0.5 (drops
                printed by range, some required after the first), and the
                block's output as the sum of the partials of 4 and of 16
                expert ranges against ``moe_apply`` (bit for bit, or
                within one bf16 ulp of each entry with the difference
                printed); (c) Scout and Maverick at smoke width (moments
                as phase 19's (e)), micro-batches 1 and 2: the whole
                sharded step bit for bit with the unsharded one, no
                collective; (d) the EmApprox kernel counts read 0.
 22. TP       — tensor parallelism over ``model`` on one card: (a) on
                its own one-rank NCCL group, smollm-360m at full width,
                phase 20's 8 x 256 batch with part of a row masked:
                ``make_sharded_grads`` (its ``TPShard`` of one rank
                passed to ``loss_fn``: the split attention, MLPs,
                embedding, head and vocabulary-parallel loss, each
                collective the identity) equal to the unsharded
                ``_value_and_grad`` bit for bit, no collective, both
                walls; (b) with no process group, what each rank of a
                split computes (``TPShard.simulated``) at full width,
                8 x 256: smollm-360m at 5 ranks (head split, vocabulary
                whole), at 16 (query-row split, 16 rows and 3072 words
                a rank) and qwen2.5-14b at 8 (head split with QKV bias):
                layer 0's self-attention and MLP, each rank's partial in
                turn, summed or concatenated, and the head with the
                vocabulary-parallel loss in lockstep
                (``testing.lockstep``); every output and the input and
                weight gradients within ``run_bound`` (twice the whole
                sublayer's own move under one ulp of its inputs, at most
                1e-3) of the whole sublayer's; (c) the EmApprox kernel
                counts read 0.
 23. SSM, cross, serving — the rest of the ``model`` split, and the
                sharded prefill and decode: (a) on its own one-rank NCCL
                group, mamba2-780m at full width, phase 20's 8 x 256
                batch: ``make_sharded_grads`` (its ``TPShard`` reaching
                every SSM) equal to ``_value_and_grad`` bit for bit, no
                collective, both walls; (b) with no process group, each
                rank's partial of layer 0 at full width, fp32, 8 x 256:
                mamba2's SSM at 16 ranks (heads), hymba's hybrid mixer
                (attention by query rows, SSM by heads, mixed in float32)
                at 2 in lockstep, the VLM's first cross-attention at 16
                (decoder rows, 1601 vision tokens) and Whisper's first
                decoder cross-attention at 4 (heads): the output and the
                input, ``enc`` and weight gradients joined within
                ``run_bound`` of the whole sublayer's; (c) on the NCCL
                group, ``make_prefill_step`` / ``make_decode_step`` with
                the mesh for smollm-360m and mamba2-780m at phase 18's
                shapes (batch 4, prompt 64 and 320, 32 tokens, the
                unsharded greedy tokens fed to both): logits and the
                placed state bit for bit the unsharded ``prefill`` /
                ``decode_step``'s, walls of both; (d) with no process
                group, context-parallel decode at full width: smollm's
                layer 0 against a 2048-slot cache split 16 ways in
                lockstep, at a length where ranks 8-15 hold no valid
                slot and at a full cache, and mamba2 layer 0's decode
                state split by heads over 16 ranks, joined, within
                ``run_bound`` of the whole; (e) the EmApprox kernel
                counts read 0 (path ``serve_mesh``).
 24. attention — row 13, the fused attention forward, at the prefill
                cell's shapes (smollm-360m's 15 / 5 heads, head 64,
                causal, bfloat16; 1747 tokens x 37 prompts and 150 x
                436): against ``dense_attention`` in float32 within twice
                the bfloat16 ``dense_attention``'s own error, which the
                probabilities rounded to float8 exceed; bit for bit from
                run to run; ``ms``,
                ``device_ms``, the bound (causal operations over 989
                TFLOP/s against Q, K, V and O over 3.35 TB/s), the plain
                version's ms and ``scaled_dot_product_attention`` as
                ``library_ms`` (a yardstick: the port never calls it);
                its launches in phases 18, 19 and 23.

Each of the main paths (serving, megascan, top-k, their sym
counterparts, training, k-means, the offline build, ingest, the stack
and recommendation) is driven with the launch counters set to 0 just
before it and read just after; each of its kernels must have launched,
and launches made only to hold one route against another are left out.
The LM serving path (phase 18), the MoE path (phase 21) and the
tensor-parallel paths (phases 22 and 23) launch no kernel of rows 1-12:
their counts must read 0; the LM training paths (phases 19 and
20) launch rows 1 and 11.  Row 13 runs wherever a self-attention on
the card records no gradient (phases 18 and 23; its record counts
those and phase 19's).
Row 5 runs on four paths (the sym batch, the shard-granular planning,
the sym top-k, recommendation): its record's ``launches`` is the sym
batch's count and ``launches_by_path`` has each path's own; so do rows
1, 2, 7, 11 and 12 (their first path, the offline build, ingest, the
stack, recommendation and LM training).  The last three lines of standard
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
PEAK_BF16_FLOPS = 989e12       # H100 SXM, bf16 on the tensor cores, dense
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
FLUSH_BYTES = 128 << 20  # written between launches to time row 8 cold
RAGGED = (13, 8, 1, 0, 27, 64, 5)   # the reference's megascan shard census
MEGA_SHAPES = [  # (shard doc counts, tm, k, duplicated rows); dim 16, bits 64
    (RAGGED, 8, 5, False), (RAGGED, 16, 5, False), ((300, 40, 9), 256, 7, False),
    (RAGGED, 16, 5, True),
]


APPEND_DOCS = 1024      # documents phase 15 appends to the 2^20 corpus
INFER_STEPS = 50        # frozen-model inference steps a document
STACK_QUERIES = 96      # queries phase 16 streams through the window
STACK_STEPS = 4         # ingest steps of phase 16, STACK_DOCS docs each
STACK_DOCS = 256
STACK_YIELD_S = 2e-4    # the writer's yield a step (default 2 ms)
STACK_CRASH_JOB = 1     # host-group job at which the fault plan crashes
REVIEW_USERS = 8192     # phase 17's review corpus (cut, see PERF.md)
REVIEW_ITEMS = 2048
REVIEW_TEST_USERS = 40
REVIEW_RATES = (0.10, 0.25, 0.50)
# phase 18: the LM zoo's serving path.  (arch, prompt length) at full
# width: mamba2's prompt crosses its 256-token SSD chunk
LM_FULL = (("smollm-360m", 64), ("mamba2-780m", 320))
LM_BATCH = 4
LM_GEN = 32
LM_CPU_TOKENS = 16      # the b=1 forward held against the CPU
LM_DECODE_TOL = 5e-3    # prefill + decode against the teacher-forced forward
# the card's fp32 forward against the CPU's, fixed from the readings in
# PERF.md: mamba2 at full width moves 2.2e-3 on the CPU alone under a
# one-ulp change of its parameters
LM_CPU_TOL = {"smollm-360m": 1e-3, "mamba2-780m": 5e-3}
LM_SMOKE_TOL = 1e-4     # (d): every smoke arch, card against CPU


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


def cold_ms(fn, reps: int = 25) -> float:
    """Median CUDA-event time of one call of ``fn`` with the L2 cache
    flushed before it: a FLUSH_BYTES write (over the card's 50 MB of
    L2) runs ahead of each call, outside the events."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del flush
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
    from repro_torch.testing import hamming_warp_sums, ragged_segments

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
        if not torch.equal(got, hamming_warp_sums(
                qsig, pay.sig, pay.row_start, pay.row_count, 64, 4.0)):
            raise AssertionError(f"{what}: not bitwise its exact model")
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
    launch = k.sim_launch_shape(bits, m, b)
    log(f"   similarity launch: {launch}, 256 threads a block; max abs err "
        f"against the plain version {err}")
    kernels.insert(0, dict(
        name="asym_exp_similarity", route="cuda",
        source="src/repro_torch/csrc/asym.cu",
        replaces="src/repro/kernels/asym/kernel.py:151",
        launches=launches["asym_exp_similarity"], max_abs_err=err,
        launch=launch,
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
    from repro_torch.testing import hamming_warp_sums

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
    if not torch.equal(got, hamming_warp_sums(qsig, pay.sig, pay.row_start,
                                              pay.row_count, bits, beta)):
        raise AssertionError("hamming megascan, full fleet: not bitwise "
                             "testing.hamming_warp_sums")
    log(f"   hamming megascan, full fleet: bit for bit "
        f"testing.hamming_warp_sums over {real} real rows")
    nbytes = 4.0 * (b * w + real * w + 2 * n_slots + (32 * w + 1) + b * n_slots)
    bound_ms, bound_by = popc_bound(b * real * w, nbytes, ctx["popc_rate"])
    launch = mk.hamming_segsum_launch_shape(w, n_slots, b)
    log(f"   hamming megascan launch: {launch}, 256 threads a block")

    def call():
        return mk.hamming_megascan_segsum_kernel(
            qsig, pay.sig, pay.row_start, pay.row_count, bits,
            temperature=beta)

    kr = dict(
        name="hamming_megascan_segsum", route="cuda",
        source="src/repro_torch/csrc/megascan.cu",
        replaces="src/repro/kernels/megascan/kernel.py:222",
        launches=launches, max_abs_err=err, launch=launch, **timed(call),
        cold_device_ms=cold_ms(call),
        plain_ms=time_ms(lambda: mref.hamming_megascan_segsum_ref(
            qsig, pay.sig, bits, pay.row_start, pay.row_count, beta)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    log_kernel(kr, dict(B=b, real_rows=real, payload_rows=pay.n_rows,
                        S=n_slots, W=w, bits=bits))
    log(f"   hamming_megascan_segsum with L2 flushed before each launch "
        f"(a {FLUSH_BYTES >> 20} MB write): {kr['cold_device_ms']:.4f} ms "
        f"(warm {kr['device_ms']:.4f} ms)")
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


def build_serve_phase(dev: torch.device, args, kernels: list) -> dict:
    """Phase 14: the JAX package's offline build and one served batch, in
    the order of examples/serve_queries.py, on a fresh corpus; adds this
    path's launches to the records of rows 1, 2, 11 and 12.  Returns the
    allocated corpus, its index and the trained model (phase 16 serves
    them)."""
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
    return dict(corpus=allocated, index=index, model=model)


# ----------------------------------------------------------------------
# phases 15-17: live ingest, the serving stack, recommendation
# ----------------------------------------------------------------------
KERNEL_MODULES = {  # record name -> (module, wrapper) of each row counted
    "asym_exp_similarity": ("repro_torch.kernels.asym.kernel",
                            "asym_similarity_kernel"),
    "asym_exp_segment_sum": ("repro_torch.kernels.asym.kernel",
                             "asym_segment_sum_kernel"),
    "hamming_similarity": ("repro_torch.kernels.hamming.kernel",
                           "hamming_similarity_kernel"),
    "asym_megascan_segsum": ("repro_torch.kernels.megascan.kernel",
                             "asym_megascan_segsum_kernel"),
    "negsamp_grads": ("repro_torch.kernels.negsamp.kernel",
                      "negsamp_grads_kernel"),
}


def _wrapper(name: str):
    import importlib
    mod, fn = KERNEL_MODULES[name]
    return getattr(importlib.import_module(mod), fn)


def zero_counts(names) -> None:
    for n in names:
        _wrapper(n).launches = 0


def read_counts(names) -> dict:
    return {n: _wrapper(n).launches for n in names}


class uncounted:
    """Restore the named rows' counters on exit: launches made to hold a
    route against another (the per-shard megascan, plain checks) do not
    count as launches of the path."""

    def __init__(self, names):
        self.names = list(names)

    def __enter__(self):
        self.saved = read_counts(self.names)

    def __exit__(self, *exc):
        for n, c in self.saved.items():
            _wrapper(n).launches = c


def add_path(kernels: list, path: str, launches: dict) -> None:
    """Record this path's launches under ``launches_by_path`` of each
    row that ran on it."""
    for kr in kernels:
        if kr["name"] in launches:
            kr.setdefault("launches_by_path",
                          {"serving": kr["launches"]})[path] = \
                launches[kr["name"]]


def require_launched(launches: dict, path: str) -> None:
    log(f"   launches on the {path} path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the {path} path")


def fresh_segment_sums(index, corpus, vecs: np.ndarray) -> np.ndarray:
    """[B, n_shards] planning sums by row 2's plain version over arrays
    rebuilt here from the index's host arrays and the corpus' doc ->
    shard map (nothing read from the index's device caches)."""
    from repro_torch.core import lsh
    from repro_torch.kernels.asym import ref

    seg = np.asarray(corpus.doc_shard_map(), np.int64)
    order = np.argsort(seg, kind="stable")
    sig = lsh.to_packed_tensor(index.doc_sig[order], index.device)
    seg_t = torch.as_tensor(seg[order].astype(np.int32), device=index.device)
    planes = torch.as_tensor(np.asarray(index.planes, np.float32),
                             device=index.device)
    return ref.asym_exp_segment_sum_ref(
        torch.as_tensor(np.asarray(vecs, np.float32), device=index.device),
        sig, planes, index.bits, seg_t, corpus.n_shards,
        index.temperature).cpu().numpy().astype(np.float64)


def ingest_phase(dev: torch.device, args, ctx: dict, kernels: list) -> None:
    """Phase 15: live ingest at 2^20 docs on phase 12's trained model: a
    doc-granular index, 1024 appended documents (the open shard grows,
    new shards spill), ``refresh_appended`` at 50 inference steps, the
    checks of the refresh, the content fence, and one batch of 12 on the
    new generation."""
    from repro_torch.configs.emapprox import CONFIG
    from repro_torch.core import pv_dbow
    from repro_torch.core.index import _sign_rows, build_index, refresh_appended
    from repro_torch.core.queries import BatchQuery, QueryBatch
    from repro_torch.data.corpus import generate_text_corpus
    from repro_torch.kernels.megascan import MegascanSpec
    from repro_torch.runtime.executor import ShardTaskExecutor
    from repro_torch.runtime.generation import GenerationClock
    from repro_torch.runtime.qcache import SemanticQueryCache

    t_phase = time.perf_counter()
    corpus, model = ctx["corpus"], ctx["model"]
    t = time.perf_counter()
    index = build_index(corpus, model, CONFIG.lsh,
                        temperature=CONFIG.pv.temperature, granularity="doc",
                        keep_doc_vectors=True, center=True,
                        device=dev).attach_corpus(corpus)
    clock = GenerationClock()
    index.use_clock(clock)
    index._fused_device_arrays()
    torch.cuda.synchronize()
    log(f"   index over the trained model: {corpus.n_docs} docs, "
        f"{corpus.n_shards} shards, {time.perf_counter() - t:.3f} s")
    ccfg = dataclasses.replace(CONFIG.corpus, n_docs=APPEND_DOCS,
                               seed=args.seed + 101)
    docs, _ = generate_text_corpus(ccfg)
    new_docs = [d.tokens for d in docs]

    names = ["asym_exp_similarity", "asym_exp_segment_sum",
             "asym_megascan_segsum"]
    zero_counts(names)
    with ShardTaskExecutor(workers=4, adaptive_workers=True) as ex:
        cache = SemanticQueryCache()
        engine = QueryBatch(corpus, index, executor=ex, cache=cache)
        probe = [BatchQuery.count([int(w)]) for w in (11, 97, 503)]
        engine.execute(probe, args.rate, rng=np.random.default_rng(1))
        engine.execute(probe, args.rate, rng=np.random.default_rng(2))
        hits_before = cache.stats["hits"]
        if hits_before != len(probe):
            raise AssertionError(f"cache: {cache.stats} before the swap")

        # ---- append + refresh, inference timed per document ----
        t = time.perf_counter()
        grown, new_ids, affected = corpus.append_documents(
            new_docs, shard_tokens=CONFIG.shard_tokens)
        append_s = time.perf_counter() - t
        inner, per_doc = pv_dbow.infer_doc_vector, []

        def timed_infer(*a, **kw):
            t0 = time.perf_counter()
            vec = inner(*a, **kw)
            torch.cuda.synchronize()
            per_doc.append(time.perf_counter() - t0)
            return vec

        walls = {}
        pv_dbow.infer_doc_vector = timed_infer
        try:
            t = time.perf_counter()
            new = refresh_appended(index, grown, model, CONFIG.pv, new_docs,
                                   affected, infer_steps=INFER_STEPS,
                                   timings=walls)
            refresh_s = time.perf_counter() - t
        finally:
            pv_dbow.infer_doc_vector = inner
        t = time.perf_counter()
        new._fused_device_arrays()
        torch.cuda.synchronize()
        walls["first_upload_s"] = time.perf_counter() - t
        engine.swap_world(grown, new)
        gen = clock.bump_content()

        # ---- the refresh's checks ----
        n0, s0 = index.n_docs, index.shard_vecs.shape[0]
        spilled = grown.n_shards - corpus.n_shards
        if not (len(new_ids) == APPEND_DOCS and spilled > 0
                and corpus.n_shards - 1 in affected):
            raise AssertionError(f"append: {len(new_ids)} docs, {spilled} "
                                 f"new shards, affected {affected}")
        untouched = np.setdiff1d(np.arange(s0), np.asarray(affected))
        for name, a_, b_ in (
                ("doc vectors", new.doc_vecs[:n0], index.doc_vecs),
                ("doc signatures", new.doc_sig[:n0], index.doc_sig),
                ("shard vectors", new.shard_vecs[untouched],
                 index.shard_vecs[untouched]),
                ("shard signatures", new.shard_sig[untouched],
                 index.shard_sig[untouched])):
            if a_.tobytes() != b_.tobytes():
                raise AssertionError(f"refresh changed old {name}")
        touched = sorted(set(affected) | set(range(s0, grown.n_shards)))
        means = np.stack([new.doc_vecs[grown.shards[sid].doc_ids].mean(axis=0)
                          for sid in touched]).astype(np.float32)
        planes = torch.as_tensor(np.asarray(new.planes, np.float32),
                                 device=dev)
        if not (np.array_equal(new.shard_vecs[touched], means)
                and np.array_equal(new.shard_sig[touched],
                                   _sign_rows(means, planes))):
            raise AssertionError("touched shard rows differ from the build "
                                 "ops over the new membership")
        df = index.doc_freq.copy()
        for tok in new_docs:
            df[np.unique(np.asarray(tok, np.int64))] += 1
        if not np.array_equal(new.doc_freq, df):
            raise AssertionError("doc-frequency deltas are not exact")
        log(f"   appended {len(new_ids)} docs: open shard "
            f"{corpus.n_shards - 1} grew, {spilled} new shards "
            f"({grown.n_shards} in all); old rows and {untouched.shape[0]} "
            f"untouched shard rows byte-identical, {len(touched)} touched "
            f"rows = mean + _sign_rows bit for bit, doc frequencies exact")

        counts = np.bincount(np.concatenate([s.tokens for s in grown.shards]),
                             minlength=grown.vocab_size)
        queries = make_queries(counts, WARM_BATCH,
                               np.random.default_rng(args.seed + 15),
                               grown.n_docs / 3200)
        vec_q = [q for q in queries if q.kind != "bool"]
        vecs = new.query_vectors([q.word_ids() for q in vec_q])
        got = new.shard_similarities_batch([q.word_ids() for q in vec_q])
        want = fresh_segment_sums(new, grown, vecs)
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   err_msg="refreshed index's planning")
        log(f"   the refreshed index's row-2 planning of {len(vec_q)} "
            f"queries equals the plain version over arrays rebuilt from the "
            f"new corpus (rtol 1e-4), [{got.shape[0]}, {got.shape[1]}]")

        spec = MegascanSpec(new, vecs)
        plans = [touched] * len(vec_q)
        group = ex.map_shard_batch(grown, plans, spec.scan_fns(),
                                   megakernel=True)
        with uncounted(names):
            per = ex.map_shard_batch(grown, plans, spec.scan_fns(),
                                     megakernel=False)
        n_pairs = results_equal(group, per, "megascan over touched shards")
        log(f"   megascan over the {len(touched)} touched and new shards: "
            f"group == per-shard bitwise on {n_pairs} (query, shard) pairs")

        engine.execute(probe, args.rate, rng=np.random.default_rng(3))
        if (cache.stats["hits"] != hits_before
                or cache.stats["stale_epoch"] < 1):
            raise AssertionError(f"a pre-swap cache entry was served after "
                                 f"the content bump: {cache.stats}")
        log(f"   content generation {gen.record()}: the pre-swap cache "
            f"entries were fenced ({cache.stats['stale_epoch']} stale)")

        seen = []
        record_planning(engine, seen)
        t = time.perf_counter()
        res = engine.execute(queries, args.rate,
                             rng=np.random.default_rng(args.seed + 16))
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t
    launches = read_counts(names)
    require_launched(launches, "ingest")
    qs, rows, plan_s = seen[0]
    check_rows(rows, plain_rows(new, qs), "batch on the new generation")
    for q, r in zip(queries, res):
        if q.kind == "count" and r.estimate is not None and not (
                math.isfinite(r.estimate.value) and r.estimate.value >= 0):
            raise AssertionError(f"count estimate {r.estimate.value}")
    ms = [1e3 * x for x in per_doc]
    if len(ms) != APPEND_DOCS:
        raise AssertionError(f"{len(ms)} documents inferred")
    log(f"   inference at {INFER_STEPS} steps, one document at a time: "
        f"{np.median(ms):.3f} ms a document median, p90 {np.percentile(ms, 90):.3f} "
        f"ms, max {max(ms):.3f} ms, {sum(ms) / 1e3:.3f} s for "
        f"{len(ms)} documents")
    log(f"   refresh wall {refresh_s:.3f} s: " + ", ".join(
        f"{k}={v:.4f}" for k, v in walls.items())
        + f"; append {append_s:.4f} s")
    log(f"   batch of {len(queries)} on the new generation: wall "
        f"{batch_s:.3f} s (planning {plan_s:.3f} s), rows match the plain "
        f"path")
    log(f"   phase 15 wall {time.perf_counter() - t_phase:.1f} s")
    add_path(kernels, "ingest", launches)


def stack_phase(dev: torch.device, args, ctx: dict, kernels: list) -> None:
    """Phase 16: the whole serving stack on phase 14's build: 4 simulated
    hosts, 2 replicas, balanced, cache, planner, window, fleet and
    ingest; 96 mixed queries stream through the window while the
    ingestor appends 4 x 256 documents and a fault plan crashes a host;
    then the megascan group route through the host group and a census."""
    from repro_torch.configs.emapprox import CONFIG
    from repro_torch.core.queries import BatchQuery
    from repro_torch.data.corpus import generate_text_corpus
    from repro_torch.kernels.megascan import MegascanSpec
    from repro_torch.launch import build_serving_stack
    from repro_torch.runtime import FaultPlan

    t_phase = time.perf_counter()
    corpus, index, model = ctx["corpus"], ctx["index"], ctx["model"]
    ccfg = dataclasses.replace(CONFIG.corpus, n_docs=STACK_STEPS * STACK_DOCS,
                               seed=args.seed + 202)
    docs, _ = generate_text_corpus(ccfg)
    feed = [d.tokens for d in docs]
    counts = np.bincount(np.concatenate([s.tokens for s in corpus.shards]),
                         minlength=corpus.vocab_size)
    queries = make_queries(counts, STACK_QUERIES,
                           np.random.default_rng(args.seed + 16),
                           corpus.n_docs / 3200)
    names = ["asym_exp_similarity", "asym_exp_segment_sum",
             "asym_megascan_segsum"]
    zero_counts(names)
    with build_serving_stack(
            corpus, index, hosts=4, replicas=2, balanced=True, cache=True,
            planner=True, window=True, fleet=True, allow_partial=True,
            max_retries=4, rate=args.rate, seed=args.seed, ingest=True,
            ingest_model=model, ingest_pv_cfg=CONFIG.pv,
            ingest_infer_steps=INFER_STEPS,
            ingest_shard_tokens=CONFIG.shard_tokens,
            ingest_yield_s=STACK_YIELD_S) as stack:
        crash_host = 2
        plan = FaultPlan(seed=args.seed).crash(crash_host,
                                               at_job=STACK_CRASH_JOB)
        plan.install(stack.executor)
        sizes, inner = [], stack.engine.execute

        def recording(qs, *a, **kw):
            sizes.append(len(qs))
            return inner(qs, *a, **kw)

        stack.engine.execute = recording
        futs, steps = [], []
        per = STACK_QUERIES // STACK_STEPS
        t_stream = time.perf_counter()
        for i in range(STACK_STEPS):
            futs += [stack.window.submit(q)
                     for q in queries[i * per:(i + 1) * per]]
            t = time.perf_counter()
            rec = stack.ingestor.step(feed[i * STACK_DOCS:
                                           (i + 1) * STACK_DOCS])
            steps.append((time.perf_counter() - t, rec))
        results = [f.result(timeout=600) for f in futs]
        if plan.record()["fired"]["crash"] <= 0:
            raise AssertionError("the scripted crash never fired")
        stream_s = time.perf_counter() - t_stream
        stack.engine.execute = inner
        if len(results) != STACK_QUERIES or any(r is None for r in results):
            raise AssertionError("a streamed query did not resolve")
        stack.fleet.crash(crash_host)          # the detector catches up
        final = stack.corpus
        spilled = sum(r["new_shards"] for _, r in steps)
        if (spilled <= 0 or stack.executor.placement.n_shards !=
                final.n_shards):
            raise AssertionError(f"placement did not extend: {spilled} new "
                                 f"shards, placement "
                                 f"{stack.executor.placement.n_shards} of "
                                 f"{final.n_shards}")

        # ---- the megascan group route through the host group ----
        rng = np.random.default_rng(args.seed + 17)
        cand = np.nonzero((counts > 50 * corpus.n_docs / 3200)
                          & (counts < 1200 * corpus.n_docs / 3200))[0]
        triples = [rng.choice(cand, 3, replace=False).tolist()
                   for _ in range(12)]
        vecs = stack.index.query_vectors(triples)
        plans = ragged_plans(12, final.n_shards, rng)
        spec = MegascanSpec(stack.index, vecs)
        before = _wrapper("asym_megascan_segsum").launches
        group = stack.executor.map_shard_batch(final, plans, spec.scan_fns(),
                                               megakernel=True)
        mega_launches = _wrapper("asym_megascan_segsum").launches - before
        host_walls = dict(stack.executor.last_job["per_host_wall_s"])
        live = set(range(stack.executor.placement.n_hosts)) - set(
            stack.executor.down)
        if not (mega_launches == spec.stats["group_launches"]
                == len(host_walls) and set(host_walls) <= live):
            raise AssertionError(f"row 7 launched {mega_launches} times for "
                                 f"{len(host_walls)} host groups with work "
                                 f"({sorted(host_walls)}, live "
                                 f"{sorted(live)})")
        launches = read_counts(names)
        per_shard = stack.executor.map_shard_batch(
            final, plans, spec.scan_fns(), megakernel=False)
        results_equal(group, per_shard, "host-group megascan vs per-shard")

        # ---- a census of the final corpus through the stack ----
        words = [int(w) for w in cand[:6]]
        gen = stack.engine._generation()
        census = stack.engine.execute([BatchQuery.count([w]) for w in words],
                                      1.0)
        for w, r in zip(words, census):
            if r.estimate.value != final.count_phrase([w]):
                raise AssertionError(f"census of word {w}: "
                                     f"{r.estimate.value} != exact "
                                     f"{final.count_phrase([w])}")
        if gen != stack.clock.current() or gen.content != STACK_STEPS:
            raise AssertionError(f"census generation {gen}, clock "
                                 f"{stack.clock.current()}")
        report = stack.engine.last_report
        ctl = stack.controller.current_plan
        log(f"   {STACK_QUERIES} queries through the window in "
            f"{stream_s:.3f} s, all resolved; batch sizes {sizes}; "
            f"controller plan: delay {ctl.delay_s if ctl else None} s, max "
            f"batch {ctl.max_batch if ctl else None}; window "
            f"{ {k: stack.window.stats[k] for k in ('batches', 'served', 'closed_by_size', 'closed_by_deadline', 'batch_retries', 'degraded', 'shed')} }")
        log(f"   ingest steps (wall s, docs, new shards, generation): "
            + "; ".join(f"{w:.3f}, {r['appended']}, {r['new_shards']}, "
                        f"{r['generation']}" for w, r in steps)
            + f"; ingest_yield_s {STACK_YIELD_S}")
        log(f"   host {crash_host} crashed at group job {STACK_CRASH_JOB} "
            f"(fault plan fired {plan.record()['fired']}); executor "
            f"{ {k: stack.executor.stats[k] for k in ('jobs', 'host_failures', 'requeued_shards', 'shed_shards', 'lost_shards')} }")
        log(f"   megascan through the host group: {mega_launches} launches "
            f"of row 7 for {len(host_walls)} host groups with work, bitwise "
            f"the per-shard route; host-group walls (s) {host_walls}")
        log(f"   census of {len(words)} words on {final.n_docs} docs, "
            f"{final.n_shards} shards equals the exact counts, generation "
            f"{gen.record()}")
        log(f"   balance audit: {json.dumps(report.balance, default=str)}")
        log(f"   budget audit: "
            f"{json.dumps(stack.window.last_budget, default=str)}")
        log(f"   cache: {stack.cache.record()}")
    require_launched(launches, "stack")
    log(f"   phase 16 wall {time.perf_counter() - t_phase:.1f} s")
    add_path(kernels, "stack", launches)


def recommend_phase(dev: torch.device, args, kernels: list) -> None:
    """Phase 17: recommendation on a review corpus of REVIEW_USERS users
    and REVIEW_ITEMS items: shard the user documents, train PV-DBOW at
    the EmApprox settings, build the asym index (and a sym one), run
    the recsys_bench protocol, and hold the user-vector scoring against
    its plain versions."""
    from repro_torch.configs.emapprox import CONFIG
    from repro_torch.core.index import build_index
    from repro_torch.core.queries.recommend import (mse, precision_at_k,
                                                    recommend_query)
    from repro_torch.data.corpus import (ReviewCorpusConfig,
                                         generate_review_corpus)
    from repro_torch.data.store import ShardedCorpus
    from repro_torch.kernels.hamming import kernel as hk
    from repro_torch.kernels.hamming import ref as href

    t_phase = time.perf_counter()
    t = time.perf_counter()
    data = generate_review_corpus(ReviewCorpusConfig(
        n_users=REVIEW_USERS, n_items=REVIEW_ITEMS, seed=args.seed + 1))
    gen_s = time.perf_counter() - t
    corpus = ShardedCorpus.from_documents(data.user_docs, data.vocab_size,
                                          shard_tokens=CONFIG.shard_tokens)
    log(f"   review corpus: {REVIEW_USERS} users, {REVIEW_ITEMS} items, "
        f"{data.ratings.shape[0]} ratings, {corpus.n_tokens} tokens, "
        f"{corpus.n_shards} shards; generated in {gen_s:.2f} s")
    names = ["asym_exp_similarity", "hamming_similarity", "negsamp_grads"]
    zero_counts(names)
    model, _, tw = train(corpus, dev, "recommend train")
    t = time.perf_counter()
    index = {mode: build_index(corpus, model, CONFIG.lsh,
                               temperature=CONFIG.pv.temperature,
                               lsh_mode=mode, device=dev)
             for mode in ("asym", "sym")}
    index_s = time.perf_counter() - t

    rng = np.random.default_rng(17)
    users = rng.choice(REVIEW_USERS, REVIEW_TEST_USERS, replace=False)
    holdout = {}
    for u in users:
        mask = data.user_of == u
        items, ratings = data.item_of[mask], data.ratings[mask]
        k = max(1, int(0.2 * len(items)))
        sel = rng.choice(len(items), k, replace=False)
        holdout[u] = (items[sel], ratings[sel], items)

    def evaluate(ix, rate, method):
        mses, precs, ts = [], [], []
        for u in users:
            t_items, t_ratings, bought = holdout[u]
            r = recommend_query(corpus, ix, data, int(u), rate, k=10,
                                method=method, rng=rng,
                                exclude_items=np.setdiff1d(bought, t_items))
            mses.append(mse(r.predictions, t_items, t_ratings))
            precs.append(precision_at_k(r.top_k, t_items, 10))
            ts.append(r.elapsed_s)
        return (float(np.nanmean(mses)), float(np.mean(precs)),
                float(np.mean(ts)))

    table = [("asym", 1.0, "precise", evaluate(index["asym"], 1.0,
                                                "emapprox"))]
    for rate in REVIEW_RATES:
        for method in ("emapprox", "srcs"):
            table.append(("asym", rate, method,
                          evaluate(index["asym"], rate, method)))
    table.append(("sym", REVIEW_RATES[1], "emapprox",
                  evaluate(index["sym"], REVIEW_RATES[1], "emapprox")))
    launches = read_counts(names)
    require_launched(launches, "recommend")
    log(f"   training {tw['train_s']:.3f} s, both indexes {index_s:.3f} s")
    for mode, rate, method, (m_, p_, t_) in table:
        log(f"   fig7 {mode} {method} rate {rate}: MSE {m_:.4f}, P@10 "
            f"{p_:.4f}, {1e3 * t_:.3f} ms a query")

    vecs = index["asym"].doc_vecs[users]
    got = torch.from_numpy(
        index["asym"].vector_shard_similarities_batch(vecs))
    want = plain_similarities(index["asym"], vecs, index["asym"]._device_sig(
        index["asym"].shard_sig, "shard")).double().cpu()
    err = close(got, want, "user vectors x shards, row 1")
    qsig = index["sym"].query_sig_tensor(vecs)
    db = index["sym"]._device_sig(index["sym"].shard_sig, "shard")
    sym = hk.hamming_similarity_kernel(qsig, db, index["sym"].bits,
                                       temperature=index["sym"].temperature)
    sym_plain = href.hamming_similarity_ref(qsig, db, index["sym"].bits,
                                            index["sym"].temperature)
    sym_rows = index["sym"].vector_shard_similarities_batch(vecs)
    if not (torch.equal(sym, sym_plain) and np.array_equal(
            sym_rows, sym_plain.cpu().numpy().astype(np.float64))):
        raise AssertionError("user vectors x shards, row 5: not exactly "
                             "the plain version")
    log(f"   {len(users)} user vectors x {corpus.n_shards} shards: row 1 "
        f"within rtol 1e-4 of plain (max abs err {err:.3g}), row 5 equal "
        f"to plain exactly")
    log(f"   phase 17 wall {time.perf_counter() - t_phase:.1f} s")
    add_path(kernels, "recommend", launches)


# ----------------------------------------------------------------------
# phase 18: the LM model zoo's serving path (no kernel of its own)
# ----------------------------------------------------------------------
def lm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, on the CPU in float64."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    if g.shape != w.shape:
        raise AssertionError(f"shapes differ: {tuple(g.shape)} {tuple(w.shape)}")
    return float((g - w).abs().max() / (w.abs().max() + 1e-9))


def decode_profile(params, cfg, prompt: int, dev: torch.device,
                   steps: int = 3) -> "tuple[float, float] | None":
    """Kernels a decode step and device-busy ms a step, from
    ``torch.profiler`` over ``steps`` greedy steps after a prefill of
    ``prompt`` tokens (batch LM_BATCH); None when the profiler shows no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    g = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, prompt), generator=g,
                         device=dev)
    state = M.init_decode_state(cfg, LM_BATCH, prompt + steps + 8, device=dev)
    logits, state = M.prefill(params, toks, cfg, state)
    tok = torch.argmax(logits, dim=-1)[:, None]
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, state = M.decode_step(params, tok, cfg, state)
            tok = torch.argmax(logits, dim=-1)[:, None]
        torch.cuda.synchronize(dev)
    on_dev = [e for e in prof.events()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(e.device_time_total for e in on_dev)
    if not on_dev or busy_us <= 0:
        return None
    return len(on_dev) / steps, busy_us / 1e3 / steps


def require_finite(x: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{what}: not all finite")


def lm_full_width(dev: torch.device, arch: str, prompt: int, seed: int) -> None:
    """Parts (a)-(c) for one architecture at full width."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.models.config import DTypePolicy
    from repro_torch.utils.trees import tree_bytes, tree_map, tree_param_count

    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = time.perf_counter()
    params = M.init_params(cfg, gen, dev)
    torch.cuda.synchronize(dev)
    log(f"   {cfg.name}: {tree_param_count(params)} parameters, "
        f"{tree_bytes(params)} bytes ({cfg.dtypes.params}), drawn on the "
        f"card in {time.perf_counter() - t:.2f} s")
    # (a) serving at the default policy: a short warm-up call, then the
    # measured one
    warm = serve(cfg, LM_BATCH, prompt, 2, device=dev, generator=gen,
                 params=params)
    torch.cuda.reset_peak_memory_stats(dev)
    live = torch.cuda.memory_allocated(dev)
    res = serve(cfg, LM_BATCH, prompt, LM_GEN, device=dev, generator=gen,
                params=params)
    peak = torch.cuda.max_memory_allocated(dev)
    if res.tokens.shape != (LM_BATCH, LM_GEN) or int(res.tokens.min()) < 0 \
            or int(res.tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"{arch}: generated tokens out of shape or range")
    step_ms = np.array(res.step_s) * 1e3
    log(f"   (a) serve batch {LM_BATCH}, prompt {prompt}, {LM_GEN} greedy "
        f"tokens, compute {cfg.dtypes.compute}: prefill "
        f"{res.prefill_s * 1e3:.3f} ms (first call {warm.prefill_s * 1e3:.3f}); "
        f"decode {float(np.median(step_ms)):.3f} ms a token (median of "
        f"{len(step_ms)}), p90 {float(np.percentile(step_ms, 90)):.3f}, min "
        f"{float(step_ms.min()):.3f}; {res.tokens_per_s:.1f} tokens/s; peak "
        f"{peak} bytes allocated, {peak - live} above the {live} live "
        f"before the call (the parameters and earlier phases' tensors)")
    log(f"       first sequence: {res.tokens[0, :12].tolist()}")
    prof = decode_profile(params, cfg, prompt, dev)
    if prof is None:
        log("       decode profile: the profiler showed no device time "
            "(kernels a step and idle share not measured)")
    else:
        busy = prof[1] / float(np.median(step_ms))
        log(f"       decode profile (torch.profiler, 3 steps): {prof[0]:.0f} "
            f"device ops a step, {prof[1]:.3f} ms device-busy a step; idle "
            f"share {1 - busy:.3f} of the median step wall")

    # (b) the fp32 policy, the same parameters; then the same two checks
    # read with the card at the default policy (a lower-precision run)
    cfg32 = dataclasses.replace(cfg, dtypes=DTypePolicy(
        "float32", "float32", "float32"))
    g2 = torch.Generator(device=dev).manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, prompt + 1),
                         generator=g2, device=dev)

    def decode_gap(c):
        """(prefill, decode) logits against the teacher-forced forward."""
        full = M.forward(params, toks, c)
        state = M.init_decode_state(c, LM_BATCH, prompt + 8, device=dev)
        lp, state = M.prefill(params, toks[:, :prompt], c, state)
        ld, state = M.decode_step(params, toks[:, prompt:], c, state)
        for x, what in ((full, "forward"), (lp, "prefill"), (ld, "decode")):
            require_finite(x, f"{arch} {c.dtypes.compute} {what} logits")
        return lm_err(lp, full[:, prompt - 1]), lm_err(ld, full[:, prompt])

    e_pre, e_dec = decode_gap(cfg32)
    if max(e_pre, e_dec) >= LM_DECODE_TOL:
        raise AssertionError(f"{arch}: prefill/decode off the teacher-forced "
                             f"forward: {e_pre:.3g} / {e_dec:.3g} >= "
                             f"{LM_DECODE_TOL}")
    low_pre, low_dec = decode_gap(cfg)
    host = tree_map(lambda a: a.cpu(), params)
    t16 = toks[:1, :LM_CPU_TOKENS]
    want = M.forward(host, t16.cpu(), cfg32)
    err = lm_err(M.forward(params, t16, cfg32), want)
    low = lm_err(M.forward(params, t16, cfg), want)
    tol = LM_CPU_TOL[arch]
    if err >= tol:
        raise AssertionError(f"{arch}: card forward off the CPU's: {err:.3g} "
                             f">= {tol}")
    if low < tol:
        raise AssertionError(f"{arch}: the card's {cfg.dtypes.compute} "
                             f"forward passes the fp32 bound ({low:.3g} < "
                             f"{tol}): the check tells nothing")
    log(f"   (b) fp32 policy: prefill + decode_step vs teacher-forced "
        f"forward {e_pre:.3g} / {e_dec:.3g} (bound {LM_DECODE_TOL}); card vs "
        f"CPU forward at b=1, s={LM_CPU_TOKENS} {err:.3g} (bound {tol}); all "
        f"finite.  The card at {cfg.dtypes.compute} through the same checks: "
        f"{low_pre:.3g} / {low_dec:.3g}, and {low:.3g} against the CPU's fp32")
    del host, params
    torch.cuda.empty_cache()


def lm_smoke_archs(dev: torch.device, seed: int) -> None:
    """Part (d): every architecture at smoke width, fp32 policy: forward
    and prefill + decode_step on the card against the same parameters on
    the CPU."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import model as M
    from repro_torch.models.config import DTypePolicy
    from repro_torch.utils.trees import tree_map

    fp32 = DTypePolicy("float32", "float32", "float32")
    for arch in list_archs():
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtypes=fp32)
        host = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
        params = tree_map(lambda a: a.to(dev), host)
        g = torch.Generator().manual_seed(seed + 2)
        toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
        enc = None
        if cfg.is_encdec or cfg.family == "vlm":
            t = cfg.encoder_seq if cfg.is_encdec else cfg.vision_tokens
            enc = torch.randn((2, t, cfg.d_model), generator=g)

        def run(p, device):
            tk = toks.to(device)
            e = None if enc is None else enc.to(device)
            full = M.forward(p, tk, cfg, enc_inputs=e)
            ctx = M.encode(p, e, cfg) if cfg.is_encdec else e
            st = M.init_decode_state(cfg, 2, 32, enc=ctx, device=device)
            _, st = M.prefill(p, tk[:, :11], cfg, st)
            dec, st = M.decode_step(p, tk[:, 11:], cfg, st)
            if st.length != 12:
                raise AssertionError(f"{arch}: state length {st.length}")
            return full, dec

        card, cpu = run(params, dev), run(host, torch.device("cpu"))
        errs = []
        for c, h, what in zip(card, cpu, ("forward", "decode")):
            require_finite(c, f"{arch} {what} logits")
            errs.append(lm_err(c, h))
            if errs[-1] >= LM_SMOKE_TOL:
                raise AssertionError(f"{arch} smoke {what}: card vs CPU "
                                     f"{errs[-1]:.3g} >= {LM_SMOKE_TOL}")
        log(f"   (d) {arch}: card vs CPU forward {errs[0]:.3g}, prefill + "
            f"decode {errs[1]:.3g}")


def lm_phase(dev: torch.device, args) -> None:
    """Phase 18: the LM zoo's serving path on the card (see the module
    docstring).  It launches no kernel of the record: the counts are
    zeroed before it and must read 0 after."""
    t_phase = time.perf_counter()
    names = list(KERNEL_MODULES)
    zero_counts(names)
    for arch, prompt in LM_FULL:
        lm_full_width(dev, arch, prompt, args.seed)
    lm_smoke_archs(dev, args.seed)
    launched = {n: c for n, c in read_counts(names).items() if c}
    if launched:
        raise AssertionError(f"the LM path launched kernels: {launched}")
    log(f"   phase 18 wall {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# phase 19: LM training (launch/train), the EmApprox curriculum on the card
# ----------------------------------------------------------------------
TRAIN_ARCH = "smollm-360m"
TRAIN_DOCS = 65536          # ~10.5 M tokens, ~40 shards of 2^18 tokens
TRAIN_STEPS = (10, 15)      # the first call, then the resumed one
TRAIN_CKPT_EVERY = 10
# the synthetic corpus' most frequent word ids (its seed, vocab 8192)
TRAIN_PROMPT = (4150, 211, 4644, 8099)
TRAIN_BATCH, TRAIN_SEQ = 8, 256
FALL_STEPS = 10             # (c): steps on one fixed batch
FALL = (("smollm-360m", 5e-3), ("mamba2-780m", 1e-3))  # the reference's lrs
TRAIN_CPU_TOKENS = 16       # (d): b=1, s=16
# (d) per leaf max |card grad - CPU grad| / max |CPU grad|, fp32 policy.
# First fixed at 1e-3 (mamba2 5e-3), which smollm's wk gradient missed
# (2.1e-3); fixed from the readings in PERF.md at twice the largest move
# of the CPU's own gradients under a one-ulp change of the parameters
# (1.57e-3 smollm, 1.5e-2 mamba2).  Each run is gated on twice its own
# largest move (``run_bound``), capped at these constants
TRAIN_CPU_TOL = {"smollm-360m": 3e-3, "mamba2-780m": 3e-2}
TRAIN_LOSS_RTOL = 1e-4      # (d) the loss, card against CPU
# (e) loss and grad_norm, card against CPU: 1e-4, and for three archs
# twice the CPU's largest move over ULP_DRAWS one-ulp draws as read in
# PERF.md (Whisper 1.47e-3; Maverick 4.6e-4, router near-ties flipping
# under some draws; the VLM 1.77e-4).  Each run is gated on twice its
# own largest move (``run_bound``), capped at these constants
TRAIN_SMOKE_TOL = 1e-4
SMOKE_TOL = {"whisper_small": 3e-3, "llama4_maverick_400b_a17b": 1e-3,
             "llama_3_2_vision_11b": 4e-4}
ULP_DRAWS = 8
# (e) the moment storage each smoke arch trains with (others float32)
SMOKE_STATE = {"smollm_360m": "q8", "llama4_maverick_400b_a17b": "bfloat16"}


def train_argv(ckpt: str, steps: int) -> list:
    return ["--arch", TRAIN_ARCH, "--n-docs", str(TRAIN_DOCS),
            "--similarity-prompt", *map(str, TRAIN_PROMPT),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(steps), "--ckpt-dir", ckpt,
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--log-every", "5"]


def fixed_batch(cfg, b: int, s: int, seed: int, dev: torch.device) -> dict:
    """Random tokens and their next-token labels, from a seeded
    generator, on ``dev`` (with zero encoder inputs where the family
    takes them)."""
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev),
             "mask": torch.ones((b, s), device=dev)}
    if cfg.is_encdec or cfg.family == "vlm":
        t = cfg.encoder_seq if cfg.is_encdec else cfg.vision_tokens
        batch["enc_inputs"] = torch.randn((b, t, cfg.d_model), generator=g
                                          ).to(dev)
    return batch


def step_profile(step_fn, params, opt_state, batch, dev: torch.device,
                 steps: int = 3) -> "tuple[float, float] | None":
    """(device ops a step, device-busy ms a step) from ``torch.profiler``
    over ``steps`` train steps; None when it shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            params, opt_state, _ = step_fn(params, opt_state, batch)
        torch.cuda.synchronize(dev)
    on_dev = [e for e in prof.events()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(e.device_time_total for e in on_dev)
    if not on_dev or busy_us <= 0:
        return None
    return len(on_dev) / steps, busy_us / 1e3 / steps


def log_walls(what: str, walls_s, tokens_a_step: int) -> float:
    """Print the median and p90 of step walls (s); returns the median ms."""
    ms = np.asarray(walls_s) * 1e3
    med = float(np.median(ms))
    log(f"   {what}: step wall {med:.3f} ms median of {len(ms)}, p90 "
        f"{float(np.percentile(ms, 90)):.3f}, min {float(ms.min()):.3f}; "
        f"{tokens_a_step / med * 1e3:.1f} tokens/s at the median")
    return med


def log_profile(prof, med_ms: float) -> None:
    if prof is None:
        log("       profile: the profiler showed no device time (ops a step "
            "and idle share not measured)")
        return
    log(f"       profile (torch.profiler, 3 steps): {prof[0]:.0f} device ops "
        f"a step, {prof[1]:.3f} ms device-busy a step; idle share "
        f"{1 - prof[1] / med_ms:.3f} of the median step wall")


def trees_equal(a, b, what: str) -> None:
    from repro_torch.utils.trees import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb) or not all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb)):
        raise AssertionError(f"{what}: not bit for bit equal")


def train_driver(dev: torch.device, kernels: list) -> int:
    """(a), (b) and (f) of phase 19: ``launch/train`` end to end at full
    width with the launch counts of its path, a resume from the last
    committed step, the step walls, a profile, peak memory and the
    checkpoint walls.  Returns the corpus' shard count."""
    import tempfile
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optimizer.adamw import AdamWConfig
    from repro_torch.utils.trees import tree_leaves

    names = ["asym_exp_similarity", "negsamp_grads"]
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        zero_counts(names)
        run = T.main(train_argv(ckpt, TRAIN_STEPS[0]))
        launches = read_counts(names)
        peak = torch.cuda.max_memory_allocated(dev)
        require_launched(launches, "lm_train")
        add_path(kernels, "lm_train", launches)
        losses = list(run.losses.values())
        if not losses or not np.all(np.isfinite(losses)):
            raise AssertionError(f"logged losses not all finite: {run.losses}")
        order = run.shard_order
        log(f"   (a) launch/train {TRAIN_ARCH}, {TRAIN_DOCS} docs, "
            f"{run.n_shards} shards, prompt {list(TRAIN_PROMPT)}: the drawn "
            f"epoch order holds {len(set(order.tolist()))} distinct shards, "
            f"the most drawn {int(np.bincount(order).max())} times; set-up "
            + ", ".join(f"{k} {v:.2f} s" for k, v in run.setup_s.items()))
        log(f"       logged losses {[round(x, 4) for x in losses]}")
        tok = TRAIN_BATCH * TRAIN_SEQ
        med = log_walls(f"(f) {TRAIN_STEPS[0]} steps of batch {TRAIN_BATCH} "
                        f"x {TRAIN_SEQ} (the steps after the first)",
                        run.step_s[1:], tok)
        log(f"       first step {run.step_s[0] * 1e3:.3f} ms; "
            f"{run.tokens_per_s:.1f} tokens/s over all steps; peak "
            f"{peak} bytes allocated, {peak - live} above the {live} live "
            f"before the call")
        log(f"       checkpoint saves (host snapshot, the writes queued): "
            f"{[round(x, 3) for x in run.save_s]} s; the final wait for the "
            f"writes {run.wait_s:.3f} s")

        # (b) the committed state restores bit for bit; a second call
        # resumes from it
        t = time.perf_counter()
        back = restore_checkpoint(ckpt, TRAIN_STEPS[0],
                                  (run.params, run.opt_state))
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t
        trees_equal(back, (run.params, run.opt_state),
                    "restored (params, opt_state)")
        del back
        again = T.main(train_argv(ckpt, TRAIN_STEPS[1]))
        if again.start_step != TRAIN_STEPS[0]:
            raise AssertionError(f"resumed from {again.start_step}, not "
                                 f"{TRAIN_STEPS[0]}")
        if not np.all(np.isfinite(list(again.losses.values()))):
            raise AssertionError("resumed losses not all finite")
        log(f"   (b) restore of step {TRAIN_STEPS[0]} equal bit for bit to "
            f"the saved state, {restore_s:.3f} s; the second call resumed "
            f"from step {again.start_step} (its restore "
            f"{again.setup_s['restore']:.3f} s) and logged "
            f"{ {k: round(v, 4) for k, v in again.losses.items()} }")

        # (f) the profile, and whether a step from one state repeats
        # bit for bit
        cfg = get_config(TRAIN_ARCH)
        opt_cfg = AdamWConfig(state_dtype=cfg.dtypes.opt_state)
        step_fn = make_train_step(cfg, opt_cfg, total_steps=TRAIN_STEPS[1])
        batch = fixed_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 3, dev)
        log_profile(step_profile(step_fn, run.params, run.opt_state, batch,
                                 dev), med)
        p1, _, m1 = step_fn(run.params, run.opt_state, batch)
        p2, _, m2 = step_fn(run.params, run.opt_state, batch)
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(tree_leaves(p1), tree_leaves(p2)))
        log(f"       one step twice from one state and batch: loss "
            f"{'equal' if torch.equal(m1['loss'], m2['loss']) else 'differs'}"
            f", parameters after it max |diff| {diff:.3g} (0: bit for bit)")
        n_shards = run.n_shards
        del run, again, p1, p2
    torch.cuda.empty_cache()
    return n_shards


def loss_falls(dev: torch.device) -> None:
    """(c): 10 steps on one fixed batch at full width, warmup_steps=1;
    also the walls, profile and peak memory of these steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optimizer.adamw import AdamWConfig, adamw_init

    for arch, lr in FALL:
        cfg = get_config(arch)
        opt_cfg = AdamWConfig(lr=lr, state_dtype=cfg.dtypes.opt_state)
        torch.cuda.reset_peak_memory_stats(dev)
        params = M.init_stacked_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        opt_state = adamw_init(params, opt_cfg)
        step_fn = make_train_step(cfg, opt_cfg, total_steps=FALL_STEPS,
                                  warmup_steps=1)
        batch = fixed_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 5, dev)
        losses, walls = [], []
        for _ in range(FALL_STEPS):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated(dev)
        if not np.all(np.isfinite(losses)) or not min(losses[1:]) < losses[0]:
            raise AssertionError(f"{arch}: loss did not fall: {losses}")
        log(f"   (c) {arch} at full width, lr {lr}, batch {TRAIN_BATCH} x "
            f"{TRAIN_SEQ}, one fixed batch: losses "
            f"{[round(x, 4) for x in losses]}; peak {peak} bytes allocated "
            f"(remat {cfg.remat})")
        med = log_walls(f"{arch} steps after the first", walls[1:],
                        TRAIN_BATCH * TRAIN_SEQ)
        log_profile(step_profile(step_fn, params, opt_state, batch, dev), med)
        if arch == TRAIN_ARCH:
            remat_walls(cfg, opt_cfg, params, opt_state, batch, dev)
        del params, opt_state
        torch.cuda.empty_cache()


def remat_walls(cfg, opt_cfg, params, opt_state, batch, dev,
                steps: int = 3) -> None:
    """(f): the step wall (median of ``steps`` after one warm-up) and
    peak memory under each activation-checkpoint policy."""
    from repro_torch.launch.steps import make_train_step
    out = []
    for remat in ("none", "full", "selective"):
        fn = make_train_step(dataclasses.replace(cfg, remat=remat), opt_cfg,
                             total_steps=FALL_STEPS, warmup_steps=1)
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for _ in range(steps + 1):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            fn(params, opt_state, batch)
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t)
        out.append(f"{remat} {float(np.median(walls[1:])) * 1e3:.3f} ms, "
                   f"peak {torch.cuda.max_memory_allocated(dev)} bytes")
    log(f"       remat policies, step wall median of {steps}: "
        + "; ".join(out))


def run_bound(move: float, cap: float) -> float:
    """A card-vs-CPU bound read from this run: twice the CPU's own move
    under one ulp of the parameters, never above ``cap`` (the constant
    first fixed from one call's readings)."""
    return min(2 * move, cap)


def one_ulp(tree, seed: int):
    """The tree with every float32 entry moved one ulp up or down (a
    random direction each)."""
    from repro_torch.utils.trees import tree_map
    g = torch.Generator().manual_seed(seed)

    def nudge(a):
        up = torch.rand(a.shape, generator=g) < 0.5
        inf = torch.full_like(a, float("inf"))
        return torch.nextafter(a, torch.where(up, inf, -inf))
    return tree_map(nudge, tree)


def grads_vs_cpu(dev: torch.device, seed: int) -> None:
    """(d): the loss and every gradient leaf at full width, fp32 policy,
    b=1, s=16, on the card against the CPU on the same stacked
    parameters, each leaf within twice the largest move of the CPU's
    own gradients under a one-ulp change of the parameters, at most
    ``TRAIN_CPU_TOL``; each reading beside its move."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import _value_and_grad
    from repro_torch.models import model as M
    from repro_torch.models.config import DTypePolicy
    from repro_torch.models.layers import tree_paths
    from repro_torch.utils.trees import tree_leaves, tree_map

    fp32 = DTypePolicy("float32", "float32", "float32")
    for arch in TRAIN_CPU_TOL:
        cfg = dataclasses.replace(get_config(arch), dtypes=fp32)
        params = M.init_stacked_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        host = tree_map(lambda a: a.cpu(), params)
        batch = fixed_batch(cfg, 1, TRAIN_CPU_TOKENS, 6, torch.device("cpu"))
        loss_c, g_c = _value_and_grad(host, batch, cfg)
        _, g_u = _value_and_grad(one_ulp(host, seed + 7), batch, cfg)
        loss_d, g_d = _value_and_grad(
            params, {k: v.to(dev) for k, v in batch.items()}, cfg)
        names = ["/".join(p) for p, _ in tree_paths(params)]
        rows = sorted(((lm_err(d, c), lm_err(u, c), n) for d, c, u, n in
                       zip(tree_leaves(g_d), tree_leaves(g_c),
                           tree_leaves(g_u), names)), reverse=True)
        tol = run_bound(max(r[1] for r in rows), TRAIN_CPU_TOL[arch])
        lerr = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
        if not np.isfinite(float(loss_d)) or lerr >= TRAIN_LOSS_RTOL \
                or rows[0][0] >= tol:
            raise AssertionError(f"{arch}: card vs CPU: loss {lerr:.3g}, "
                                 f"worst leaf (err, one-ulp move, name) "
                                 f"{rows[0]} (bound {tol})")
        log(f"   (d) {arch} fp32, b=1, s={TRAIN_CPU_TOKENS}: loss "
            f"{float(loss_d):.6f}, card vs CPU {lerr:.3g} (bound "
            f"{TRAIN_LOSS_RTOL}); per-leaf max |dg| / max |g| worst: "
            + ", ".join(f"{n} {e:.3g} (the CPU's one-ulp move {u:.3g})"
                        for e, u, n in rows[:3])
            + f"; bound {tol:.3g} (twice the largest move, at most "
            f"{TRAIN_CPU_TOL[arch]}); largest move "
            f"{max(r[1] for r in rows):.3g}; median leaf error "
            f"{float(np.median([r[0] for r in rows])):.3g}")
        del params, host, g_c, g_d, g_u
        torch.cuda.empty_cache()


def smoke_train_steps(dev: torch.device, seed: int) -> None:
    """(e): every architecture at smoke width, fp32 policy, two
    make_train_step steps (the first has lr 0) on the card against the
    same parameters on the CPU: loss and grad_norm within twice the
    CPU's own largest move under ULP_DRAWS one-ulp changes of the
    parameters, at most SMOKE_TOL (TRAIN_SMOKE_TOL for the rest)."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.config import DTypePolicy
    from repro_torch.optimizer.adamw import AdamWConfig, adamw_init
    from repro_torch.utils.trees import tree_leaves, tree_map

    fp32 = DTypePolicy("float32", "float32", "float32")
    lr = 5e-3
    cpu = torch.device("cpu")
    for arch in list_archs():
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtypes=fp32)
        opt_cfg = AdamWConfig(lr=lr, state_dtype=SMOKE_STATE.get(arch,
                                                                 "float32"))
        step_fn = make_train_step(cfg, opt_cfg, total_steps=2, warmup_steps=1)
        host = M.init_stacked_params(cfg, torch.Generator().manual_seed(seed),
                                     "cpu")
        batch = fixed_batch(cfg, 2, 12, seed + 2, cpu)

        def run(p, d):
            p = tree_map(lambda a: a.to(d), p)
            o = adamw_init(p, opt_cfg)
            b = {k: v.to(d) for k, v in batch.items()}
            ms = []
            for _ in range(2):
                p, o, m = step_fn(p, o, b)
                ms += [float(m["loss"]), float(m["grad_norm"])]
            return p, np.array(ms)

        p_cpu, m_cpu = run(host, cpu)
        move = max(float(np.max(np.abs(run(one_ulp(host, seed + 7 + i), cpu)[1]
                                       - m_cpu) / np.abs(m_cpu)))
                   for i in range(ULP_DRAWS))
        p_card, m_card = run(host, dev)
        err = float(np.max(np.abs(m_card - m_cpu) / np.abs(m_cpu)))
        tol = run_bound(move, SMOKE_TOL.get(arch, TRAIN_SMOKE_TOL))
        if not np.all(np.isfinite(m_card)) or err >= tol:
            raise AssertionError(f"{arch} smoke steps: loss / grad_norm card "
                                 f"{m_card} vs CPU {m_cpu} ({err:.3g} >= "
                                 f"{tol:.3g})")
        pmax = pmed = 0.0
        for a, b in zip(tree_leaves(p_card), tree_leaves(p_cpu)):
            d = (a.detach().double().cpu() - b.double()).abs()
            pmax, pmed = max(pmax, float(d.max())), max(pmed, float(d.median()))
        if pmax > 2 * lr or pmed > 1e-3 * lr:
            raise AssertionError(f"{arch} smoke step: parameters apart "
                                 f"{pmax:.3g} (median {pmed:.3g})")
        log(f"   (e) {arch} ({opt_cfg.state_dtype} moments): loss and "
            f"grad_norm card vs CPU {err:.3g} (bound {tol:.3g}: twice the "
            f"CPU's largest one-ulp move {move:.3g}, at most "
            f"{SMOKE_TOL.get(arch, TRAIN_SMOKE_TOL):.3g}); parameters "
            f"after the lr "
            f"{lr} step "
            f"max |diff| {pmax:.3g}, largest leaf median {pmed:.3g}")


def lm_train_kernels(dev: torch.device, n_shards: int) -> None:
    """Rows 1 and 11 at the shapes the training path gives them (the
    prompt against every shard signature, 128 bits, dim 32; a PV-DBOW
    step of 8192 pairs, 5 negatives), against their plain versions."""
    from repro_torch.core import lsh
    from repro_torch.kernels.asym import ops, ref
    from repro_torch.kernels.negsamp import kernel as nk
    from repro_torch.kernels.negsamp import ref as nref

    with uncounted(["asym_exp_similarity", "negsamp_grads"]):
        g = torch.Generator(device=dev).manual_seed(13)
        q = torch.randn((1, 32), generator=g, device=dev)
        x = torch.randn((n_shards, 32), generator=g, device=dev)
        planes = lsh.hyperplanes(lsh.LSHConfig(bits=128), 32, dev)
        db = lsh.pack_bits(lsh.signature_bits(x, planes))
        e1 = close(ops.asym_exp_similarity(q, db, planes, 128, temperature=8.0),
                   ref.asym_exp_similarity_ref(q, db, planes, 128, 8.0),
                   "row 1 at the training path's shape")
        unit = lambda t: t / t.norm(dim=-1, keepdim=True)
        d = unit(torch.randn((8192, 32), generator=g, device=dev))
        w = unit(torch.randn((8192, 32), generator=g, device=dev))
        wn = unit(torch.randn((8192, 5, 32), generator=g, device=dev))
        e11 = negsamp_close(nk.negsamp_grads_kernel(d, w, wn, temperature=8.0),
                            nref.negsamp_grads_ref(d, w, wn, 8.0), 1e-6,
                            "row 11 at the training path's shape")
    log(f"   rows 1 (1 x {n_shards} shards, bits 128, dim 32) and 11 (8192 "
        f"pairs, K=5, dim 32) at the training path's shapes against plain: "
        f"max abs err {e1:.3g}, {e11:.3g}")


def train_phase_lm(dev: torch.device, args, kernels: list) -> None:
    """Phase 19: LM training on the card (see the module docstring)."""
    t_phase = time.perf_counter()
    n_shards = train_driver(dev, kernels)
    loss_falls(dev)
    grads_vs_cpu(dev, args.seed)
    smoke_train_steps(dev, args.seed)
    lm_train_kernels(dev, n_shards)
    log(f"   phase 19 wall {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# phase 20: the distributed side on one card
# ----------------------------------------------------------------------
MESH_STEPS = 6              # (b): launch/train through the mesh
MESH_CKPT_EVERY = 3


def mesh_train(dev: torch.device, kernels: list):
    """(b): ``launch/train`` through the initialised one-rank world;
    returns its run."""
    import tempfile
    from repro_torch.launch import train as T

    names = ["asym_exp_similarity", "negsamp_grads"]
    with tempfile.TemporaryDirectory() as ckpt:
        argv = train_argv(ckpt, MESH_STEPS)
        argv[argv.index("--ckpt-every") + 1] = str(MESH_CKPT_EVERY)
        zero_counts(names)
        run = T.main(argv)
        launches = read_counts(names)
    require_launched(launches, "lm_train_mesh")
    add_path(kernels, "lm_train_mesh", launches)
    losses = list(run.losses.values())
    if not losses or not np.all(np.isfinite(losses)):
        raise AssertionError(f"logged losses not all finite: {run.losses}")
    log(f"   (b) launch/train {TRAIN_ARCH} through the (1, 1) mesh, "
        f"{MESH_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}, a checkpoint "
        f"every {MESH_CKPT_EVERY}: logged losses "
        f"{[round(x, 4) for x in losses]}; set-up "
        + ", ".join(f"{k} {v:.2f} s" for k, v in run.setup_s.items()))
    log_walls("(b) the steps after the first", run.step_s[1:],
              TRAIN_BATCH * TRAIN_SEQ)
    log(f"       first step {run.step_s[0] * 1e3:.3f} ms; checkpoint "
        f"snapshots {[round(x, 3) for x in run.save_s]} s")
    return run


MESH_TIMED = 5              # (c): timed pairs, the first side alternating
                            # (10 until phase 23 took their time)


def sharded_vs_plain(dev: torch.device, mesh, run) -> None:
    """(c): one step of each from (b)'s state on one batch, micro-batches
    1 and 2: parameters, moments and loss bit for bit; then
    ``MESH_TIMED`` pairs of one unsharded and one sharded step (on
    state placed once), the side that runs first alternating."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import full_tree, place_tree
    from repro_torch.launch import steps as ST
    from repro_torch.optimizer.adamw import AdamWConfig

    cfg = get_config(TRAIN_ARCH)
    opt_cfg = AdamWConfig(state_dtype=cfg.dtypes.opt_state)
    batch = fixed_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 5, dev)
    batch["mask"][1, TRAIN_SEQ // 2:] = 0.0

    def wall(fn, *args) -> tuple:
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t, out

    for mb in (1, 2):
        kw = dict(microbatches=mb, total_steps=TRAIN_STEPS[1])
        plain = ST.make_train_step(cfg, opt_cfg, **kw)
        sharded = ST.make_train_step(cfg, opt_cfg, mesh=mesh, **kw)
        place_s, (sp, so) = wall(lambda: (
            place_tree(run.params, ST.params_shardings(cfg, mesh)),
            place_tree(run.opt_state, ST.opt_state_shardings(cfg, mesh))))
        p1, o1, m1 = plain(run.params, run.opt_state, batch)
        p2, o2, m2 = sharded(sp, so, batch)
        trees_equal(full_tree((p2, o2)), (p1, o1),
                    f"(c) sharded step, micro-batches {mb}: parameters and "
                    f"moments")
        if not torch.equal(m1["loss"], m2["loss"]):
            raise AssertionError(f"(c) micro-batches {mb}: loss "
                                 f"{float(m2['loss'])} != {float(m1['loss'])}")
        if sharded.collectives.kinds:
            raise AssertionError(f"(c) a one-rank mesh launched "
                                 f"{sharded.collectives.kinds}")
        del p1, o1, p2, o2
        walls = {"plain": [], "sharded": []}
        steps = {"plain": (plain, run.params, run.opt_state),
                 "sharded": (sharded, sp, so)}
        for i in range(MESH_TIMED):
            for side in (("plain", "sharded") if i % 2 == 0
                         else ("sharded", "plain")):
                fn, p, o = steps[side]
                walls[side].append(wall(fn, p, o, batch)[0] * 1e3)
        med = {k: float(np.median(v)) for k, v in walls.items()}
        diff = np.subtract(walls["sharded"], walls["plain"])
        log(f"   (c) micro-batches {mb}: the sharded step equal bit for "
            f"bit to the unsharded one (loss {float(m1['loss']):.6f}, every "
            f"parameter and moment), no collective launched; {MESH_TIMED} "
            f"pairs: unsharded {med['plain']:.3f} ms median (quartiles "
            f"{np.percentile(walls['plain'], 25):.3f}-"
            f"{np.percentile(walls['plain'], 75):.3f}), sharded "
            f"{med['sharded']:.3f} ms ("
            f"{np.percentile(walls['sharded'], 25):.3f}-"
            f"{np.percentile(walls['sharded'], 75):.3f}); sharded minus "
            f"unsharded a pair: median {float(np.median(diff)):.3f} ms, "
            f"sharded faster in {int((diff < 0).sum())} of {MESH_TIMED}; "
            f"placing the state {place_s * 1e3:.3f} ms")
        del sp, so


def compression_on_nccl(dev: torch.device, mesh) -> None:
    """(d): ``compressed_tree_psum`` over the one-rank data axis against
    ``quantize_roundtrip`` of the same tree, bit for bit."""
    from repro_torch.distributed.compression import (
        compressed_tree_psum,
        quantize_roundtrip,
    )
    from repro_torch.utils.trees import tree_leaves
    g = torch.Generator(device=dev).manual_seed(21)
    tree = {"wq": torch.randn((32, 960, 960), generator=g, device=dev),
            "tok_emb": torch.randn((49152, 960), generator=g, device=dev),
            "norm": torch.randn((32, 960), generator=g, device=dev)}
    err = {k: 1e-3 * torch.randn(v.shape, generator=g, device=dev)
           for k, v in tree.items()}
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    summed, new_err = compressed_tree_psum(tree, "data", err, mesh=mesh)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t
    for (k, x), got, got_err in zip(sorted(tree.items()),
                                    tree_leaves(summed), tree_leaves(new_err)):
        want, want_err = quantize_roundtrip(x + err[k])
        if not (torch.equal(got, want) and torch.equal(got_err, want_err)):
            raise AssertionError(f"(d) {k}: compressed_psum is not "
                                 f"quantize_roundtrip bit for bit")
    n = sum(x.numel() for x in tree.values())
    log(f"   (d) compressed_tree_psum of {n} floats on the NCCL group "
        f"({wall * 1e3:.3f} ms): sums and residuals equal "
        f"quantize_roundtrip's bit for bit")


def dist_phase(dev: torch.device, kernels: list) -> None:
    """Phase 20: the distributed side on one card (module docstring)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    if dist.is_initialized():
        raise AssertionError("a process group is up before phase 20")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh("cuda")
        log(f"   (a) one-rank NCCL group through a HashStore; mesh {mesh}")
        run = mesh_train(dev, kernels)
        sharded_vs_plain(dev, mesh, run)
        del run
        torch.cuda.empty_cache()
        compression_on_nccl(dev, mesh)
        log("   (e) one H100 cannot time a multi-GPU step: no multi-GPU "
            "time is measured here and none is modelled")
    finally:
        dist.destroy_process_group()
    log(f"   (f) process group destroyed; phase 20 wall "
        f"{time.perf_counter() - t_phase:.1f} s")

# ----------------------------------------------------------------------
# phase 21: the MoE family through the sharded step
# ----------------------------------------------------------------------
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_BATCH, MOE_SEQ = 8, 256  # one dispatch group of 2048 tokens
MOE_RANGES = 4               # (b): contiguous token ranges, one a batch rank
MOE_FACTORS = (1.25, 0.5)    # (b): capacity factors (160 and 64 places)
MOE_SPLITS = (4, 16)         # (b): expert ranges, one a model rank
# (b) where the partials' sum is not the whole block's bits (cuBLAS may
# pick another algorithm for another expert count): the FFN's float32
# sums in another order may round to a neighbouring bfloat16 value, so
# each entry is held to one bfloat16 ulp of its magnitude, 2^-7 of it
MOE_PARTIAL_RTOL = 2.0 ** -7
MOE_SMOKE = ("llama4_scout_17b_a16e", "llama4_maverick_400b_a17b")


def cut_depth_params(cfg, full_layers: int, seed: int, dev: torch.device):
    """The stacked parameters of ``cfg`` (its depth cut from
    ``full_layers``), each layer drawn at the full model's scale: the
    reference's initializer divides a stacked leaf's draw by the root
    of its layer count, so one layer alone would draw every weight at
    std 1 (at which the bf16 forward's silu overflows and the
    gradients turn NaN)."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import materialize

    def rescale(tree):
        if isinstance(tree, dict):
            return {k: rescale(v) for k, v in tree.items()}
        return dataclasses.replace(
            tree, scale=tree.scale * math.sqrt(cfg.n_layers / full_layers))
    defs = M.param_defs(cfg)
    defs = dict(defs, layers=rescale(defs["layers"]))
    return materialize(defs, torch.Generator(device=dev).manual_seed(seed),
                       cfg.dtypes.params_dtype, dev)


def moe_full_grads(dev: torch.device, mesh, seed: int) -> dict:
    """(a): Scout at full width, one layer, the sharded step's loss and
    gradients (``make_sharded_grads``, whose MoE block runs
    expert-parallel: its peers' counts, the region's collectives and the
    aux statistics' all-reduce are over no live axis) on the one-rank
    mesh against the unsharded ``_value_and_grad``, bit for bit and
    finite, no collective; returns the layer's MoE parameters in the
    compute dtype and the config."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.launch import steps as ST
    from repro_torch.models import moe as Mo
    from repro_torch.models.layers import tree_paths
    from repro_torch.utils.trees import tree_leaves

    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=1)
    params = cut_depth_params(cfg, full.n_layers, seed, dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    batch = fixed_batch(cfg, MOE_BATCH, MOE_SEQ, 9, dev)
    batch["mask"][1, MOE_SEQ // 2:] = 0.0
    # a first call on one short row takes the set-up out of the walls
    ST._value_and_grad(params, fixed_batch(cfg, 1, 16, 9, dev), cfg)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    loss_u, g_u = ST._value_and_grad(params, batch, cfg)
    torch.cuda.synchronize(dev)
    wall_u = time.perf_counter() - t
    peak_u = torch.cuda.max_memory_allocated(dev)
    want = tree_leaves(g_u)
    for (path, _), g in zip(tree_paths(params), want):
        require_finite(g, f"(a) the gradient of {'/'.join(path)}")
    placed = place_tree(params, ST.params_shardings(cfg, mesh))
    del params, g_u
    torch.cuda.reset_peak_memory_stats(dev)
    grads = ST.make_sharded_grads(cfg, mesh)
    shards = []
    moe_apply = Mo.moe_apply

    def seen(p, x, c, shard=None):
        shards.append(shard)
        return moe_apply(p, x, c, shard)
    Mo.moe_apply = seen
    try:
        t = time.perf_counter()
        loss_s, g_s = grads(placed, batch)
        torch.cuda.synchronize(dev)
        wall_s = time.perf_counter() - t
    finally:
        Mo.moe_apply = moe_apply
    if not shards or any(sh is None for sh in shards):
        raise AssertionError("(a) the sharded step did not run the "
                             "expert-parallel MoE block")
    peak_s = torch.cuda.max_memory_allocated(dev)
    if not (torch.equal(loss_s, loss_u) and len(g_s) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(g_s, want))):
        raise AssertionError("(a) the sharded loss and gradients are not "
                             "the unsharded ones bit for bit")
    if grads.collectives.kinds:
        raise AssertionError(f"(a) a one-rank mesh launched "
                             f"{grads.collectives.kinds}")
    require_finite(loss_s, "(a) loss")
    log(f"   (a) {MOE_ARCH} at full width, 1 layer ({n_params} parameters, "
        f"{cfg.n_experts} experts, top-{cfg.top_k}), {MOE_BATCH} x "
        f"{MOE_SEQ}: the sharded loss ({float(loss_s):.6f}) and all "
        f"{len(want)} gradient leaves, through the expert-parallel block "
        f"(experts {shards[0].experts or '()'}, batch axes "
        f"{shards[0].batch or '()'}), equal the unsharded ones bit for "
        f"bit, no collective launched; unsharded {wall_u:.3f} s, peak "
        f"{peak_u} bytes; sharded {wall_s:.3f} s, peak {peak_s} bytes "
        f"(the unsharded gradients held)")
    moe = {k: v.to_local()[0].to(cfg.dtypes.compute_dtype)
           for k, v in placed["layers"]["moe"].items()}
    del placed, g_s, want
    torch.cuda.empty_cache()
    return {"cfg": cfg, "moe": moe}


def whole_batch_places(probs: torch.Tensor, k: int, n_groups: int):
    """The plain routing of a whole micro-batch whose [n, E] router
    probabilities fill ``n_groups`` groups exactly: (expert ids, places)
    [n, k], a place being the cumsum over the group's (token, k)
    choices of its expert's one-hot, as the reference counts it."""
    n, e = probs.shape
    _, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    idx = idx[:, :k]
    onehot = torch.nn.functional.one_hot(idx, e)
    flat = onehot.reshape(n_groups, n // n_groups * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(n, k, e)
    return idx, (pos * onehot).sum(-1)


def moe_ranks(dev: torch.device, cfg, moe: dict) -> None:
    """(b): what each rank would compute, at (a)'s width, with no
    process group: the places and kept flags of ``MOE_RANGES`` token
    ranges (each routed on its own rows, from the earlier ranges'
    counts) against a plain whole-batch cumsum's, at each of
    ``MOE_FACTORS``; the block's output as the sum of the expert-range
    partials of each of ``MOE_SPLITS`` against ``moe_apply``."""
    from repro_torch.models import moe as Mo

    g = torch.Generator(device=dev).manual_seed(31)
    n_tok = MOE_BATCH * MOE_SEQ
    x = torch.randn((MOE_BATCH, MOE_SEQ, cfg.d_model), generator=g,
                    device=dev).to(cfg.dtypes.compute_dtype)
    tokens = x.reshape(n_tok, cfg.d_model)
    e, k = cfg.n_experts, cfg.top_k
    g_size = Mo.group_size(n_tok)
    n_groups = -(-n_tok // g_size)
    probs = Mo.router_probs(tokens, moe["router"])
    size = n_tok // MOE_RANGES
    for cf in MOE_FACTORS:
        c_cfg = dataclasses.replace(cfg, capacity_factor=cf)
        cap = Mo.expert_capacity(c_cfg, g_size)
        w_idx, w_pos = whole_batch_places(probs, k, n_groups)
        w_keep = w_pos < cap
        before = torch.zeros((n_groups, e), dtype=torch.long, device=dev)
        drops = []
        for r in range(MOE_RANGES):
            a, b = r * size, (r + 1) * size
            _, idx = Mo.top_k(Mo.router_probs(tokens[a:b], moe["router"]), k)
            grp = Mo.group_ids(a, size, n_tok, dev)
            places = Mo.slice_places(idx, grp, before)
            before = before + Mo.slice_counts(idx, grp, n_groups, e)
            if not (torch.equal(idx, w_idx[a:b])
                    and torch.equal(places, w_pos[a:b])
                    and torch.equal(places < cap, w_keep[a:b])):
                raise AssertionError(f"(b) factor {cf}, range {r}: expert "
                                     f"ids, places or kept flags differ "
                                     f"from the whole batch's")
            drops.append(int((places >= cap).sum()))
        if cf < 1 and not any(drops[1:]):
            raise AssertionError(f"(b) factor {cf}: no drop on a range "
                                 f"after the first ({drops})")
        log(f"   (b) factor {cf} (capacity {cap}): {MOE_RANGES} ranges of "
            f"{size} tokens, each routed on its rows from its peers' "
            f"counts: expert ids, places and kept flags equal a plain "
            f"whole-batch cumsum's; drops by range {drops}")
    whole = Mo.moe_apply(moe, x, cfg).reshape(n_tok, cfg.d_model)
    gates, idx = Mo.top_k(probs, k)
    grp = Mo.group_ids(0, n_tok, n_tok, dev)
    places = Mo.slice_places(
        idx, grp, torch.zeros((n_groups, e), dtype=torch.long, device=dev))
    cap = Mo.expert_capacity(cfg, g_size)
    for m in MOE_SPLITS:
        e_loc = e // m
        total = torch.zeros_like(whole)
        for r in range(m):
            w = {n: moe[n][r * e_loc:(r + 1) * e_loc]
                 for n in ("w_gate", "w_up", "w_down")}
            total = total + Mo.expert_range_output(
                w, tokens, gates, idx, places, grp,
                Mo.slice_groups(0, n_tok, n_tok), cap, r * e_loc)
        require_finite(total, f"(b) the partials of {m} ranges")
        if torch.equal(total, whole):
            log(f"   (b) the block's output as the sum of {m} expert "
                f"ranges' partials ({e_loc} experts each): equal to "
                f"moe_apply's bit for bit")
            continue
        diff = (total.float() - whole.float()).abs()
        worst = float((diff / whole.float().abs().clamp(min=1e-30)).max())
        if bool((diff > MOE_PARTIAL_RTOL * whole.float().abs()).any()):
            raise AssertionError(f"(b) {m} ranges: partials' sum apart "
                                 f"from moe_apply by {worst:.3g} of an "
                                 f"entry (bound {MOE_PARTIAL_RTOL:.3g})")
        log(f"   (b) the block's output as the sum of {m} expert ranges' "
            f"partials: not bit for bit; max |diff| {float(diff.max()):.3g}, "
            f"at most {worst:.3g} of its entry (bound "
            f"{MOE_PARTIAL_RTOL:.3g}); {int((diff > 0).sum())} of "
            f"{diff.numel()} entries differ")


def moe_smoke_steps(dev: torch.device, mesh, seed: int) -> None:
    """(c): the whole sharded step at smoke width on the one-rank mesh,
    Scout and Maverick (moments as ``SMOKE_STATE``), micro-batches 1
    and 2: parameters, moments and loss equal the unsharded step's bit
    for bit, no collective launched."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import full_tree, place_tree
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.optimizer.adamw import AdamWConfig, adamw_init

    for arch in MOE_SMOKE:
        cfg = get_config(arch, smoke=True)
        opt_cfg = AdamWConfig(state_dtype=SMOKE_STATE.get(arch, "float32"))
        params = M.init_stacked_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        opt = adamw_init(params, opt_cfg)
        batch = fixed_batch(cfg, 8, 16, seed + 3, dev)
        batch["mask"][1, 8:] = 0.0
        for mb in (1, 2):
            kw = dict(microbatches=mb, warmup_steps=0, total_steps=10)
            plain = ST.make_train_step(cfg, opt_cfg, **kw)
            sharded = ST.make_train_step(cfg, opt_cfg, mesh=mesh, **kw)
            p1, o1, m1 = plain(params, opt, batch)
            p2, o2, m2 = sharded(
                place_tree(params, ST.params_shardings(cfg, mesh)),
                place_tree(opt, ST.opt_state_shardings(cfg, mesh)), batch)
            trees_equal(full_tree((p2, o2)), (p1, o1),
                        f"(c) {arch}, micro-batches {mb}: parameters and "
                        f"moments")
            if not torch.equal(m1["loss"], m2["loss"]):
                raise AssertionError(f"(c) {arch}, micro-batches {mb}: "
                                     f"loss {float(m2['loss'])} != "
                                     f"{float(m1['loss'])}")
            if sharded.collectives.kinds:
                raise AssertionError(f"(c) a one-rank mesh launched "
                                     f"{sharded.collectives.kinds}")
            log(f"   (c) {arch} smoke ({opt_cfg.state_dtype} moments), "
                f"micro-batches {mb}: the sharded step equal bit for bit "
                f"to the unsharded one (loss {float(m1['loss']):.6f}, every "
                f"parameter and moment), no collective launched")


def moe_phase(dev: torch.device, args, kernels: list) -> None:
    """Phase 21: the MoE family through the sharded step on one card
    (module docstring).  It launches no kernel of the record: the
    counts are zeroed before it and must read 0 after (recorded as path
    ``moe_mesh``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    names = list(KERNEL_MODULES)
    zero_counts(names)
    if dist.is_initialized():
        raise AssertionError("a process group is up before phase 21")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh("cuda")
        full = moe_full_grads(dev, mesh, args.seed)
        moe_ranks(dev, full["cfg"], full["moe"])
        del full
        torch.cuda.empty_cache()
        moe_smoke_steps(dev, mesh, args.seed)
    finally:
        dist.destroy_process_group()
    counts = read_counts(names)
    launched = {n: c for n, c in counts.items() if c}
    if launched:
        raise AssertionError(f"the MoE path launched kernels: {launched}")
    add_path(kernels, "moe_mesh", counts)
    log(f"   (d) EmApprox kernel launches on the path: {counts}; phase 21 "
        f"wall {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# phase 22: tensor parallelism over ``model`` in the sharded step
# ----------------------------------------------------------------------
TP_ARCH = "smollm-360m"
# (b): (arch, ranks, the attention split the ranks must take), full
# width, layer 0 and the head, each rank's partial in turn
TP_SPLITS = (("smollm-360m", 5, "heads"), ("smollm-360m", 16, "seq"),
             ("qwen2.5-14b", 8, "heads"))
TP_CAP = 1e-3     # (b): the most ``run_bound`` allows a joined output


def dev_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, on the device."""
    if got.shape != want.shape:
        raise AssertionError(f"shapes differ: {tuple(got.shape)} "
                             f"{tuple(want.shape)}")
    return float((got.detach().float() - want.detach().float()).abs().max()
                 / want.detach().float().abs().max().clamp(min=1e-30))


def nudged(tensors: list, seed: int) -> list:
    """Every float32 entry of ``tensors`` moved one ulp up or down (a
    random direction each), on their device."""
    g = None
    out = []
    for a in tensors:
        if g is None:
            g = torch.Generator(device=a.device).manual_seed(seed)
        up = torch.rand(a.shape, generator=g, device=a.device) < 0.5
        inf = torch.full_like(a, float("inf"))
        out.append(torch.nextafter(a, torch.where(up, inf, -inf)))
    return out


def tp_full_grads(dev: torch.device, mesh, seed: int) -> None:
    """(a): smollm-360m at full width, phase 20's batch with part of a
    row masked: ``make_sharded_grads`` on the one-rank mesh (its
    ``TPShard`` of one rank passed to ``loss_fn``, every split sublayer
    and the vocabulary-parallel loss on its path) equal to the
    unsharded ``_value_and_grad`` bit for bit, no collective."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import TPShard
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.utils.trees import tree_leaves

    cfg = get_config(TP_ARCH)
    params = M.init_stacked_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    batch = fixed_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 5, dev)
    batch["mask"][1, TRAIN_SEQ // 2:] = 0.0
    # a first call on one short row takes the set-up out of the walls
    ST._value_and_grad(params, fixed_batch(cfg, 1, 16, 9, dev), cfg)
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    loss_u, g_u = ST._value_and_grad(params, batch, cfg)
    torch.cuda.synchronize(dev)
    wall_u = time.perf_counter() - t
    want = tree_leaves(g_u)
    placed = place_tree(params, ST.params_shardings(cfg, mesh))
    grads = ST.make_sharded_grads(cfg, mesh)
    seen = []
    loss_fn = M.loss_fn

    def spy(*args, **kw):
        seen.append(kw.get("tp"))
        return loss_fn(*args, **kw)
    M.loss_fn = spy
    try:
        t = time.perf_counter()
        loss_s, g_s = grads(placed, batch)
        torch.cuda.synchronize(dev)
        wall_s = time.perf_counter() - t
    finally:
        M.loss_fn = loss_fn
    if not seen or any(not isinstance(tp, TPShard) or tp.size != 1
                       or tp is not grads.tp for tp in seen):
        raise AssertionError(f"(a) the sharded step did not pass its "
                             f"one-rank TPShard to loss_fn: {seen}")
    require_finite(loss_s, "(a) loss")
    if not (torch.equal(loss_s, loss_u) and len(g_s) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(g_s, want))):
        raise AssertionError("(a) the sharded loss and gradients are not "
                             "the unsharded ones bit for bit")
    if grads.collectives.kinds:
        raise AssertionError(f"(a) a one-rank mesh launched "
                             f"{grads.collectives.kinds}")
    log(f"   (a) {TP_ARCH} at full width, {TRAIN_BATCH} x {TRAIN_SEQ}: "
        f"make_sharded_grads through the tensor-parallel path (a split "
        f"of {grads.tp.size} rank) equal to the unsharded loss "
        f"({float(loss_s):.6f}) and all {len(want)} gradient leaves bit "
        f"for bit, no collective launched; walls unsharded {wall_u:.3f} s, "
        f"sharded {wall_s:.3f} s")
    del params, placed, g_u, g_s, want
    torch.cuda.empty_cache()


def tp_join(fn, p: dict, x: torch.Tensor, ct: torch.Tensor, m: int,
            rows: bool):
    """The partials of ``fn(p, x, TPShard.simulated(r, m))`` of every
    rank joined: (output, [input gradient, weight gradients]), the
    outputs concatenated along dim 1 where ``rows`` (each rank's
    cotangent its rows), else summed; the gradients summed."""
    from repro_torch.distributed.collectives import TPShard
    outs, grads = [], None
    n = x.shape[1] // m
    for r in range(m):
        leaves = [x] + list(p.values())
        ins = [a.detach().requires_grad_(True) for a in leaves]
        out = fn(dict(zip(p, ins[1:])), ins[0], TPShard.simulated(r, m))
        c = ct[:, r * n:(r + 1) * n] if rows else ct
        g = torch.autograd.grad(out, ins, c)
        outs.append(out.detach())
        grads = list(g) if grads is None else [a + b for a, b in
                                               zip(grads, g)]
    return (torch.cat(outs, 1) if rows else sum(outs[1:], outs[0])), grads


def tp_whole(fn, p: dict, x: torch.Tensor, ct: torch.Tensor,
             dtype=torch.float32):
    """(output, [input gradient, weight gradients]) of the whole
    sublayer ``fn(p, x, NO_TP)``, its inputs and cotangent in
    ``dtype``."""
    from repro_torch.distributed.collectives import NO_TP
    ins = [a.detach().to(dtype).requires_grad_(True)
           for a in [x] + list(p.values())]
    out = fn(dict(zip(p, ins[1:])), ins[0], NO_TP)
    return out.detach(), list(torch.autograd.grad(out, ins, ct.to(dtype)))


def tp_hold(what: str, names: list, got, want, moved, exact) -> str:
    """Each joined output against the whole one within ``run_bound``
    of the whole one's own move: the larger of its move under one ulp
    of its inputs (``moved``), its own float32 rounding (its distance
    from the same sublayer run on the inputs in float64, ``exact``)
    and one float32 ulp of itself (a scalar such as the loss may round
    back to its own bits).  A sum over a long dim (49152 logits) in
    another order moves more than one ulp of its inputs does; the
    rounding bounds that.  Returns the worst reading."""
    worst = (0.0, "")
    for name, a, b, c, e in zip(names, got, want, moved, exact):
        err = dev_err(a, b)
        move, rnd = dev_err(c, b), dev_err(b, e)
        tol = run_bound(max(move, rnd, torch.finfo(torch.float32).eps),
                        TP_CAP)
        require_finite(a, f"(b) {what}: {name}")
        if err > tol:
            raise AssertionError(f"(b) {what}: {name} joined from the "
                                 f"ranks' partials {err:.3g} from the "
                                 f"whole (bound {tol:.3g}: one-ulp move "
                                 f"{move:.3g}, float32 rounding {rnd:.3g})")
        worst = max(worst, (err / tol, f"{name} {err:.3g} (bound {tol:.3g}"
                                       f", move {move:.3g}, rounding "
                                       f"{rnd:.3g})"))
    return worst[1]


def tp_ranks(dev: torch.device, seed: int) -> None:
    """(b): at full width with no process group, what each rank of a
    split of ``m`` computes (``TPShard.simulated(rank, m)``): layer 0's
    self-attention and MLP, their partials summed or concatenated, and
    the head with the vocabulary-parallel loss in lockstep
    (``testing.lockstep``); outputs and the input and weight gradients
    against the whole sublayer's (``tp_hold``)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import NO_TP
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.models.attention import attention_apply, attention_split
    from repro_torch.models.config import DTypePolicy
    from repro_torch.models.layers import materialize, swiglu
    from repro_torch.testing import lockstep

    fp32 = DTypePolicy("float32", "float32", "float32")
    b, s = TRAIN_BATCH, TRAIN_SEQ
    for arch, m, split in TP_SPLITS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), dtypes=fp32)
        got_split = attention_split(cfg, m, s)
        if got_split != split:
            raise AssertionError(f"(b) {arch} at {m} ranks: attention "
                                 f"split {got_split}, not {split}")
        g = torch.Generator(device=dev).manual_seed(seed + m)
        attn = materialize(blocks.attn_defs(cfg), g, torch.float32, dev)
        mlp = materialize(blocks.mlp_defs(cfg), g, torch.float32, dev)
        x = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
        ct = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
        positions = torch.arange(s, device=dev)

        def attn_fn(p, h, tp):
            return attention_apply(p, h, cfg=cfg, positions=positions,
                                   tp=tp)[0]

        def mlp_fn(p, h, tp):
            return swiglu(h, p["w_gate"], p["w_up"], p["w_down"], tp,
                          cfg.d_ff)
        readings = []
        for what, fn, p, rows in (("attention", attn_fn, attn,
                                   split == "seq"),
                                  ("MLP", mlp_fn, mlp, False)):
            names = ["output", "input gradient"] + [f"d{k}" for k in p]
            out, gr = tp_join(fn, p, x, ct, m, rows)
            w_out, w_gr = tp_whole(fn, p, x, ct)
            moved = nudged([x] + list(p.values()), seed + 7)
            u_out, u_gr = tp_whole(fn, dict(zip(p, moved[1:])), moved[0], ct)
            e_out, e_gr = tp_whole(fn, p, x, ct, torch.float64)
            readings.append(f"{what} " + tp_hold(
                f"{arch}, {m} ranks, {what}", names, [out] + gr,
                [w_out] + w_gr, [u_out] + u_gr, [e_out] + e_gr))
            del out, gr, w_out, w_gr, u_out, u_gr, e_out, e_gr, moved

        # the head and the vocabulary-parallel loss, in lockstep
        v = cfg.vocab_size
        head = {"lm_head": torch.randn((cfg.d_model, v), generator=g,
                                       device=dev) / math.sqrt(cfg.d_model)}
        h = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
        labels = torch.randint(0, v, (b, s), generator=g, device=dev)
        mask = torch.ones((b, s), device=dev)
        mask[1, s // 2:] = 0.0
        split_v = v % m == 0

        def loss(hh, w, tp):
            z = M._logits(hh, {"lm_head": w}, cfg, tp)
            nll = M.vocab_parallel_nll(z, labels, tp if split_v else NO_TP)
            return (nll * mask).sum() / mask.sum().clamp(min=1.0)

        def whole(hh, w, dtype=torch.float32):
            hh, w = [a.detach().to(dtype).requires_grad_(True)
                     for a in (hh, w)]
            val = loss(hh, w, NO_TP)
            return [val.detach()] + list(torch.autograd.grad(val, [hh, w]))
        want = whole(h, head["lm_head"])
        moved = whole(*nudged([h, head["lm_head"]], seed + 11))
        exact = whole(h, head["lm_head"], torch.float64)
        ins = [[a.detach().requires_grad_(True) for a in
                (h, head["lm_head"])] for _ in range(m)]
        vals = lockstep(lambda tp: loss(*ins[tp.rank], tp), m)
        per_rank = [[val.detach(), *torch.autograd.grad(val, pair)]
                    for val, pair in zip(vals, ins)]
        if any(not torch.equal(r[0], per_rank[0][0]) for r in per_rank):
            raise AssertionError(f"(b) {arch}, {m} ranks: the ranks' "
                                 f"losses differ")
        names = ["loss", "input gradient", "dlm_head"]
        if split_v:
            # each rank's logits columns: the input's gradient is summed
            # over the ranks (region_in), the head's is each rank's chunk
            joined = [per_rank[0][0]] + [sum(r[i] for r in per_rank)
                                         for i in (1, 2)]
            loss_reading = tp_hold(f"{arch}, {m} ranks, loss", names,
                                   joined, want, moved, exact)
        else:
            # the vocabulary whole on every rank: each rank's is whole
            for r in per_rank:
                loss_reading = tp_hold(f"{arch}, {m} ranks, loss", names,
                                       r, want, moved, exact)
        torch.cuda.synchronize(dev)
        log(f"   (b) {arch} at full width, {m} ranks ({split} split"
            f"{', vocabulary ' + str(v // m) + ' a rank' if split_v else ', vocabulary whole'}, "
            f"d_ff {cfg.d_ff // m} a rank), {b} x {s}: every output and "
            f"gradient joined from the ranks' partials within twice the "
            f"whole one's own move; worst (error / bound): "
            + "; ".join(readings) + f"; loss {loss_reading}; "
            f"{time.perf_counter() - t0:.1f} s")
        del attn, mlp, head, want, moved, exact, ins, vals, per_rank
        torch.cuda.empty_cache()


def tp_phase(dev: torch.device, args, kernels: list) -> None:
    """Phase 22: tensor parallelism over ``model`` on one card (module
    docstring).  It launches no kernel of the record: the counts are
    zeroed before it and must read 0 after (recorded as path
    ``tp_mesh``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    names = list(KERNEL_MODULES)
    zero_counts(names)
    if dist.is_initialized():
        raise AssertionError("a process group is up before phase 22")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        tp_full_grads(dev, make_host_mesh("cuda"), args.seed)
    finally:
        dist.destroy_process_group()
    tp_ranks(dev, args.seed)
    counts = read_counts(names)
    launched = {n: c for n, c in counts.items() if c}
    if launched:
        raise AssertionError(f"the tensor-parallel path launched kernels: "
                             f"{launched}")
    add_path(kernels, "tp_mesh", counts)
    log(f"   (c) EmApprox kernel launches on the path: {counts}; phase 22 "
        f"wall {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# phase 23: the SSM and cross-attention over ``model``, sharded serving
# ----------------------------------------------------------------------
SP_ARCH = "mamba2-780m"
# (b): (arch, ranks, sublayer of layer 0), full width, each rank's part
SP_SPLITS = (("mamba2-780m", 16, "ssm"), ("hymba-1.5b", 2, "hybrid"),
             ("llama-3.2-vision-11b", 16, "cross"),
             ("whisper-small", 4, "cross"))
CP_SLOTS, CP_RANKS, CP_BATCH = 2048, 16, 8   # (d)
CP_LENGTHS = (1000, CP_SLOTS - 1)  # (d): ranks 8-15 empty; a full cache


def sp_full_grads(dev: torch.device, mesh, seed: int) -> None:
    """(a): mamba2-780m at full width, phase 20's batch with part of a
    row masked: ``make_sharded_grads`` on the one-rank mesh, its
    ``TPShard`` of one rank passed to every SSM, equal to the unsharded
    ``_value_and_grad`` bit for bit, no collective."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import TPShard
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.utils.trees import tree_leaves

    cfg = get_config(SP_ARCH)
    params = M.init_stacked_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    batch = fixed_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 5, dev)
    batch["mask"][1, TRAIN_SEQ // 2:] = 0.0
    ST._value_and_grad(params, fixed_batch(cfg, 1, 16, 9, dev), cfg)
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    loss_u, g_u = ST._value_and_grad(params, batch, cfg)
    torch.cuda.synchronize(dev)
    wall_u = time.perf_counter() - t
    want = tree_leaves(g_u)
    placed = place_tree(params, ST.params_shardings(cfg, mesh))
    grads = ST.make_sharded_grads(cfg, mesh)
    seen = []
    ssm_apply = ssm_mod.ssm_apply

    def spy(*args, **kw):
        seen.append(kw.get("tp", args[4] if len(args) > 4 else None))
        return ssm_apply(*args, **kw)
    ssm_mod.ssm_apply = spy
    try:
        t = time.perf_counter()
        loss_s, g_s = grads(placed, batch)
        torch.cuda.synchronize(dev)
        wall_s = time.perf_counter() - t
    finally:
        ssm_mod.ssm_apply = ssm_apply
    if not seen or any(not isinstance(tp, TPShard) or tp is not grads.tp
                       for tp in seen):
        raise AssertionError(f"(a) the sharded step did not pass its "
                             f"one-rank TPShard to the SSM: {seen[:3]}")
    require_finite(loss_s, "(a) loss")
    if not (torch.equal(loss_s, loss_u) and len(g_s) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(g_s, want))):
        raise AssertionError("(a) the sharded loss and gradients are not "
                             "the unsharded ones bit for bit")
    if grads.collectives.kinds:
        raise AssertionError(f"(a) a one-rank mesh launched "
                             f"{grads.collectives.kinds}")
    log(f"   (a) {SP_ARCH} at full width, {TRAIN_BATCH} x {TRAIN_SEQ}: "
        f"make_sharded_grads, its one-rank TPShard reaching the SSM "
        f"{len(seen)} times, equal to the unsharded loss "
        f"({float(loss_s):.6f}) and all {len(want)} gradient leaves bit "
        f"for bit, no collective launched; walls unsharded {wall_u:.3f} s, "
        f"sharded {wall_s:.3f} s")
    del params, placed, g_u, g_s, want
    torch.cuda.empty_cache()


def tp_lockstep(fn, p: dict, x: torch.Tensor, ct: torch.Tensor, m: int,
                whole=()):
    """``m`` ranks of ``fn(p, x, tp)`` in lockstep (``testing.lockstep``):
    (output, [input gradient, weight gradients]), the output every
    rank's (they must be equal), the gradients summed over the ranks but
    for the leaves named in ``whole``, which every rank computes whole
    (rank 0's)."""
    from repro_torch.testing import lockstep
    ins = [[a.detach().requires_grad_(True) for a in [x] + list(p.values())]
           for _ in range(m)]
    outs = lockstep(lambda tp: fn(dict(zip(p, ins[tp.rank][1:])),
                                  ins[tp.rank][0], tp), m)
    if any(not torch.equal(o, outs[0]) for o in outs):
        raise AssertionError("the lockstep ranks' outputs differ")
    per = [torch.autograd.grad(o, i, ct) for o, i in zip(outs, ins)]
    names = ["x"] + list(p)
    grads = [per[0][j] if n in whole else sum(g[j] for g in per)
             for j, n in enumerate(names)]
    return outs[0].detach(), grads


def sp_ranks(dev: torch.device, seed: int) -> None:
    """(b): each rank's part of layer 0's SSM, hybrid mixer or
    cross-attention at full width with no process group, joined and
    held against the whole sublayer's (``tp_hold``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    from repro_torch.models.attention import (attention_split,
                                              cross_attention_apply)
    from repro_torch.models.config import DTypePolicy
    from repro_torch.models.layers import materialize
    from repro_torch.models.ssm import ssm_apply, ssm_split

    fp32 = DTypePolicy("float32", "float32", "float32")
    b, s = TRAIN_BATCH, TRAIN_SEQ
    positions = torch.arange(s, device=dev)
    for arch, m, what in SP_SPLITS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), dtypes=fp32)
        g = torch.Generator(device=dev).manual_seed(seed + m)
        whole = ()
        if what == "ssm":
            split = ssm_split(cfg, m)
            p = materialize(blocks.ssm_defs(cfg), g, torch.float32, dev)

            def fn(q, h, tp):
                return ssm_apply(q, h, cfg, tp=tp)[0]
        elif what == "hybrid":
            split = f"attention {attention_split(cfg, m, s)}, SSM " \
                f"{ssm_split(cfg, m)}"
            defs = blocks.block_defs(cfg, "hybrid")
            p = {"attn": defs["attn"], "ssm": defs["ssm"], "mix": defs["mix"]}
            p = materialize(p, g, torch.float32, dev)
            # flat names ("attn/wq", "mix"): each leaf one entry of p
            p = {f"{k}/{n}": v for k, sub in p.items() if k != "mix"
                 for n, v in sub.items()} | {
                "mix": p["mix"] + torch.randn(2, generator=g, device=dev)}
            whole = ("mix",)

            def fn(q, h, tp):
                tree = {"attn": {}, "ssm": {}, "mix": q["mix"]}
                for k, v in q.items():
                    if "/" in k:
                        top, n = k.split("/")
                        tree[top][n] = v
                return blocks.hybrid_mixer(tree, h, cfg, positions=positions,
                                           tp=tp)[0]
        else:
            split = attention_split(cfg, m, s)
            t_enc = cfg.encoder_seq if cfg.is_encdec else cfg.vision_tokens
            cross = blocks.cross_defs(cfg)
            p = materialize({k: cross[k] for k in ("wq", "wk", "wv", "wo")},
                            g, torch.float32, dev)
            p["enc"] = torch.randn((b, t_enc, cfg.d_model), generator=g,
                                   device=dev)

            def fn(q, h, tp):
                w = {k: v for k, v in q.items() if k != "enc"}
                return cross_attention_apply(w, h, q["enc"], cfg=cfg, tp=tp)
        x = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
        ct = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
        names = ["output", "input gradient"] + [f"d{k}" for k in p]
        if what == "hybrid":
            out, gr = tp_lockstep(fn, p, x, ct, m, whole)
        else:
            out, gr = tp_join(fn, p, x, ct, m, split == "seq")
        w_out, w_gr = tp_whole(fn, p, x, ct)
        moved = nudged([x] + list(p.values()), seed + 7)
        u_out, u_gr = tp_whole(fn, dict(zip(p, moved[1:])), moved[0], ct)
        e_out, e_gr = tp_whole(fn, p, x, ct, torch.float64)
        reading = tp_hold(f"{arch}, {m} ranks, {what}", names, [out] + gr,
                          [w_out] + w_gr, [u_out] + u_gr, [e_out] + e_gr)
        torch.cuda.synchronize(dev)
        log(f"   (b) {arch} layer 0 {what} at full width, {m} ranks "
            f"({split} split), {b} x {s}: the output and every gradient "
            f"joined from the ranks' parts within twice the whole one's "
            f"own move; worst (error / bound): {reading}; "
            f"{time.perf_counter() - t0:.1f} s")
        del p, out, gr, w_out, w_gr, u_out, u_gr, e_out, e_gr, moved
        torch.cuda.empty_cache()


def serve_on_mesh(dev: torch.device, mesh, seed: int) -> None:
    """(c): the sharded prefill and decode steps on the one-rank mesh
    against the unsharded ``prefill`` / ``decode_step`` at phase 18's
    shapes, the unsharded greedy tokens fed to both: logits and the
    state bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import full_tree, place_tree
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.utils.trees import tree_leaves

    for arch, prompt in LM_FULL:
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(seed)
        stacked = M.init_stacked_params(cfg, gen, dev)
        views = M._unstack_params(stacked)
        toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, prompt),
                             generator=gen, device=dev)
        max_len = prompt + LM_GEN

        def run(prefill, decode, params, state, feed=None):
            """(logits of each call, greedy tokens, state, prefill s,
            decode s a token)."""
            logits, fed = [], []
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            out, state = prefill(params, toks, state)
            torch.cuda.synchronize(dev)
            pre = time.perf_counter() - t
            logits.append(out)
            t = time.perf_counter()
            for i in range(LM_GEN - 1):
                nxt = out.argmax(-1, keepdim=True) if feed is None \
                    else feed[i]
                fed.append(nxt)
                out, state = decode(params, nxt, state)
                logits.append(out)
            torch.cuda.synchronize(dev)
            return logits, fed, state, pre, \
                (time.perf_counter() - t) / (LM_GEN - 1)
        with torch.no_grad():
            want, fed, w_state, w_pre, w_dec = run(
                ST.make_prefill_step(cfg), ST.make_decode_step(cfg), views,
                M.init_decode_state(cfg, LM_BATCH, max_len, device=dev))
            placed = place_tree(stacked, ST.params_shardings(cfg, mesh,
                                                             serve=True))
            sh = ST.decode_state_shardings(
                cfg, mesh, ST.abstract_decode_state(cfg, LM_BATCH, max_len,
                                                    False), LM_BATCH)
            pre_step = ST.make_prefill_step(cfg, mesh)
            dec_step = ST.make_decode_step(cfg, mesh)
            got, _, g_state, g_pre, g_dec = run(
                pre_step, dec_step, placed, place_tree(
                    M.init_decode_state(cfg, LM_BATCH, max_len, device=dev),
                    sh), fed)
        for a, b_ in zip(got, want):
            require_finite(a, f"(c) {arch} logits")
        if not (len(got) == len(want) and all(
                torch.equal(a, b_) for a, b_ in zip(got, want))):
            raise AssertionError(f"(c) {arch}: the sharded serving logits "
                                 f"are not the unsharded ones bit for bit")
        g_state = full_tree(g_state)
        if g_state.length != w_state.length or not all(
                torch.equal(a, b_) for a, b_ in
                zip(tree_leaves(g_state), tree_leaves(w_state))
                if isinstance(a, torch.Tensor)):
            raise AssertionError(f"(c) {arch}: the sharded serving state "
                                 f"is not the unsharded one bit for bit")
        kinds = {**pre_step.collectives.kinds, **dec_step.collectives.kinds}
        if kinds:
            raise AssertionError(f"(c) a one-rank mesh launched {kinds}")
        log(f"   (c) {arch} at full width, batch {LM_BATCH}, prompt "
            f"{prompt}, {LM_GEN} tokens, compute {cfg.dtypes.compute}: "
            f"make_prefill_step / make_decode_step on the mesh equal to the "
            f"unsharded prefill / decode_step bit for bit (all {len(got)} "
            f"logits and the state), no collective launched; prefill "
            f"{w_pre * 1e3:.3f} ms unsharded, {g_pre * 1e3:.3f} ms sharded; "
            f"decode {w_dec * 1e3:.3f} / {g_dec * 1e3:.3f} ms a token "
            f"(first calls, mean of {LM_GEN - 1})")
        del stacked, views, placed, want, got, w_state, g_state
        torch.cuda.empty_cache()


def cp_decode(dev: torch.device, seed: int) -> None:
    """(d): context-parallel decode at full width with no process
    group: smollm's layer 0 self-attention against a ``CP_SLOTS``-slot
    cache split over ``CP_RANKS`` lockstep ranks, and mamba2's layer 0
    SSM decode state split by heads, joined, held against the whole."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import TPShard
    from repro_torch.models import blocks
    from repro_torch.models.attention import KVCache, attention_apply
    from repro_torch.models.config import DTypePolicy
    from repro_torch.models.layers import materialize
    from repro_torch.models.ssm import SSMState, init_ssm_state, ssm_apply
    from repro_torch.testing import lockstep

    fp32 = DTypePolicy("float32", "float32", "float32")
    cfg = dataclasses.replace(get_config(TP_ARCH), dtypes=fp32)
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    p = materialize(blocks.attn_defs(cfg), g, torch.float32, dev)
    shape = (CP_BATCH, CP_SLOTS, cfg.n_kv_heads, cfg.head_dim)
    k = torch.randn(shape, generator=g, device=dev)
    v = torch.randn(shape, generator=g, device=dev)
    x = torch.randn((CP_BATCH, 1, cfg.d_model), generator=g, device=dev)
    n = CP_SLOTS // CP_RANKS
    for length in CP_LENGTHS:
        pos = torch.where(torch.arange(CP_SLOTS, device=dev) < length,
                          torch.arange(CP_SLOTS, device=dev), -1) \
            .to(torch.int32)
        positions = torch.arange(length, length + 1, device=dev)

        def whole(q, h, kk, vv):
            return attention_apply(q, h, cfg=cfg, positions=positions,
                                   cache=KVCache(kk.clone(), vv.clone(), pos,
                                                 length))[0]

        def rank(tp):
            r = tp.rank
            chunk = KVCache(k[:, r * n:(r + 1) * n].clone(),
                            v[:, r * n:(r + 1) * n].clone(), pos, length)
            return attention_apply(p, x, cfg=cfg, positions=positions,
                                   cache=chunk, tp=tp)[0]
        outs = lockstep(rank, CP_RANKS)
        if any(not torch.equal(o, outs[0]) for o in outs):
            raise AssertionError("(d) the lockstep ranks' outputs differ")
        want = whole(p, x, k, v)
        mv = nudged([x, k, v] + list(p.values()), seed + 29)
        moved = whole(dict(zip(p, mv[3:])), *mv[:3])
        exact = whole({a: w.double() for a, w in p.items()}, x.double(),
                      k.double(), v.double())
        empty = [r for r in range(CP_RANKS) if int(pos[r * n]) < 0]
        reading = tp_hold(f"smollm decode at length {length}", ["output"],
                          [outs[0]], [want], [moved], [exact])
        log(f"   (d) {TP_ARCH} layer 0 decode at length {length} against a "
            f"{CP_SLOTS}-slot cache split over {CP_RANKS} ranks ({n} slots "
            f"a rank; ranks {empty[0] if empty else '-'}"
            f"{'-' + str(empty[-1]) if len(empty) > 1 else ''} hold no valid "
            f"slot), the softmax joined by log-sum-exp: {reading}")

    cfg = dataclasses.replace(get_config(SP_ARCH), dtypes=fp32)
    p = materialize(blocks.ssm_defs(cfg), g, torch.float32, dev)
    x0 = torch.randn((CP_BATCH, 64, cfg.d_model), generator=g, device=dev)
    x1 = torch.randn((CP_BATCH, 1, cfg.d_model), generator=g, device=dev)
    st = ssm_apply(p, x0, cfg, init_ssm_state(CP_BATCH, cfg, torch.float32,
                                              dev))[1]
    hl, dl = cfg.ssm_heads // CP_RANKS, cfg.d_inner // CP_RANKS

    def one_step(q, h, state):
        return ssm_apply(q, h, cfg, SSMState(state.state.clone(),
                                             state.conv.clone()))
    w_out, w_st = one_step(p, x1, st)
    outs, sts = [], []
    for r in range(CP_RANKS):
        chunk = SSMState(st.state[:, r * hl:(r + 1) * hl].clone(),
                         st.conv[..., r * dl:(r + 1) * dl].clone())
        o, s1 = ssm_apply(p, x1, cfg, chunk,
                          tp=TPShard.simulated(r, CP_RANKS))
        outs.append(o)
        sts.append(s1)
    got = [sum(outs[1:], outs[0]), torch.cat([a.state for a in sts], 1),
           torch.cat([a.conv for a in sts], 2)]
    mv = nudged([x1] + list(p.values()), seed + 31)
    u_out, u_st = one_step(dict(zip(p, mv[1:])), mv[0], st)
    # the SSD keeps its state and step math in float32 (``.float()``)
    e_out, e_st = one_step({a: w.double() for a, w in p.items()},
                           x1.double(), SSMState(st.state, st.conv.double()))
    reading = tp_hold("mamba2 decode state", ["output", "state", "conv"],
                      got, [w_out, w_st.state, w_st.conv],
                      [u_out, u_st.state, u_st.conv],
                      [e_out, e_st.state, e_st.conv])
    torch.cuda.synchronize(dev)
    log(f"   (d) {SP_ARCH} layer 0 decode step after 64 tokens, its state "
        f"split over {CP_RANKS} ranks ({hl} heads, {dl} conv channels a "
        f"rank): the summed output and the joined state within twice the "
        f"whole one's own move; worst {reading}")


def serve_phase_mesh(dev: torch.device, args, kernels: list) -> None:
    """Phase 23 (module docstring).  It launches no kernel of the
    record: the counts are zeroed before it and must read 0 after
    (recorded as path ``serve_mesh``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    names = list(KERNEL_MODULES)
    zero_counts(names)
    if dist.is_initialized():
        raise AssertionError("a process group is up before phase 23")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh("cuda")
        sp_full_grads(dev, mesh, args.seed)
        serve_on_mesh(dev, mesh, args.seed)
    finally:
        dist.destroy_process_group()
    sp_ranks(dev, args.seed)
    cp_decode(dev, args.seed)
    counts = read_counts(names)
    launched = {n: c for n, c in counts.items() if c}
    if launched:
        raise AssertionError(f"the phase 23 paths launched kernels: "
                             f"{launched}")
    add_path(kernels, "serve_mesh", counts)
    log(f"   (e) EmApprox kernel launches on the path: {counts}; phase 23 "
        f"wall {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# phase 24: the fused attention forward (row 13) at the prefill cell's
# shapes
# ----------------------------------------------------------------------
ATTN_HEADS = (15, 5, 64)      # smollm-360m: query heads, KV heads, head dim
ATTN_SHAPES = ((1747, 37), (150, 436))  # the prefill cell's longest and
                                        # shortest prompts: (length, rows)


def _attention_errors(aref, got, q, k, v):
    """(kernel, dense bfloat16, control) max abs errors against
    ``dense_attention`` in float32, causal, over prompts in slices (the
    float32 scores of every prompt at once would take 20 GB)."""
    err = plain = control = 0.0
    for i in range(0, q.shape[0], 4):
        qs, ks, vs = (x[i:i + 4] for x in (q, k, v))
        want = aref.dense_attention(qs.float(), ks.float(), vs.float(),
                                    causal=True)
        err = max(err, float((got[i:i + 4].float() - want).abs().max()))
        plain = max(plain, float((aref.dense_attention(
            qs, ks, vs, causal=True).float() - want).abs().max()))
        b, s, h, hd = qs.shape
        kh = ks.shape[2]
        scores = aref._gqa_scores(qs.float().reshape(b, s, kh, h // kh, hd),
                                  ks.float()) / aref._sqrt_in(hd, torch.float32)
        scores = torch.where(aref._causal_mask(s, s, 0, 0, q.device),
                             scores, aref.NEG_INF)
        p = torch.softmax(scores, dim=-1).to(torch.float8_e4m3fn).float()
        bad = aref._gqa_out(p, vs.float()).reshape(b, s, h, hd)
        control = max(control, float((bad - want).abs().max()))
        del want, scores, p, bad
    return err, plain, control


def attention_phase(dev: torch.device, launches_by_path: dict) -> list:
    """Row 13 at the prefill cell's shapes (the benchmark's
    ``prefill-64k``: 65536 tokens a batch), causal, bfloat16: the
    kernel against ``dense_attention`` in float32, within twice the
    error of ``dense_attention`` in bfloat16 on the same inputs (the
    tolerance of the card tests), while ``dense_attention`` in float32
    with its probabilities rounded to float8 e4m3 (the control) must
    fall outside it; bit for bit from run to run; ``ms``, ``device_ms``, the bound (causal operations, QK^T and
    PV, over 989 TFLOP/s against Q, K, V and O read or written once
    over 3.35 TB/s), the plain version (``dense_attention`` in
    bfloat16) and ``scaled_dot_product_attention`` as ``library_ms``,
    a yardstick the port never calls.  ``launches_by_path``: the
    kernel's launches in phases 18 (``lm_serve``), 19 (``lm_train``)
    and 23 (``serve_mesh``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel as ak
    from repro_torch.kernels.attention import ref as aref

    h, kh, hd = ATTN_HEADS
    require_launched({"fused_attention": launches_by_path["lm_serve"]},
                     "lm_serve")
    out = []
    for s, b in ATTN_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(13)
        q = torch.randn(b, s, h, hd, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(b, s, kh, hd, generator=gen,
                            device=dev).bfloat16() for _ in range(2))

        def call():
            return ak.fused_attention_kernel(q, k, v, causal=True)

        got = call()
        same(got, call(), f"fused attention at {s} x {b}")
        err, plain, control = _attention_errors(aref, got, q, k, v)
        log(f"   max abs err against float32: kernel {err:.4g}, "
            f"dense bfloat16 {plain:.4g}, control (P in float8) "
            f"{control:.4g}")
        if not err <= 2 * plain < control:
            raise AssertionError(
                f"fused attention at {s} x {b}: max abs err {err:.4g}, "
                f"bound {2 * plain:.4g}, control {control:.4g}")
        ops = 4.0 * b * h * hd * s * (s + 1) / 2
        nbytes = 2.0 * (2 * q.numel() + 2 * k.numel())
        t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
        plain_ms = time_ms(lambda: aref.dense_attention(q, k, v, causal=True),
                           reps=5, warmup=1)
        torch.cuda.empty_cache()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        times = timed(call)
        kr = dict(
            name=f"fused_attention_{s}x{b}", route="cuda",
            source="src/repro_torch/csrc/attention.cu", replaces=None,
            launches=launches_by_path["lm_serve"],
            launches_by_path=dict(launches_by_path), max_abs_err=err,
            plain_err=plain, control_err=control,
            **times, plain_ms=plain_ms,
            bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=library_ms)
        log_kernel(kr, dict(S=s, B=b, H=h, KH=kh, hd=hd, causal=True))
        log(f"   {100 * kr['bound_ms'] / kr['device_ms']:.1f} % of the "
            f"bound; library (scaled_dot_product_attention) "
            f"{library_ms:.4f} ms")
        out.append(kr)
        del q, k, v, qt, kt, vt, got
        torch.cuda.empty_cache()
    return out


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
    build = build_serve_phase(dev, args, kernels)
    log(f"== live ingest: {APPEND_DOCS} docs appended to the {args.n_docs}-"
        f"doc corpus, refresh at {INFER_STEPS} inference steps")
    ingest_phase(dev, args, ctx, kernels)
    log(f"== serving stack: 4 hosts, 2 replicas, window, planner, cache, "
        f"fleet, ingest on the {args.build_docs}-doc build")
    stack_phase(dev, args, build, kernels)
    log(f"== recommendation: {REVIEW_USERS} users x {REVIEW_ITEMS} items")
    recommend_phase(dev, args, kernels)
    # the EmApprox phases' corpora, indexes and models are not read again
    del ctx, build
    torch.cuda.empty_cache()
    log(f"== LM serving: {', '.join(a for a, _ in LM_FULL)} at full width "
        f"through launch/serve.serve, then every architecture at smoke "
        f"width against the CPU")
    from repro_torch.kernels.attention import kernel as attn_kernel
    attn = attn_kernel.fused_attention_kernel
    attn_by_path = {}
    n0 = attn.launches
    lm_phase(dev, args)
    attn_by_path["lm_serve"] = attn.launches - n0
    log(f"== LM training on {card}: launch/train {TRAIN_ARCH} at full "
        f"width on {TRAIN_DOCS} docs with the similarity curriculum, a "
        f"resume, the loss on one batch "
        f"({', '.join(a for a, _ in FALL)}), gradients against the CPU, "
        f"every architecture at smoke width")
    n0 = attn.launches
    train_phase_lm(dev, args, kernels)
    attn_by_path["lm_train"] = attn.launches - n0
    log(f"== distributed on {card}: a one-rank NCCL mesh, launch/train "
        f"{TRAIN_ARCH} through it, the sharded step against the unsharded "
        f"step, the compressed all-reduce")
    dist_phase(dev, kernels)
    log(f"== MoE through the sharded step on {card}: {MOE_ARCH} at full "
        f"width (1 layer) on a one-rank NCCL mesh, each rank's routing and "
        f"expert ranges, Scout and Maverick smoke steps")
    moe_phase(dev, args, kernels)
    log(f"== tensor parallelism over model on {card}: {TP_ARCH} at full "
        f"width through the sharded step's split path on a one-rank NCCL "
        f"mesh, each rank's partials at "
        f"{', '.join(f'{a} m={m}' for a, m, _ in TP_SPLITS)}")
    tp_phase(dev, args, kernels)
    log(f"== the SSM, cross-attention and serving over model on {card}: "
        f"{SP_ARCH} at full width through the sharded step, each rank's "
        f"part at {', '.join(f'{a} m={m}' for a, m, _ in SP_SPLITS)}, the "
        f"sharded prefill and decode of "
        f"{', '.join(a for a, _ in LM_FULL)} on a one-rank NCCL mesh, "
        f"context-parallel decode over {CP_RANKS} ranks")
    n0 = attn.launches
    serve_phase_mesh(dev, args, kernels)
    attn_by_path["serve_mesh"] = attn.launches - n0
    log(f"== fused attention (row 13) at the prefill cell's shapes: "
        f"{', '.join(f'{a} x {b}' for a, b in ATTN_SHAPES)}, heads "
        f"{ATTN_HEADS}")
    kernels += attention_phase(dev, attn_by_path)
    log(f"== done in {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
