"""Training driver: config-driven, fault-tolerant, mesh-agnostic.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --steps 200 --batch 8 --seq 256                   # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --smoke --device cpu --steps 4 --batch 2 --seq 32 --n-docs 200

The JAX package's driver on the port: micro-batched gradient
accumulation, checkpoint/restart (resumes from the latest committed
step), similarity-driven data sampling (``--similarity-prompt``: the
port's PV-DBOW training, index build and shard probabilities on the
device, which launch the negative-sampling and asym-similarity
kernels), loss logging.  The training state is the stacked parameter
tree and an ``OptState``, placed as shards by the logical rules
(``params_shardings`` / ``opt_state_shardings``) on the host mesh
(``make_host_mesh``: the initialised world, or a one-rank group made
for the run and ended with it), and trained by the sharded step; on
one device every collective is an identity.  A checkpoint holds the
whole tensors and restores to the device before it is placed.  Batches
are assembled and moved to the device in a prefetch thread.

``main`` returns a ``TrainRun`` with the final state (whole tensors),
the logged losses and the walls of the steps, the checkpoint saves and the
restore.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.corpus import SyntheticCorpusConfig, generate_text_corpus
from repro_torch.data.pipeline import (
    LMBatchPipeline,
    PrefetchIterator,
    SimilaritySampler,
)
from repro_torch.data.store import ShardedCorpus
from repro_torch.distributed.sharding import full_tree, place_tree
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (
    make_train_step,
    opt_state_shardings,
    params_shardings,
)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optimizer.adamw import AdamWConfig, OptState, adamw_init


@dataclasses.dataclass
class TrainRun:
    params: dict                   # the stacked parameter tree after the run
    opt_state: OptState
    start_step: int                # 0, or the committed step resumed from
    losses: Dict[int, float]       # loss of every logged step
    step_s: List[float]            # wall of each step of this run
    tokens: int                    # tokens trained on in this run
    n_shards: int
    shard_order: Optional[np.ndarray]   # the similarity sampler's draw
    setup_s: Dict[str, float]      # data, similarity index, state, restore
    save_s: List[float] = dataclasses.field(default_factory=list)
    wait_s: float = 0.0            # the final wait for queued writes
    data_wait_s: float = 0.0       # the loop's wait for batches

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(sum(self.step_s), 1e-9)


class _StepClock:
    """Ends of steps: CUDA events on the card (no synchronisation in
    the loop; the walls are read once at the end), the host clock on
    the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks: list = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def walls(self) -> List[float]:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--n-docs", type=int, default=2000)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--similarity-prompt", type=int, nargs="*", default=None,
                    help="word ids; shards are pps-sampled toward them")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def _similarity_order(corpus: ShardedCorpus, prompt, dev: torch.device
                      ) -> np.ndarray:
    """EmApprox as a training-data curriculum: a PV-DBOW model and a
    shard-granular index on ``dev``, the prompt's shard probabilities,
    one epoch's shard order drawn from them."""
    from repro_torch.core.index import build_index
    from repro_torch.core.lsh import LSHConfig
    from repro_torch.core.pv_dbow import PVDBOWConfig, train_pv_dbow
    pv_cfg = PVDBOWConfig(dim=32, steps=300)
    index = build_index(corpus, train_pv_dbow(corpus, pv_cfg, device=dev),
                        LSHConfig(bits=128), temperature=pv_cfg.temperature,
                        device=dev)
    probs = index.shard_probabilities(prompt)
    return SimilaritySampler(probs).draw_epoch_order()


def train(args: argparse.Namespace) -> TrainRun:
    """The driver's body (see the module docstring)."""
    dev = resolve_device(args.device)
    owns_group = not dist.is_initialized()
    mesh = make_host_mesh(dev)
    try:
        return _train(args, dev, mesh)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(args: argparse.Namespace, dev: torch.device, mesh) -> TrainRun:
    cfg = get_config(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(cfg, max_seq_len=max(cfg.max_seq_len, args.seq))
    opt_cfg = AdamWConfig(lr=args.lr, state_dtype=cfg.dtypes.opt_state)
    setup: Dict[str, float] = {}

    # ---------------- data -------------------------------------------
    t = time.perf_counter()
    ccfg = SyntheticCorpusConfig(
        n_docs=args.n_docs,
        vocab_size=min(cfg.vocab_size, 8192), n_topics=16)
    docs, _ = generate_text_corpus(ccfg)
    corpus = ShardedCorpus.from_documents(docs, ccfg.vocab_size)
    setup["data"] = time.perf_counter() - t
    shard_order = None
    if args.similarity_prompt:
        t = time.perf_counter()
        shard_order = _similarity_order(corpus, args.similarity_prompt, dev)
        setup["similarity"] = time.perf_counter() - t
        print(f"[train] similarity sampling over {corpus.n_shards} shards")
    pipeline = LMBatchPipeline(corpus, args.batch, args.seq,
                               shard_order=shard_order)

    # ---------------- state ------------------------------------------
    t = time.perf_counter()
    params = M.init_stacked_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt_state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              total_steps=args.steps, mesh=mesh)
    setup["state"] = time.perf_counter() - t

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        t = time.perf_counter()
        step, restored = ckpt.restore_latest((params, opt_state))
        if step is not None:
            start_step, (params, opt_state) = step, restored
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            setup["restore"] = time.perf_counter() - t
            print(f"[train] resumed from step {start_step}")
    params = place_tree(params, params_shardings(cfg, mesh))
    opt_state = place_tree(opt_state, opt_state_shardings(cfg, mesh))
    writer = dist.get_rank() == 0

    # ---------------- loop -------------------------------------------
    run = TrainRun(params=params, opt_state=opt_state, start_step=start_step,
                   losses={}, step_s=[], tokens=0, n_shards=corpus.n_shards,
                   shard_order=shard_order, setup_s=setup)
    it = PrefetchIterator(iter(_batch_stream(pipeline, cfg, dev)), depth=2)
    clock = _StepClock(dev)
    t0 = time.time()
    saved = None
    try:
        for step in range(start_step, args.steps):
            batch = next(it)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            clock.mark()
            run.tokens += batch["tokens"].numel()
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                run.losses[step] = loss
                tps = run.tokens / max(time.time() - t0, 1e-9)
                print(f"[train] step {step} loss {loss:.4f} "
                      f"gnorm {gn:.3f} tok/s {tps:,.0f}", flush=True)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                run.save_s.append(_save(ckpt, step + 1, params, opt_state,
                                        writer))
                saved = step + 1
    finally:
        it.close()
    run.step_s = clock.walls()
    run.data_wait_s = it.wait_s
    if ckpt:
        if saved != args.steps:
            run.save_s.append(_save(ckpt, args.steps, params, opt_state,
                                    writer))
        t = time.perf_counter()
        ckpt.wait()
        run.wait_s = time.perf_counter() - t
    run.params, run.opt_state = full_tree((params, opt_state))
    print(f"[train] done: {args.steps} steps, "
          f"{run.tokens:,} tokens, {time.time()-t0:.1f}s, "
          f"{run.data_wait_s:.3f}s waiting for {it.gets} batches")
    return run


def _save(ckpt: CheckpointManager, step: int, params, opt_state,
          writer: bool) -> float:
    """Queue a checkpoint of the whole tensors (rank 0 writes it);
    returns the wall of its host snapshot."""
    t = time.perf_counter()
    state = full_tree((params, opt_state))
    if writer:
        ckpt.save(step, state)
    return time.perf_counter() - t


def _batch_stream(pipeline: LMBatchPipeline, cfg: ModelConfig,
                  dev: torch.device):
    """The pipeline's batches, epoch after epoch, as tensors on ``dev``
    (token ids int64), with zero encoder inputs for the enc-dec and VLM
    families."""
    epoch = 0
    while True:
        yielded = False
        for b in pipeline.iter_epoch(epoch):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            batch["tokens"] = batch["tokens"].long()
            batch["labels"] = batch["labels"].long()
            if cfg.is_encdec or cfg.family == "vlm":
                t = cfg.encoder_seq if cfg.is_encdec else cfg.vision_tokens
                batch["enc_inputs"] = torch.zeros(
                    (b["tokens"].shape[0], t, cfg.d_model),
                    dtype=cfg.dtypes.compute_dtype, device=dev)
            yielded = True
            yield batch
        epoch += 1
        if not yielded:
            raise RuntimeError("corpus too small for one batch")


def main(argv=None) -> TrainRun:
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
