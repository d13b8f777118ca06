"""Training traffic: the port's train step at a fixed batch of packed
rows, fed by its data pipeline.

Set-up makes the documents (Zipfian ids, log-normal lengths) from the
seed, stores them in a ``ShardedCorpus`` and packs them with
``LMBatchPipeline`` (shards in order, so the rows are the documents
laid end to end and cut every ``seq + 1`` tokens), read through the
port's own batch stream (``launch.train._batch_stream``) behind its
``PrefetchIterator``; it makes the weights, builds the AdamW state and
``launch.steps.make_train_step``, and drives that step through the
check's first steps, which also warm up every shape.  The window runs
the same object on: it takes a batch from the stream, calls the step,
and stops once the host clock has passed the window's length; the
device is synchronised at both ends.  Once the window (and, traced,
the profiled steps) has closed and the peak memory has been read,
``outputs`` copies the state and runs one more step of the same call
on the stream's next batch: a step the program cannot tell from the
window's, taken after every warm-up.

The check (``check``): the reference trains a copy of the same weights
on the same rows, made again from the seed, for the first steps, in
float32, and takes the last step from the copy of the program's state
(its parameters and AdamW moments, the rows packed again from the
documents).  Numbers (``readings``):

  * ``loss_gap``   the largest relative gap of a step's loss, first
    steps;
  * ``grad_gap_median`` the first gradient as the optimizer got it,
    worked out from its first moment after one step (m / (1 - b1), the
    clip taken off by the step's ``grad_norm``), per leaf (per layer of
    a stacked leaf): |norm_p - norm_r| over the larger of norm_r and
    the median leaf's, the median over the leaves (``grad_gap``, the
    largest, is printed beside it: the embedding's gradient, summed in
    bfloat16 over every occurrence of a token, reads far above every
    other leaf, and above the control, which sums it in float32);
  * ``change_gap`` the same of the parameters' change over the first
    steps, the largest over the leaves, leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's
    (rounding moves them under Adam);
  * ``late_loss_gap``, ``late_grad_gap_median``, ``late_change_gap``
    the same three of the step after the window (its gradient worked
    out from the moments before and after it: (m1 - b1 m0) / (1 - b1)),
    ``late_grad_gap`` printed beside them.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict

import numpy as np
import torch

from bench.lib import lm
from bench.lib.core import Run
from bench.lib.trace import WINDOW
from bench.reference import common as C


def _docs(ctx):
    t, s = ctx.traffic, ctx.sizes
    dl = t["doc_length"]
    return lm.documents(ctx.seed, ctx.config.token_vocab(s),
                        t["corpus_tokens"], dl["median"], dl["sigma"],
                        dl["min"], dl["max"])


def epoch_batches(docs, rows: int, seq: int):
    """(whole batches, batches) of one epoch of the pipeline over
    ``docs``: the documents laid end to end and cut into batches of
    ``rows * (seq + 1)`` tokens, then, where at least two tokens a row
    are left, a last batch padded to the length."""
    need = rows * (seq + 1)
    total = sum(len(d) for d in docs)
    full = total // need
    rest = total - full * need
    return full, full + int(rest > rows and rest // rows >= 2)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Program:
    """The system under test as the window drives it."""

    def __init__(self, ctx):
        from repro_torch.data.pipeline import LMBatchPipeline, PrefetchIterator
        from repro_torch.data.store import Document, ShardedCorpus
        from repro_torch.launch import steps as S
        from repro_torch.launch.train import _batch_stream
        from repro_torch.optimizer.adamw import AdamWConfig, adamw_init

        self.ctx = ctx
        t, dev = ctx.traffic, ctx.device
        cfgm, s = ctx.config, ctx.sizes
        opt = cfgm.SPEC["optimizer"]
        self.rows, self.seq = t["rows"], t["seq"]
        self.flops_per_token = cfgm.train_flops_per_token(s, self.seq)
        pcfg = cfgm.port_config(ctx.smoke)
        opt_cfg = AdamWConfig(
            lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
            weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
            state_dtype=cfgm.SPEC["dtypes"]["opt_state"])
        docs = _docs(ctx)
        corpus = ShardedCorpus.from_documents(
            [Document(i, d) for i, d in enumerate(docs)],
            cfgm.token_vocab(s), shard_tokens=t["shard_tokens"])
        pipe = LMBatchPipeline(corpus, self.rows, self.seq,
                               shard_order=np.arange(corpus.n_shards))
        self.it = PrefetchIterator(_batch_stream(pipe, pcfg, dev),
                                   depth=t["prefetch"])
        self.drawn = 0       # batches taken from the stream
        self.full, self.per_epoch = epoch_batches(docs, self.rows, self.seq)

        weights = lm.make_weights(cfgm.leaves(s), ctx.seed, dev)
        first = {k: w.clone() for k, w in weights.items()}
        params = lm.to_tree(cfgm.PORT_PATHS, weights)
        state = adamw_init(params, opt_cfg)
        self.step = S.make_train_step(pcfg, opt_cfg, microbatches=1,
                                      total_steps=opt["total_steps"],
                                      warmup_steps=opt["warmup_steps"])
        losses = []
        for i in range(t["check_steps"]):
            params, state, met = self.step(params, state, self._next())
            losses.append(met["loss"])
            if i == 0:
                clip = self._clip(float(met["grad_norm"]))
                m1 = lm.from_tree(cfgm.PORT_PATHS, state.m)
                g1 = lm.leaf_norms({k: v.float() / (1 - opt["b1"]) / clip
                                    for k, v in m1.items()})
        now = lm.from_tree(cfgm.PORT_PATHS, params)
        change = lm.leaf_norms({k: now[k].float() - first[k]
                                for k in first})
        del first, weights, now
        self.record = {"losses": [float(x) for x in losses], "g1": g1,
                       "change": change}
        self.params, self.state = params, state
        _sync(dev)

    def window(self, run: Run, seconds: float) -> None:
        dev = self.ctx.device
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        losses, wait = [], 0.0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            batch = self._next()
            wait += time.perf_counter() - a
            self.params, self.state, met = self.step(self.params,
                                                     self.state, batch)
            losses.append(met["loss"])
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(dev)
        run.window_s = time.perf_counter() - t0
        n = len(losses)
        run.units = run.attempted = n
        run.tokens = n * self.rows * self.seq
        run.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        run.data_wait_s = wait
        run.model_flops = run.tokens * self.flops_per_token
        if dev.type == "cuda":
            run.window_peak_bytes = torch.cuda.max_memory_allocated(dev)

    def traced(self, n: int) -> int:
        """``n`` more steps inside the trace's window span."""
        from torch.profiler import record_function
        with record_function(WINDOW):
            _sync(self.ctx.device)
            for _ in range(n):
                with record_function("bench.next_batch"):
                    batch = self._next()
                with record_function("bench.train_step"):
                    self.params, self.state, _ = self.step(
                        self.params, self.state, batch)
            _sync(self.ctx.device)
        return n

    def _next(self):
        self.drawn += 1
        return next(self.it)

    def outputs(self) -> Dict:
        """The check's record: set-up's first steps, and one more step
        of the window's call with the state it started from (``late``).
        The step takes the stream's next batch of whole rows (the
        pipeline's padded last batch of an epoch is passed over)."""
        cfgm = self.ctx.config
        paths, b1 = cfgm.PORT_PATHS, cfgm.SPEC["optimizer"]["b1"]
        while self.drawn % self.per_epoch >= self.full:
            self._next()
        index = self.drawn % self.per_epoch
        batch = self._next()
        copy = {part: {k: v.detach().float().clone()
                       for k, v in lm.from_tree(paths, tree).items()}
                for part, tree in (("params", self.params),
                                   ("m", self.state.m), ("v", self.state.v))}
        t = int(self.state.step) + 1
        self.params, self.state, met = self.step(self.params, self.state,
                                                 batch)
        clip = self._clip(float(met["grad_norm"]))
        now = lm.from_tree(paths, self.params)
        m1 = lm.from_tree(paths, self.state.m)
        self.record["late"] = {
            "index": index, "t": t, **copy,
            "loss": float(met["loss"]),
            "g": lm.leaf_norms({k: (m1[k].float() - b1 * copy["m"][k])
                                / (1 - b1) / clip for k in m1}),
            "change": lm.leaf_norms({k: now[k].float() - copy["params"][k]
                                     for k in now})}
        _sync(self.ctx.device)
        return self.record

    def _clip(self, gnorm: float) -> float:
        return min(1.0, self.ctx.config.SPEC["optimizer"]["grad_clip"]
                   / max(gnorm, 1e-9))

    def close(self) -> None:
        self.it.close()
        self.params = self.state = self.step = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_record(ctx, late: Dict, precision: str = "fp32",
                     rows: int | None = None) -> Dict:
    """What the reference gives for the check's first steps (each
    step's loss, the first gradient's leaf norms, the change's) and for
    the step after the window (``late``: from the copy of the program's
    state before it).  The weights and rows are made again from the
    seed; ``rows`` cuts each step's batch to its first rows (a fault
    the check must see)."""
    t, dev = ctx.traffic, ctx.device
    cfgm, s = ctx.config, ctx.sizes
    opt = cfgm.SPEC["optimizer"]
    C.no_tf32()
    first = lm.make_weights(cfgm.leaves(s), ctx.seed, dev)
    params = {k: w.clone().requires_grad_(True) for k, w in first.items()}
    docs = _docs(ctx)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, g1 = [], None
    for i in range(t["check_steps"]):
        loss, grads = _loss_and_grads(ctx, params, docs, i, precision, rows)
        losses.append(loss)
        if i == 0:
            g1 = lm.leaf_norms(grads)
        C.adamw_step(params, grads, m, v, i + 1, opt)
        del grads
    change = lm.leaf_norms({k: params[k].detach() - first[k]
                            for k in first})
    del first, params, m, v
    params = {k: p.clone().requires_grad_(True)
              for k, p in late["params"].items()}
    m = {k: x.clone() for k, x in late["m"].items()}
    v = {k: x.clone() for k, x in late["v"].items()}
    loss, grads = _loss_and_grads(ctx, params, docs, late["index"],
                                  precision, rows)
    g = lm.leaf_norms(grads)
    C.adamw_step(params, grads, m, v, late["t"], opt)
    del grads
    moved = lm.leaf_norms({k: params[k].detach() - late["params"][k]
                           for k in params})
    return {"losses": losses, "g1": g1, "change": change,
            "late": {"index": late["index"], "t": late["t"], "loss": loss,
                     "g": g, "change": moved}}


def _loss_and_grads(ctx, params, docs, index: int, precision: str,
                    rows: int | None):
    """The reference's loss and gradient on batch ``index`` of the
    stream, packed again from the documents (its first ``rows``)."""
    t, dev = ctx.traffic, ctx.device
    model = ctx.reference.Model(ctx.sizes, params, precision)
    tok, lab = C.pack_rows(docs, index * t["rows"], t["rows"], t["seq"])
    take = rows or t["rows"]
    tok = torch.from_numpy(tok[:take]).to(dev)
    lab = torch.from_numpy(lab[:take]).to(dev)
    return C.loss_and_grads(model, params, tok, lab, t["ref_block_rows"])


def _gaps(g_p: Dict, g_r: Dict, change_p: Dict, change_r: Dict):
    """(worst gradient gap, its leaf, median gradient gap, worst change
    gap, its leaf, leaves left out of the change)."""
    gaps, names = lm.leaf_gaps(g_p, g_r)
    med = float(np.median(torch.cat(list(g_r.values())).numpy()))
    keep = {k: g >= 1e-3 * med for k, g in g_r.items()}
    change_gap, change_leaf = lm.worst_leaf_gap(change_p, change_r, keep)
    return (float(gaps.max()), names[int(gaps.argmax())],
            float(np.median(gaps)), change_gap, change_leaf,
            sum(int((~k).sum()) for k in keep.values()))


def _loss_gap(p: float, r: float) -> float:
    return abs(p - r) / abs(r) if math.isfinite(p) else math.inf


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    loss_gap = max(_loss_gap(p, r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_leaf, grad_med, change_gap, change_leaf, out = _gaps(
        prog["g1"], ref["g1"], prog["change"], ref["change"])
    lp, lr = prog["late"], ref["late"]
    l_grad, l_grad_leaf, l_med, l_change, l_change_leaf, l_out = _gaps(
        lp["g"], lr["g"], lp["change"], lr["change"])
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_gap_median": grad_med, "change_gap": change_gap,
            "late_loss_gap": _loss_gap(lp["loss"], lr["loss"]),
            "late_grad_gap": l_grad, "late_grad_gap_median": l_med,
            "late_change_gap": l_change,
            "_where": f"grad {grad_leaf}, change {change_leaf}, {out} "
                      f"leaves left out of the change; after the window "
                      f"(batch {prog['late']['index']}, update "
                      f"{prog['late']['t']}): grad {l_grad_leaf}, change "
                      f"{l_change_leaf}, {l_out} left out"}


def check(ctx, outputs: Dict) -> Dict[str, float]:
    return readings(outputs, reference_record(ctx, outputs["late"]))
