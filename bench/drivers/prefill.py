"""Prefill traffic: a closed loop of batch inference over documents
(scoring, extraction, the first token of an answer), one batch at a
time.

Each batch has one prompt length, and as many prompts of it as fit the
mix's ``tokens_per_batch``.  The lengths are a fixed set, the
mid-quantiles of a log-normal (``lengths``), the same for every seed;
the seed orders them and draws the prompts' Zipfian ids.  Each cycle
through the set pairs the k-th shortest length with the k-th longest
and runs the pairs, and the two of a pair, in an order drawn from the
seed: every window then holds nearly the same mix, whatever the seed
and wherever the window ends.  A batch is submitted once its
prompts are on the device; it runs ``models.init_decode_state`` and
``launch.steps.make_prefill_step`` and takes the argmax of the last
logits to the host, which ends the time to first token of each of its
prompts.  Set-up makes the weights and runs every (length, rows) shape
once.  The window submits batches until the host clock has passed its
length and the cycle through the lengths is whole, so that every
window does the same work in another order; its time runs to the last
batch's first tokens.

The check (``check``): once the window has closed, a sample drawn from
the seed of the requests it finished, with a batch of the longest
length in it, is run through the float32 reference on prompts made
again from the seed, and compared:

  * ``logit_gap``  the widest gap by which a served token's reference
    logit lies below the reference's best (greedy tokens);
  * ``logit_err``  of a reservoir sample of prompts whose last logits
    the window copied (``sample.logit_slots`` and one of the longest
    length), |logits_p - logits_r| / |logits_r|, the largest;
  * the state prefill leaves, of a reservoir sample of prompts whose
    state the window copied (one prompt a kept batch, and one of the
    longest length): per layer, |state_p - state_r| / |state_r| (the
    Frobenius norm), the largest, for each number of the
    configuration's ``STATE_CHECKS`` (``kv_err``: the keys after their
    rotation and the values).
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench.lib import lm
from bench.lib.core import Run
from bench.lib.trace import WINDOW
from bench.reference import common as C

WINDOW_STREAM, WARMUP_STREAM = 0, 1


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Plan:
    """The seed's sequence of batches: (length, rows) of batch i."""

    def __init__(self, ctx):
        t = ctx.traffic
        g = t["lengths"]
        self.seed = ctx.seed
        self.lengths = lm.prompt_lengths(g["n"], g["median"], g["sigma"],
                                         g["min"], g["max"])
        self.budget = t["tokens_per_batch"]
        self._perm: Dict[int, np.ndarray] = {}

    def rows(self, length: int) -> int:
        return max(1, self.budget // length)

    def _cycle(self, c: int) -> np.ndarray:
        if c not in self._perm:
            rng = np.random.default_rng(lm.sub_seed(self.seed, 5, c))
            srt = sorted(self.lengths)
            n = len(srt)
            pairs = [[srt[k], srt[n - 1 - k]] for k in range(n // 2)]
            order = []
            for j in rng.permutation(len(pairs)):
                order.extend(rng.permutation(pairs[j]).tolist())
            if n % 2:
                order.append(srt[n // 2])
            self._perm[c] = np.asarray(order)
        return self._perm[c]

    def batch(self, i: int) -> Tuple[int, int]:
        n = len(self.lengths)
        length = int(self._cycle(i // n)[i % n])
        return length, self.rows(length)

    def shapes(self) -> List[Tuple[int, int]]:
        return sorted({(x, self.rows(x)) for x in self.lengths})


class Reservoir:
    """Which prompts' outputs the window keeps: ``k`` slots filled by
    reservoir sampling over the batches (one prompt of a batch, drawn
    from the seed's stream ``tag``), and one slot for a prompt of the
    longest length seen.  ``offer`` returns the slots batch i's prompt
    now fills."""

    def __init__(self, seed: int, k: int, tag: int):
        self.rng = np.random.default_rng(lm.sub_seed(seed, tag))
        self.k = k
        self.picks: Dict[int, Tuple[int, int]] = {}   # slot -> (i, row)
        self.longest = -1
        self.seen = 0

    def offer(self, i: int, length: int, rows: int) -> List[int]:
        row = int(self.rng.integers(rows))
        j = int(self.rng.integers(self.seen + 1))
        self.seen += 1
        slots = []
        if self.seen <= self.k:
            slots.append(self.seen - 1)
        elif j < self.k:
            slots.append(j)
        if length > self.longest:
            self.longest = length
            slots.append(self.k)
        for s in slots:
            self.picks[s] = (i, row)
        return slots


class Program:
    """The system under test as the window drives it."""

    def __init__(self, ctx, warm: bool = True):
        from repro_torch.launch import steps as S
        from repro_torch.models import model as M
        self.ctx, self.M = ctx, M
        t, dev = ctx.traffic, ctx.device
        cfgm, s = ctx.config, ctx.sizes
        self.pcfg = cfgm.port_config(ctx.smoke)
        self.plan = Plan(ctx)
        self.cdf = torch.tensor(lm.zipf_cdf(cfgm.token_vocab(s)), device=dev)
        stacked = lm.to_tree(cfgm.PORT_PATHS,
                             lm.make_weights(cfgm.leaves(s), ctx.seed, dev))
        layers = stacked.pop("layers")
        n = _first_leaf(layers).shape[0]
        stacked["layers"] = [_index(layers, i) for i in range(n)]
        self.params = stacked
        self.step = S.make_prefill_step(self.pcfg)
        self.done: List[tuple] = []     # (i, length, rows, served tokens)
        self.kept: Dict[int, Tuple[int, int, dict]] = {}
        self.kept_logits: Dict[int, Tuple[int, int, torch.Tensor]] = {}
        self.res = Reservoir(ctx.seed, t["sample"]["state_slots"], 6)
        self.res_logits = Reservoir(ctx.seed, t["sample"]["logit_slots"], 8)
        self.next = 0
        for j, (length, rows) in enumerate(self.plan.shapes() if warm
                                           else []):
            self._batch(WARMUP_STREAM, j, length, rows)
        _sync(dev)

    def _batch(self, stream: int, i: int, length: int, rows: int):
        dev = self.ctx.device
        tokens = lm.prompt_tokens(self.ctx.seed, stream, i, rows, length,
                                  self.cdf, dev)
        _sync(dev)
        t0 = time.perf_counter()
        state = self.M.init_decode_state(self.pcfg, rows, length,
                                         device=dev)
        logits, state = self.step(self.params, tokens, state)
        served = logits.argmax(-1).cpu()
        ttft = time.perf_counter() - t0
        bad = int((~torch.isfinite(logits)).any(-1).sum())
        return served.numpy(), ttft, state, bad, logits

    def _window_batch(self, run: Run | None):
        i = self.next
        self.next += 1
        length, rows = self.plan.batch(i)
        served, ttft, state, bad, logits = self._batch(WINDOW_STREAM, i,
                                                       length, rows)
        self.done.append((i, length, rows, served))
        for slot in self.res.offer(i, length, rows):
            row = self.res.picks[slot][1]
            part = self.ctx.config.port_state(state, row)
            self.kept[slot] = (i, row, {k: v.clone() for k, v in part.items()})
        for slot in self.res_logits.offer(i, length, rows):
            row = self.res_logits.picks[slot][1]
            self.kept_logits[slot] = (i, row, logits[row].clone())
        if run is not None:
            run.ttft_s.append(ttft)
            run.ttft_n.append(rows)
            run.tokens += length * rows
            run.attempted += rows
            run.failed += bad
            run.model_flops += rows * self.ctx.config.prefill_flops(
                self.ctx.sizes, length)
            run.units += 1

    def window(self, run: Run, seconds: float) -> None:
        dev = self.ctx.device
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cycle = len(self.plan.lengths)
        while True:
            self._window_batch(run)
            if time.perf_counter() - t0 >= seconds and \
                    self.next % cycle == 0:
                break
        run.window_s = time.perf_counter() - t0
        if dev.type == "cuda":
            run.window_peak_bytes = torch.cuda.max_memory_allocated(dev)

    def traced(self, n: int) -> int:
        """``n`` more of the window's batches inside the trace's span
        (their requests are not counted in the window's metrics)."""
        from torch.profiler import record_function
        with record_function(WINDOW):
            _sync(self.ctx.device)
            for _ in range(n):
                with record_function("bench.prefill_batch"):
                    self._window_batch(None)
            _sync(self.ctx.device)
        return n

    def outputs(self) -> Dict:
        return {"done": self.done, "kept": self.kept,
                "kept_logits": self.kept_logits}

    def close(self) -> None:
        self.params = self.step = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def sample(ctx, done: List[tuple], kept: Dict) -> Dict[int, tuple]:
    """{batch i: (length, rows, sorted rows to compare)}: batches drawn
    from the seed among those finished (``sample.batches`` of them, a
    batch of the longest length among them), ``sample.rows_per_batch``
    prompts drawn in each, and every kept prompt (``kept``: slot ->
    (i, row, ...))."""
    t = ctx.traffic["sample"]
    rng = np.random.default_rng(lm.sub_seed(ctx.seed, 7))
    by_i = {d[0]: d for d in done}
    order = [d[0] for d in done]
    chosen = set(rng.choice(order, size=min(t["batches"], len(order)),
                            replace=False).tolist())
    longest = max(d[1] for d in done)
    chosen.add(next(d[0] for d in done if d[1] == longest))
    chosen |= {i for i, _, _ in kept.values()}
    out = {}
    for i in sorted(chosen):
        _, length, rows, _ = by_i[i]
        pick = set(rng.choice(rows, size=min(t["rows_per_batch"], rows),
                              replace=False).tolist())
        pick |= {r for j, r, _ in kept.values() if j == i}
        out[i] = (length, rows, sorted(pick))
    return out


def reference_outputs(ctx, chosen: Dict[int, tuple], kept_at, precision):
    """The reference's last logits for every chosen prompt, and its
    state for each (i, row) in ``kept_at``: ({(i, row): logits [V]},
    {(i, row): state dict})."""
    dev, s = ctx.device, ctx.sizes
    C.no_tf32()
    weights = lm.make_weights(ctx.config.leaves(s), ctx.seed, dev)
    model = ctx.reference.Model(s, weights, precision)
    cdf = torch.tensor(lm.zipf_cdf(ctx.config.token_vocab(s)), device=dev)
    block = ctx.traffic["ref_block_tokens"]
    logits, states = {}, {}
    for i, (length, rows, pick) in chosen.items():
        tok = lm.prompt_tokens(ctx.seed, WINDOW_STREAM, i, rows, length,
                               cdf, dev)
        per = max(1, block // length)
        plain = [r for r in pick if (i, r) not in kept_at]
        for a in range(0, len(plain), per):
            rr = plain[a:a + per]
            out, _ = model.prefill(tok[rr])
            for r, row in zip(rr, out):
                logits[(i, r)] = row
        for r in pick:
            if (i, r) in kept_at:
                out, st = model.prefill(tok[[r]], want_state=True)
                logits[(i, r)] = out[0]
                states[(i, r)] = {k: v[:, 0] for k, v in st.items()}
    return logits, states


def readings(ctx, served: Dict[tuple, int], states: Dict[tuple, dict],
             logits: Dict[tuple, torch.Tensor],
             ref_logits: Dict[tuple, torch.Tensor],
             ref_states: Dict[tuple, dict]) -> Dict[str, float]:
    gaps = []
    for key, tok in served.items():
        z = ref_logits[key].float()
        gaps.append(float(z.max() - z[int(tok)]))
    errs = [float((z.float() - ref_logits[key].float()).norm()
                  / ref_logits[key].float().norm().clamp_min(1e-30))
            for key, z in logits.items()]
    out = {"logit_gap": max(gaps), "logit_err": max(errs)}
    for name, parts in ctx.config.STATE_CHECKS.items():
        worst = 0.0
        for key, st in states.items():
            for part in parts:
                p = st[part].float()
                r = ref_states[key][part].float()
                num = (p - r).flatten(1).norm(dim=1)
                den = r.flatten(1).norm(dim=1).clamp_min(1e-30)
                worst = max(worst, float((num / den).max()))
        out[name] = worst
    out["_where"] = (f"{len(served)} prompts, {len(logits)} logits, "
                     f"{len(states)} states")
    return out


def check(ctx, outputs: Dict) -> Dict[str, float]:
    done, kept = outputs["done"], outputs["kept"]
    kept_logits = outputs["kept_logits"]
    chosen = sample(ctx, done, {**{-1 - k: v for k, v in kept.items()},
                                **kept_logits})
    by_i = {d[0]: d for d in done}
    served = {(i, r): int(by_i[i][3][r])
              for i, (_, _, pick) in chosen.items() for r in pick}
    states = {(i, r): st for i, r, st in kept.values()}
    logits = {(i, r): z for i, r, z in kept_logits.values()}
    ref_logits, ref_states = reference_outputs(ctx, chosen, set(states),
                                               "fp32")
    return readings(ctx, served, states, logits, ref_logits, ref_states)
